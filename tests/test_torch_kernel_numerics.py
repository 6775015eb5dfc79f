"""K3's and K4's tensor-core arithmetic, emulated in plain torch on the
CPU, against the JAX package's flash attention and SSD chunk scan (the
Pallas kernels in interpret mode, as tests/test_torch_flash_attention.py
and tests/test_torch_ssd_scan.py run them; K4 also against the step-by-step
oracle).

The bf16 path of ``csrc/flash_attention.cu`` computes q k^T on the unscaled
bf16 q and k (exact products, f32 sums), scales the scores in f32, walks
64-key tiles with the online rescale, and feeds p to the tensor cores as
p_hi + p_lo (p_hi = bf16(p), p_lo = bf16(p - p_hi)). The emulation below
follows those steps (the kernel's sums run in another order, which is f32
reassociation only). A second case measures how far the same emulation
lands with a single bf16 p: the reason for the split, recorded in PERF.md
(run with ``-s`` to print it). K4's bf16 path (``csrc/ssd_scan.cu``) feeds
its three f32 operands (the masked scores M, the state h for C h, and the
weighted x of the state update) as hi + lo halves in the same way; its
second test shows that one bf16 for any of them leaves K4's tolerance.
K4's backward's bf16 path (``csrc/ssd_scan_bwd.cu``) feeds six f32
operands (M, dS, the states H and G, k o x and e o dy) as hi + lo halves,
takes S once per group and sums dB and dC over runs of heads, then over
the runs; its emulation is held against the plain chunked backward and
``jax.vjp`` of the JAX package's ``ssd_chunked``, and its second test
prints how far one bf16 for each operand lands. Inputs come from numpy
seeds."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.ref import ssd_scan_ref as jssd_ref
from repro.kernels.ssd_scan import ssd_scan as jssd
from repro.models.ssm import ssd_chunked as jssd_chunked
from repro_torch.kernels.ref import ssd_scan_grouped_bwd_ref

torch.set_num_threads(1)

TILE = 64                # query rows and keys of a tile, as the kernel's
MASK_FILL = -2.0e38
# K3's bf16 tolerance on the card (tests/test_torch_cuda.py, chip_smoke.py):
# the f32 result is rounded to bf16 once, so one bf16 ulp (2^-7 relative)
K3_TOL_BF16 = dict(rtol=2.0 ** -7, atol=1e-3)


def k3_emulated(q, k, v, *, causal=True, window=None, split=True):
    """q (BH, Sq, D), k, v (BH, Sk, D) bf16 -> (o bf16, o before its
    rounding f32), with the kernel's bf16-path arithmetic."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    out = torch.empty((bh, sq, d), dtype=torch.float32)
    for q0 in range(0, sq, TILE):
        qt = q[:, q0:q0 + TILE].float()
        qp = torch.arange(q0, q0 + qt.shape[1])[:, None]
        kt_end = -(-sk // TILE)
        if causal:
            kt_end = min(kt_end, (q0 + TILE - 1) // TILE + 1)
        kt_begin = max(0, q0 - window + 1) // TILE if window else 0
        m = torch.full((bh, qt.shape[1]), MASK_FILL)
        l = torch.zeros((bh, qt.shape[1]))
        acc = torch.zeros((bh, qt.shape[1], d))
        for kt in range(kt_begin, kt_end):
            k0 = kt * TILE
            kt_, vt = k[:, k0:k0 + TILE].float(), v[:, k0:k0 + TILE].float()
            s = (qt @ kt_.transpose(1, 2)) * scale
            kp = torch.arange(k0, k0 + kt_.shape[1])[None, :]
            ok = torch.ones_like(s[0], dtype=torch.bool)
            if causal:
                ok &= kp <= qp
            if window:
                ok &= kp > qp - window
            s = s.masked_fill(~ok, MASK_FILL)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(-1)
            m = m_new
            if split:
                p_hi = p.bfloat16().float()
                p_lo = (p - p_hi).bfloat16().float()
                pv = p_hi @ vt + p_lo @ vt
            else:
                pv = p.bfloat16().float() @ vt
            acc = acc * corr[..., None] + pv
        out[:, q0:q0 + TILE] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.bfloat16(), out


def _qkv(bh, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, np.float32).astype(jnp.bfloat16)
            for s in ((bh, sq, d), (bh, sk, d), (bh, sk, d))]


def _jax(q, k, v, causal, window):
    o = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
               causal=causal, window=window, interpret=True)
    return torch.from_numpy(np.asarray(o, np.float32))


def _torch(t):
    return torch.from_numpy(np.asarray(t, np.float32)).bfloat16()


def _oracle(q, k, v, causal, window):
    """The same attention in float64 on the same bf16 inputs."""
    q, k, v = (torch.from_numpy(np.asarray(t, np.float64)) for t in (q, k, v))
    s = q @ k.transpose(1, 2) / math.sqrt(q.shape[-1])
    qp = torch.arange(q.shape[1])[:, None]
    kp = torch.arange(k.shape[1])[None, :]
    ok = torch.ones_like(s[0], dtype=torch.bool)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    return torch.softmax(s.masked_fill(~ok, -math.inf), -1) @ v


SHAPES = [  # (BH, Sq, Sk, D, causal, window)
    (2, 128, 128, 64, True, None),
    (2, 128, 256, 80, True, None),
    (2, 128, 128, 80, True, 37),
    (2, 256, 256, 128, True, None),
    (2, 128, 256, 128, False, 37),
]


@pytest.mark.parametrize("bh,sq,sk,d,causal,window", SHAPES)
def test_k3_split_p_emulation_matches_jax(bh, sq, sk, d, causal, window):
    """The kernel's bf16 arithmetic (p_hi + p_lo) lands within K3's bf16
    tolerance of the JAX kernel."""
    q, k, v = _qkv(bh, sq, sk, d, bh * sq + sk + d)
    want = _jax(q, k, v, causal, window)
    got, _ = k3_emulated(_torch(q), _torch(k), _torch(v), causal=causal,
                         window=window)
    torch.testing.assert_close(got.float(), want, **K3_TOL_BF16)


def test_k3_single_bf16_p_is_the_reason_for_the_split():
    """The same emulation with p as one bf16: its f32 result lies far
    further from a float64 oracle than the split's, and the printed counts
    say how many outputs leave K3's bf16 tolerance against JAX."""
    bh, sq, sk, d, causal, window = 4, 256, 256, 128, True, None
    q, k, v = _qkv(bh, sq, sk, d, 2024)
    want = _jax(q, k, v, causal, window)
    oracle = _oracle(q, k, v, causal, window)
    tol = K3_TOL_BF16
    rows = {}
    for split in (True, False):
        o, o32 = k3_emulated(_torch(q), _torch(k), _torch(v), causal=causal,
                             window=window, split=split)
        err = (o.float() - want).abs()
        rows[split] = (float((o32.double() - oracle).abs().max()),
                       float(err.max()),
                       int((err > tol["atol"] + tol["rtol"] * want.abs())
                           .sum()))
    print(f"\nK3 emulation at (BH, S, D) = ({bh}, {sq}, {d}), causal, bf16: "
          f"max |o_f32 - float64 oracle| split {rows[True][0]:.3e}, single "
          f"bf16 p {rows[False][0]:.3e}; against JAX after rounding: max "
          f"|err| split {rows[True][1]:.3e} ({rows[True][2]} of "
          f"{want.numel()} outside rtol 2^-7 atol 1e-3), single "
          f"{rows[False][1]:.3e} ({rows[False][2]} outside)")
    assert rows[True][2] == 0
    assert rows[True][0] * 10 < rows[False][0]


# ---------------------------------------------------------------------------
# K4 (csrc/ssd_scan.cu), bf16 path
# ---------------------------------------------------------------------------

CHUNK = 64               # K4's chunk length
# K4's tolerances on the card (tests/test_torch_cuda.py, chip_smoke.py): the
# f32 state 3e-4, the JAX kernel test's own for chunked against sequential;
# bf16 y one bf16 ulp (2^-7 relative) besides
K4_TOL_STATE = dict(rtol=3e-4, atol=3e-4)
K4_TOL_BF16 = dict(rtol=2.0 ** -7, atol=1e-3)
K4_OPERANDS = ("M", "h", "wx")


def _hi_lo(v, split):
    """v as the kernel feeds it to the tensor cores: bf16(v) plus, with
    ``split``, bf16(v - bf16(v)); both returned in f32."""
    hi = v.bfloat16().float()
    lo = (v - hi).bfloat16().float() if split else torch.zeros_like(v)
    return hi, lo


def _clip_exp(v):
    return torch.exp(v.clamp(-60.0, 0.0))


def k4_emulated(x, dt, A, B, C, *, single=()):
    """x (BH, S, P), B, C (BH, S, N) bf16, dt (BH, S), A (BH,) f32 ->
    (y bf16, y before its rounding f32, h_final f32), with the kernel's
    bf16-path arithmetic: 64-step chunks, steps past S as dt = 0 steps, f32
    sums of exact bf16 products, and the three f32 operands M (the masked,
    decayed scores), h (the incoming state, for C h) and w x (x weighted
    for the state update) each as hi + lo bf16 halves; an operand named in
    ``single`` enters as one bf16 instead."""
    bh, s, p = x.shape
    n = B.shape[-1]
    xf, bf, cf = x.float(), B.float(), C.float()
    h = torch.zeros((bh, n, p))
    y = torch.empty((bh, s, p))
    idx = torch.arange(CHUNK)
    causal = idx[:, None] >= idx[None, :]
    for t0 in range(0, s, CHUNK):
        ln = min(CHUNK, s - t0)
        xc, bc, cc = (torch.zeros((bh, CHUNK, t.shape[-1])) for t in
                      (xf, bf, cf))
        d = torch.zeros((bh, CHUNK))
        for full, part in ((xf, xc), (bf, bc), (cf, cc), (dt, d)):
            part[:, :ln] = full[:, t0:t0 + ln]
        cum = torch.cumsum(d * A[:, None], 1)
        m = torch.where(causal, (cc @ bc.transpose(1, 2))
                        * _clip_exp(cum[:, :, None] - cum[:, None, :])
                        * d[:, None, :], torch.zeros(()))
        h_hi, h_lo = _hi_lo(h, "h" not in single)
        yc = (cc @ h_hi + cc @ h_lo) * _clip_exp(cum)[..., None]
        m_hi, m_lo = _hi_lo(m, "M" not in single)
        y[:, t0:t0 + ln] = (yc + m_hi @ xc + m_lo @ xc)[:, :ln]
        w = _clip_exp(cum[:, -1:] - cum) * d
        wx_hi, wx_lo = _hi_lo(xc * w[..., None], "wx" not in single)
        bt = bc.transpose(1, 2)
        h = (h * _clip_exp(cum[:, -1])[:, None, None] + bt @ wx_hi
             + bt @ wx_lo)
    return y.bfloat16(), y, h


def _ssd_inputs(bh, s, p, n, seed):
    """x ~ N(0, 1), B, C ~ 0.3 N(0, 1) in bf16, dt = softplus(N(0, 1)) / 2,
    A = -exp(N(0, 1)) / 2 in f32 (numpy; as the JAX kernel test draws)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bh, s, p), np.float32).astype(jnp.bfloat16)
    dt = (np.log1p(np.exp(rng.standard_normal((bh, s)))) * 0.5).astype(
        np.float32)
    A = (-np.exp(rng.standard_normal(bh)) * 0.5).astype(np.float32)
    B, C = ((rng.standard_normal((bh, s, n)) * 0.3).astype(np.float32)
            .astype(jnp.bfloat16) for _ in "BC")
    return x, dt, A, B, C


def _k4_torch(ins):
    x, dt, A, B, C = ins
    return (_torch(x), torch.from_numpy(dt), torch.from_numpy(A), _torch(B),
            _torch(C))


def _k4_jax(ins, chunk):
    """The JAX Pallas kernel in interpret mode (chunk given) or, with
    chunk None, the JAX package's step-by-step oracle."""
    args = [jnp.asarray(a) for a in ins]
    y, h = (jssd(*args, chunk=chunk, interpret=True) if chunk
            else jssd_ref(*args))
    return (torch.from_numpy(np.asarray(y, np.float32)),
            torch.from_numpy(np.array(h, np.float32)))


K4_SHAPES = [  # (BH, S, P, N): mamba2's P and N, zamba2's N, P 32, ragged
    (2, 256, 64, 128),
    (2, 256, 64, 64),
    (3, 128, 32, 16),
    (2, 200, 64, 128),
]


@pytest.mark.parametrize("bh,s,p,n", K4_SHAPES)
def test_k4_split_emulation_matches_jax(bh, s, p, n):
    """The kernel's bf16 arithmetic (M, h and w x as hi + lo halves) lands
    within K4's tolerances of the JAX Pallas kernel at its 64-step chunk
    (where S is a multiple of it) and of the step-by-step oracle."""
    ins = _ssd_inputs(bh, s, p, n, bh * s + p + n)
    y, _, h = k4_emulated(*_k4_torch(ins))
    for chunk in ((CHUNK, None) if s % CHUNK == 0 else (None,)):
        want_y, want_h = _k4_jax(ins, chunk)
        torch.testing.assert_close(y.float(), want_y, **K4_TOL_BF16)
        torch.testing.assert_close(h, want_h, **K4_TOL_STATE)


def test_k4_single_bf16_operand_is_the_reason_for_the_split():
    """Each of the three f32 operands as a single bf16 leaves K4's
    tolerance against the JAX kernel: w x the state's 3e-4, M and h the
    bf16 y's one ulp; with all three split nothing does. The printed counts
    (``-s``) are recorded in PERF.md."""
    ins = _ssd_inputs(2, 256, 64, 128, 2025)
    want_y, want_h = _k4_jax(ins, CHUNK)
    t = _k4_torch(ins)

    def outside(got, want, tol):
        err = (got - want).abs()
        return int((err > tol["atol"] + tol["rtol"] * want.abs()).sum())

    rows = {}
    for single in ((),) + tuple((op,) for op in K4_OPERANDS):
        y, _, h = k4_emulated(*t, single=single)
        rows[single] = (outside(y.float(), want_y, K4_TOL_BF16),
                        outside(h, want_h, K4_TOL_STATE),
                        float((h - want_h).abs().max()))
    print("\nK4 emulation at (BH, S, P, N) = (2, 256, 64, 128), bf16, "
          f"against JAX (y {want_y.numel()} outputs, state "
          f"{want_h.numel()}): " + "; ".join(
              f"{'+'.join(k) or 'all split'} single: y {v[0]} outside, state "
              f"{v[1]} outside (max |err| {v[2]:.2e})"
              for k, v in rows.items()))
    assert rows[()][:2] == (0, 0)
    assert rows[("wx",)][1] > 0
    assert rows[("M",)][0] > 0 and rows[("h",)][0] > 0


# ---------------------------------------------------------------------------
# K4's backward (csrc/ssd_scan_bwd.cu), bf16 path
# ---------------------------------------------------------------------------

# chip_smoke.py's GRAD_TOL for bf16: |got - want| <= rtol |want| + atol
# max|want|, one bf16 rounding of the f32 result and 2^-9 of the scale
GRAD_RTOL, GRAD_ATOL = 2.0 ** -7, 2.0 ** -9
K4_BWD_OPERANDS = ("M", "dS", "G", "H", "kx", "ey")
K4_BWD_OUTPUTS = ("dx", "d(dt)", "dA", "dB", "dC")


def k4_bwd_emulated(x, dt, A, B, C, dy, dh, *, run, single=()):
    """x (Bt, S, H, P), B and C (Bt, S, G, N), dy bf16; dt (Bt, S, H), A
    (H,), dh (Bt, H, N, P) f32 -> (dx, d(dt), dA, dB, dC), with the bf16
    backward kernel's arithmetic: 64-step chunks, steps past S as dt = 0
    steps; the states entering (H) and the state gradients leaving (G)
    each chunk by two scans whose updates take k o x and e o dy as hi + lo
    halves, stored as hi + lo halves; per chunk S^T = B C^T once per group,
    Q^T = x dy^T, M^T and dS^T in f32; dx = k o (B G) + M^T dy, dB and dC
    summed over runs of ``run`` consecutive heads of a group (k o (x G^T)
    and e o (dy H^T) a head, then (sum dS^T) C and (sum dS) B once a run),
    then over the runs in order; every f32 operand (M, the run's sum of dS,
    G, H, k o x, e o dy) as hi + lo halves, or as one bf16 if named in
    ``single``; sums of exact bf16 products in f32; each gradient rounded
    once."""
    bt, s, hh, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hpg = hh // g
    nc = -(-s // CHUNK)
    pad = nc * CHUNK - s

    def chunks(t):  # (Bt, S, K, W) -> (Bt, nc, K, L, W) f32
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad))
        return t.reshape(bt, nc, CHUNK, *t.shape[2:]).transpose(2, 3)

    def split(v, name):
        hi = v.bfloat16().float()
        lo = (torch.zeros_like(v) if name in single
              else (v - hi).bfloat16().float())
        return hi, lo

    def prod(a, pair):  # a @ (hi + lo) as two products summed in f32
        return a @ pair[0] + a @ pair[1]

    xc, dyc, Bc, Cc = (chunks(t) for t in (x, dy, B, C))
    dtc = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad)).reshape(
        bt, nc, CHUNK, hh).transpose(2, 3)                 # (Bt, nc, H, L)
    a = A.float()[None, None, :, None]
    cum = torch.cumsum(dtc * a, -1)
    e, d = _clip_exp(cum), _clip_exp(cum[..., -1:] - cum)
    k, E = d * dtc, e[..., -1]
    grp = torch.arange(hh) // hpg
    Bh, Ch = Bc[:, :, grp], Cc[:, :, grp]                  # to heads
    # the states kernel: each state stored before its chunk's update
    h = torch.zeros((bt, hh, n, p))
    G = dh.float().clone()
    Hs, Gs = [None] * nc, [None] * nc
    for c in range(nc):
        Hs[c] = split(h, "H")
        if c < nc - 1:
            h = h * E[:, c, :, None, None] + prod(
                Bh[:, c].transpose(-1, -2),
                split(k[:, c, ..., None] * xc[:, c], "kx"))
    for c in reversed(range(nc)):
        Gs[c] = split(G, "G")
        if c > 0:
            G = G * E[:, c, :, None, None] + prod(
                Ch[:, c].transpose(-1, -2),
                split(e[:, c, ..., None] * dyc[:, c], "ey"))
    # the gradient kernel, in the transposed layout (rows j, columns i)
    idx = torch.arange(CHUNK)
    low = idx[None, :] >= idx[:, None]
    strict = idx[None, :] > idx[:, None]
    dx = torch.empty((bt, nc, hh, CHUNK, p))
    ddt = torch.empty((bt, nc, hh, CHUNK))
    dA_part = torch.empty((bt, nc, hh))
    dB = torch.zeros((bt, nc, g, CHUNK, n))
    dC = torch.zeros((bt, nc, g, CHUNK, n))
    for c in range(nc):
        (hhi, hlo), (ghi, glo) = Hs[c], Gs[c]
        cm = cum[:, c]
        v = cm[..., None, :] - cm[..., :, None]            # cum_i - cum_j
        w = _clip_exp(v)
        dtj = dtc[:, c][..., :, None]
        sT = (Bc[:, c] @ Cc[:, c].transpose(-1, -2))[:, grp]
        qT = xc[:, c] @ dyc[:, c].transpose(-1, -2)
        sw = torch.where(low, sT * w, 0.0)
        qw = torch.where(low, qT * w, 0.0)
        mT, dsT = sw * dtj, qw * dtj
        vT = qT * sw
        rT = torch.where(strict & (v >= -60.0) & (v <= 0.0), vT * dtj, 0.0)
        bg = prod(Bh[:, c], (ghi, glo))
        dk = (xc[:, c] * bg).sum(-1)
        m_hi, m_lo = split(mT, "M")
        dx[:, c] = k[:, c][..., None] * bg + m_hi @ dyc[:, c] + m_lo @ dyc[:, c]
        tB = k[:, c][..., None] * prod(xc[:, c], (ghi.transpose(-1, -2),
                                                  glo.transpose(-1, -2)))
        dyH = prod(dyc[:, c], (hhi.transpose(-1, -2), hlo.transpose(-1, -2)))
        de = (Ch[:, c] * dyH).sum(-1)
        tC = e[:, c][..., None] * dyH
        for gi in range(g):
            for h0 in range(gi * hpg, (gi + 1) * hpg, run):
                heads = range(h0, min(h0 + run, (gi + 1) * hpg))
                acc_b, acc_c = torch.zeros_like(tB[:, 0]), torch.zeros_like(
                    tC[:, 0])
                dsum = torch.zeros_like(dsT[:, 0])
                for hd in heads:
                    acc_b = acc_b + tB[:, hd]
                    acc_c = acc_c + tC[:, hd]
                    dsum = dsum + dsT[:, hd]
                ds_hi, ds_lo = split(dsum, "dS")
                acc_b = acc_b + ds_hi @ Cc[:, c, gi] + ds_lo @ Cc[:, c, gi]
                acc_c = acc_c + ds_hi.transpose(-1, -2) @ Bc[:, c, gi]
                acc_c = acc_c + ds_lo.transpose(-1, -2) @ Bc[:, c, gi]
                dB[:, c, gi] += acc_b
                dC[:, c, gi] += acc_c
        gh = ((ghi + glo) * (hhi + hlo)).sum((-1, -2))
        ok_d = (cm[..., -1:] - cm >= -60.0) & (cm[..., -1:] - cm <= 0.0)
        ok_d[..., -1] = False
        ok_e = (cm >= -60.0) & (cm <= 0.0)
        tt = dtc[:, c] * dk * d[:, c] * ok_d
        dcum = (rT.sum(-2) - rT.sum(-1) + de * e[:, c] * ok_e - tt)
        dcum[..., -1] += tt.sum(-1) + gh * E[:, c] * ok_e[..., -1]
        dda = torch.flip(torch.cumsum(torch.flip(dcum, [-1]), -1), [-1])
        ddt[:, c] = vT.sum(-1) + d[:, c] * dk + A.float()[None, :, None] * dda
        dA_part[:, c] = (dtc[:, c] * dda).sum(-1)

    def unchunk(t):  # (Bt, nc, K, L, W) -> (Bt, S, K, W)
        return t.transpose(2, 3).reshape(bt, nc * CHUNK, t.shape[2],
                                         t.shape[-1])[:, :s]

    return (unchunk(dx).bfloat16(),
            ddt.transpose(2, 3).reshape(bt, nc * CHUNK, hh)[:, :s],
            dA_part.reshape(bt * nc, hh).sum(0), unchunk(dB).bfloat16(),
            unchunk(dC).bfloat16())


def _k4_bwd_inputs(bt, s, hh, p, g, n, seed):
    """As chip_smoke.py's K4 backward cases: x ~ N(0, 1), B, C ~ 0.3 N(0, 1)
    and dy ~ N(0, 1) in bf16 (x, B, C views of one buffer), dt =
    softplus(N(0, 1)) / 2, A = -exp(N(0, 1)) / 2, dh ~ N(0, 1) in f32."""
    rng = np.random.default_rng(seed)
    di = hh * p
    buf = rng.standard_normal((bt, s, di + 2 * g * n)).astype(np.float32)
    buf[..., di:] *= 0.3
    buf = torch.from_numpy(buf).bfloat16()
    dt = torch.from_numpy((np.log1p(np.exp(rng.standard_normal(
        (bt, s, hh)))) * 0.5).astype(np.float32))
    A = torch.from_numpy((-np.exp(rng.standard_normal(hh)) * 0.5).astype(
        np.float32))
    dy = torch.from_numpy(rng.standard_normal((bt, s, hh, p)).astype(
        np.float32)).bfloat16()
    dh = torch.from_numpy(rng.standard_normal((bt, hh, n, p)).astype(
        np.float32))
    return (buf[..., :di].reshape(bt, s, hh, p), dt, A,
            buf[..., di:di + g * n].reshape(bt, s, g, n),
            buf[..., di + g * n:].reshape(bt, s, g, n), dy, dh)


def _k4_bwd_shares(got, want):
    """Each gradient's worst |got - want| over its bf16 GRAD_TOL allowance
    (rtol |want| + atol max|want|)."""
    out = []
    for gr, w in zip(got, want):
        w = w.double()
        allow = GRAD_RTOL * w.abs() + GRAD_ATOL * float(w.abs().max())
        out.append(float(((gr.double() - w).abs() / allow).max()))
    return out


K4_BWD_CASES = [  # (Bt, S, H, P, G, N, run)
    (1, 200, 4, 64, 1, 128, 2),    # ragged S, mamba2's N
    (2, 64, 4, 64, 2, 64, 2),      # one chunk, G < H
    (1, 130, 6, 32, 2, 16, 2),     # a group of 3 heads in runs of 2 and 1
    (1, 256, 8, 64, 1, 64, 3),     # zamba2's N, runs of 3, 3, 2
]


@pytest.mark.parametrize("bt,s,hh,p,g,n,run", K4_BWD_CASES)
def test_k4_backward_split_emulation_matches_plain_and_jax(bt, s, hh, p, g,
                                                           n, run):
    """The bf16 backward's arithmetic (six operands as hi + lo halves, S
    once per group, dB / dC over runs then runs) lands within the bf16
    GRAD_TOL of ``ssd_scan_grouped_bwd_ref`` in f32 on the same values and
    of ``jax.vjp`` of the JAX package's ``ssd_chunked`` at chunk 64."""
    x, dt, A, B, C, dy, dh = _k4_bwd_inputs(bt, s, hh, p, g, n,
                                            s * n + hh + run)
    got = k4_bwd_emulated(x, dt, A, B, C, dy, dh, run=run)
    want = ssd_scan_grouped_bwd_ref(x.float(), dt, A, B.float(), C.float(),
                                    dy.float(), dh)

    def f(x, dt, A, B, C):
        return jssd_chunked(x, dt, A, B, C, CHUNK)

    _, vjp = jax.vjp(f, *(jnp.asarray(t.float().contiguous().numpy())
                          for t in (x, dt, A, B, C)))
    jwant = vjp((jnp.asarray(dy.float().numpy()),
                 jnp.asarray(dh.transpose(-1, -2).contiguous().numpy())))
    jwant = [torch.from_numpy(np.array(w, np.float32)) for w in jwant]
    for ref in (want, jwant):
        shares = _k4_bwd_shares(got, ref)
        assert max(shares) <= 1.0, dict(zip(K4_BWD_OUTPUTS, shares))


def test_k4_backward_single_bf16_operand_is_the_reason_for_the_split():
    """Each of the six f32 operands fed as one bf16 moves its gradients'
    worst error toward the bf16 GRAD_TOL; all six as one bf16 most. The
    printed table (``-s``: the worst share of the allowance a gradient,
    the worse of two draws) is recorded in PERF.md."""
    cases = [(1, 1024, 4, 64, 1, 128, 2, 1), (1, 1024, 8, 64, 1, 64, 3, 2)]
    rows = {}
    for single in ((),) + tuple((op,) for op in K4_BWD_OPERANDS) + (
            K4_BWD_OPERANDS,):
        worst = [0.0] * 5
        for bt, s, hh, p, g, n, run, seed in cases:
            ins = _k4_bwd_inputs(bt, s, hh, p, g, n, seed)
            x, dt, A, B, C, dy, dh = ins
            want = ssd_scan_grouped_bwd_ref(x.float(), dt, A, B.float(),
                                            C.float(), dy.float(), dh)
            got = k4_bwd_emulated(*ins, run=run, single=single)
            worst = [max(u, v) for u, v in zip(
                worst, _k4_bwd_shares(got, want))]
        rows[single] = worst
    names = {(): "none (all split)", K4_BWD_OPERANDS: "all six"}
    print("\nK4 backward emulation, bf16, the worst |err| a gradient as a "
          "share of GRAD_TOL against ssd_scan_grouped_bwd_ref in f32 (worse "
          "of (1, 1024, 4, 64, 1, 128) and (1, 1024, 8, 64, 1, 64)); "
          "operand(s) fed as one bf16:")
    for single, worst in rows.items():
        print(f"  {names.get(single, single[0] if single else ''):>16}: "
              + ", ".join(f"{o} {v:.3f}" for o, v in
                          zip(K4_BWD_OUTPUTS, worst)))
    split = max(rows[()])
    assert split < 0.6
    assert max(rows[K4_BWD_OPERANDS]) > split
    assert all(max(rows[(op,)]) >= split for op in K4_BWD_OPERANDS)
