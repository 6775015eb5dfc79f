"""K3's tensor-core arithmetic, emulated in plain torch on the CPU, against
the JAX package's flash attention (the Pallas kernel in interpret mode, as
tests/test_torch_flash_attention.py runs it).

The bf16 path of ``csrc/flash_attention.cu`` computes q k^T on the unscaled
bf16 q and k (exact products, f32 sums), scales the scores in f32, walks
64-key tiles with the online rescale, and feeds p to the tensor cores as
p_hi + p_lo (p_hi = bf16(p), p_lo = bf16(p - p_hi)). The emulation below
follows those steps (the kernel's sums run in another order, which is f32
reassociation only). A second case measures how far the same emulation
lands with a single bf16 p: the reason for the split, recorded in PERF.md
(run with ``-s`` to print it). Inputs come from numpy seeds."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash

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
