"""Plain PyTorch versions of the port's kernels (the correctness references).

Mirrors the JAX package's ``kernels/ref.py``. The CPU tests run these, and
chip_smoke.py holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

BIG = 1.0e9
MASK_FILL = -2.0e38     # f32-safe masked score, as the reference's kernels
SSD_CHUNK = 64          # K4's chunk along the sequence, forward and backward


def lora_matmul_ref(x, w, a, b, scale: float):
    """x:(M,K) @ w:(K,N) + scale * (x@a):(M,r) @ b:(r,N), f32 accumulation,
    one rounding to x's dtype."""
    xf = x.float()
    base = xf @ w.float()
    delta = (xf @ a.float()) @ b.float()
    return (base + scale * delta).to(x.dtype)


def _attention_scores(q, k, causal, window, q_pos, k_pos):
    """(the scaled f32 scores with masked ones at MASK_FILL (B, H, Sq, Sk),
    the mask (Sq, Sk): True where a key is kept)."""
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    sq, sk = q.shape[2], k.shape[2]
    if q_pos is None:
        q_pos = torch.arange(sq, device=q.device)
    if k_pos is None:
        k_pos = torch.arange(sk, device=q.device)
    qp = q_pos.to(q.device, torch.int64)[:, None]
    kp = k_pos.to(q.device, torch.int64)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    return s.masked_fill(~ok, MASK_FILL), ok


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        q_pos: Optional[torch.Tensor] = None,
                        k_pos: Optional[torch.Tensor] = None):
    """q:(B,H,Sq,D), k,v:(B,H,Sk,D) -> (B,H,Sq,D); f32 softmax, masked
    scores at MASK_FILL (the reference's ``_mask_bias``: causal keeps
    k_pos <= q_pos, a window k_pos > q_pos - window). q_pos (Sq,) and
    k_pos (Sk,) int are the tokens' positions, shared by every (batch,
    head); omitted, they count from 0. A row whose keys are all masked
    averages V over all Sk keys, as the reference's softmax does."""
    s, _ = _attention_scores(q, k, causal, window, q_pos, k_pos)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def flash_attention_fwd_stats_ref(q, k, v, *, causal: bool = True,
                                  window: Optional[int] = None,
                                  q_pos: Optional[torch.Tensor] = None,
                                  k_pos: Optional[torch.Tensor] = None):
    """:func:`flash_attention_ref`'s output (the same ops, the same bits)
    and the row statistics K3's forward keeps for its backward: m (B, H,
    Sq) f32, the largest masked score of each row (MASK_FILL where every
    key is masked), and l (B, H, Sq) f32, the sum of exp(s - m) over the
    row (Sk where every key is masked). Returns (o, m, l)."""
    s, _ = _attention_scores(q, k, causal, window, q_pos, k_pos)
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1),
                       v.float())
    m = s.amax(dim=-1)
    l = torch.exp(s - m[..., None]).sum(dim=-1)
    return out.to(q.dtype), m, l


def flash_attention_bwd_ref(q, k, v, m, l, do, *, causal: bool = True,
                            window: Optional[int] = None,
                            q_pos: Optional[torch.Tensor] = None,
                            k_pos: Optional[torch.Tensor] = None):
    """The gradients (dq, dk, dv) of :func:`flash_attention_ref` at the
    cotangent do (B, H, Sq, D), by FlashAttention-2's backward from the
    forward's row statistics m, l (B, H, Sq) f32, as K3's backward kernel
    (``csrc/flash_attention_bwd.cu``) computes them, in f32 torch ops:
    P = exp(s - m) / max(l, 1e-30) on the masked scores s (m and l kept
    apart: a row whose keys are all masked has P = 1/Sk), dV = P^T dO,
    dP = dO V^T, rowsum(P o dP) (the row's dO . O, from P and dP), dS =
    P o (dP - rowsum(P o dP)) / sqrt(head_dim), 0 wherever the mask drops
    a key (masked_fill cuts the gradient, also on a row whose keys are all
    masked), dQ = dS K and dK = dS^T Q; each rounded once to its input's
    dtype."""
    s, ok = _attention_scores(q, k, causal, window, q_pos, k_pos)
    p = torch.exp(s - m.float()[..., None]) / l.float().clamp_min(
        1e-30)[..., None]
    dof = do.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.float())
    dsum = (p * dp).sum(dim=-1, keepdim=True)
    ds = torch.where(ok, p * (dp - dsum), 0.0) / math.sqrt(q.shape[-1])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def window_dp_ref(slot_cost: torch.Tensor, gain: torch.Tensor):
    """B independent CHC window min-plus DPs (Eq. 10) in torch ops.

    slot_cost: (B, w1, tn+1) f32 — cheapest cost of buying k units in slot
    tau (infeasible k priced at BIG); gain: (B, U+1) f32, U = w1*tn.
    Returns (n_tot (B, w1) i32, obj (B,) f32).

    A line-for-line port of the reference's lane-batched shifted-slice DP
    (``window_opt._solve_xla_batch`` / ``_dp_step_shifted_batch``): slots
    are a loop, each step takes tn+1 statically shifted slices of the
    BIG-padded state, a running strict ``<`` keeps the smallest k on ties,
    ``torch.argmax`` takes the first max u*, and the backtrack gathers
    ``choices[tau, u]``. Choices are stored as int8 (tn <= 127): at the
    main path's 105,000 rows an int64 buffer would take ~0.5 GB a slot."""
    b, w1, kw = slot_cost.shape
    tn = kw - 1
    u1 = gain.shape[1]
    if u1 != w1 * tn + 1:
        raise ValueError(f"gain {tuple(gain.shape)} does not match "
                         f"slot_cost {tuple(slot_cost.shape)}")
    if not 1 <= tn <= 127:
        raise ValueError(f"table width tn={tn} outside [1, 127]")
    dev = slot_cost.device
    C = torch.full((b, u1), BIG, dtype=torch.float32, device=dev)
    C[:, 0] = 0.0
    padded = torch.full((b, tn + u1), BIG, dtype=torch.float32, device=dev)
    choices = torch.empty((w1, b, u1), dtype=torch.int8, device=dev)
    for tau in range(w1):
        row = slot_cost[:, tau]
        padded[:, tn:] = C
        best = C + row[:, 0:1]
        bestk = torch.zeros((b, u1), dtype=torch.int8, device=dev)
        for k in range(1, tn + 1):
            # C[u-k] is the padded state shifted k to the right
            cand = padded[:, tn - k: tn - k + u1] + row[:, k: k + 1]
            take = cand < best
            best = torch.where(take, cand, best)
            bestk.masked_fill_(take, k)
        choices[tau] = bestk
        C = best

    obj = torch.where(C < BIG / 2, gain - C, -torch.inf)
    u_star = torch.argmax(obj, dim=1)          # first max on ties
    n_tot = torch.empty((b, w1), dtype=torch.int32, device=dev)
    u = u_star
    for tau in range(w1 - 1, -1, -1):
        k = choices[tau].gather(1, u[:, None])[:, 0].to(torch.int64)
        n_tot[:, tau] = k.to(torch.int32)
        u = u - k
    return n_tot, obj.gather(1, u_star[:, None])[:, 0]


def ssd_scan_ref(x, dt, A, B, C):
    """Step-by-step SSD recurrence (the reference's ``ssd_scan_ref``, from a
    zero state).

    x:(BH, S, P), dt:(BH, S), A:(BH,), B,C:(BH, S, N).
    h_t = exp(dt_t A) h_{t-1} + dt_t * outer(B_t, x_t);  y_t = C_t @ h_t,
    in f32 with an (BH, N, P) f32 state, one step a loop iteration, batched
    over BH. Returns (y:(BH,S,P) in x's dtype, h_final:(BH,N,P) f32)."""
    bh, s, p = x.shape
    n = B.shape[-1]
    xf, dtf, Af, Bf, Cf = (t.float() for t in (x, dt, A, B, C))
    h = torch.zeros((bh, n, p), dtype=torch.float32, device=x.device)
    ys = torch.empty((bh, s, p), dtype=torch.float32, device=x.device)
    for t in range(s):
        decay = torch.exp(dtf[:, t] * Af)[:, None, None]
        outer = Bf[:, t, :, None] * xf[:, t, None, :]
        h = decay * h + dtf[:, t, None, None] * outer
        ys[:, t] = torch.bmm(Cf[:, t, None, :], h)[:, 0]
    return ys.to(x.dtype), h


def ssd_scan_grouped_ref(x, dt, A, B, C):
    """:func:`ssd_scan_ref` on the model's layout: x (Bt, S, H, P), dt
    (Bt, S, H), A (H,), B and C (Bt, S, G, N), head h reading group
    h // (H / G). B and C are repeated from groups to heads and every
    operand is flattened to (Bt*H, ...) copies. Returns (y (Bt, S, H, P)
    contiguous in x's dtype, h_final (Bt, H, N, P) f32)."""
    bt, s, hh, p = x.shape
    n = B.shape[3]
    rep = hh // B.shape[2]
    if rep > 1:
        B = B.repeat_interleave(rep, dim=2)
        C = C.repeat_interleave(rep, dim=2)
    y, h = ssd_scan_ref(
        x.transpose(1, 2).reshape(bt * hh, s, p),
        dt.transpose(1, 2).reshape(bt * hh, s), A.repeat(bt),
        B.transpose(1, 2).reshape(bt * hh, s, n),
        C.transpose(1, 2).reshape(bt * hh, s, n))
    return (y.reshape(bt, hh, s, p).transpose(1, 2).contiguous(),
            h.reshape(bt, hh, n, p))


def _clip_exp(v):
    """exp of v clipped to [-60, 0], and where the clip passes a gradient
    (inside or on its edges, as ``torch.clamp``'s backward: an exponent
    that rounds to 0 off the diagonal, after a tiny dt, still carries
    one)."""
    return torch.exp(v.clamp(-60.0, 0.0)), (v >= -60.0) & (v <= 0.0)


def ssd_scan_grouped_bwd_ref(x, dt, A, B, C, dy, dh=None):
    """The gradients of the SSD scan on the model's layout by the chunked
    reverse scan that K4's backward kernel runs, in torch ops: the plain
    version beside ``csrc/ssd_scan_bwd.cu`` at full size.

    x (Bt, S, H, P), dt (Bt, S, H) f32, A (H,) f32, B and C (Bt, S, G, N),
    the cotangents dy (Bt, S, H, P) of y and dh (Bt, H, N, P) f32 of the
    final state (None: zero). It differentiates the function the forward
    kernel computes: chunks of SSD_CHUNK steps, cum the inclusive in-chunk
    sum of dt A, every exponent clipped to [-60, 0] (no gradient past the
    clip's edges); a ragged S is padded with dt = 0 steps. Per chunk, with H
    the state entering it (a first forward pass) and G the gradient of the
    state leaving it (the reverse scan G <- exp(cum_last) G + sum_i
    exp(cum_i) C_i dy_i^T), every gradient is chunk-local. f32 throughout;
    dB and dC are summed over the heads of their group, and each gradient
    is rounded once to its input's dtype. Returns (dx, ddt, dA, dB, dC)."""
    bt, s, hh, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = hh // g
    chunk = SSD_CHUNK
    nc = -(-s // chunk)
    pad = nc * chunk - s

    def chunks(t):  # (Bt, S, K, W) -> (Bt, K, nc, chunk, W) f32
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad))
        return t.reshape(bt, nc, chunk, *t.shape[2:]).permute(0, 3, 1, 2, 4)

    xf, dyf = chunks(x), chunks(dy)
    Bf = chunks(B).repeat_interleave(rep, 1)
    Cf = chunks(C).repeat_interleave(rep, 1)
    dtf = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad)).reshape(
        bt, nc, chunk, hh).permute(0, 3, 1, 2)             # (Bt, H, nc, L)
    a = A.float()[None, :, None, None]
    cum = torch.cumsum(dtf * a, dim=-1)
    e, ok_e = _clip_exp(cum)                               # decay in
    d, ok_d = _clip_exp(cum[..., -1:] - cum)               # decay to end
    ok_d[..., -1] = False   # cum_last - cum_last: its two sides cancel
    E, ok_E = e[..., -1], ok_e[..., -1]                    # chunk decay
    k = d * dtf
    # states entering each chunk, and the state gradients leaving each
    ins = torch.einsum("bhcln,bhclp->bhcnp", Bf * k[..., None], xf)
    outs = torch.einsum("bhcln,bhclp->bhcnp", Cf * e[..., None], dyf)
    h = torch.zeros((bt, hh, n, p), dtype=torch.float32, device=x.device)
    G = h.clone() if dh is None else dh.float()
    Hs, Gs = [], [None] * nc
    for c in range(nc):
        Hs.append(h)
        h = h * E[:, :, c, None, None] + ins[:, :, c]
    for c in reversed(range(nc)):
        Gs[c] = G
        G = G * E[:, :, c, None, None] + outs[:, :, c]
    Hs, Gs = torch.stack(Hs, 2), torch.stack(Gs, 2)
    # the intra-chunk terms: M_ij = (C_i . B_j) w_ij dt_j for i >= j
    w, ok_w = _clip_exp(cum[..., :, None] - cum[..., None, :])
    lower = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device)
    w = w * lower.tril()
    ok_w = ok_w & lower.tril(-1)   # the diagonal's two sides cancel
    S = torch.einsum("bhcin,bhcjn->bhcij", Cf, Bf)
    Q = torch.einsum("bhcip,bhcjp->bhcij", dyf, xf)
    M, dS = S * w * dtf[..., None, :], Q * w * dtf[..., None, :]
    V = Q * S * w
    R = V * dtf[..., None, :] * ok_w
    D1 = torch.einsum("bhcip,bhcnp->bhcin", dyf, Hs)
    D2 = torch.einsum("bhcjp,bhcnp->bhcjn", xf, Gs)
    D3 = torch.einsum("bhcjn,bhcnp->bhcjp", Bf, Gs)
    dx = torch.einsum("bhcij,bhcip->bhcjp", M, dyf) + k[..., None] * D3
    dBh = torch.einsum("bhcij,bhcin->bhcjn", dS, Cf) + k[..., None] * D2
    dCh = torch.einsum("bhcij,bhcjn->bhcin", dS, Bf) + e[..., None] * D1
    dk = (Bf * D2).sum(-1)
    T = dtf * dk * d * ok_d
    dcum = (R.sum(-1) - R.sum(-2) + (Cf * D1).sum(-1) * e * ok_e - T)
    dcum[..., -1] += T.sum(-1) + (Gs * Hs).sum((-1, -2)) * E * ok_E
    dda = torch.flip(torch.cumsum(torch.flip(dcum, [-1]), -1), [-1])
    ddt = V.sum(-2) + d * dk + a * dda

    def unchunk(t):  # (Bt, K, nc, L, W) -> (Bt, S, K, W)
        return t.permute(0, 2, 3, 1, 4).reshape(bt, nc * chunk, -1,
                                                 t.shape[-1])[:, :s]

    def grouped(t):  # summed over the heads of each group, in order
        return unchunk(t.reshape(bt, g, rep, nc, chunk, n).sum(2))

    return (unchunk(dx).to(x.dtype),
            ddt.permute(0, 2, 3, 1).reshape(bt, nc * chunk, hh)[:, :s],
            (dtf * dda).sum((0, 2, 3)), grouped(dBh).to(B.dtype),
            grouped(dCh).to(C.dtype))
