"""Plain f32 reference of a Mamba-2 layer [arXiv:2405.21060]: pre-norm,
input projections (LoRA on the x projection), a depthwise causal conv and
SiLU over (x, B, C), the SSD scan, the D skip, the gated RMSNorm and the
output projection (LoRA on it).

The scan, per head h with A_h < 0 and state (N, P):
    state_t = exp(dt_t A_h) state_{t-1} + dt_t B_t x_t^T
    y_t     = C_t^T state_t
computed in chunks of CHUNK steps: within a chunk as the masked product
(C B^T o L) (dt x) with L_ij = exp(cum_i - cum_j), i >= j; across chunks
through the state each chunk leaves, carried in a loop.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from port_bench.reference.common import lora_proj, rmsnorm
from port_bench.weights import ssm_sizes

CHUNK = 64


def ssd(x, dt, a, bm, cm, prec):
    """x (b, S, H, P), dt (b, S, H) > 0, a (H,) < 0, bm / cm (b, S, G, N)
    -> y (b, S, H, P), from a zero state."""
    b, s, nh, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    rep = nh // g
    c = min(CHUNK, s)
    if s % c:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {c}")
    nc = s // c
    xs = x.reshape(b, nc, c, nh, p)
    dts = dt.reshape(b, nc, c, nh)
    bs = bm.reshape(b, nc, c, g, n).repeat_interleave(rep, dim=3)
    cs = cm.reshape(b, nc, c, g, n).repeat_interleave(rep, dim=3)
    cum = torch.cumsum(dts * a, dim=2)                     # (b, nc, c, H)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (.., i, j, H)
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                   device=x.device))[None, None, :, :, None]
    decay = torch.exp(torch.where(causal, diff, float("-inf")))
    scores = prec.einsum("bcihn,bcjhn->bcijh", cs, bs) * decay
    dx = dts[..., None] * xs
    y = prec.einsum("bcijh,bcjhp->bcihp", scores, dx)
    # the state each chunk leaves, and the one entering each chunk
    to_end = torch.exp(cum[:, :, -1:, :] - cum)            # (b, nc, c, H)
    left = prec.einsum("bcjhn,bcjhp->bchnp", bs * to_end[..., None], dx)
    whole = torch.exp(cum[:, :, -1, :])                    # (b, nc, H)
    state = torch.zeros((b, nh, n, p), dtype=x.dtype, device=x.device)
    entering = []
    for i in range(nc):
        entering.append(state)
        state = state * whole[:, i, :, None, None] + left[:, i]
    entering = torch.stack(entering, dim=1)               # (b, nc, H, N, P)
    y = y + prec.einsum("bcihn,bchnp->bcihp",
                        cs * torch.exp(cum)[..., None], entering)
    return y.reshape(b, s, nh, p)


def _pair(lora: dict, name: str) -> dict:
    return {"a": lora[f"mamba/lora/{name}/a"],
            "b": lora[f"mamba/lora/{name}/b"]}


def layer(model, w, lora, h, prec):
    """One Mamba-2 layer: h (B, S, d) f32 -> (h, 0)."""
    z_ = ssm_sizes(model)
    di, nh, p, g, n, wc = (z_["di"], z_["H"], z_["P"], z_["G"], z_["N"],
                           z_["wc"])
    eps = model["norm_eps"]
    scale = model["lora"]["alpha"] / model["lora"]["rank"]
    b, s, d = h.shape
    x = rmsnorm(h, w["norm/scale"], eps)
    z = prec.mm(x, w["mamba/wz"])
    xin = lora_proj(prec, x, w["mamba/wx"], _pair(lora, "in"), scale)
    braw = prec.mm(x, w["mamba/wB"].reshape(d, g * n))
    craw = prec.mm(x, w["mamba/wC"].reshape(d, g * n))
    dt_raw = prec.mm(x, w["mamba/wdt"])
    xbc = torch.cat([xin, braw, craw], dim=-1)
    pad = F.pad(xbc, (0, 0, wc - 1, 0))
    conv = sum(pad[:, i:i + s] * w["mamba/conv_w"][:, i] for i in range(wc))
    xbc = F.silu(conv + w["mamba/conv_b"])
    xs = xbc[..., :di].reshape(b, s, nh, p)
    bm = xbc[..., di:di + g * n].reshape(b, s, g, n)
    cm = xbc[..., di + g * n:].reshape(b, s, g, n)
    dt = F.softplus(dt_raw + w["mamba/dt_bias"])
    a = -torch.exp(w["mamba/A_log"])
    y = ssd(xs, dt, a, bm, cm, prec) + xs * w["mamba/D"][:, None]
    gated = y.reshape(b, s, di) * F.silu(z)
    out = rmsnorm(gated, w["mamba/norm_scale"], eps)
    res = lora_proj(prec, out, w["mamba/out_proj"], _pair(lora, "out"),
                    scale)
    return prec(h + res), torch.zeros((), device=h.device)
