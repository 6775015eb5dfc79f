"""Mamba2 block: SSD (state-space duality), chunked [arXiv:2405.21060]
(the reference's ``models/ssm.py``).

Recurrence per head h (A scalar-per-head, state (P, N)):
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t  (outer) x_t
    y_t = C_t . h_t + D * x_t

Prefill's causal conv goes through ``ops.causal_conv`` (one kernel each
way on the card) and its SSD through ``ops.ssd`` (K4 on the card) when
``kcfg.use_cuda``; otherwise they run :func:`_causal_conv` and
:func:`ssd_chunked`, the reference model's own computations. The ``wx``
and ``out_proj`` projections carry LoRA adapters and go through
``lora.proj`` (K2); ``wz``, ``wB``, ``wC`` and ``wdt`` are plain products,
as XLA computes them in the reference. Decode keeps O(1) state: the
depthwise-conv tail (width-1 raw frames) and the (H, P, N) f32 SSD state.
``A_log``, ``D`` and ``dt_bias`` stay f32 whatever the model dtype.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import lora as lora_lib
from repro_torch.models.common import (const_param, normal_param, ones_param,
                                      zeros_param)
from repro_torch.obs import ranges
from repro_torch.sharding import shard


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_mamba(generator: torch.Generator, cfg, dtype) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    H = s.heads(d)
    G, N, wc = s.n_groups, s.state_size, s.conv_width
    dev = generator.device
    f32 = dict(dtype=torch.float32, device=dev)
    p = {
        "wz": normal_param(generator, (d, di), ("fsdp", "tensor"), dtype),
        "wx": normal_param(generator, (d, di), ("fsdp", "tensor"), dtype),
        "wB": normal_param(generator, (d, G, N), ("fsdp", None, None), dtype),
        "wC": normal_param(generator, (d, G, N), ("fsdp", None, None), dtype),
        "wdt": normal_param(generator, (d, H), ("fsdp", "ssm_heads"), dtype),
        "conv_w": normal_param(generator, (di + 2 * G * N, wc),
                               ("tensor", None), dtype, stddev=0.3),
        "conv_b": zeros_param((di + 2 * G * N,), ("tensor",), dtype, dev),
        # A in (-inf, 0): A = -exp(A_log); init A in [-1, -e]
        "A_log": const_param(torch.log(torch.linspace(1.0, math.e, H, **f32)),
                             ("ssm_heads",)),
        "D": ones_param((H,), ("ssm_heads",), torch.float32, dev),
        "dt_bias": const_param(
            torch.log(torch.expm1(torch.full((H,), 0.01, **f32))),
            ("ssm_heads",)),
        "norm_scale": ones_param((di,), ("tensor",), dtype, dev),
        "out_proj": normal_param(generator, (di, d), ("tensor", "fsdp"),
                                 dtype),
    }
    r = cfg.lora.rank
    p["lora"] = {
        "in": lora_lib.lora_pair_params(generator, d, (di,), r),
        "out": lora_lib.lora_pair_params(generator, di, (d,), r),
    }
    return p


# ---------------------------------------------------------------------------
# Depthwise causal conv
# ---------------------------------------------------------------------------

def _causal_conv(xbc, w, b):
    """xbc:(B,S,C), w:(C,wc) depthwise causal conv + silu.

    The reference's sum over the wc shifted views, as an f32 multiply-add
    rounded once to xbc's dtype (no cuDNN convolution, so no TF32)."""
    wc = w.shape[1]
    s = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, wc - 1, 0))
    wf = w.float()
    y = pad[:, 0:s].float() * wf[:, 0]
    for i in range(1, wc):
        y = y + pad[:, i:i + s].float() * wf[:, i]
    return F.silu(y.to(xbc.dtype) + b)


def _conv_step(state, xbc_t, w, b):
    """state:(B,wc-1,C), xbc_t:(B,1,C) -> (new_state, y:(B,1,C))."""
    window = torch.cat([state, xbc_t], dim=1)  # (B, wc, C)
    wf = w.float()
    y = window[:, 0].float() * wf[:, 0]
    for i in range(1, w.shape[1]):
        y = y + window[:, i].float() * wf[:, i]
    return window[:, 1:], F.silu(y.to(window.dtype) + b)[:, None]


# ---------------------------------------------------------------------------
# SSD core (chunked)
# ---------------------------------------------------------------------------

def _clip_exp(v):
    return torch.exp(v.clamp(-60.0, 0.0))


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """SSD scan, the reference model's chunked computation.

    x: (B,S,H,P) inputs, dt: (B,S,H) positive step sizes, A: (H,) negative,
    B, C: (B,S,G,N); returns y:(B,S,H,P) in x's dtype and the final state
    (B,H,P,N) f32, from a zero state. A ragged S is zero-padded with dt = 0
    (identity steps).
    """
    b, s, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    cs = min(chunk, s)
    orig_s = s
    if s % cs:
        pad = cs - s % cs
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        s = s + pad
    nc = s // cs

    xf = x.float().reshape(b, nc, cs, H, P)
    dtf = dt.float().reshape(b, nc, cs, H)
    Bf = B.float().reshape(b, nc, cs, G, N)
    Cf = C.float().reshape(b, nc, cs, G, N)

    da = dtf * A  # (b, nc, cs, H), negative
    cum = torch.cumsum(da, dim=2)  # inclusive

    # ---- intra-chunk (quadratic in cs) ----
    gb = torch.einsum("bcign,bcjgn->bcijg", Cf, Bf)
    gb = gb.repeat_interleave(rep, dim=-1)  # (b,nc,i,j,H)
    L = _clip_exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])
    causal = torch.tril(torch.ones((cs, cs), dtype=torch.bool,
                                   device=x.device))
    m = gb * L * causal[None, None, :, :, None].float()
    m = m * dtf[:, :, None, :, :]  # dt_j
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", m, xf)

    # ---- chunk-end states ----
    decay_to_end = _clip_exp(cum[:, :, -1:, :] - cum)  # (b,nc,cs,H)
    Bh = Bf.repeat_interleave(rep, dim=3) if G != H else Bf  # (b,nc,cs,H,N)
    states = torch.einsum("bcjhn,bcjhp->bchpn",
                          (decay_to_end * dtf)[..., None] * Bh, xf)

    # ---- inter-chunk recurrence ----
    chunk_decay = _clip_exp(cum[:, :, -1, :])  # (b,nc,H)
    h = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)  # the state entering chunk c
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)  # (b,nc,H,P,N)

    # ---- inter-chunk contribution ----
    Ch = Cf.repeat_interleave(rep, dim=3) if G != H else Cf
    decay_in = _clip_exp(cum)  # (b,nc,cs,H)
    y_inter = torch.einsum("bcihn,bchpn->bcihp", Ch, h_prev) * \
        decay_in[..., None]

    y = (y_intra + y_inter).reshape(b, s, H, P)[:, :orig_s]
    return y.to(x.dtype), h


def ssd_step(state, x_t, dt_t, A, B_t, C_t):
    """One decode step. state:(B,H,P,N); x_t:(B,H,P); dt_t:(B,H);
    B_t,C_t:(B,G,N). In f32, the decay clipped to [-60, 0]."""
    H = x_t.shape[1]
    rep = H // B_t.shape[1]
    Bh = B_t.repeat_interleave(rep, dim=1).float()  # (B,H,N)
    Ch = C_t.repeat_interleave(rep, dim=1).float()
    dtf = dt_t.float()
    da = _clip_exp(dtf * A)  # (B,H)
    new = state * da[:, :, None, None] + (
        dtf[:, :, None, None] * x_t.float()[..., None] * Bh[:, :, None, :])
    y = torch.einsum("bhn,bhpn->bhp", Ch, new)
    return new, y


# ---------------------------------------------------------------------------
# Full block
# ---------------------------------------------------------------------------

@ranges.stage(ranges.SSM_GATED_NORM)
def _gated_norm(y, z, scale, eps):
    g = y.float() * F.silu(z.float())
    var = g.square().mean(dim=-1, keepdim=True)
    return (g * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def _project_inputs(cfg, p, x, kcfg: ops.KernelConfig = ops.DEFAULT):
    s = cfg.ssm
    G, N = s.n_groups, s.state_size
    d = cfg.d_model
    scale = cfg.lora.alpha / cfg.lora.rank
    z = x @ p["wz"]
    xin = lora_lib.proj(x, p["wx"], None, p["lora"]["in"], scale, kcfg)
    Braw = (x @ p["wB"].reshape(d, G * N)).reshape(*x.shape[:-1], G, N)
    Craw = (x @ p["wC"].reshape(d, G * N)).reshape(*x.shape[:-1], G, N)
    dt_raw = x @ p["wdt"]
    return z, xin, Braw, Craw, dt_raw


@ranges.stage(ranges.SSM_CONV)
def _conv(xin, Braw, Craw, w, b, kcfg: ops.KernelConfig = ops.DEFAULT):
    """The causal conv over x, B and C side by side (``ops.causal_conv``),
    split again: x (B,S,di), B, C (B,S,G,N), views of one buffer."""
    bsz, S, G, N = Braw.shape
    xs, B, C = ops.causal_conv(xin, Braw.reshape(bsz, S, G * N),
                               Craw.reshape(bsz, S, G * N), w, b, kcfg=kcfg)
    return xs, B.reshape(bsz, S, G, N), C.reshape(bsz, S, G, N)


def _conv_tail(xin, Braw, Craw, wc: int):
    """The decode step's conv state: the last wc-1 raw (pre-conv) frames of
    x, B and C side by side (B, wc-1, C), zero in front when S < wc-1."""
    bsz, S, G, N = Braw.shape
    k = min(S, wc - 1)
    tail = torch.cat([xin[:, S - k:], Braw[:, S - k:].reshape(bsz, k, G * N),
                      Craw[:, S - k:].reshape(bsz, k, G * N)], dim=-1)
    # no pad of a full tail: PyTorch 2.11's DTensor cannot pad a tensor
    # split on a mesh of more than one dimension (the sharded dry run)
    return tail if k == wc - 1 else F.pad(tail, (0, 0, wc - 1 - k, 0))


@ranges.stage(ranges.SSM_MIXER)
def apply_mamba(cfg, p, x, return_cache: bool = False,
                kcfg: ops.KernelConfig = ops.DEFAULT):
    """x:(B,S,d) -> (B,S,d). Forward / prefill path. With ``return_cache``
    also returns {conv: the last wc-1 raw (pre-conv) frames, ssd: the final
    state (B,H,P,N) f32}."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    H, P = s.heads(d), s.head_dim
    bsz, S, _ = x.shape

    z, xin, Braw, Craw, dt_raw = _project_inputs(cfg, p, x, kcfg)
    xs, B, C = _conv(xin, Braw, Craw, p["conv_w"], p["conv_b"], kcfg)
    xs = xs.reshape(bsz, S, H, P)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    xs = shard(xs, "batch", "seq", "ssm_heads", None)
    if kcfg.use_cuda:
        y, h_final = ops.ssd(xs, dt, A, B, C, kcfg=kcfg)
        h_final = h_final.transpose(2, 3)  # the kernel's (N, P) -> (P, N)
    else:
        y, h_final = ssd_chunked(xs, dt, A, B, C, s.chunk_size)
    # the reference's casts: xs (model dtype) times D cast to y's dtype
    y = y + xs.float().to(y.dtype) * p["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(bsz, S, di)

    out = _gated_norm(y, z, p["norm_scale"], cfg.norm_eps)
    scale = cfg.lora.alpha / cfg.lora.rank
    res = lora_lib.proj(out, p["out_proj"], None, p["lora"]["out"], scale,
                        kcfg)
    if return_cache:
        conv_tail = _conv_tail(xin, Braw, Craw, s.conv_width)
        return res, {"conv": conv_tail, "ssd": h_final}
    return res


def init_mamba_cache(cfg, batch: int, dtype, device) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    H, G, N, P = s.heads(d), s.n_groups, s.state_size, s.head_dim
    conv_dim = di + 2 * G * N
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssd": torch.zeros((batch, H, P, N), dtype=torch.float32,
                           device=device),
    }


def mamba_cache_specs() -> dict:
    """Logical axes of one layer's cache (:func:`init_mamba_cache`)."""
    return {"conv": ("batch", None, "tensor"),
            "ssd": ("batch", "ssm_heads", None, None)}


def apply_mamba_decode(cfg, p, x_t, cache, kcfg: ops.KernelConfig = ops.DEFAULT):
    """x_t:(B,1,d), cache {conv, ssd} -> (y:(B,1,d), new cache)."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    H, G, N, P = s.heads(d), s.n_groups, s.state_size, s.head_dim
    bsz = x_t.shape[0]

    z, xin, Braw, Craw, dt_raw = _project_inputs(cfg, p, x_t, kcfg)
    xbc = torch.cat([xin, Braw.reshape(bsz, 1, G * N),
                     Craw.reshape(bsz, 1, G * N)], dim=-1)
    conv_state, xbc = _conv_step(cache["conv"], xbc, p["conv_w"],
                                 p["conv_b"])
    xs = xbc[..., :di].reshape(bsz, H, P)
    B = xbc[..., di:di + G * N].reshape(bsz, G, N)
    C = xbc[..., di + G * N:].reshape(bsz, G, N)
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])  # (B,H)
    A = -torch.exp(p["A_log"])

    new_ssd, y = ssd_step(cache["ssd"], xs.float(), dt, A, B, C)
    y = y + xs.float() * p["D"][None, :, None]
    y = y.reshape(bsz, 1, di).to(x_t.dtype)

    out = _gated_norm(y, z, p["norm_scale"], cfg.norm_eps)
    scale = cfg.lora.alpha / cfg.lora.rank
    res = lora_lib.proj(out, p["out_proj"], None, p["lora"]["out"], scale,
                        kcfg)
    return res, {"conv": conv_state, "ssd": new_ssd}
