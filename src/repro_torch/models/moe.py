"""Mixture-of-Experts layer (Mixtral-style: top-k softmax router, SwiGLU
experts); the reference's ``models/moe.py``.

Dispatch is sort-based with capacity buckets: the tokens of a group are
stably argsorted by expert id and scattered into an (E * C + 1, d) buffer
whose last row takes the tokens dropped past an expert's capacity C; each
expert runs one dense product, and the outputs are combined back with the
router weights. Routing is grouped per batch row, as in the reference, and
all rows are routed at once here (the reference vmaps one group). The
expert products are ``torch.bmm`` (the reference leaves them to XLA
einsums, outside any Pallas kernel). The reference's four sharding hints
stand at the same points, in the port's (E, B * C, d) layout of the
expert products.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import act_fn, normal_param
from repro_torch.sharding import shard

# named ranges around the layer's four stages, so that a profiler trace
# shows the device time of each (a few us of host time a layer otherwise)
ROUTE, DISPATCH, EXPERTS, COMBINE = ("moe route", "moe dispatch",
                                     "moe experts", "moe combine")


def init_moe(generator: torch.Generator, cfg, dtype) -> dict:
    """Router (d, E) in f32 whatever the model dtype (std 0.02); experts
    w1 / w3 (E, d, f) and w2 (E, f, d) in ``dtype`` with the reference's
    default fan-in scaling (1/sqrt of the leading axis, E)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    return {
        "router": normal_param(generator, (d, e), ("fsdp", None),
                               torch.float32, stddev=0.02),
        "w1": normal_param(generator, (e, d, f), ("experts", "fsdp", "tensor"),
                           dtype),
        "w3": normal_param(generator, (e, d, f), ("experts", "fsdp", "tensor"),
                           dtype),
        "w2": normal_param(generator, (e, f, d), ("experts", "tensor", "fsdp"),
                           dtype),
    }


def expert_capacity(cfg, group_tokens: int) -> int:
    """Slots per expert for a group of ``group_tokens`` tokens: at least
    top_k, and rounded up to a multiple of 128 from 128 on (the
    reference's MXU alignment, kept so both drop the same tokens)."""
    m = cfg.moe
    cap = int(group_tokens * m.top_k * m.capacity_factor / m.num_experts)
    cap = max(m.top_k, cap)
    if cap >= 128:
        cap = (cap + 127) // 128 * 128
    return cap


def route(cfg, router_w, x):
    """x (..., T, d) -> (idx (..., T, k) i64, weights (..., T, k) in x's
    dtype, aux (...) f32), one group per leading index.

    The logits and the softmax are f32. The top k take the largest gates
    with the lower expert index first among equal gates, as
    ``lax.top_k`` does (``torch.topk`` does not promise it): a stable sort
    in descending order. The Switch-style load-balance loss is per group."""
    m = cfg.moe
    logits = x.float() @ router_w.float()                     # (..., T, E)
    gates = torch.softmax(logits, dim=-1)
    weights, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    weights, idx = weights[..., :m.top_k], idx[..., :m.top_k]
    weights = weights / torch.clamp_min(weights.sum(-1, keepdim=True), 1e-9)
    me = gates.mean(dim=-2)
    ce = F.one_hot(idx[..., 0], m.num_experts).float().mean(dim=-2)
    aux = m.num_experts * torch.sum(me * ce, dim=-1) * m.aux_loss_coef
    return idx, weights.to(x.dtype), aux


def _dispatch(cfg, x, idx, cap: int):
    """Every group at once. x (G, T, d), idx (G, T, k) -> (buf (G, E, C, d),
    (order, src_tok, dest, keep), each (G, T * k)). A stable argsort by
    expert, the per-expert counts, each routed token's slot in its
    expert's bucket; past the capacity it goes to row E * C, dropped."""
    g, t, d = x.shape
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    dev = x.device
    flat_expert = idx.reshape(g, t * k)
    flat_token = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_expert, dim=-1, stable=True)
    sorted_expert = torch.gather(flat_expert, 1, order)
    counts = torch.zeros((g, e), dtype=torch.int64, device=dev).scatter_add_(
        1, flat_expert, torch.ones_like(flat_expert))
    starts = torch.cumsum(counts, dim=-1) - counts
    pos = (torch.arange(t * k, device=dev)[None]
           - torch.gather(starts, 1, sorted_expert))
    keep = pos < cap
    dest = torch.where(keep, sorted_expert * cap + pos, e * cap)
    src_tok = flat_token[order]
    rows = torch.gather(x, 1, src_tok[..., None].expand(g, t * k, d))
    buf = torch.zeros((g, e * cap + 1, d), dtype=x.dtype, device=dev)
    # kept tokens own distinct slots; the dropped ones all land in the
    # last row, which is cut off
    buf.scatter_(1, dest[..., None].expand(g, t * k, d), rows)
    return buf[:, :e * cap].reshape(g, e, cap, d), (order, src_tok, dest,
                                                    keep)


def _combine(cfg, out, info, wts, t: int):
    """out (G, E, C, d) -> y (G, T, d) f32: each kept (token, expert) pair's
    output times its router weight, added onto zeros at its token.

    With top_k = 2 each token receives at most two adds onto 0: 0 + a is
    a, and a + b is b + a in f32, so ``index_add_`` gives the same bits in
    whatever order its atomics run on the card. That does not hold for
    top_k > 2."""
    g, e, cap, d = out.shape
    order, src_tok, dest, keep = info
    flat = out.reshape(g, e * cap, d)
    picked = torch.gather(
        flat, 1, torch.clamp_max(dest, e * cap - 1)[..., None].expand(
            -1, -1, d))
    picked = torch.where(keep[..., None], picked, 0.0)
    w_sorted = torch.gather(wts.reshape(g, -1), 1, order)
    add = picked.float() * w_sorted[..., None].float()
    y = torch.zeros((g * t, d), dtype=torch.float32, device=out.device)
    base = (torch.arange(g, device=out.device) * t)[:, None]
    y.index_add_(0, (src_tok + base).reshape(-1), add.reshape(-1, d))
    return y.reshape(g, t, d)


def apply_moe(cfg, p, x):
    """x (B, S, d) -> (y (B, S, d) in x's dtype, aux loss: the mean of the
    per-row losses). Routing grouped per batch row."""
    b, s, d = x.shape
    e = cfg.moe.num_experts
    cap = expert_capacity(cfg, s)
    act = act_fn(cfg.mlp_act)
    rf = torch.profiler.record_function
    with rf(ROUTE):
        idx, wts, aux = route(cfg, p["router"], x)
    with rf(DISPATCH):
        buf, info = _dispatch(cfg, x, idx, cap)               # (B, E, C, d)
        buf = shard(buf, "batch", "experts", None, "embed")
        xe = buf.transpose(0, 1).reshape(e, b * cap, d)
    with rf(EXPERTS):
        h = act(torch.bmm(xe, p["w1"]))
        if cfg.mlp_act == "silu":
            h = h * torch.bmm(xe, p["w3"])
        h = shard(h, "experts", "batch", "tensor")
        out = torch.bmm(h, p["w2"]).reshape(e, b, cap, d).transpose(0, 1)
        out = shard(out, "batch", "experts", None, "embed")
    with rf(COMBINE):
        y = _combine(cfg, out, info, wts, s).to(x.dtype)
        y = shard(y, "batch", "seq", "embed")
    return y, aux.mean()
