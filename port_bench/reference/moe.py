"""Plain f32 reference of a Mixtral-style decoder layer: pre-norm GQA
attention with rotary positions and LoRA on its projections, then a
sparse MoE feed-forward (softmax router, top-k experts, SwiGLU experts).

The MoE semantics are the configuration's: routing grouped per batch row,
the top k gates renormalised to sum to one, a Switch-style load-balance
loss per row (the experts' mean gate times the share of tokens whose first
choice they are, times E and the loss coefficient), averaged over rows and
added to the training loss; each expert takes at most ``capacity`` of a
row's (token, choice) pairs, the first in token order, and drops the rest.

Which experts a token takes is a choice between near ties, which bf16 and
f32 can make differently; a reference run can therefore take the choices
of the run it judges (``Routes``), as a served model's reference takes its
served tokens, and measure how far each lies below its own.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from port_bench.reference.common import lora_proj, rmsnorm

ATTENTION_BYTES = 2 ** 31     # score bytes a block of heads may take


def capacity(moe: dict, tokens: int) -> int:
    """(token, choice) pairs an expert takes from a row of ``tokens``:
    at least top_k, and from 128 on rounded up to a multiple of 128."""
    cap = int(tokens * moe["top_k"] * moe["capacity_factor"]
              / moe["num_experts"])
    cap = max(moe["top_k"], cap)
    return (cap + 127) // 128 * 128 if cap >= 128 else cap


def rope(x, theta):
    """x (B, S, heads, D) rotated by positions 0 .. S-1 (rotate-half)."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    freqs = theta ** -(torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend_block(q, k, v, causal: bool, window, prec):
    """q, k, v (B, heads, S, D) -> (B, heads, S, D), softmax over the
    unmasked keys."""
    s = q.shape[2]
    scores = prec.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None, :]
    ok = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    p = torch.softmax(scores.masked_fill(~ok, float("-inf")), dim=-1)
    return prec.einsum("bhqk,bhkd->bhqd", p, v)


def attend(q, k, v, causal: bool, window, prec):
    """q (B, S, H, D), k / v (B, S, KV, D) -> (B, S, H, D); blocks of
    heads, each recomputed in the backward, so that the scores of one block
    are held at a time."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    step = max(1, min(h, ATTENTION_BYTES // (4 * b * s * s)))
    out = [checkpoint(_attend_block, q[:, i:i + step], k[:, i:i + step],
                      v[:, i:i + step], causal, window, prec,
                      use_reentrant=False)
           for i in range(0, h, step)]
    return torch.cat(out, dim=1).transpose(1, 2)


def _pair(lora: dict, target: str):
    key = f"attn/lora/{target}/"
    if key + "a" not in lora:
        return None
    return {"a": lora[key + "a"], "b": lora[key + "b"]}


class Routes:
    """The expert choices of a run: ``given`` (each step's list of each
    layer's (B, S, k) choices) are taken in place of the reference's own,
    ``gap`` is then the widest by which a token's j-th chosen gate lies
    below the reference's j-th largest, over every layer and step
    (0 where all agree); with nothing given, the reference's own choices
    are kept in ``taken``, as ``given`` holds them."""

    def __init__(self, given=None):
        self.given, self.taken, self.gap = given, {}, 0.0

    def choose(self, step: int, layer: int, gates, idx):
        if self.given is None:
            self.taken.setdefault((step, layer), idx.detach().clone())
            return idx
        given, gates = self.given[step][layer], gates.detach()
        want = torch.sort(gates, dim=-1, descending=True).values[
            ..., :idx.shape[-1]]
        self.gap = max(self.gap, float((want - gates.gather(-1, given))
                                       .max()))
        return given

    def steps(self) -> list:
        n = 1 + max(layer for _, layer in self.taken)
        return [[self.taken[(k, i)] for i in range(n)]
                for k in sorted({k for k, _ in self.taken})]


def moe_ffn(model, w, x, prec):
    """x (B, S, d) -> (y (B, S, d), load-balance loss)."""
    m = model["moe"]
    e, k = m["num_experts"], m["top_k"]
    b, s, d = x.shape
    gates = torch.softmax(prec.mm(x, w["moe/router"]), dim=-1)
    idx = torch.sort(gates, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :k]
    if "moe/routes" in w:
        routes, step, i = w["moe/routes"]
        idx = routes.choose(step, i, gates, idx)
    top = gates.gather(-1, idx)
    wts = top / top.sum(-1, keepdim=True).clamp_min(1e-9)
    first = F.one_hot(idx[..., 0], e).float().mean(dim=-2)
    aux = (e * (gates.mean(dim=-2) * first).sum(-1)
           * m["aux_loss_coef"]).mean()
    # each expert keeps the first ``cap`` (token, choice) pairs of a row
    expert = idx.reshape(b, s * k)
    pos = (F.one_hot(expert, e).cumsum(1) - 1).gather(
        -1, expert[..., None])[..., 0]
    keep = pos < capacity(m, s)
    token = (torch.arange(b, device=x.device)[:, None] * s
             + torch.arange(s * k, device=x.device)[None, :] // k)
    weight = wts.reshape(b, s * k)
    xf = x.reshape(b * s, d)
    y = torch.zeros_like(xf)
    for j in range(e):
        sel = (expert == j) & keep
        t, g = token[sel], weight[sel]
        xe = xf[t]
        hid = (F.silu(prec.mm(xe, w["moe/w1"][j]))
               * prec.mm(xe, w["moe/w3"][j]))
        y = y.index_add(0, t, prec.mm(hid, w["moe/w2"][j]) * g[:, None])
    return y.reshape(b, s, d), aux


def layer(model, w, lora, h, prec):
    """One decoder layer: h (B, S, d) f32 -> (h, load-balance loss)."""
    eps = model["norm_eps"]
    scale = model["lora"]["alpha"] / model["lora"]["rank"]
    b, s, _ = h.shape
    x = rmsnorm(h, w["attn_norm/scale"], eps)
    q = lora_proj(prec, x, w["attn/wq"], _pair(lora, "q"), scale)
    k = lora_proj(prec, x, w["attn/wk"], _pair(lora, "k"), scale)
    v = lora_proj(prec, x, w["attn/wv"], _pair(lora, "v"), scale)
    theta = model["rope_theta"]
    o = attend(rope(q, theta), rope(k, theta), v, model.get("causal", True),
               model.get("sliding_window"), prec)
    wo = w["attn/wo"]
    h = prec(h + lora_proj(prec, o.reshape(b, s, -1),
                           wo.reshape(-1, wo.shape[-1]), _pair(lora, "o"),
                           scale))
    y, aux = moe_ffn(model, w, rmsnorm(h, w["mlp_norm/scale"], eps), prec)
    return prec(h + y), aux
