"""The plain reference of one LoRA training step, in f32 PyTorch.

It imports nothing of the program. Its weights are the benchmark's own
draw (``port_bench.weights``): each layer is drawn again from the seed
when it is needed and cast to f32, so the reference holds one layer's
weights at a time beside the embedding and the head. A step runs the
layers forward without a graph, keeping each layer's input; the head and
the loss come in blocks of rows; then each layer, last to first, runs
again under autograd from its kept input and passes the gradient of its
input down, giving its LoRA gradients. The optimizer is AdamW with the
global-norm clip and the warm-up cosine schedule, written out here.

``Precision`` holds the tensors the model computes with: "f32" (the
reference; TF32 is switched off) or "fp8", the control, the step below
the configuration's bf16 that a later change would be tempted by: each
matrix product's operands and each tensor the model keeps in its dtype
between layers (the residual stream, the logits) rounded to float8 e4m3
with a per-tensor scale in the forward pass, and the gradient reaching
them rounded to e5m2.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

HEAD_ROWS = 4096        # rows of logits a block of the head and the loss


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    scale = torch.finfo(dtype).max / x.detach().abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).float() / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


class Precision:
    def __init__(self, name: str):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """A tensor as this precision holds it."""
        return _Fp8.apply(x) if self.name == "fp8" else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self(a) @ self(b)

    def einsum(self, eq: str, *xs) -> torch.Tensor:
        return torch.einsum(eq, *(self(x) for x in xs))


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def lora_proj(prec, x, w, lora, scale):
    """x @ W + scale (x @ A) @ B, W (in, ...) and B (r, ...) flattened."""
    w2 = w.reshape(w.shape[0], -1)
    y = prec.mm(x, w2)
    if lora is not None:
        b = lora["b"].reshape(lora["b"].shape[0], -1)
        y = y + scale * prec.mm(prec.mm(x, lora["a"]), b)
    return y.reshape(*x.shape[:-1], *w.shape[1:])


def schedule(step: int, o: dict) -> float:
    """Warm-up then cosine to a tenth; ``step`` counts from 0."""
    base, warm, total = o["lr"], o["warmup_steps"], o["total_steps"]
    if step < warm:
        return base * min((step + 1) / max(warm, 1), 1.0)
    t = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return base * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * t)))


class AdamW:
    """AdamW over a {name: f32 tensor} of LoRA leaves."""

    def __init__(self, params: dict, o: dict):
        self.o, self.step = o, 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    def update(self, params: dict, grads: dict) -> tuple:
        """-> (new params, global gradient norm before the clip, the
        clipped gradients)."""
        o = self.o
        norm = math.sqrt(sum(float(g.double().square().sum())
                             for g in grads.values()))
        clip = min(1.0, o["grad_clip"] / max(norm, 1e-9))
        lr = schedule(self.step, o)
        self.step += 1
        bc1 = 1 - o["b1"] ** self.step
        bc2 = 1 - o["b2"] ** self.step
        new, clipped = {}, {}
        for k, p in params.items():
            g = grads[k] * clip
            clipped[k] = g
            self.m[k] = o["b1"] * self.m[k] + (1 - o["b1"]) * g
            self.v[k] = o["b2"] * self.v[k] + (1 - o["b2"]) * g.square()
            delta = (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2)
                                         + o["eps"])
            new[k] = p - lr * (delta + o["weight_decay"] * p)
        return new, norm, clipped


def head_loss(final_scale, table, transpose: bool, h, targets, eps, prec):
    """Cross-entropy mean over every row of h (N, d) and its gradient with
    respect to h, in blocks of HEAD_ROWS rows. ``table`` is the head
    (d, V), or the tied embedding (V, d) when ``transpose``."""
    n = h.shape[0]
    total, dh = 0.0, torch.empty_like(h)
    w = table.t() if transpose else table
    for i in range(0, n, HEAD_ROWS):
        hb = h[i:i + HEAD_ROWS].detach().requires_grad_(True)
        logits = prec(prec.mm(rmsnorm(hb, final_scale, eps), w))
        nll = (torch.logsumexp(logits, -1)
               - logits.gather(-1, targets[i:i + HEAD_ROWS, None])[:, 0])
        loss = nll.sum() / n
        dh[i:i + HEAD_ROWS], = torch.autograd.grad(loss, hb)
        total += float(loss.detach())
    return total, dh


def train_step(arch, model: dict, draw: Callable[[str], dict], lora: dict,
               batch, prec: Precision) -> tuple:
    """(loss, {name: gradient}) of one step of the configuration's
    ``model``: ``arch`` (a family's module) gives ``layer(model, weights,
    lora, h, prec) -> (h, aux loss)``; ``draw(group)`` returns a group's
    weights in f32; ``lora`` holds every LoRA leaf by path."""
    tokens, targets = batch
    b, s = tokens.shape
    emb = draw("embed")["embed"]
    final = draw("final_norm")["final_norm/scale"]
    head = emb if model.get("tie_embeddings") else draw("head")["head"]
    n_layers = model["num_layers"]

    def within(tree: dict, i: int) -> dict:
        pre = f"layers/{i}/"
        return {k[len(pre):]: v for k, v in tree.items() if k.startswith(pre)}

    def layer_lora(i):
        return within(lora, i)

    def layer_weights(i):
        return within(draw(f"layers/{i}"), i)

    kept, aux_total = [], 0.0
    with torch.no_grad():
        h = prec(emb[tokens.reshape(-1)].reshape(b, s, -1))
        for i in range(n_layers):
            kept.append(h)
            h, aux = arch.layer(model, layer_weights(i), layer_lora(i),
                                h, prec)
            aux_total += float(aux)
    ce, dh = head_loss(final, head, bool(model.get("tie_embeddings")),
                       h.reshape(b * s, -1), targets.reshape(-1),
                       model["norm_eps"], prec)
    dh = dh.reshape(b, s, -1)
    grads = {}
    for i in reversed(range(n_layers)):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in layer_lora(i).items()}
        x = kept.pop().requires_grad_(i > 0)
        out, aux = arch.layer(model, layer_weights(i), leaves, x, prec)
        wrt = list(leaves.values()) + ([x] if i > 0 else [])
        outs, seeds = [out], [dh]
        if aux.requires_grad:
            outs.append(aux)
            seeds.append(torch.ones_like(aux))
        got = torch.autograd.grad(outs, wrt, seeds)
        for k, g in zip(leaves, got):
            grads[f"layers/{i}/{k}"] = g
        if i > 0:
            dh = got[-1]
        del out, aux, got, x, outs, seeds
    return ce + aux_total, grads
