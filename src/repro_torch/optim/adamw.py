"""AdamW over a tree of tensors (the reference's ``optim/adamw.py``).

The trainer passes the LoRA leaf list, so the base model carries no
optimizer state. Updates are functional: they return new tensors and leave
their inputs as they were. ``step`` is an int32 0-dim tensor; m and v are
f32.

Rounding follows the reference's jitted step on the CPU (XLA's compiled
program, measured leaf by leaf): both moment blends are one FMA each,
``fma(b1, m, (1 - b1) g)`` and ``fma(b2, v, (1 - b2) g^2)``, so m and v come
out bit-equal; XLA rewrites ``(m / bc1) / (sqrt(v / bc2) + eps)`` into one
division ``m / (bc1 (sqrt(v / bc2) + eps))`` and contracts the parameter
update into ``fma(-lr, delta, p)``, which the port repeats too. The new
parameters then agree to the bit but for about 1 element in 30,000, one
ulp off (the reference's tests state it).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.utils.tree import flatten, unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: list
    v: list


def _f32(x: float) -> float:
    """A Python constant as the reference's f32 program holds it."""
    return float(np.float32(x))


def _fma(a: float, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded to f32 once (the f64 product of two f32 values is
    exact, so only the sum rounds, before the final rounding: as an FMA
    but where the exact sum needs over 53 bits)."""
    return (a * b.double() + c.double()).float()


def _map(fn, *trees):
    leaves = [flatten(t)[0] for t in trees]
    return unflatten(flatten(trees[0])[1], [fn(*xs) for xs in zip(*leaves)])


def init(params) -> AdamWState:
    leaves = flatten(params)[0]
    dev = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m=_map(zeros, params),
        v=_map(zeros, params),
    )


def global_norm(tree) -> torch.Tensor:
    leaves = flatten(tree)[0]
    total = 0
    for leaf in leaves:
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    bound = torch.full((), max_norm, dtype=torch.float32, device=norm.device)
    # a tensor divided by a tensor: one rounding (a Python scalar over a
    # tensor is its reciprocal times the scalar)
    scale = torch.clamp(bound / torch.clamp(norm, min=1e-9), max=1.0)
    return _map(lambda leaf: leaf * scale, tree), norm


def update(grads, state: AdamWState, params, *, lr, b1=0.9, b2=0.999,
           eps=1e-8, weight_decay=0.0):
    """Returns (new_params, new_state). ``lr`` is a Python float or a 0-dim
    f32 tensor."""
    step = state.step + 1
    stepf = step.float()
    c1, c2 = _f32(b1), _f32(b2)
    d1, d2 = _f32(1 - b1), _f32(1 - b2)
    bc1 = 1.0 - torch.pow(torch.full_like(stepf, c1), stepf)
    bc2 = 1.0 - torch.pow(torch.full_like(stepf, c2), stepf)
    lr_t = torch.as_tensor(lr, dtype=torch.float32, device=stepf.device)
    neg_lr = -lr_t.double()
    eps_t = torch.full_like(stepf, _f32(eps))

    def upd(g, m, v, p):
        g = g.float()
        m_new = _fma(c1, m, d1 * g)
        v_new = _fma(c2, v, d2 * torch.square(g))
        delta = m_new / (bc1 * (torch.sqrt(v_new / bc2) + eps_t))
        if weight_decay:
            delta = delta + _f32(weight_decay) * p.float()
        p_new = (neg_lr * delta.double() + p.float().double()).float()
        return p_new.to(p.dtype), m_new, v_new

    g_l, m_l, v_l, p_l = (flatten(t)[0] for t in
                          (grads, state.m, state.v, params))
    out = [upd(*xs) for xs in zip(g_l, m_l, v_l, p_l)]
    rebuild = lambda i, t: unflatten(flatten(t)[1], [o[i] for o in out])
    return rebuild(0, params), AdamWState(step=step, m=rebuild(1, state.m),
                                          v=rebuild(2, state.v))
