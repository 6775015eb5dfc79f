"""Faults planted under the program's train step, to show that
``correct`` catches them (the tests at a small size, ``calibrate`` at a
cell's own). Each is a wrapper of the step: ``FAULTS[name](step)``.

- ``unchanged``: the step runs but returns the state it was given;
- ``half_batch``: the step sees half the batch (half the rows, or half
  the sequence of a single row), its loss the mean over those;
- ``doubled_leaf``: one LoRA leaf's gradient doubled where the step makes
  it, before the clip and the optimizer;
- ``altered_route`` (MoE): the first token of each row takes, as its first
  choice, the lowest-numbered expert outside its top k, where the router
  chooses.
"""
from __future__ import annotations

import contextlib

import torch


def unchanged(step):
    def wrapped(params, opt, batch):
        _, _, metrics = step(params, opt, batch)
        return params, opt, metrics
    return wrapped


def half_batch(step):
    def wrapped(params, opt, batch):
        rows = batch["tokens"].shape[0]
        if rows > 1:
            half = {k: v[:rows // 2] for k, v in batch.items()}
        else:
            cols = batch["tokens"].shape[1] // 2
            half = {k: v[:, :cols] for k, v in batch.items()}
        return step(params, opt, half)
    return wrapped


@contextlib.contextmanager
def _doubled_first_gradient():
    from repro_torch.optim import adamw

    clip = adamw.clip_by_global_norm

    def doubled(grads, max_norm):
        return clip([2 * grads[0], *grads[1:]], max_norm)

    adamw.clip_by_global_norm = doubled
    try:
        yield
    finally:
        adamw.clip_by_global_norm = clip


def doubled_leaf(step):
    def wrapped(params, opt, batch):
        with _doubled_first_gradient():
            return step(params, opt, batch)
    return wrapped


@contextlib.contextmanager
def _altered_first_choice():
    from repro_torch.models import moe

    route = moe.route

    def altered(cfg, w, x):
        idx, wts, aux = route(cfg, w, x)
        free = torch.ones(idx.shape[:-2] + (cfg.moe.num_experts,),
                          dtype=torch.bool, device=idx.device)
        free.scatter_(-1, idx[..., 0, :], False)
        idx = idx.clone()
        idx[..., 0, 0] = free.int().argmax(-1)
        return idx, wts, aux

    moe.route = altered
    try:
        yield
    finally:
        moe.route = route


def altered_route(step):
    def wrapped(params, opt, batch):
        with _altered_first_choice():
            return step(params, opt, batch)
    return wrapped


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "doubled_leaf": doubled_leaf, "altered_route": altered_route}
