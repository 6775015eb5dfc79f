"""Train / eval / prefill / decode step factories (the reference's
``train/step.py``).

``train_step`` differentiates only the LoRA leaves (path-partitioned): the
frozen base model gets no gradient and no optimizer state, as in the
paper's LoRA fine-tuning. The leaves are detached copies that require
grad, merged into the tree for the forward; ``torch.autograd.grad`` over
them alone gives the gradients, so no ``.grad`` is ever set on the base.
Every step takes a ``kcfg`` as ``forward`` does: with
``KernelConfig(use_cuda=True)`` K2 and K4 run forward and backward and K3
forward (``kernels/ops.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.job import exact_div
from repro_torch.kernels import ops
from repro_torch.models import transformer as tf
from repro_torch.obs import ranges
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.sharding import shard
from repro_torch.train.losses import task_loss
from repro_torch.utils.partition import is_lora_path, partition_by_path
from repro_torch.utils.tree import flatten


class TrainMetrics(NamedTuple):
    loss: torch.Tensor
    grad_norm: torch.Tensor
    lr: torch.Tensor


def init_opt_state(params) -> adamw.AdamWState:
    lora_leaves, _ = partition_by_path(params, is_lora_path)
    return adamw.init(lora_leaves)


def batch_to(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors as tensors on ``device`` (integer
    arrays as int64, the index type)."""
    out = {}
    for k, x in batch.items():
        t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
        if not t.is_floating_point() and t.dtype != torch.bool:
            t = t.long()
        out[k] = t.to(device)
    return out


def _device(params) -> torch.device:
    return flatten(params)[0][0].device


@ranges.stage(ranges.LOSS)
def _loss(cfg, logits, batch, aux):
    return task_loss(cfg, logits, batch) + aux


def _value_and_grad(cfg, tcfg, kcfg, merge, lora0, batch):
    """(loss, grads over the LoRA leaves) of one (micro)batch."""
    leaves = [leaf.detach().requires_grad_(True) for leaf in lora0]
    logits, aux = tf.forward(cfg, merge(leaves), batch, kcfg=kcfg,
                             remat=tcfg.remat)
    loss = _loss(cfg, logits, batch, aux)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), list(grads)


def _lr(tcfg, step):
    return warmup_cosine(step, base_lr=tcfg.lr,
                         warmup_steps=tcfg.warmup_steps,
                         total_steps=tcfg.total_steps)


def _apply(tcfg, merge, lora0, opt_state, grads):
    with ranges.span(ranges.OPTIM):
        grads, gnorm = adamw.clip_by_global_norm(grads, tcfg.grad_clip)
        lr = _lr(tcfg, opt_state.step)
        with torch.no_grad():
            new_lora, new_opt = adamw.update(
                grads, opt_state, lora0, lr=lr, b1=tcfg.b1, b2=tcfg.b2,
                eps=tcfg.eps, weight_decay=tcfg.weight_decay)
    return merge(new_lora), new_opt, gnorm, lr


def make_train_step(cfg, tcfg, kcfg: ops.KernelConfig = ops.DEFAULT):
    """-> train_step(params, opt_state, batch) -> (params, opt_state,
    metrics). With ``tcfg.microbatches`` a > 1 the batch is cut into a
    microbatches whose losses and gradients are summed in order, from
    zeros, and divided by a (the reference's scan)."""

    def train_step(params, opt_state, batch):
        with ranges.span(ranges.TRAIN_STEP):
            return _train_step(params, opt_state, batch)

    def _train_step(params, opt_state, batch):
        batch = batch_to(batch, _device(params))
        lora0, merge = partition_by_path(params, is_lora_path)
        a = tcfg.microbatches
        if a > 1:
            # under a sharding context the batch is gathered once, and each
            # microbatch laid out over the batch axes (the reference's
            # constraint); both are the identity otherwise
            batch = {k: shard(x, *(None,) * x.ndim) for k, x in batch.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=lora0[0].device)
            grads = [torch.zeros_like(leaf) for leaf in lora0]
            for i in range(a):
                mb = {k: shard(x.reshape((a, x.shape[0] // a) + x.shape[1:])[i],
                               "batch", *(None,) * (x.ndim - 1))
                      for k, x in batch.items()}
                l_i, g_i = _value_and_grad(cfg, tcfg, kcfg, merge, lora0, mb)
                loss = loss + l_i
                grads = [g + gi for g, gi in zip(grads, g_i)]
            loss = exact_div(loss, a)
            grads = [exact_div(g, a) for g in grads]
        else:
            loss, grads = _value_and_grad(cfg, tcfg, kcfg, merge, lora0,
                                          batch)
        new_params, new_opt, gnorm, lr = _apply(tcfg, merge, lora0,
                                                opt_state, grads)
        return new_params, new_opt, TrainMetrics(loss, gnorm, lr)

    return train_step


def make_grad_step(cfg, tcfg, kcfg: ops.KernelConfig = ops.DEFAULT):
    """Gradient-only step for accumulation: (params, batch) -> (loss,
    grads over the LoRA leaves)."""

    def grad_step(params, batch):
        batch = batch_to(batch, _device(params))
        lora0, merge = partition_by_path(params, is_lora_path)
        return _value_and_grad(cfg, tcfg, kcfg, merge, lora0, batch)

    return grad_step


def apply_grads(cfg, tcfg, params, opt_state, grads):
    """Optimizer apply for externally accumulated grads."""
    lora0, merge = partition_by_path(params, is_lora_path)
    new_params, new_opt, _, _ = _apply(tcfg, merge, lora0, opt_state, grads)
    return new_params, new_opt


def make_eval_step(cfg, kcfg: ops.KernelConfig = ops.DEFAULT):
    def eval_step(params, batch):
        batch = batch_to(batch, _device(params))
        with torch.no_grad():
            logits, _ = tf.forward(cfg, params, batch, kcfg=kcfg)
            return task_loss(cfg, logits, batch)

    return eval_step


def make_prefill_step(cfg, max_len: int,
                      kcfg: ops.KernelConfig = ops.DEFAULT):
    def prefill_step(params, batch):
        with torch.no_grad():
            return tf.prefill(cfg, params, batch_to(batch, _device(params)),
                              max_len=max_len, kcfg=kcfg)

    return prefill_step


def make_decode_step(cfg, kcfg: ops.KernelConfig = ops.DEFAULT):
    def decode_step(params, cache, batch):
        with torch.no_grad():
            return tf.decode_step(cfg, params,
                                  batch_to(batch, _device(params)), cache,
                                  kcfg=kcfg)

    return decode_step
