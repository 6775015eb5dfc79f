"""Meta-tensor stand-ins for every model input (the dry run's; nothing is
allocated). The JAX package's ``launch/specs.py``.

``input_specs(cfg, shape)`` mirrors what the data pipeline / serving
frontend feeds the step for that (architecture, input-shape) pair:
  train    -> the training batch (tokens or stub embeddings + targets)
  prefill  -> the prompt batch
  decode   -> ONE new token plus a KV / state cache of seq_len, holding
              seq_len - 1 tokens
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer as tf
from repro_torch.sharding import axes_to_str


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _token_batch(cfg: ModelConfig, b: int, s: int, with_targets: bool):
    dt = tf.model_dtype(cfg)
    out = {}
    if cfg.embed_inputs:
        out["embeds"] = _meta((b, s, cfg.d_model), dt)
        if with_targets:
            out["targets"] = _meta((b, s), torch.int32)
    else:
        out["tokens"] = _meta((b, s), torch.int32)
    if cfg.m_rope:
        out["positions"] = _meta((b, s, 3), torch.int32)
    if cfg.encoder_only and with_targets:
        out["loss_mask"] = _meta((b, s), torch.bool)
    return out


def batch_axes(batch_spec) -> dict:
    """Logical axes of a batch dict (string leaves, see
    ``sharding.axes_to_str``)."""
    ax = {}
    for k in batch_spec:
        if k == "embeds":
            ax[k] = axes_to_str(("batch", "seq", "embed"))
        elif k == "positions":
            ax[k] = axes_to_str(("batch", "seq", None))
        else:
            ax[k] = axes_to_str(("batch", "seq"))
    return ax


def input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """(batch spec, cache spec or None): dicts of meta tensors; the cache
    is :func:`~repro_torch.models.transformer.init_cache`'s tree with its
    ``index`` at seq_len - 1."""
    b, s = shape.global_batch, shape.seq_len
    if shape.mode == "train":
        return _token_batch(cfg, b, s, with_targets=True), None
    if shape.mode == "prefill":
        return _token_batch(cfg, b, s, with_targets=False), None
    if shape.mode == "decode":
        cache = tf.init_cache(cfg, b, s, "meta")
        cache["index"] = s - 1
        return _token_batch(cfg, b, 1, with_targets=False), cache
    raise ValueError(shape.mode)
