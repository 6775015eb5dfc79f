"""Modality frontend stubs (the reference's ``models/frontends.py``).

For the VLM and audio families the vision encoder and the conv audio codec
are not implemented, in the reference as here: ``make_frontend_embeddings``
fabricates patch / frame embeddings of the right shape, and
``make_mrope_positions`` gives a synthetic image span (t, h, w) streams that
differ, so the multimodal rotary path and the position mask are exercised.
The draws use a ``torch.Generator``, so they cannot match ``jax.random``
bit for bit; ``make_mrope_positions`` is numpy and equals the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import model_dtype


def make_frontend_embeddings(generator: torch.Generator, cfg, batch: int,
                             seq: int) -> torch.Tensor:
    """Fabricated patch / frame embeddings (B, S, d_model) in the model
    dtype on the generator's device."""
    x = torch.randn((batch, seq, cfg.d_model), generator=generator,
                    dtype=torch.float32, device=generator.device)
    return x.to(model_dtype(cfg)) * 0.02


def make_mrope_positions(batch: int, seq: int, image_span=None) -> np.ndarray:
    """(B, S, 3) int32 positions: text positions identical across streams;
    an optional image span ``(start, h, w)`` over [start, start + h*w) gets
    2-D (h, w) coordinates with a constant temporal index, and the text
    after it resumes at start + max(h, w) (the Qwen2-VL M-RoPE layout)."""
    t = np.arange(seq, dtype=np.int32)
    pos = np.stack([t, t, t], axis=-1)  # (S, 3)
    if image_span is not None:
        start, h, w = image_span
        n = h * w
        assert start + n <= seq
        hh, ww = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        pos[start:start + n, 0] = start  # constant temporal index
        pos[start:start + n, 1] = start + hh.reshape(-1)
        pos[start:start + n, 2] = start + ww.reshape(-1)
        nxt = start + max(h, w)
        tail = seq - (start + n)
        if tail > 0:
            cont = nxt + np.arange(tail, dtype=np.int32)
            pos[start + n:, :] = cont[:, None]
    return np.broadcast_to(pos[None], (batch, seq, 3)).copy()


def make_masked_prediction_batch(generator: torch.Generator, cfg, batch: int,
                                 seq: int, mask_prob: float = 0.08) -> dict:
    """HuBERT-style batch: frame embeddings (B, S, d), codebook targets
    (B, S) int32 in [0, vocab) and a boolean loss mask (B, S) with each
    frame masked with probability ``mask_prob``."""
    dev = generator.device
    embeds = make_frontend_embeddings(generator, cfg, batch, seq)
    targets = torch.randint(0, cfg.vocab_size, (batch, seq),
                            generator=generator, device=dev,
                            dtype=torch.int32)
    mask = torch.rand((batch, seq), generator=generator, device=dev) < \
        mask_prob
    return {"embeds": embeds, "targets": targets, "loss_mask": mask}
