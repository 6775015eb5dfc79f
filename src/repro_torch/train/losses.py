"""Losses: causal LM cross-entropy and masked prediction (HuBERT-style);
the reference's ``train/losses.py``."""
from __future__ import annotations

import torch


def cross_entropy(logits, targets, loss_mask=None, z_loss: float = 0.0):
    """logits (B,S,V) f32, targets (B,S) int. Mean over unmasked tokens."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = logz - gold
    if z_loss:
        nll = nll + z_loss * torch.square(logz)
    if loss_mask is not None:
        w = loss_mask.float()
        return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)
    return nll.mean()


def lm_loss(cfg, logits, batch):
    """Next-token prediction: shift inside unless explicit targets given."""
    if "targets" in batch:
        return cross_entropy(logits, batch["targets"], batch.get("loss_mask"))
    toks = batch["tokens"]
    return cross_entropy(logits[:, :-1], toks[:, 1:])


def masked_prediction_loss(cfg, logits, batch):
    """Encoder masked-prediction (audio): CE only on masked frames."""
    return cross_entropy(logits, batch["targets"], batch["loss_mask"])


def task_loss(cfg, logits, batch):
    if cfg.encoder_only:
        return masked_prediction_loss(cfg, logits, batch)
    return lm_loss(cfg, logits, batch)
