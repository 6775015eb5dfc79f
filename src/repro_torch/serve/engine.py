"""Minimal batched serving engine: prefill + greedy / temperature decode
(the reference's ``serve/engine.py``).

Requests are batched to a fixed width, length-bucketed; the cache is the
model's (the ring-buffer KV cache, the Mamba2 conv and SSD state, or both for
hybrid). Requests are token prompts, as in the reference's engine, so a
config fed embeddings (``embed_inputs``: the VLM, audio) is refused; drive
those through ``models.prefill`` / ``decode_step`` with ``embeds``. Temperature sampling draws from a
``torch.Generator``, so it cannot match the reference's
``jax.random.categorical`` bit for bit; greedy decoding matches exactly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf


@dataclass
class Request:
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0    # 0 = greedy


class ServingEngine:
    def __init__(self, cfg, params, max_len: int = 2048, seed: int = 0,
                 device=None):
        if not cfg.supports_decode:
            raise ValueError(f"{cfg.name}: encoder-only arch cannot serve "
                             "decode")
        if cfg.embed_inputs:
            raise ValueError(f"{cfg.name}: takes embeddings, not tokens; the "
                             "engine serves token prompts only")
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    @torch.no_grad()
    def generate_batch(self, requests: List[Request]) -> List[np.ndarray]:
        """Decodes a batch of equal-length prompts in lockstep.

        Production serving would bucket requests by prompt length (padding
        without pad-attention-masking is incorrect); the engine checks it."""
        plen = len(requests[0].prompt)
        if any(len(r.prompt) != plen for r in requests):
            raise ValueError("batch requests must be length-bucketed")
        prompts = np.stack([r.prompt for r in requests]).astype(np.int64)
        batch = {"tokens": torch.from_numpy(prompts).to(self.device)}
        logits, cache = tf.prefill(self.cfg, self.params, batch,
                                   self.max_len)
        max_new = max(r.max_new_tokens for r in requests)
        toks = []
        tok = self._sample(logits[:, -1], requests)
        for _ in range(max_new):
            toks.append(tok)
            logits, cache = tf.decode_step(self.cfg, self.params,
                                           {"tokens": tok[:, None]}, cache)
            tok = self._sample(logits[:, -1], requests)
        out = (torch.stack(toks, dim=1).cpu().numpy().astype(np.int32)
               if toks else np.zeros((len(requests), 0), np.int32))
        return [out[i, :r.max_new_tokens] for i, r in enumerate(requests)]

    def _sample(self, logits: torch.Tensor,
                requests: List[Request]) -> torch.Tensor:
        greedy = torch.argmax(logits, dim=-1)
        temps = [r.temperature for r in requests]
        if max(temps) == 0.0:
            return greedy
        t = torch.tensor(temps, dtype=torch.float32, device=logits.device)
        probs = torch.softmax(logits / t.clamp_min(1e-3)[:, None], dim=-1)
        sampled = torch.multinomial(probs, 1, generator=self.generator)[:, 0]
        return torch.where(t > 0, sampled, greedy)
