"""Shard-aware host data loader (the reference's ``data/loader.py``, numpy,
copied).

Deterministic per (seed, step), so an elastic restart (spot preemption,
then a checkpoint restore) resumes the exact stream position: that is what
makes the paper's switching cost a cost in time, never in data. On a
cluster each process would load only its shard (``host_slice``).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.data.synthetic import MarkovLM


class ShardedLMLoader:
    def __init__(self, vocab_size: int, global_batch: int, seq_len: int,
                 seed: int = 0):
        self.vocab_size = vocab_size
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.seed = seed
        self.src = MarkovLM(vocab_size, seed)

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for a given global step (restart-safe)."""
        rows = []
        for b in range(self.global_batch):
            rng = np.random.default_rng(
                (self.seed * 1_000_003 + step) * 4099 + b
            )
            rows.append(self.src.sample(rng, self.seq_len).astype(np.int32))
        return {"tokens": np.stack(rows)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    def host_slice(self, batch: dict, host_id: int, n_hosts: int) -> dict:
        per = self.global_batch // n_hosts
        return {k: v[host_id * per: (host_id + 1) * per]
                for k, v in batch.items()}
