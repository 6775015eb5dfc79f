"""Elastic slot-driven fine-tuning: the paper's scheduler driving a real
LoRA training loop (the reference's ``train/elastic.py``).

Each market slot the policy picks (n_o, n_s); the trainer then executes
``round(mu_t * H(n_t) * steps_per_unit)`` optimizer steps of the slot. The
global batch is held fixed (paper Sec. III-B: "to avoid affecting the
model's convergence ... we fix the global batch size"), so the update
sequence is the one an n_t-wide data-parallel cluster would produce:
elasticity changes wall-clock time and cost, never the math. On every
instance-count change the trainer performs a real checkpoint save and
restore (``repro_torch.checkpoint``), measuring the serialized bytes and
deriving the switching time from them at ``bandwidth_bps``.

Spot preemption: if the market's availability drops below the policy's
spot allocation, the allocation is trimmed (the simulator's semantics);
the data stream's determinism (``ShardedLMLoader.batch_at``) guarantees no
sample is lost or duplicated.

Checkpoints go to ``ckpt_dir`` (None: a directory under the system's
temporary directory). The model is drawn on ``device`` (None: the card) from
``torch.Generator(device).manual_seed(tcfg.seed)``; the policy is the
caller's, on whatever device it was built for (the port's AHAP solves its
windows on the card through K1 unless given ``device="cpu"``).
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import restore, save
from repro_torch.configs.base import (JobConfig, ModelConfig,
                                      ThroughputConfig, TrainConfig)
from repro_torch.core.job import value_fn
from repro_torch.core.market import Trace
from repro_torch.core.policies import BasePolicy, Obs
from repro_torch.data.loader import ShardedLMLoader
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.train.step import init_opt_state, make_train_step
from repro_torch.utils.partition import is_lora_path, partition_by_path


@dataclass
class SlotLog:
    t: int
    n_od: int
    n_spot: int
    price: float
    mu: float
    steps: int
    mean_loss: float
    cost: float
    reconfig_s: float = 0.0
    ckpt_bytes: int = 0


@dataclass
class ElasticReport:
    utility: float
    value: float
    cost: float
    completion_time: float
    z_final: float
    completed: bool
    total_steps: int
    losses: List[float] = field(default_factory=list)
    slots: List[SlotLog] = field(default_factory=list)


class ElasticTrainer:
    def __init__(
        self,
        cfg: ModelConfig,
        tcfg: TrainConfig,
        job: JobConfig,
        tput: ThroughputConfig,
        policy: BasePolicy,
        trace: Trace,
        pred_matrix: Optional[np.ndarray] = None,
        steps_per_unit: float = 4.0,
        ckpt_dir: Optional[str] = None,
        bandwidth_bps: float = 800e6,
        seed: int = 0,
        ckpt_retries: int = 2,
        device=None,
    ):
        self.cfg, self.tcfg, self.job, self.tput = cfg, tcfg, job, tput
        self.policy, self.trace, self.pred = policy, trace, pred_matrix
        self.steps_per_unit = steps_per_unit
        self.ckpt_dir = ckpt_dir or os.path.join(tempfile.gettempdir(),
                                                 "repro_torch_elastic")
        self.bandwidth_bps = bandwidth_bps
        self.ckpt_retries = ckpt_retries
        self.device = resolve_device(device)

        gen = torch.Generator(self.device).manual_seed(tcfg.seed)
        self.params = tf.init_params(gen, cfg)
        self.opt = init_opt_state(self.params)
        self._step = make_train_step(cfg, tcfg)
        self.loader = ShardedLMLoader(
            cfg.vocab_size, tcfg.global_batch, tcfg.seq_len, seed=seed
        )
        self.global_step = 0

    # ------------------------------------------------------------------
    def _reconfigure(self, t: int) -> tuple:
        """Checkpoint round trip on an instance-count change; returns
        (seconds at ``bandwidth_bps``, bytes)."""
        path = os.path.join(self.ckpt_dir, "elastic.ckpt")
        lora, merge = partition_by_path(self.params, is_lora_path)
        state = {"lora": lora, "opt": self.opt, "step": self.global_step}
        nbytes = save(path, state, meta={"arch": self.cfg.name},
                      retries=self.ckpt_retries)
        restored, meta = restore(path, state, retries=self.ckpt_retries)
        # re-adopt the restored state (exercises the real path)
        self.params = merge(restored["lora"])
        self.opt = restored["opt"]
        secs = nbytes * 8.0 / self.bandwidth_bps
        return secs, nbytes

    def _train_steps(self, steps: int) -> List[float]:
        losses = []
        for _ in range(steps):
            batch = self.loader.batch_at(self.global_step)
            self.params, self.opt, m = self._step(self.params, self.opt,
                                                  batch)
            losses.append(float(m.loss))
            self.global_step += 1
        return losses

    # ------------------------------------------------------------------
    def run(self) -> ElasticReport:
        job, tput = self.job, self.tput
        policy = self.policy
        policy.reset(job, tput)
        z, n_prev, cost = 0.0, 0, 0.0
        T_complete: Optional[float] = None
        losses: List[float] = []
        slots: List[SlotLog] = []

        for t in range(job.deadline):
            price = float(self.trace.prices[t])
            avail = int(self.trace.avail[t])
            obs = Obs(t=t, price=price, avail=avail, z_prev=z, n_prev=n_prev,
                      pred=self.pred[t] if self.pred is not None else None)
            n_o, n_s = policy.decide(obs)
            n_s = int(np.clip(n_s, 0, min(avail, job.n_max)))
            n_o = int(np.clip(n_o, 0, job.n_max - n_s))
            n = n_o + n_s
            if 0 < n < job.n_min:
                n_o += job.n_min - n
                n = n_o + n_s

            reconfig_s, nbytes = (0.0, 0)
            if n != n_prev and n > 0:
                reconfig_s, nbytes = self._reconfigure(t)
            mu = 1.0 if n == n_prev else (tput.mu1 if n > n_prev else tput.mu2)
            if n == 0 and n_prev == 0:
                mu = 1.0

            work = mu * (tput.alpha * n + (tput.beta if n > 0 else 0.0))
            work = min(work, job.workload - z) if z + work >= job.workload \
                else work
            steps = int(round(work * self.steps_per_unit))
            slot_losses = self._train_steps(steps)
            losses.extend(slot_losses)

            cost += n_s * price + n_o * job.on_demand_price
            full_work = mu * (tput.alpha * n + (tput.beta if n > 0 else 0.0))
            if full_work > 0 and z + full_work >= job.workload \
                    and T_complete is None:
                T_complete = t + (job.workload - z) / full_work
            z = min(z + full_work, job.workload)
            slots.append(SlotLog(
                t=t, n_od=n_o, n_spot=n_s, price=price, mu=mu, steps=steps,
                mean_loss=(float(np.mean(slot_losses)) if slot_losses
                           else float("nan")),
                cost=n_s * price + n_o * job.on_demand_price,
                reconfig_s=reconfig_s, ckpt_bytes=nbytes,
            ))
            n_prev = n
            if T_complete is not None:
                break

        if T_complete is None:
            h_max = tput.alpha * job.n_max + tput.beta
            dt_ = (job.workload - z) / h_max
            T_complete = job.deadline + dt_
            cost += job.on_demand_price * job.n_max * dt_
            # termination config: run the remaining steps on-demand
            steps = int(round((job.workload - z) * self.steps_per_unit))
            losses.extend(self._train_steps(steps))
            z = job.workload

        value = float(value_fn(job, T_complete))
        return ElasticReport(
            utility=value - cost, value=value, cost=cost,
            completion_time=float(T_complete), z_final=float(z),
            completed=T_complete <= job.deadline,
            total_steps=self.global_step, losses=losses, slots=slots,
        )
