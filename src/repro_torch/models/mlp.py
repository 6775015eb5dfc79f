"""Dense MLP: SwiGLU (llama-style, 3 matrices) or plain act (2 matrices,
optional bias); the reference's ``models/mlp.py``. The plain products go to
``torch.matmul``, as the reference leaves them to XLA; an adapted w1 goes
through K2."""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import lora as lora_lib
from repro_torch.models.common import act_fn, normal_param


def init_mlp(generator: torch.Generator, cfg, dtype) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dev = generator.device
    p = {
        "w1": normal_param(generator, (d, f), dtype),
        "w2": normal_param(generator, (f, d), dtype),
    }
    if cfg.mlp_act == "silu":  # SwiGLU gate
        p["w3"] = normal_param(generator, (d, f), dtype)
    if cfg.mlp_bias:
        p["b1"] = torch.zeros((f,), dtype=dtype, device=dev)
        p["b2"] = torch.zeros((d,), dtype=dtype, device=dev)
    if "mlp" in cfg.lora.targets:
        p["lora"] = lora_lib.init_lora_pair(generator, d, (f,), cfg.lora.rank)
    return p


def apply_mlp(cfg, p, x, kcfg: ops.KernelConfig = ops.DEFAULT):
    act = act_fn(cfg.mlp_act)
    scale = cfg.lora.alpha / cfg.lora.rank
    h = lora_lib.proj(x, p["w1"], p.get("b1"), p.get("lora"), scale, kcfg)
    if "w3" in p:  # SwiGLU
        h = act(h) * (x @ p["w3"])
    else:
        h = act(h)
    y = h @ p["w2"]
    if "b2" in p:
        y = y + p["b2"]
    return y
