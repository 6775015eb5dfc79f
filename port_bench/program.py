"""The benchmark's one door into the system under test, the port
(``repro_torch``): its configuration classes, its train step and its MoE
router's choices. Nothing
else of the benchmark imports the port, and the reference imports neither
this module nor the port."""
from __future__ import annotations

import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"


def _port():
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import repro_torch.configs as configs
    import repro_torch.kernels.ops as ops
    import repro_torch.train.step as step
    return configs, ops, step


def model_config(model: dict):
    """The port's ModelConfig of a configuration file's ``model`` section."""
    configs, _, _ = _port()
    fields = dict(model)
    nested = {"moe": configs.MoEConfig, "ssm": configs.SSMConfig,
              "lora": configs.LoRAConfig}
    for key, cls in nested.items():
        if fields.get(key) is not None:
            sub = dict(fields[key])
            if "targets" in sub:
                sub["targets"] = tuple(sub["targets"])
            fields[key] = cls(**sub)
    return configs.ModelConfig(**fields)


def train_step(model: dict, traffic: dict, use_cuda: bool = True):
    """(the port's train step, its optimizer-state init) for a
    configuration and a lora_train traffic mix."""
    configs, ops, step = _port()
    o = traffic["optimizer"]
    tcfg = configs.TrainConfig(
        seq_len=traffic["seq_len"], global_batch=traffic["batch"],
        lr=o["lr"], weight_decay=o["weight_decay"],
        warmup_steps=o["warmup_steps"], total_steps=o["total_steps"],
        b1=o["b1"], b2=o["b2"], eps=o["eps"], grad_clip=o["grad_clip"],
        remat=traffic["remat"])
    fn = step.make_train_step(model_config(model), tcfg,
                              ops.KernelConfig(use_cuda=use_cuda))
    return fn, step.init_opt_state


def prebuild(model: dict, device) -> None:
    """Builds the kernels a configuration's training step launches, side by
    side, before the first step would build them one after another (a no-op
    once they are built, and on the CPU)."""
    if device.type != "cuda":
        return
    _port()
    from repro_torch.kernels import (build, flash_attention, lora_matmul,
                                     ssd_scan)
    sources = [lora_matmul.SOURCE]
    if model.get("num_heads"):
        sources += [flash_attention.SOURCE, flash_attention.BACKWARD_SOURCE]
    if model.get("ssm"):
        sources += [ssd_scan.SOURCE, ssd_scan.BACKWARD_SOURCE]
    build.build_all(sources)


def recording_routes(step, log: list):
    """``step``, appending to ``log`` at each call one list of the port's
    MoE router's choices, (..., T, k) each, in the order it was called
    (the forward's layers, then remat's recompute)."""
    _port()
    from repro_torch.models import moe

    def wrapped(params, opt, batch):
        route, calls = moe.route, []

        def recorded(cfg, w, x):
            out = route(cfg, w, x)
            calls.append(out[0].detach().clone())
            return out

        moe.route = recorded
        try:
            return step(params, opt, batch)
        finally:
            moe.route = route
            log.append(calls)
    return wrapped
