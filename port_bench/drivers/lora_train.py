"""Runs a ``lora_train`` traffic mix: LoRA fine-tuning through the port's
train step.

Set-up draws the weights on the card from the seed, builds one train step
and its optimizer state, and drives them through the first SETUP_STEPS
steps on the window's own feed; those steps warm up every shape the window
uses, and the reference follows each of them (``train_check``). The
window then queues steps back to back, as a training loop does, with no
synchronize between them (the host runs at most LAG steps ahead of the
card), until ``--seconds`` have passed; one synchronize closes it, and
every step started in it completes and counts. With ``--trace 1`` the
window is ``trace_steps`` steps under ``torch.profiler`` instead. The
program's state is freed before the reference runs.
"""
from __future__ import annotations

import gc
import math
import sys
import time

import torch

from port_bench import program, trace, train_check, weights

SETUP_STEPS = 2
LAG = 2          # steps queued ahead of the one the card runs


def _lora_leaves(params) -> list:
    return [(p, x) for p, x in weights.tree_leaves(params)
            if weights.is_lora(p)]


def setup(ctx, step_wrapper=lambda step: step) -> dict:
    """Draws the weights, builds the train step and runs the first
    SETUP_STEPS steps. Returns the state the window goes on from (params,
    opt, launch: queues the step on the feed's k-th batch and returns its
    metrics), the program's trajectory over those steps (with, in an MoE
    configuration, its router's choices in each: "routes"),
    ``lora0`` (the drawn LoRA leaves) and ``failed`` (steps with a loss
    that is not a number)."""
    model, traffic, dev = ctx.model, ctx.traffic, torch.device(ctx.device)
    seed = ctx.seed
    t0 = time.perf_counter()
    flat = weights.draw_all(model, seed, dev)
    lora0 = {p: x.clone() for p, x in flat.items() if weights.is_lora(p)}
    st = {"params": weights.program_tree(flat), "lora0": lora0, "failed": 0}
    del flat
    step, init_opt = program.train_step(model, traffic,
                                        use_cuda=dev.type == "cuda")
    routes = []             # the router's choices in set-up's steps
    recorded = step_wrapper(program.recording_routes(step, routes)
                            if model.get("moe") else step)
    step = step_wrapper(step)
    st["opt"] = init_opt(st["params"])
    b1 = traffic["optimizer"]["b1"]

    def launch(k):
        tok, tgt = train_check.feed(model, traffic, seed, k, dev)
        fn = recorded if k < SETUP_STEPS else step
        st["params"], st["opt"], m = fn(st["params"], st["opt"],
                                        {"tokens": tok, "targets": tgt})
        return m

    st["launch"] = launch
    prog = {"losses": [], "grad_norms": []}
    times = [time.perf_counter() - t0]          # the draw, then each step
    for k in range(SETUP_STEPS):
        t0 = time.perf_counter()
        m = launch(k)
        loss = float(m.loss)
        st["failed"] += not math.isfinite(loss)
        times.append(time.perf_counter() - t0)
        prog["losses"].append(loss)
        prog["grad_norms"].append(float(m.grad_norm))
        if k == 0:
            prog["first_grad"] = train_check.norms({
                p: g / (1 - b1) for (p, _), g in
                zip(_lora_leaves(st["params"]), st["opt"].m)})
    prog["change"] = train_check.norms({
        p: x - lora0[p] for p, x in _lora_leaves(st["params"])})
    if model.get("moe"):
        prog["routes"] = [calls[:model["num_layers"]] for calls in routes]
    st["prog"] = prog
    print("port_bench: set-up: weights drawn and the step built in "
          f"{times[0]:.3f} s; steps " + ", ".join(f"{t:.3f}" for t in
                                                   times[1:]) + " s",
          file=sys.stderr)
    return st


def _window(launch, k, dev, more) -> tuple:
    """Queues steps k, k + 1, ... while ``more(steps so far)``, the host
    never more than LAG steps ahead of the card, then synchronizes once.
    -> (steps, steps whose loss is not a number)."""
    cuda = dev.type == "cuda"
    losses, marks, steps = [], [], 0
    while True:
        with torch.profiler.record_function(trace.STEP_RANGE):
            losses.append(launch(k + steps).loss)
        steps += 1
        if cuda:
            marks.append(torch.cuda.Event())
            marks[-1].record()
            if len(marks) > LAG:
                marks.pop(0).synchronize()
        if not more(steps):
            break
    if cuda:
        torch.cuda.synchronize(dev)
    bad = int((~torch.isfinite(torch.stack(losses).float())).sum())
    return steps, bad


def run(ctx) -> dict:
    """``ctx``: seed, seconds, trace, device, start (the process's first
    perf_counter), model (a configuration's ``model``), traffic, cell (its
    limits), per_layer ({name: reader}), step_wrapper (tests put a fault
    under the step). Returns the result's parts."""
    model, traffic, dev = ctx.model, ctx.traffic, torch.device(ctx.device)
    program.prebuild(model, dev)
    st = setup(ctx, ctx.step_wrapper)
    launch, tokens = st["launch"], traffic["batch"] * traffic["seq_len"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - ctx.start

    summary = None
    if ctx.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        n = traffic["trace_steps"]
        with profile(activities=acts) as prof:
            with record_function(trace.WINDOW_RANGE):
                steps, bad = _window(launch, SETUP_STEPS, dev,
                                     lambda s: s < n)
        summary = trace.read_profile(prof, steps)
        window_s = summary["window_s"]
        print("port_bench: device time a step by class: " + ", ".join(
            f"{c} {1e3 * v / steps:.3f} ms" for c, v in
            summary["class_s"].items()), file=sys.stderr)
    else:
        t0 = time.perf_counter()
        steps, bad = _window(
            launch, SETUP_STEPS, dev,
            lambda s: time.perf_counter() - t0 < ctx.seconds)
        window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    failed, prog, lora0 = st["failed"] + bad, st["prog"], st["lora0"]
    del st, launch
    gc.collect()            # the step's closure and the state hold a cycle
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ref = train_check.reference_for(model, traffic, ctx.seed, lora0, prog,
                                    dev)
    got, checks, correct = train_check.judge(prog, ref, failed,
                                             ctx.cell["limits"])
    print(f"port_bench: set-up {setup_s:.3f} s, window {window_s:.3f} s "
          f"({steps} steps), reference {time.perf_counter() - t0:.3f} s "
          f"({SETUP_STEPS} steps); losses {prog['losses']} against "
          f"{ref and ref['losses']}", file=sys.stderr)
    print("port_bench: not compared (no upper reading, cells/<workload>"
          ".json): " + ", ".join(f"{k} {got[k]!r}" for k in got
                                 if k not in checks), file=sys.stderr)
    out = {"correct": correct, "attempted": SETUP_STEPS + steps,
           "failed": failed, "checks": checks,
           "device": {"memory_peak_bytes": peak}}
    if summary is None:
        out["metrics"] = {
            "train_tokens_per_s": steps * tokens / window_s,
            "train_peak_gib": peak / 2 ** 30,
            "setup_s": setup_s}
        return out
    summary.update(model=model, traffic=traffic)
    out["metrics"] = {name: reader.read(summary)
                      for name, reader in ctx.per_layer.items()}
    out["device"].update(busy_s=summary["busy_s"], window_s=window_s)
    out["breakdown"] = {"device_ops": [list(x) for x in
                                       summary["device_ops"]],
                        "idle_gaps": [list(x) for x in
                                      summary["idle_gaps"]]}
    return out
