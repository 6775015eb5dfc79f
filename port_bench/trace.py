"""Reads a ``torch.profiler`` trace of a few training steps into the
summary the per-layer metrics read.

Each device kernel falls in one class. A kernel inside the device span of
one of the program's named ranges (RANGES) takes that range's class;
otherwise its name decides (the program's kernels by NAMES, the library's
matrix products by GEMM), and what is left is ``elementwise``: PyTorch's
own kernels, copies and fills. Time is the sum of each kernel's own device
time, never a range's span, which holds the idle gaps between its kernels.
Busy time is the union of every device activity's interval; the window is
the host range WINDOW_RANGE around the traced steps (each a STEP_RANGE,
queued with no synchronize between them) and the one ``synchronize``
that ends them.
"""
from __future__ import annotations

import bisect
import re

STEP_RANGE = "port_bench step"
WINDOW_RANGE = "port_bench window"
# the program's range names (spans) and the class of what runs inside
RANGES = {"moe route": "moe", "moe dispatch": "moe", "moe experts": "moe",
          "moe combine": "moe",
          "K3 backward": "attention", "ops.attention repeat kv": "attention",
          "K4 backward": "ssd",
          "K2 backward W transpose": "lora", "K2 backward dx": "lora"}
# the program's kernels, by the start of their function names
NAMES = (("lora_", "lora"), ("flash_fwd_", "attention"), ("ssd_scan_", "ssd"))
# the library's matrix products, by parts of their lower-cased names
GEMM = ("gemm", "gemv", "cublas", "cutlass", "xmma", "nvjet", "splitkreduce")
CLASSES = ("moe", "attention", "ssd", "lora", "gemm", "elementwise")


def base_name(name: str) -> str:
    """A kernel's function name alone: "void (anonymous namespace)::
    lora_prefill_kernel<16>(...)" -> "lora_prefill_kernel"."""
    n = name.replace("(anonymous namespace)::", "")
    n = n[5:] if n.startswith("void ") else n
    return re.split(r"[<(]", n, maxsplit=1)[0].rsplit("::", 1)[-1]


def classify(name: str, rng) -> str:
    if rng is not None:
        return RANGES[rng]
    base = base_name(name)
    for prefix, cls in NAMES:
        if base.startswith(prefix):
            return cls
    low = name.lower()
    if any(w in low for w in GEMM):
        return "gemm"
    return "elementwise"


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(kernels, spans, host, steps: int) -> dict:
    """``kernels``: (start ns, end ns, name) of device activities;
    ``spans``: (start ns, end ns, range name) of the program's ranges on
    the device; ``host``: (start ns, end ns, name) of host-side events,
    the STEP_RANGE ones among them. -> the summary (seconds)."""
    counted = sum(n == STEP_RANGE for _, _, n in host)
    if counted != steps:
        raise ValueError(f"{counted} traced steps, expected {steps}")
    (w0, w1), = [(a, b) for a, b, n in host if n == WINDOW_RANGE]
    kernels = [k for k in kernels if k[0] >= w0 and k[1] <= w1]
    spans = sorted(s for s in spans if s[2] in RANGES)
    starts = [a for a, _, _ in spans]
    class_s = dict.fromkeys(CLASSES, 0.0)
    by_name, named, launches = {}, {}, {}
    for a, b, name in kernels:
        i = bisect.bisect_right(starts, a) - 1
        rng = spans[i][2] if i >= 0 and b <= spans[i][1] else None
        class_s[classify(name, rng)] += (b - a) / 1e9
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
        for prefix, _ in NAMES:
            if base_name(name).startswith(prefix):
                key = f"{prefix}|{rng or ''}"
                named[key] = named.get(key, 0) + 1
    for a, b, name in spans:
        if w0 <= a and b <= w1:
            launches[name] = launches.get(name, 0) + 1
    busy = _union((a, b) for a, b, _ in kernels)
    busy_s = sum(b - a for a, b in busy) / 1e9
    return {"steps": steps, "window_s": (w1 - w0) / 1e9, "busy_s": busy_s,
            "class_s": class_s,
            "named": named, "range_spans": launches,
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
            "idle_gaps": _gaps(busy, host, w0, w1)}


def _gaps(busy, host, w0, w1, top: int = 10, named: int = 500) -> list:
    """The window's idle device time summed by the innermost host event
    running at each gap's middle, longest first; the ``named`` longest
    gaps are looked up, the rest summed as short gaps."""
    events = sorted((a, b, n) for a, b, n in host
                    if n not in (STEP_RANGE, WINDOW_RANGE))
    starts = [a for a, _, _ in events]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((b - a, a, b) for a, b in zip(edges[::2], edges[1::2])
                   if b > a), reverse=True)
    out = {}
    if len(gaps) > named:
        out["(shorter gaps)"] = sum(g for g, _, _ in gaps[named:]) / 1e9
    for _, a, b in gaps[:named]:
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid)
        best = None
        for j in range(i - 1, max(i - 400, 0) - 1, -1):
            s, e, n = events[j]
            if e >= mid and (best is None or e - s < best[1] - best[0]):
                best = (s, e, n)
        name = best[2] if best else "(no host event)"
        out[name] = out.get(name, 0.0) + (b - a) / 1e9
    return sorted(out.items(), key=lambda kv: -kv[1])[:top]


def read_profile(prof, steps: int) -> dict:
    """The summary of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    kernels, spans, host = [], [], []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() != DeviceType.CUDA:
            host.append((a, b, e.name()))
        elif e.is_user_annotation():
            spans.append((a, b, e.name()))
        elif e.duration_ns() > 0:
            kernels.append((a, b, e.name()))
    return summarize(kernels, spans, host, steps)
