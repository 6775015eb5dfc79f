"""Reads the program's own profiler ranges out of a ``--trace 1`` run's
profile, beside ``trace.py``'s summary, for the per-layer metrics that
name a stage of the step (the port's ranges: ``repro_torch/obs/ranges``,
the MoE layer's four and the kernels' own, each stage's backward half
named ``<stage> backward``):

- device seconds by each kernel's innermost program range: the shortest
  device-side span of a range that holds it (a range's device span runs
  from the first to the last kernel launched inside it, so an outer
  range's span may hold an inner range's kernels, never the reverse);
  a kernel in no program range counts under NONE;
- each range's count and its device spans' seconds in the window;
- the idle seconds of every gap between device activities in the window,
  by the program ranges that any host thread was inside at the gap's
  middle: under the innermost (shortest) of them, and under the set of
  them all.

Every program range is a user range of the profile but the benchmark's
own (``trace.STEP_RANGE``, ``trace.WINDOW_RANGE``); the program counts its
steps with STEP. The harness hands a metric's reader the summary alone:
:func:`of` finds the window's profile among the live objects (the
``torch.profiler.profile`` whose window range lasts the summary's
``window_s``) and keeps what it read in the summary.
"""
from __future__ import annotations

import gc
import sys

from port_bench import trace

STEP = "train step"
NONE = "(no program range)"
KEY = "program_ranges"


def _innermost(items, ranges) -> list:
    """For each (start, end, ...) of ``items`` (sorted), the name of the
    shortest of ``ranges`` (start, end, name) that holds it, or None."""
    ranges = sorted(ranges)
    out, active, i = [], [], 0
    for a, b, *_ in items:
        while i < len(ranges) and ranges[i][0] <= a:
            active.append(ranges[i])
            i += 1
        active = [r for r in active if r[1] >= a]
        holding = [r for r in active if r[1] >= b]
        out.append(min(holding, key=lambda r: r[1] - r[0])[2]
                   if holding else None)
    return out


def _within(points, ranges) -> list:
    """For each point (sorted), the (innermost name, every name) of
    ``ranges`` holding it."""
    ranges = sorted(ranges)
    out, active, i = [], [], 0
    for x in points:
        while i < len(ranges) and ranges[i][0] <= x:
            active.append(ranges[i])
            i += 1
        active = [r for r in active if r[1] >= x]
        inner = (min(active, key=lambda r: r[1] - r[0])[2] if active
                 else NONE)
        out.append((inner, frozenset(r[2] for r in active)))
    return out


def summarize(kernels, spans, host, window) -> dict:
    """``kernels``: (start ns, end ns, name) of device activities;
    ``spans``: (start ns, end ns, name) of user ranges on the device;
    ``host``: (start ns, end ns, name) of user ranges on the host, every
    thread's; ``window``: (start ns, end ns) -> the program ranges'
    summary (seconds)."""
    w0, w1 = window
    mine = (trace.STEP_RANGE, trace.WINDOW_RANGE)
    kernels = sorted(k for k in kernels if w0 <= k[0] and k[1] <= w1)
    spans = [s for s in spans if s[2] not in mine]
    host = [h for h in host if h[2] not in mine]
    device_s, span_s, counts, unranged = {}, {}, {}, {}
    for (a, b, kernel), name in zip(kernels, _innermost(kernels, spans)):
        if name is None:
            name = NONE
            unranged[kernel] = unranged.get(kernel, 0.0) + (b - a) / 1e9
        device_s[name] = device_s.get(name, 0.0) + (b - a) / 1e9
    for a, b, name in spans:
        if w0 <= a and b <= w1:
            span_s[name] = span_s.get(name, 0.0) + (b - a) / 1e9
    for a, b, name in host:
        if w0 <= a and b <= w1:
            counts[name] = counts.get(name, 0) + 1
    busy = trace._union((a, b) for a, b, _ in kernels)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    idle_s, idle_within = {}, {}
    for (a, b), (inner, names) in zip(
            gaps, _within([(a + b) / 2 for a, b in gaps], host)):
        idle_s[inner] = idle_s.get(inner, 0.0) + (b - a) / 1e9
        idle_within[names] = idle_within.get(names, 0.0) + (b - a) / 1e9
    return {"steps": counts.get(STEP, 0), "window_s": (w1 - w0) / 1e9,
            "counts": counts,
            "busy_s": sum(b - a for a, b in busy) / 1e9,
            "device_s": device_s, "span_s": span_s, "idle_s": idle_s,
            "idle_within": idle_within,
            "unranged": sorted(unranged.items(), key=lambda kv: -kv[1])[:5]}


def read_profile(prof):
    """The summary of a finished ``torch.profiler.profile``, or None
    where it holds no window range."""
    from torch.autograd import DeviceType

    kernels, spans, host, window = [], [], [], None
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() != DeviceType.CUDA:
            if e.name() == trace.WINDOW_RANGE:
                window = (a, b)
            elif e.is_user_annotation():
                host.append((a, b, e.name()))
        elif e.is_user_annotation():
            spans.append((a, b, e.name()))
        elif e.duration_ns() > 0:
            kernels.append((a, b, e.name()))
    return None if window is None else summarize(kernels, spans, host,
                                                 window)


def _window_profile(window_s: float):
    """The summary of the live profile whose window lasts ``window_s``."""
    from torch.profiler import profile

    for obj in gc.get_objects():
        if (isinstance(obj, profile) and obj.profiler is not None
                and getattr(obj.profiler, "kineto_results", None)):
            r = read_profile(obj)
            if r is not None and abs(r["window_s"] - window_s) < 1e-9:
                return r
    return None


def device_in(r: dict, names) -> float:
    """Device seconds of the kernels whose innermost program range is one
    of ``names``."""
    return sum(r["device_s"].get(n, 0.0) for n in names)


def idle_in(r: dict, names) -> float:
    """Idle seconds while a host thread was inside one of ``names``."""
    return sum(v for k, v in r["idle_within"].items() if k & set(names))


def halves(*names) -> tuple:
    """Each stage's name and its backward half's."""
    return tuple(n for name in names for n in (name, f"{name} backward"))


def _report(r: dict, steps: int) -> None:
    def per_step(d):
        return ", ".join(f"{k} {1e3 * v / steps:.3f}" for k, v in
                         sorted(d.items(), key=lambda kv: -kv[1]))

    print(f"port_bench: device ms a step by program range: "
          f"{per_step(r['device_s'])}", file=sys.stderr)
    print(f"port_bench: idle ms a step by program range: "
          f"{per_step(r['idle_s'])}", file=sys.stderr)
    if r["busy_s"]:
        share = {n: 100 * r["device_s"].get(n, 0.0) / r["busy_s"]
                 for n in (STEP, NONE)}
        print(f"port_bench: of busy, kernels in '{STEP}' and no other "
              f"program range {share[STEP]:.2f}%, in none {share[NONE]:.2f}"
              "% (the harness's among them; the longest: " + "; ".join(
                  f"{k[:80]} {1e3 * v / steps:.3f} ms" for k, v in
                  r["unranged"]) + ")", file=sys.stderr)


def of(s: dict, who: str):
    """The program ranges' summary of the window ``s`` summarizes, or None
    (printed why) where the profile holds another count of the program's
    steps than the window's, or none."""
    if KEY not in s:
        s[KEY] = _window_profile(s["window_s"])
        if s[KEY] is not None:
            _report(s[KEY], s["steps"])
    r = s[KEY]
    if r is None:
        print(f"{who}: no profile of the window found: not read",
              file=sys.stderr)
        return None
    if r["steps"] != s["steps"]:
        print(f"{who}: {r['steps']} '{STEP}' ranges in the window of "
              f"{s['steps']} steps: not read", file=sys.stderr)
        return None
    return r
