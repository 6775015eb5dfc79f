"""The program ranges' reader (``ranges.py``) and the metrics that read it,
on canned profiles, and on a traced run of the CPU stand-ins."""
import json
import os
import subprocess
import sys

import pytest

from port_bench import catalog, ranges, trace

US = 1000       # ns
READERS = ("ssm_mixer_ms_per_step", "moe_backward_ms_per_step",
           "head_loss_ms_per_step", "optimizer_ms_per_step",
           "layer_idle_ms_per_step")


def _canned(steps=1):
    """(kernels, spans, host, window) of ``steps`` steps, each 100 us: a
    block (a norm, the mixer's conv inside the mixer, a residual add) on
    the main thread, its backward half on another, the head and loss, the
    optimizer, and a memset after the program's step; idle gaps between
    them."""
    kernels, spans, host = [], [], []
    for i in range(steps):
        t = i * 100

        def k(a, b, name="k"):
            kernels.append(((t + a) * US, (t + b) * US, name))

        def span(a, b, name):
            spans.append(((t + a) * US, (t + b) * US, name))

        def rng(a, b, name):          # any thread's
            host.append(((t + a) * US, (t + b) * US, name))

        rng(0, 100, trace.STEP_RANGE)
        rng(1.5, 95.5, ranges.STEP)
        span(2, 92, ranges.STEP)
        k(2, 4)                                   # the step's own
        rng(4.5, 35, "block")
        span(6, 30, "block")                      # its add, its children
        k(6, 7)
        rng(10, 12, "norm")
        span(10, 12, "norm")
        k(10, 12)
        rng(13, 29, "ssm mixer")
        span(13, 28, "ssm mixer")
        k(13, 14)
        k(27, 28)
        rng(15, 25.5, "ssm conv")
        span(15, 25, "ssm conv")
        k(15, 25)
        k(29, 30)                                 # the residual add
        rng(31, 37, "head")
        span(31, 36, "head")
        k(31, 36)
        rng(39, 42, "loss")
        span(39, 42, "loss")
        k(39, 42)
        rng(43, 75, "block backward")     # the backward's thread
        span(43, 75, "block backward")
        k(43, 50)
        rng(51, 57, "ssm conv backward")
        span(51, 57, "ssm conv backward")
        k(51, 57)
        k(60, 75)
        rng(76, 80, "moe experts backward")
        span(76, 80, "moe experts backward")
        k(76, 80)
        rng(81.5, 93, "optim")
        span(82, 92, "optim")
        k(82, 86)
        k(90, 92)
        k(96, 98, "Memset (Device)")              # after the program's step
    window = (0, steps * 100 * US)
    host.append((*window, trace.WINDOW_RANGE))
    return kernels, spans, host, window


def _summary(steps=1, counted=None):
    r = ranges.summarize(*_canned(steps))
    return {"steps": steps if counted is None else counted,
            "window_s": r["window_s"], ranges.KEY: r}


def test_each_kernel_takes_its_innermost_range():
    r = _summary()[ranges.KEY]
    ms = {k: round(1e3 * v, 6) for k, v in r["device_s"].items()}
    assert ms == {ranges.STEP: 0.002, "block": 0.002, "norm": 0.002,
                  "ssm mixer": 0.002, "ssm conv": 0.010, "head": 0.005,
                  "loss": 0.003, "block backward": 0.022,
                  "ssm conv backward": 0.006, "moe experts backward": 0.004,
                  "optim": 0.006, ranges.NONE: 0.002}
    assert r["counts"]["block"] == 1 and r["counts"][ranges.STEP] == 1
    assert r["span_s"]["optim"] == pytest.approx(10e-6)
    assert r["busy_s"] == pytest.approx(sum(r["device_s"].values()))


def test_idle_is_charged_to_the_ranges_any_thread_was_inside():
    r = _summary()[ranges.KEY]
    idle = {k: round(1e3 * v, 6) for k, v in r["idle_s"].items()}
    # the gaps (us) by their middles: 0-2 and 98-100 outside the step;
    # 4-6, 7-10, 12-13, 30-31 in the block; 14-15, 25-27 (the conv ended
    # at 25.5), 28-29 in the mixer; 50-51, 57-60 in the block's backward
    # half, which the main thread (in the step) waits for; 36-39, 42-43,
    # 75-76, 80-82, 92-96 in the step alone; 86-90 in the optimizer
    assert idle == {ranges.NONE: 0.004, "block": 0.007, "ssm mixer": 0.004,
                    "block backward": 0.004, ranges.STEP: 0.011,
                    "optim": 0.004}
    assert 1e3 * ranges.idle_in(r, ranges.halves("block")) == \
        pytest.approx(0.007 + 0.004 + 0.004)


def test_the_readers_on_a_canned_window():
    s = _summary(steps=2)
    read = {m: catalog.metric(m).read(s) for m in READERS}
    assert read == pytest.approx({
        "ssm_mixer_ms_per_step": 0.002 + 0.010 + 0.006,
        "moe_backward_ms_per_step": 0.004,
        "head_loss_ms_per_step": 0.008,
        "optimizer_ms_per_step": 0.010,
        "layer_idle_ms_per_step": 0.015})


def test_a_reader_is_silent_on_another_step_count(capsys):
    s = _summary(steps=2, counted=3)
    assert all(catalog.metric(m).read(s) is None for m in READERS)
    assert "2 'train step' ranges in the window of 3 steps" in \
        capsys.readouterr().err


def test_a_reader_is_silent_without_the_program_ranges(capsys):
    kernels, spans, host, window = _canned()
    host = [h for h in host if h[2] != ranges.STEP]
    r = ranges.summarize(kernels, spans, host, window)
    s = {"steps": 1, "window_s": r["window_s"], ranges.KEY: r}
    assert all(catalog.metric(m).read(s) is None for m in READERS)
    s = {"steps": 1, "window_s": 1.0, ranges.KEY: None}
    assert catalog.metric(READERS[0]).read(s) is None
    assert "no profile of the window" in capsys.readouterr().err


def test_the_harness_summary_takes_no_program_range_as_a_class():
    """trace.RANGES holds none of the program's new ranges: trace.py
    classes each kernel as it did."""
    kernels, spans, host, window = _canned()
    s = trace.summarize(kernels, spans, host, steps=1)
    assert s["class_s"]["moe"] == pytest.approx(0)
    assert s["range_spans"] == {}


_RUN = """
import json, sys, tempfile
from port_bench import run, testing
root = tempfile.mkdtemp()
bench = testing.make_catalog(root, metrics=tuple(sys.argv[2:]))
rc = run.main(["--workload", sys.argv[1], "--seed", "3000007919",
               "--seconds", "0.1", "--trace", "1"], bench=bench, root=root,
              device="cpu")
print(json.dumps({"rc": rc}))
"""


@pytest.mark.parametrize("workload", ["tiny.moe", "tiny.ssm"])
def test_a_traced_run_reads_the_program_ranges(workload):
    """On the CPU the profile holds no device activity: each reader finds
    the window's profile and the program's steps, and reads no device
    time (the window is one idle gap, charged where the host was at its
    middle)."""
    root = catalog.ROOT.parent
    out = subprocess.run(
        [sys.executable, "-c", _RUN, workload, *READERS], cwd=root,
        env=dict(os.environ, PYTHONPATH=str(root)), capture_output=True,
        text=True, timeout=600, check=True)
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {"rc": 0}
    read = {m: v["value"] for m, v in json.loads(lines[-2])["metrics"].items()}
    idle = read.pop("layer_idle_ms_per_step")
    assert read == dict.fromkeys(READERS[:-1], 0.0)
    assert isinstance(idle, float) and idle >= 0
    assert "device ms a step by program range" in out.stderr
