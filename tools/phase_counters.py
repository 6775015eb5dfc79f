"""Clock64 phase counters in a copy of a kernel source: the parts that
``tools/k3_bwd_phases.py`` and ``tools/k4_bwd_phases.py`` share.

A tool lists its insertion points (``edits``: a line of the source and
what replaces it, built with :func:`start`, :func:`tick` and
:func:`flush`); :func:`build` adds the ``__device__`` array
``g_phases[3][8]`` and the C entries ``phases_read`` / ``phases_clear``,
applies the edits, compiles the copy with ``build.NVCC_FLAGS`` into
``build/<name>/`` and loads it. :func:`count` runs a launch once to warm
up, then once with the counters cleared, and returns the sums;
:func:`print_rows` prints each kernel's mean cycles a step of each phase,
and :func:`event_us` an instrumented launch's time by CUDA events."""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SLOTS = 8   # counters a kernel kind: its phases, then its step count last

_COMMON = [
    ("constexpr unsigned kFull = 0xffffffffu;\n",
     "constexpr unsigned kFull = 0xffffffffu;\n"
     f"__device__ unsigned long long g_phases[3][{SLOTS}];\n"),
    ('extern "C" {\n',
     'extern "C" {\n'
     "int phases_read(unsigned long long* out) {\n"
     "  return (int)cudaMemcpyFromSymbol(out, g_phases, sizeof(g_phases));\n"
     "}\n"
     "int phases_clear() {\n"
     f"  unsigned long long z[3][{SLOTS}] = {{}};\n"
     "  return (int)cudaMemcpyToSymbol(g_phases, z, sizeof(z));\n"
     "}\n"),
]


def start() -> str:
    """The counters of a walk over steps: before its loop."""
    return (f"unsigned long long pc[{SLOTS}] = {{}};\n"
            "long long tp = clock64();\n")


def tick(i: int) -> str:
    """Phase i ends here: the cycles since the last tick go to pc[i]."""
    return f"{{ long long x = clock64(); pc[{i}] += x - tp; tp = x; }}\n"


def step() -> str:
    """A step ends here (counted in the last slot)."""
    return f"pc[{SLOTS - 1}] += 1;\n"


def flush(kind: int | str, lead: str) -> str:
    """After the loop: the thread ``lead`` names adds its counters to kernel
    kind ``kind``'s row."""
    return (f"if ({lead}) {{ for (int i = 0; i < {SLOTS}; ++i) "
            f"atomicAdd(&g_phases[{kind}][i], pc[i]); }}\n")


def instrumented(src: str, edits, name: str) -> str:
    """The source with the shared entries and the tool's edits; raises if a
    line an edit follows is not in the source exactly once."""
    for old, new in _COMMON + list(edits):
        if src.count(old) != 1:
            raise RuntimeError(f"{name} no longer has the line the counters "
                               f"follow: {old!r}")
        src = src.replace(old, new)
    return src


def build(source: str, edits, out: str):
    """Writes the instrumented copy of ``csrc/<source>`` to
    ``build/<out>/``, compiles and loads it."""
    from repro_torch.kernels import build as _build

    out_dir = ROOT / "build" / out
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = source.removesuffix(".cu") + "_phases"
    copy = out_dir / f"{stem}.cu"
    copy.write_text(instrumented((_build.CSRC / source).read_text(), edits,
                                 source))
    lib_path = out_dir / f"{stem}.so"
    subprocess.run([_build._nvcc("the phase counters"), *_build.NVCC_FLAGS,
                    "-I", str(_build.CSRC), "-o", str(lib_path), str(copy)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib_path))


def entry(lib, name: str, signatures: dict):
    """The C entry ``name`` with its ctypes signature from a wrapper's
    table."""
    fn = getattr(lib, name)
    fn.argtypes = signatures[name][0]
    fn.restype = ctypes.c_int
    return fn


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def count(lib, launch) -> list:
    """The counters' sums over one launch (after a warm-up launch)."""
    import torch

    counts = (ctypes.c_ulonglong * (3 * SLOTS))()
    launch()
    torch.cuda.synchronize()
    lib.phases_clear()
    launch()
    torch.cuda.synchronize()
    lib.phases_read(counts)
    return list(counts)


def print_rows(label: str, counts: list, kernels: dict, unit: str) -> None:
    """For kernel kind k (``kernels``' k-th entry: its name and its phases)
    the mean cycles a ``unit`` of each phase and their total."""
    for kind, (kernel, phases) in enumerate(kernels.items()):
        row = counts[SLOTS * kind: SLOTS * (kind + 1)]
        steps = row[-1]
        print(f"{label} {kernel}: {steps} {unit}s; cycles a {unit}: "
              + ", ".join(f"{ph} {row[i] / steps:.0f}"
                          for i, ph in enumerate(phases))
              + f"; total {sum(row[:len(phases)]) / steps:.0f}")


def event_us(launch, reps: int = 10) -> float:
    """Microseconds a launch by CUDA events, the mean of ``reps``."""
    import torch

    start_ev, stop_ev = (torch.cuda.Event(enable_timing=True)
                         for _ in range(2))
    start_ev.record()
    for _ in range(reps):
        launch()
    stop_ev.record()
    stop_ev.synchronize()
    return start_ev.elapsed_time(stop_ev) / reps * 1e3
