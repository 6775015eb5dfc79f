"""Where a step of K3's bf16 backward spends its cycles, on the card.

Writes a copy of ``csrc/flash_attention_bwd.cu`` whose three bf16 kernels
read ``clock64()`` at the phases of each walked tile (the step's top: the
stage's mbarrier wait, the barrier and the next tile's TMA; S and dP by
wgmma and their wait; the elementwise work; dV and dK or dQ by wgmma and
their wait), sums them over each block's tiles and thread 0 of every block
into a ``__device__`` array, builds it with ``build.NVCC_FLAGS`` into
``build/k3_bwd_phases/`` and launches it (as ``flash_attention_backward``
would) at llama2-7b's and zamba2-2.7b's training shapes, causal, bf16.
It times the ``repro_torch`` that ``PYTHONPATH`` names:

    PYTHONPATH=src python3 tools/k3_bwd_phases.py

Prints the card (``nvidia-smi``'s name and power limit) and, for each
shape and kernel, the mean cycles a tile of each phase (thread 0's clock,
with two blocks an SM sharing the tensor cores), then the instrumented
launch's time by CUDA events. The counters are inserted at fixed lines of
the source: the script raises if the source no longer has them."""
from __future__ import annotations

import ctypes
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "k3_bwd_phases"
PHASES = ("top", "S, dP wgmma + wait", "elementwise", "dV, dK / dQ wgmma + wait")
SHAPES = {"llama2-7b": (256, 1024, 128), "zamba2-2.7b": (256, 1024, 80)}


def _tick(i: int) -> str:
    return f"{{ long long x = clock64(); pc[{i}] += x - tp; tp = x; }}\n"


def _flush(kind: str) -> str:
    return ("  if (threadIdx.x == 0) {\n"
            "    for (int i = 0; i < 5; ++i) "
            f"atomicAdd(&g_phases[{kind}][i], pc[i]);\n"
            "  }\n")


def instrumented(src: str) -> str:
    """The source with the phase counters and their two C entry points."""
    edits = [
        ("constexpr unsigned kFull = 0xffffffffu;\n",
         "constexpr unsigned kFull = 0xffffffffu;\n"
         "__device__ unsigned long long g_phases[3][8];\n"),
        ('extern "C" {\n',
         'extern "C" {\n'
         "int phases_read(unsigned long long* out) {\n"
         "  return (int)cudaMemcpyFromSymbol(out, g_phases, sizeof(g_phases));\n"
         "}\n"
         "int phases_clear() {\n"
         "  unsigned long long z[3][8] = {};\n"
         "  return (int)cudaMemcpyToSymbol(g_phases, z, sizeof(z));\n"
         "}\n"),
    ]
    start = "  unsigned long long pc[5] = {0, 0, 0, 0, 0};\n  long long tp = clock64();\n"
    q_loop = ("  for (int kt = kt_begin; kt < kt_end; ++kt) {\n"
              "    const int buf = (kt - kt_begin) % kStages;\n")
    kv_loop = ("  for (int qt = qt_begin; qt < qt_end; ++qt) {\n"
               "    const int buf = (qt - qt_begin) % kStages;\n")
    edits += [
        (q_loop, start + q_loop),
        ("    const uint32_t k_a = tc::smem_addr(ks + buf * T::kBytes);\n",
         "    " + _tick(0) +
         "    const uint32_t k_a = tc::smem_addr(ks + buf * T::kBytes);\n"),
        ("    hold(s);\n    hold(dp);\n\n    // element 4 j + e: row h",
         "    hold(s);\n    hold(dp);\n    " + _tick(1) +
         "\n    // element 4 j + e: row h"),
        ("    if constexpr (kDq) {\n      // dq += dS k",
         "    " + _tick(2) + "    if constexpr (kDq) {\n      // dq += dS k"),
        ("      hold(hi);\n      hold(lo);\n    }\n  }\n",
         "      hold(hi);\n      hold(lo);\n    }\n    " + _tick(3) +
         "    pc[4] += 1;\n  }\n" + _flush("kDq ? 1 : 0")),
        (kv_loop, start + kv_loop),
        ("    const uint32_t q_a = tc::smem_addr(qs + buf * T::kBytes);\n",
         "    " + _tick(0) +
         "    const uint32_t q_a = tc::smem_addr(qs + buf * T::kBytes);\n"),
        ("    hold(s);\n    hold(dp);\n\n    // element 4 j + e: key h",
         "    hold(s);\n    hold(dp);\n    " + _tick(1) +
         "\n    // element 4 j + e: key h"),
        ("    uint32_t ph[4][4], pl[4][4];\n",
         "    " + _tick(2) + "    uint32_t ph[4][4], pl[4][4];\n"),
        ("    hold(sh);\n    hold(sl);\n  }\n",
         "    hold(sh);\n    hold(sl);\n    " + _tick(3) +
         "    pc[4] += 1;\n  }\n" + _flush("2")),
    ]
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"flash_attention_bwd.cu no longer has the "
                               f"line the counters follow: {old!r}")
        src = src.replace(old, new)
    return src


def main() -> int:
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as k3

    OUT.mkdir(parents=True, exist_ok=True)
    source = OUT / "flash_attention_bwd_phases.cu"
    source.write_text(instrumented((build.CSRC / k3.BACKWARD_SOURCE)
                                   .read_text()))
    lib_path = OUT / "flash_attention_bwd_phases.so"
    subprocess.run([build._nvcc("the phase counters"), *build.NVCC_FLAGS,
                    "-I", str(build.CSRC), "-o", str(lib_path), str(source)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    launch = lib.flash_attention_bwd_launch
    launch.argtypes = k3._BACKWARD_SIGNATURES["flash_attention_bwd_launch"][0]
    launch.restype = ctypes.c_int
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    counts = (ctypes.c_ulonglong * 24)()
    for arch, (bh, s, d) in SHAPES.items():
        q, k, v, do = (torch.randn(bh, s, d, device="cuda", generator=gen)
                       .bfloat16() for _ in range(4))
        _, m, l = k3.flash_attention(q, k, v, stats=True)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        dsum = torch.empty((bh, s), dtype=torch.float32, device="cuda")

        def run():
            rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        do.data_ptr(), m.data_ptr(), l.data_ptr(),
                        dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                        dv.data_ptr(), bh, s, s, d, 1, 0,
                        1.0 / math.sqrt(d), 1, None, None,
                        torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"launch failed ({rc})")

        run()
        torch.cuda.synchronize()
        lib.phases_clear()
        run()
        torch.cuda.synchronize()
        lib.phases_read(counts)
        for kind, name in enumerate(("rowdot", "dq", "dkdv")):
            row = counts[8 * kind: 8 * kind + 5]
            tiles = row[4]
            print(f"{arch} (BH, S, D) = {(bh, s, d)} {name}: {tiles} tiles; "
                  "cycles a tile: " + ", ".join(
                      f"{p} {row[i] / tiles:.0f}"
                      for i, p in enumerate(PHASES))
                  + f"; total {sum(row[:4]) / tiles:.0f}")
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        for _ in range(10):
            run()
        stop.record()
        stop.synchronize()
        print(f"{arch}: {start.elapsed_time(stop) / 10 * 1e3:.1f} us a "
              "launch, instrumented, by CUDA events")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    sys.exit(main())
