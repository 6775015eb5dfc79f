"""Where a step of K3's bf16 backward spends its cycles, on the card.

Writes a copy of ``csrc/flash_attention_bwd.cu`` whose three bf16 kernels
read ``clock64()`` at the phases of each walked tile (the step's top: the
stage's mbarrier wait, the barrier and the next tile's TMA; S and dP by
wgmma and their wait; the elementwise work; dV and dK or dQ by wgmma and
their wait), sums them over each block's tiles and thread 0 of every block
into a ``__device__`` array, builds it with ``build.NVCC_FLAGS`` into
``build/k3_bwd_phases/`` (``tools/phase_counters.py``) and launches it
(as ``flash_attention_backward`` would) at llama2-7b's and zamba2-2.7b's
training shapes, causal, bf16.
It times the ``repro_torch`` that ``PYTHONPATH`` names:

    PYTHONPATH=src python3 tools/k3_bwd_phases.py

Prints the card (``nvidia-smi``'s name and power limit) and, for each
shape and kernel, the mean cycles a tile of each phase (thread 0's clock,
with two blocks an SM sharing the tensor cores), then the instrumented
launch's time by CUDA events. The counters are inserted at fixed lines of
the source: the script raises if the source no longer has them."""
from __future__ import annotations

import math
import sys
from pathlib import Path

import phase_counters as pcs
from phase_counters import flush, start, step, tick

ROOT = Path(__file__).resolve().parents[1]
KERNELS = {name: ("top", "S, dP wgmma + wait", "elementwise",
                  "dV, dK / dQ wgmma + wait")
           for name in ("rowdot", "dq", "dkdv")}
SHAPES = {"llama2-7b": (256, 1024, 128), "zamba2-2.7b": (256, 1024, 80)}


def edits() -> list:
    """Where the counters go in flash_attention_bwd.cu."""
    q_loop = ("  for (int kt = kt_begin; kt < kt_end; ++kt) {\n"
              "    const int buf = (kt - kt_begin) % kStages;\n")
    kv_loop = ("  for (int qt = qt_begin; qt < qt_end; ++qt) {\n"
               "    const int buf = (qt - qt_begin) % kStages;\n")
    return [
        (q_loop, start() + q_loop),
        ("    const uint32_t k_a = tc::smem_addr(ks + buf * T::kBytes);\n",
         "    " + tick(0) +
         "    const uint32_t k_a = tc::smem_addr(ks + buf * T::kBytes);\n"),
        ("    hold(s);\n    hold(dp);\n\n    // element 4 j + e: row h",
         "    hold(s);\n    hold(dp);\n    " + tick(1) +
         "\n    // element 4 j + e: row h"),
        ("    if constexpr (kDq) {\n      // dq += dS k",
         "    " + tick(2) + "    if constexpr (kDq) {\n      // dq += dS k"),
        ("      hold(hi);\n      hold(lo);\n    }\n  }\n",
         "      hold(hi);\n      hold(lo);\n    }\n    " + tick(3) + step()
         + "  }\n" + flush("kDq ? 1 : 0", "threadIdx.x == 0")),
        (kv_loop, start() + kv_loop),
        ("    const uint32_t q_a = tc::smem_addr(qs + buf * T::kBytes);\n",
         "    " + tick(0) +
         "    const uint32_t q_a = tc::smem_addr(qs + buf * T::kBytes);\n"),
        ("    hold(s);\n    hold(dp);\n\n    // element 4 j + e: key h",
         "    hold(s);\n    hold(dp);\n    " + tick(1) +
         "\n    // element 4 j + e: key h"),
        ("    uint32_t ph[4][4], pl[4][4];\n",
         "    " + tick(2) + "    uint32_t ph[4][4], pl[4][4];\n"),
        ("    hold(sh);\n    hold(sl);\n  }\n",
         "    hold(sh);\n    hold(sl);\n    " + tick(3) + step() + "  }\n"
         + flush(2, "threadIdx.x == 0")),
    ]


def main() -> int:
    import torch

    from repro_torch.kernels import flash_attention as k3

    lib = pcs.build(k3.BACKWARD_SOURCE, edits(), "k3_bwd_phases")
    launch = pcs.entry(lib, "flash_attention_bwd_launch",
                       k3._BACKWARD_SIGNATURES)
    print(f"card: {pcs.card()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
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

        pcs.print_rows(f"{arch} (BH, S, D) = {(bh, s, d)}",
                       pcs.count(lib, run), KERNELS, "tile")
        print(f"{arch}: {pcs.event_us(run):.1f} us a launch, instrumented, "
              "by CUDA events")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    sys.exit(main())
