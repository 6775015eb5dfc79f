"""Where K4's bf16 backward spends its cycles, on the card.

Writes a copy of ``csrc/ssd_scan_bwd.cu`` whose bf16 kernels read
``clock64()`` at the phases of each step: in the states kernel (a chunk of
its scan) the state's staging, the top (scalars, the stage's mbarrier wait,
the barrier), the weighted rows' hi + lo halves, the update (E scaling,
wgmma and its wait) and the bottom (barrier, the next chunk's TMA); in the
gradient kernel (a head of its run) warpgroup 0's top, S^T and Q^T,
elementwise work, dx's products with d k, the dx store and the wait for
warpgroup 1, and warp 0's reverse sum, and warpgroup 1's top, its
products with d e, <G, H> and its wait. Thread 0 of each warpgroup sums
its block's steps into a ``__device__`` array. The copy is built with
``build.NVCC_FLAGS`` into ``build/k4_bwd_phases/``
(``tools/phase_counters.py``) and launched (as
``ssd_scan_grouped_backward`` would) at mamba2-370m's and zamba2-2.7b's
training shapes, bf16. It times the ``repro_torch`` that ``PYTHONPATH``
names:

    PYTHONPATH=src python3 tools/k4_bwd_phases.py

Prints the card (``nvidia-smi``'s name and power limit) and, for each
shape and kernel, the mean cycles a step of each phase (thread 0's clock,
with the other blocks of its SM sharing it), then the instrumented
launch's time by CUDA events, then each kernel's device time in a launch
of the uninstrumented ``ssd_scan_grouped_backward`` (``torch.profiler``,
the mean of 5 launches) with the gradient kernel's grid at each target of
``WAVES`` blocks an SM (``ssd_scan.RUN_WAVES``). The counters are inserted
at fixed lines of the source: the script raises if the source no longer
has them."""
from __future__ import annotations

import sys
from pathlib import Path

import phase_counters as pcs
from phase_counters import flush, start, step, tick

ROOT = Path(__file__).resolve().parents[1]
KERNELS = {
    "states": ("staging", "top", "hi + lo halves", "update (wgmma + wait)",
               "bottom"),
    "gradient, warpgroup 0": ("top", "S^T, Q^T", "elementwise",
                              "dx products, d k", "dx store, wait",
                              "reverse sum"),
    "gradient, warpgroup 1": ("top", "x G^T, dy H^T, d e", "<G, H>", "wait"),
}
SHAPES = {"mamba2-370m": (8, 2048, 32, 64, 1, 128),
          "zamba2-2.7b": (8, 1024, 80, 64, 1, 64)}
WAVES = (2, 3)   # the gradient kernel's grid targets timed, blocks an SM


def edits() -> list:
    """Where the counters go in ssd_scan_bwd.cu."""
    return [
        # the states kernel
        ("  for (int q = 0; q < nc; ++q) {\n    const int c = chunk_of(q);\n",
         start() +
         "  for (int q = 0; q < nc; ++q) {\n    const int c = chunk_of(q);\n"),
        ("    hop::fence_proxy_async();\n    if (q == steps) {\n",
         tick(0) + "    hop::fence_proxy_async();\n    if (q == steps) {\n"),
        ("    __syncthreads();  // the chunk's tiles and scalars are in\n",
         "    __syncthreads();  // the chunk's tiles and scalars are in\n"
         + tick(1)),
        ("    __syncthreads();  // the halves are written\n",
         "    __syncthreads();  // the halves are written\n" + tick(2)),
        ("    for (int mt = 0; mt < kNH; ++mt) hop::hold(acc[mt]);\n",
         "    for (int mt = 0; mt < kNH; ++mt) hop::hold(acc[mt]);\n"
         + tick(3)),
        ("    if (tid == 0 && q + 2 < steps) load(q + 2);\n  }\n}\n",
         "    if (tid == 0 && q + 2 < steps) load(q + 2);\n" + tick(4)
         + step() + "  }\n" + flush(0, "tid == 0") + "}\n"),
        # the gradient kernel, warpgroup 0
        ("    for (int q = 0; q < nh; ++q) {\n      const int h = h0 + q, "
         "st = q & 1;\n",
         start() + "    for (int q = 0; q < nh; ++q) {\n      const int h "
         "= h0 + q, st = q & 1;\n"),
        ("      const uint32_t gha = xa + 2 * kBlk, gla = gha + Z::kSt;\n"
         "      if (q == 0) {",
         "      const uint32_t gha = xa + 2 * kBlk, gla = gha + Z::kSt;\n"
         + tick(0) + "      if (q == 0) {"),
        ("      hop::hold(qa);\n", "      hop::hold(qa);\n" + tick(1)),
        ("      hop::split_a(mt, mhi, mlo);\n",
         "      hop::split_a(mt, mhi, mlo);\n" + tick(2)),
        ("      hop::hold(mhi);\n      hop::hold(mlo);\n",
         "      hop::hold(mhi);\n      hop::hold(mlo);\n" + tick(3)),
        ("      named_sync(2);  // every per-step sum of head q is in\n",
         "      named_sync(2);  // every per-step sum of head q is in\n"
         + tick(4)),
        ("* g.heads + h] = part;\n      }\n    }\n",
         "* g.heads + h] = part;\n      }\n" + tick(5) + step() + "    }\n"
         + flush(1, "tid == 0")),
        # the gradient kernel, warpgroup 1
        ("    for (int q = 0; q < nh; ++q) {\n      const int st = q & 1;\n",
         start() +
         "    for (int q = 0; q < nh; ++q) {\n      const int st = q & 1;\n"),
        ("      float dep[2] = {0.0f, 0.0f};\n",
         tick(0) + "      float dep[2] = {0.0f, 0.0f};\n"),
        ("      // <G, H>: the four halves", tick(1)
         + "      // <G, H>: the four halves"),
        ("      named_sync(2);\n    }\n    named_sync(3);",
         tick(2) + "      named_sync(2);\n" + tick(3) + step() + "    }\n"
         + flush(2, "tid == kWg") + "    named_sync(3);"),
    ]


def _kernel_us(torch, k4, args) -> dict:
    """Each kernel's device time in a launch of the uninstrumented
    backward, the mean of 5 launches."""
    k4.ssd_scan_grouped_backward(*args)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            k4.ssd_scan_grouped_backward(*args)
        torch.cuda.synchronize()
    per = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            name = next((k for k in ("states", "grad", "finish")
                         if k in ev.name), ev.name[:40])
            per[name] = per.get(name, 0.0) + ev.device_time / 5
    return per


def main() -> int:
    import torch

    from repro_torch.kernels import ssd_scan as k4

    lib = pcs.build(k4.BACKWARD_SOURCE, edits(), "k4_bwd_phases")
    launch = pcs.entry(lib, "ssd_scan_bwd_bf16_launch",
                       k4._BACKWARD_SIGNATURES)
    print(f"card: {pcs.card()}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    for arch, (bt, s, hh, p, g, n) in SHAPES.items():
        di = hh * p
        xbc = torch.randn((bt, s, di + 2 * g * n), device="cuda",
                          generator=gen).bfloat16()
        x = xbc[..., :di].unflatten(-1, (hh, p))
        B = xbc[..., di:di + g * n].unflatten(-1, (g, n))
        C = xbc[..., di + g * n:].unflatten(-1, (g, n))
        dt = torch.nn.functional.softplus(torch.randn(
            (bt, s, hh), device="cuda", generator=gen)) * 0.5
        A = -torch.exp(torch.randn((hh,), device="cuda", generator=gen)) / 2
        dy = torch.randn((bt, s, hh, p), device="cuda",
                         generator=gen).bfloat16()
        dh = torch.randn((bt, hh, n, p), device="cuda", generator=gen)
        nc = -(-s // 64)
        run, rpg = k4.backward_runs(bt, s, hh, g, sms)
        f32 = dict(dtype=torch.float32, device="cuda")
        dx, dB, dC = (torch.empty_like(t) for t in (x, B, C))
        ddt, dA = torch.empty((bt, s, hh), **f32), torch.empty((hh,), **f32)
        dA_part = torch.empty((bt * nc, hh), **f32)
        parts = torch.empty((2, bt, s, g * rpg, n), **f32)
        states = torch.empty((2, bt, hh, nc, 2, k4.state_rows(n), 64),
                             dtype=torch.bfloat16, device="cuda")

        def run_once():
            rc = launch(x.data_ptr(), *k4._strides3(x), dt.data_ptr(),
                        *k4._strides3(dt), A.data_ptr(), A.stride(0),
                        B.data_ptr(), *k4._strides3(B), C.data_ptr(),
                        *k4._strides3(C), dy.data_ptr(), *k4._strides3(dy),
                        dh.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
                        dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
                        dA_part.data_ptr(), parts[0].data_ptr(),
                        parts[1].data_ptr(), states[0].data_ptr(),
                        states[1].data_ptr(), bt, s, hh, g, p, n, run, rpg,
                        torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"launch failed ({rc})")

        label = f"{arch} (Bt, S, H, P, G, N) = {(bt, s, hh, p, g, n)}"
        pcs.print_rows(label, pcs.count(lib, run_once), KERNELS, "step")
        print(f"{arch}: {pcs.event_us(run_once):.1f} us a launch, "
              "instrumented, by CUDA events")
        kept = k4.RUN_WAVES
        try:
            for waves in WAVES:
                k4.RUN_WAVES = waves
                r, n_runs = k4.backward_runs(bt, s, hh, g, sms)
                per = _kernel_us(torch, k4, (x, dt, A, B, C, dy, dh))
                print(f"{arch}: RUN_WAVES {waves} (runs of {r} heads, "
                      f"{bt * nc * g * n_runs} gradient blocks on {sms} "
                      "SMs): device us a launch, uninstrumented: "
                      + ", ".join(f"{k} {v:.1f}" for k, v in per.items())
                      + f"; total {sum(per.values()):.1f}")
        finally:
            k4.RUN_WAVES = kept
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    sys.exit(main())
