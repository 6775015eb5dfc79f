"""K4, the Mamba2 SSD chunk scan, as a hand-written CUDA kernel.

Replaces the TPU kernel ``src/repro/kernels/ssd_scan.py:_kernel``. The
source is ``csrc/ssd_scan.cu`` (design and bound in its header), built and
loaded by :mod:`repro_torch.kernels.build`. Layout as the TPU kernel's:
x (BH, S, P), dt (BH, S), A (BH,), B and C (BH, S, N), heads folded into
the batch. The kernel picks its own chunk length (64 steps); a ragged S is
masked inside the kernel.

:func:`ssd_scan` launches the kernel for CUDA tensors and runs the plain
version (:func:`repro_torch.kernels.ref.ssd_scan_ref`, step by step) for CPU
tensors. There is no fallback: on a CUDA tensor a missing compiler, a failed
build or a failed launch raises. ``ssd_scan.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import ssd_scan_ref

SOURCE = "ssd_scan.cu"
HEAD_DIMS = (32, 64)
MAX_STATE = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ssd_scan_launch": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
                        ctypes.c_int),
}


def build() -> tuple:
    """Compile csrc/ssd_scan.cu unless that exact source is built already.
    Returns (library path, compiler output)."""
    return _build.build(SOURCE)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load K4's shared library, once per process."""
    return _build.load(SOURCE, _SIGNATURES)


def _check(x, dt, A, B, C):
    ts = (x, dt, A, B, C)
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError("ssd_scan takes all tensors on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    if (x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype
            or dt.dtype != torch.float32 or A.dtype != torch.float32):
        raise TypeError("ssd_scan takes x, B, C of one dtype, float32 or "
                        "bfloat16, and dt, A in float32, got "
                        f"{[t.dtype for t in ts]}")
    if x.dim() != 3 or B.dim() != 3:
        raise ValueError("ssd_scan takes x (BH, S, P), dt (BH, S), A (BH,), "
                         f"B and C (BH, S, N), got {[tuple(t.shape) for t in ts]}")
    bh, s, p = x.shape
    n = B.shape[2]
    if (tuple(dt.shape) != (bh, s) or tuple(A.shape) != (bh,)
            or tuple(B.shape) != (bh, s, n) or C.shape != B.shape):
        raise ValueError("ssd_scan shapes do not match: "
                         f"{[tuple(t.shape) for t in ts]}")
    if p not in HEAD_DIMS or not 1 <= n <= MAX_STATE:
        raise ValueError(f"ssd_scan takes head_dim P in {HEAD_DIMS} and "
                         f"state N in [1, {MAX_STATE}], got P={p}, N={n}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("ssd_scan takes contiguous tensors")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor):
    """Returns (y (BH, S, P) in x's dtype, h_final (BH, N, P) f32). CUDA
    tensors launch K4 on the current stream; CPU tensors run the plain
    version."""
    if all(t.device.type == "cpu" for t in (x, dt, A, B, C)):
        return ssd_scan_ref(x, dt, A, B, C)
    _check(x, dt, A, B, C)
    lib = load_library()
    bh, s, p = x.shape
    n = B.shape[2]
    y = torch.empty_like(x)
    hfin = torch.empty((bh, n, p), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), hfin.data_ptr(), bh, s, p, n,
            _DTYPES[x.dtype], stream)
    _build.check(lib, SOURCE, rc, "ssd_scan")
    ssd_scan.launches += 1
    return y, hfin


ssd_scan.launches = 0
