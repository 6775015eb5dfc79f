"""K1, the CHC window min-plus DP (Eq. 10), as a hand-written CUDA kernel.

Replaces the TPU kernel ``src/repro/kernels/window_dp.py:_kernel``. The
source is ``csrc/window_dp.cu`` (design and bound in its header), built and
loaded by :mod:`repro_torch.kernels.build`.

:func:`window_dp` launches the kernel for CUDA tensors and runs the plain
version (:func:`repro_torch.kernels.ref.window_dp_ref`) for CPU tensors.
There is no fallback: on a CUDA tensor a missing compiler, a failed build
or a failed launch raises. ``window_dp.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import window_dp_ref

SOURCE = "window_dp.cu"
_SIGNATURES = {
    "window_dp_launch": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
}


def build() -> tuple:
    """Compile csrc/window_dp.cu unless that exact source is built already.
    Returns (library path, compiler output)."""
    return _build.build(SOURCE)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load K1's shared library, once per process."""
    return _build.load(SOURCE, _SIGNATURES)


def _check(slot_cost: torch.Tensor, gain: torch.Tensor):
    if slot_cost.device.type != "cuda" or gain.device != slot_cost.device:
        raise ValueError(
            f"window_dp takes both tensors on one CUDA device, got "
            f"{slot_cost.device} and {gain.device}")
    if slot_cost.dtype != torch.float32 or gain.dtype != torch.float32:
        raise TypeError(f"window_dp takes float32, got {slot_cost.dtype} "
                        f"and {gain.dtype}")
    if slot_cost.dim() != 3 or gain.dim() != 2:
        raise ValueError(f"window_dp takes (B, w1, tn+1) and (B, U+1), got "
                         f"{tuple(slot_cost.shape)} and {tuple(gain.shape)}")
    b, w1, kw = slot_cost.shape
    if gain.shape[0] != b or gain.shape[1] != w1 * (kw - 1) + 1:
        raise ValueError(f"gain {tuple(gain.shape)} does not match "
                         f"slot_cost {tuple(slot_cost.shape)}")
    if not 1 <= kw - 1 <= 127:
        raise ValueError(f"table width tn={kw - 1} outside [1, 127]")
    if not (slot_cost.is_contiguous() and gain.is_contiguous()):
        raise ValueError("window_dp takes contiguous tensors")


def window_dp(slot_cost: torch.Tensor, gain: torch.Tensor):
    """Solve B independent CHC window DPs.

    slot_cost: (B, w1, tn+1) f32; gain: (B, U+1) f32, U = w1*tn.
    Returns (n_tot (B, w1) i32, obj (B,) f32). CUDA tensors launch K1 on
    the current stream; CPU tensors run the plain version."""
    if slot_cost.device.type == "cpu" and gain.device.type == "cpu":
        return window_dp_ref(slot_cost, gain)
    _check(slot_cost, gain)
    lib = load_library()
    b, w1, kw = slot_cost.shape
    n_tot = torch.empty((b, w1), dtype=torch.int32, device=slot_cost.device)
    obj = torch.empty((b,), dtype=torch.float32, device=slot_cost.device)
    stream = torch.cuda.current_stream(slot_cost.device).cuda_stream
    with torch.cuda.device(slot_cost.device):
        rc = lib.window_dp_launch(
            slot_cost.data_ptr(), gain.data_ptr(), n_tot.data_ptr(),
            obj.data_ptr(), b, w1, kw - 1, stream,
        )
    _build.check(lib, SOURCE, rc, "window_dp")
    window_dp.launches += 1
    return n_tot, obj


window_dp.launches = 0
