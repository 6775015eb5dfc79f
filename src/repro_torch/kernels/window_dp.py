"""K1, the CHC window min-plus DP (Eq. 10), as a hand-written CUDA kernel.

Replaces the TPU kernel ``src/repro/kernels/window_dp.py:_kernel``. The
source is ``csrc/window_dp.cu`` (design and bound in its header). It is
compiled with ``nvcc`` for ``sm_90a`` at first use into
``build/repro_torch/`` at the repo root (listed in .gitignore) and loaded
through ``ctypes``; the library name carries a hash of the source, so an
edited kernel is rebuilt.

:func:`window_dp` launches the kernel for CUDA tensors and runs the plain
version (:func:`repro_torch.kernels.ref.window_dp_ref`) for CPU tensors.
There is no fallback: on a CUDA tensor a missing compiler, a failed build
or a failed launch raises. ``window_dp.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels.ref import window_dp_ref

_SRC = Path(__file__).resolve().parent / "csrc" / "window_dp.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: K1 (window_dp) cannot be built")
    return found


def build() -> tuple:
    """Compile csrc/window_dp.cu into BUILD_DIR unless that exact source is
    built already. Returns (library path, compiler output)."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"window_dp_{digest}.so"
    if out.exists():
        return out, ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {_SRC}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load K1's shared library, once per process."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        lib.window_dp_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.window_dp_launch.restype = ctypes.c_int
        lib.window_dp_error_string.argtypes = [ctypes.c_int]
        lib.window_dp_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


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
    if rc != 0:
        msg = lib.window_dp_error_string(rc).decode()
        raise RuntimeError(f"window_dp launch failed: {msg} ({rc})")
    window_dp.launches += 1
    return n_tot, obj


window_dp.launches = 0
