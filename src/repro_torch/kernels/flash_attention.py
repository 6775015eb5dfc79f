"""K3, forward flash attention (causal and / or sliding window), as a
hand-written CUDA kernel.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py:_kernel``.
The source is ``csrc/flash_attention.cu`` (design and bound in its header),
built and loaded by :mod:`repro_torch.kernels.build`. Layout (BH, S, D),
heads folded into the batch; query and key positions both count from 0.

:func:`flash_attention` launches the kernel for CUDA tensors and runs the
plain version (:func:`repro_torch.kernels.ref.flash_attention_ref`) for CPU
tensors. There is no fallback: on a CUDA tensor a missing compiler, a failed
build or a failed launch raises. ``flash_attention.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import flash_attention_ref

SOURCE = "flash_attention.cu"
HEAD_DIMS = (64, 80, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "flash_attention_launch": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                ctypes.c_float, _I, _P], ctypes.c_int),
}


def build() -> tuple:
    """Compile csrc/flash_attention.cu unless that exact source is built
    already. Returns (library path, compiler output)."""
    return _build.build(SOURCE)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load K3's shared library, once per process."""
    return _build.load(SOURCE, _SIGNATURES)


def _check(q, k, v, window):
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("flash_attention takes q, k, v on one CUDA device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention takes float32 or bfloat16, all of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError("flash_attention takes q (BH, Sq, D) and k, v "
                         f"(BH, Sk, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, sq, d = q.shape
    if k.shape[0] != bh or k.shape[2] != d or k.shape[1] < 1:
        raise ValueError(f"flash_attention shapes do not match: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head_dim in {HEAD_DIMS}, "
                         f"got {d}")
    if bh > 65535:
        raise ValueError(f"flash_attention takes BH <= 65535, got {bh}")
    if window is not None and (window < 1 or sq >= k.shape[1] + window):
        # a row with every key outside its window: the kernel skips the
        # tiles such a row would average over (see the source's header)
        raise ValueError(f"flash_attention takes window >= 1 with Sq < Sk + "
                         f"window, got window={window}, Sq={sq}, "
                         f"Sk={k.shape[1]}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError("flash_attention takes contiguous, 16-byte aligned "
                         "tensors")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q (BH, Sq, D), k, v (BH, Sk, D) -> (BH, Sq, D) in q's dtype. CUDA
    tensors launch K3 on the current stream; CPU tensors run the plain
    version."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_ref(q[None], k[None], v[None], causal=causal,
                                   window=window)[0]
    _check(q, k, v, window)
    lib = load_library()
    bh, sq, d = q.shape
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, sq,
            k.shape[1], d, int(causal), 0 if window is None else int(window),
            1.0 / math.sqrt(d), _DTYPES[q.dtype], stream)
    _build.check(lib, SOURCE, rc, "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
