"""K3, forward flash attention (causal and / or sliding window), as a
hand-written CUDA kernel.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py:_kernel``.
The source is ``csrc/flash_attention.cu`` (design and bound in its header),
built and loaded by :mod:`repro_torch.kernels.build`. Layout (BH, S, D),
heads folded into the batch. Query and key positions count from 0 unless
the caller gives them: ``q_pos`` (Sq,) and ``k_pos`` (Sk,) int32, shared by
every (batch, head), as Qwen2-VL's M-RoPE temporal stream masks attention.
With positions K3 visits every key tile, so a row whose keys are all
masked averages V over all keys, as the plain version does.

:func:`flash_attention` launches the kernel for CUDA tensors and runs the
plain version (:func:`repro_torch.kernels.ref.flash_attention_ref`) for CPU
tensors. There is no fallback: on a CUDA tensor a missing compiler, a failed
build or a failed launch raises. ``flash_attention.launches`` counts kernel
launches, ``flash_attention.position_launches`` those of them with
positions. Under grad mode it refuses an input that requires grad (its
output would carry no gradient). With ``stats=True`` it also returns each
row's running max m and running sum l (BH, Sq) f32, which the backward
reads.

:class:`FlashAttention` is the way in under autograd (``ops.attention``
takes it): its forward launches K3 and keeps m and l when an input needs a
gradient, its backward calls :func:`flash_attention_backward` inside the
profiler range :data:`BACKWARD`. On CUDA tensors that launches K3's
backward kernel (``csrc/flash_attention_bwd.cu``, design and bound in its
header): FlashAttention-2's backward, P recomputed from m and l, three
kernels (rowsum(P o dP), dK and dV a key tile, dQ a query tile) with no
float atomics. In bf16 each is one warpgroup a block issuing Hopper's
``wgmma.mma_async`` on tiles that TMA copies into wgmma's swizzled
shared-memory layout, P and dS fed from registers as hi + lo bf16 halves;
in f32 they run on the CUDA cores. Its plain version is
:func:`repro_torch.kernels.ref.flash_attention_bwd_ref`; on CPU tensors the
backward is autograd through :func:`repro_torch.kernels.ref.
flash_attention_ref`. There is no fallback: on a CUDA tensor a failed
build or launch raises. ``flash_attention_backward.launches`` counts the
backward's launches (three kernels each). The reference has no backward
kernel (its models train through XLA's differentiation of the plain
attention), so this is K3's own backward, not a port of one.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import (flash_attention_fwd_stats_ref,
                                     flash_attention_ref)
from repro_torch.obs import ranges

SOURCE = "flash_attention.cu"
BACKWARD_SOURCE = "flash_attention_bwd.cu"
BACKWARD = "K3 backward"
HEAD_DIMS = (64, 80, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "flash_attention_launch": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _F, _I, _P, _P, _P, _P, _P], ctypes.c_int),
}
_BACKWARD_SIGNATURES = {
    "flash_attention_bwd_launch": ([_P, _P, _P, _P,      # q, k, v, dO
                                    _P, _P, _P,          # m, l, dsum
                                    _P, _P, _P,          # dq, dk, dv
                                    _I, _I, _I, _I, _I, _I, _F, _I,
                                    _P, _P, _P], ctypes.c_int),
    "flash_attention_bwd_smem_bytes": ([_I, _I, _I], ctypes.c_int),
}


def build() -> tuple:
    """Compile csrc/flash_attention.cu unless that exact source is built
    already. Returns (library path, compiler output)."""
    return _build.build(SOURCE)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load K3's shared library, once per process."""
    return _build.load(SOURCE, _SIGNATURES)


def load_backward_library() -> ctypes.CDLL:
    """Build (if needed) and load the library of K3's backward, once per
    process."""
    return _build.load(BACKWARD_SOURCE, _BACKWARD_SIGNATURES)


def _check_positions(q, k, q_pos, k_pos):
    if (q_pos is None) != (k_pos is None):
        raise ValueError("flash_attention takes both q_pos and k_pos or "
                         "neither")
    for name, p, n in (("q_pos", q_pos, q.shape[1]),
                       ("k_pos", k_pos, k.shape[1])):
        if p.dtype != torch.int32:
            raise TypeError(f"flash_attention takes {name} as int32, got "
                            f"{p.dtype}")
        if p.device != q.device:
            raise ValueError(f"flash_attention takes {name} on q's device "
                             f"{q.device}, got {p.device}")
        if p.dim() != 1 or p.shape[0] != n or not p.is_contiguous():
            raise ValueError(f"flash_attention takes {name} contiguous, of "
                             f"shape ({n},), got {tuple(p.shape)}")


def _check(q, k, v, window, positions: bool, name="flash_attention"):
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"{name} takes q, k, v on one CUDA device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16, all of "
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
    if window is not None and window < 1:
        raise ValueError(f"flash_attention takes window >= 1, got {window}")
    if window is not None and not positions and sq >= k.shape[1] + window:
        # a row with every key outside its window: the index path skips
        # the tiles such a row would average over (see the source's header)
        raise ValueError(f"flash_attention takes window >= 1 with Sq < Sk + "
                         f"window, got window={window}, Sq={sq}, "
                         f"Sk={k.shape[1]}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError("flash_attention takes contiguous, 16-byte aligned "
                         "tensors")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_pos: Optional[torch.Tensor] = None,
                    k_pos: Optional[torch.Tensor] = None,
                    stats: bool = False):
    """q (BH, Sq, D), k, v (BH, Sk, D) -> (BH, Sq, D) in q's dtype; q_pos
    (Sq,) and k_pos (Sk,) int32 the positions that mask (both or neither).
    With ``stats`` returns (o, m, l), m and l (BH, Sq) f32 each row's
    running max and running sum. CUDA tensors launch K3 on the current
    stream; CPU tensors run the plain version."""
    _build.refuse_grad("flash_attention", q, k, v)
    positions = q_pos is not None or k_pos is not None
    if positions:
        _check_positions(q, k, q_pos, k_pos)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        kw = dict(causal=causal, window=window, q_pos=q_pos, k_pos=k_pos)
        if stats:
            return tuple(t[0] for t in flash_attention_fwd_stats_ref(
                q[None], k[None], v[None], **kw))
        return flash_attention_ref(q[None], k[None], v[None], **kw)[0]
    _check(q, k, v, window, positions)
    lib = load_library()
    bh, sq, d = q.shape
    o = torch.empty_like(q)
    m, l = ((torch.empty((bh, sq), dtype=torch.float32, device=q.device)
             for _ in range(2)) if stats else (None, None))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, sq,
            k.shape[1], d, int(causal), 0 if window is None else int(window),
            1.0 / math.sqrt(d), _DTYPES[q.dtype],
            q_pos.data_ptr() if positions else None,
            k_pos.data_ptr() if positions else None,
            m.data_ptr() if stats else None,
            l.data_ptr() if stats else None, stream)
    _build.check(lib, SOURCE, rc, "flash_attention")
    flash_attention.launches += 1
    flash_attention.position_launches += positions
    return (o, m, l) if stats else o


flash_attention.launches = 0
flash_attention.position_launches = 0


def flash_attention_backward(q, k, v, m, l, do, *, causal: bool = True,
                             window: Optional[int] = None,
                             q_pos: Optional[torch.Tensor] = None,
                             k_pos: Optional[torch.Tensor] = None,
                             needs=(True,) * 3):
    """The gradients (dq, dk, dv) of :func:`flash_attention`'s output at
    the cotangent do (BH, Sq, D) in q's dtype, from the forward's row
    statistics m and l (BH, Sq) f32 (``stats=True``); None where ``needs``
    says an input wants none. CUDA tensors launch K3's backward kernel on
    the current stream; CPU tensors run autograd through the plain version
    (m and l unread)."""
    ins = (q, k, v)
    if all(t.device.type == "cpu" for t in ins):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need)
                   for t, need in zip(ins, needs)]
            o = flash_attention_ref(ins[0][None], ins[1][None], ins[2][None],
                                    causal=causal, window=window,
                                    q_pos=q_pos, k_pos=k_pos)[0]
            wanted = [t for t in ins if t.requires_grad]
            got = iter(torch.autograd.grad(o, wanted, do))
        return tuple(next(got) if t.requires_grad else None for t in ins)
    name = "flash_attention_backward"
    _build.refuse_grad(name, q, k, v, m, l, do)
    positions = q_pos is not None or k_pos is not None
    if positions:
        _check_positions(q, k, q_pos, k_pos)
    _check(q, k, v, window, positions, name)
    if m is None or l is None:
        raise ValueError(f"{name} takes the forward's m and l "
                         "(flash_attention(..., stats=True)), got None")
    bh, sq, d = q.shape
    for what, t in (("m", m), ("l", l)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (bh, sq)
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name} takes {what} ({bh}, {sq}) float32 "
                             f"contiguous on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} {t.device}")
    if (tuple(do.shape) != tuple(q.shape) or do.dtype != q.dtype
            or do.device != q.device):
        raise ValueError(f"{name} takes do shaped as q {tuple(q.shape)} in "
                         f"{q.dtype} on {q.device}, got {tuple(do.shape)} "
                         f"{do.dtype} {do.device}")
    if not do.is_contiguous() or do.data_ptr() % 16:
        raise ValueError(f"{name} takes do contiguous, 16-byte aligned")
    lib = load_backward_library()
    dq, dk, dv = (torch.empty_like(t) for t in ins)
    dsum = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            m.data_ptr(), l.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), bh, sq, k.shape[1], d,
            int(causal), 0 if window is None else int(window),
            1.0 / math.sqrt(d), _DTYPES[q.dtype],
            q_pos.data_ptr() if positions else None,
            k_pos.data_ptr() if positions else None, stream)
    _build.check(lib, BACKWARD_SOURCE, rc, name)
    flash_attention_backward.launches += 1
    return tuple(g if need else None for g, need in zip((dq, dk, dv), needs))


flash_attention_backward.launches = 0


class FlashAttention(torch.autograd.Function):
    """K3 under autograd: :func:`flash_attention` forward (with the row
    statistics when an input needs a gradient),
    :func:`flash_attention_backward` backward (see the module's
    docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window, q_pos, k_pos):
        kw = dict(causal=causal, window=window, q_pos=q_pos, k_pos=k_pos)
        if not any(ctx.needs_input_grad[:3]):
            # no backward to come (serving): the kernel writes no statistics
            return flash_attention(q, k, v, **kw)
        ctx.mask = (causal, window)
        o, m, l = flash_attention(q, k, v, stats=True, **kw)
        ctx.save_for_backward(q, k, v, m, l, q_pos, k_pos)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, m, l, q_pos, k_pos = ctx.saved_tensors
        causal, window = ctx.mask
        do = do.contiguous()
        with ranges.span(BACKWARD):
            grads = flash_attention_backward(
                q, k, v, m, l, do, causal=causal, window=window,
                q_pos=q_pos, k_pos=k_pos, needs=ctx.needs_input_grad[:3])
        return (*grads, None, None, None, None)
