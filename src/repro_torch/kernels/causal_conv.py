"""The Mamba-2 mixer's depthwise causal conv + silu as one hand-written CUDA
kernel each way.

No TPU kernel: the reference computes the conv as plain XLA
(``src/repro/models/ssm.py:_causal_conv``), and so does the port's plain
version, ``models/ssm._causal_conv``: the cat of x, B and C, then a chain
of torch ops. The source is ``csrc/causal_conv.cu`` (function, roundings
and bound in its header), built and loaded by
:mod:`repro_torch.kernels.build`.

:func:`causal_conv` takes x (Bt, S, di), B and C (Bt, S, G*N) where they
lie (each with a contiguous last dimension, any batch and sequence
strides), w (di + 2 G N, wc) with wc in [1, MAX_WIDTH] and b (di + 2 G
N,), one dtype (float32 or bfloat16), and returns xbc (Bt, S, di + 2 G N)
contiguous, bit-equal to ``_causal_conv`` of the cat on the card. CUDA
tensors launch the kernel; CPU tensors run the plain version (called
through ``models/ssm``, so that what is patched there is what runs).
:func:`causal_conv_backward` gives the gradients of x, B, C, w and b from
the cotangents of xbc's three parts: on CUDA tensors the backward kernel
(u recomputed from the inputs, f32 sums, each gradient rounded once, dw
and db from per-run partials summed in a fixed order), on CPU tensors
:func:`repro_torch.kernels.ref.causal_conv_bwd_ref`, the same formula in
torch ops. There is no fallback: on a CUDA tensor a failed build, a
layout the kernel does not take or a failed launch raises.
``causal_conv.launches`` and ``causal_conv.backward_launches`` count the
kernels' launches.

:class:`CausalConv` is the way in under autograd (``ops.causal_conv``
takes it). It saves the inputs alone, and returns xbc's x, B and C parts
as views of the one buffer, so that the SSD kernel reads them in place and
their cotangents reach the backward kernel apart: nothing is summed into
a (Bt, S, C) gradient first.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import causal_conv_bwd_ref

SOURCE = "causal_conv.cu"
MAX_WIDTH = 4
ALIGN = 8           # a row moves 16 bytes at a time: strides in elements
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SEG = [_P, _L, _L, _I, _I]                    # x, strides, width, vec
_BWD_SEG = [_P, _L, _L, _P, _L, _L, _P, _I, _I]  # x, dy, dx, width, vec
_SIGNATURES = {
    "causal_conv_fwd_launch": (_SEG * 3 + [_P, _P, _P,   # w, b, xbc
                                            _I, _I, _I, _I, _P],
                               ctypes.c_int),
    "causal_conv_bwd_launch": (_BWD_SEG * 3 + [_P, _P,          # w, b
                                                _P, _P, _P,      # part dw db
                                                _I, _I, _I, _I, _P],
                               ctypes.c_int),
    "causal_conv_scratch_rows": ([_I, _I], _L),
}


def build() -> tuple:
    """Compile csrc/causal_conv.cu unless that exact source is built
    already. Returns (library path, compiler output)."""
    return _build.build(SOURCE)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the conv's library, once per process."""
    return _build.load(SOURCE, _SIGNATURES)


def plain(xin, B, C, w, b):
    """The plain version: ``models/ssm._causal_conv`` of the cat, looked up
    at the call (``models/ssm`` imports this module through ``ops``)."""
    from repro_torch.models import ssm

    return ssm._causal_conv(torch.cat([xin, B, C], dim=-1), w, b)


def split(xbc, di: int, gn: int):
    """xbc's x, B and C parts, views of it."""
    return xbc[..., :di], xbc[..., di:di + gn], xbc[..., di + gn:]


def check_inputs(xin, B, C, w, b) -> None:
    """Raise unless the kernel takes these: x, B, C (Bt, S, width) with a
    contiguous last dimension, w (their widths' sum, wc) with wc in [1,
    MAX_WIDTH] and b (that sum,), both contiguous, all of one dtype
    (float32 or bfloat16) on one CUDA device."""
    ts = (xin, B, C, w, b)
    dev = xin.device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"causal_conv takes all tensors on one CUDA device, "
                         f"got {[str(t.device) for t in ts]}")
    if xin.dtype not in _DTYPES or any(t.dtype != xin.dtype for t in ts):
        raise TypeError(f"causal_conv takes x, B, C, w and b of one dtype, "
                        f"float32 or bfloat16, got {[t.dtype for t in ts]}")
    shapes = [tuple(t.shape) for t in ts]
    if (any(t.dim() != 3 for t in (xin, B, C))
            or B.shape[:2] != xin.shape[:2] or C.shape[:2] != xin.shape[:2]):
        raise ValueError(f"causal_conv takes x, B and C (Bt, S, width) of "
                         f"one (Bt, S), got {shapes}")
    ch = xin.shape[2] + B.shape[2] + C.shape[2]
    if (w.dim() != 2 or w.shape[0] != ch
            or not 1 <= w.shape[1] <= MAX_WIDTH or tuple(b.shape) != (ch,)):
        raise ValueError(f"causal_conv takes w ({ch}, wc) with wc in [1, "
                         f"{MAX_WIDTH}] and b ({ch},), got {shapes}")
    if not (w.is_contiguous() and b.is_contiguous()):
        raise ValueError("causal_conv takes w and b contiguous")
    for name, t in (("x", xin), ("B", B), ("C", C)):
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"causal_conv takes {name} with a contiguous "
                             f"last dimension, got strides {t.stride()}")


def _rows_aligned(t) -> bool:
    """t's rows start on 16-byte boundaries (None: no rows to read)."""
    return t is None or (t.data_ptr() % 16 == 0 and all(
        st % ALIGN == 0 for st in t.stride()[:2]))


def _strides(t):
    return (0, 0) if t is None else (t.stride(0), t.stride(1))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(xin, B, C, w, b):
    lib = load_library()
    bt, s = xin.shape[:2]
    widths = [t.shape[2] for t in (xin, B, C)]
    ch = sum(widths)
    xbc = torch.empty((bt, s, ch), dtype=xin.dtype, device=xin.device)
    args, off = [], 0
    for t, width in zip((xin, B, C), widths):
        # xbc's rows hold the segment 16 bytes at a time only where it
        # starts on a multiple of 8 channels and its rows do
        vec = (width % ALIGN == 0 and off % ALIGN == 0 and ch % ALIGN == 0
               and _rows_aligned(t))
        args += [t.data_ptr(), *_strides(t), width, int(vec)]
        off += width
    stream = torch.cuda.current_stream(xin.device).cuda_stream
    with torch.cuda.device(xin.device):
        rc = lib.causal_conv_fwd_launch(
            *args, w.data_ptr(), b.data_ptr(), xbc.data_ptr(), bt, s,
            w.shape[1], _DTYPES[xin.dtype], stream)
    _build.check(lib, SOURCE, rc, "causal_conv")
    causal_conv.launches += 1
    return xbc


def causal_conv(xin: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """silu(causal conv of cat(x, B, C) by w, + b): xbc (Bt, S, di + 2 G N)
    contiguous in the inputs' dtype. CUDA tensors launch the kernel on the
    current stream; CPU tensors run the plain version."""
    _build.refuse_grad("causal_conv", xin, B, C, w, b)
    if all(t.device.type == "cpu" for t in (xin, B, C, w, b)):
        return plain(xin, B, C, w, b)
    check_inputs(xin, B, C, w, b)
    return _launch(xin, B, C, w, b)


causal_conv.launches = 0
causal_conv.backward_launches = 0


def _launch_backward(ins, douts, needs):
    xin, B, C, w, b = ins
    lib = load_library()
    bt, s = xin.shape[:2]
    wc = w.shape[1]
    dev = xin.device
    grads = [torch.empty(t.shape, dtype=t.dtype, device=dev) if need
             else None for t, need in zip(ins, needs)]
    args = []
    for t, dy, g in zip((xin, B, C), douts, grads[:3]):
        width = t.shape[2]
        vec = width % ALIGN == 0 and _rows_aligned(t) and _rows_aligned(dy)
        args += [t.data_ptr(), *_strides(t), _ptr(dy), *_strides(dy),
                 _ptr(g), width, int(vec)]
    ch = w.shape[0]
    # the scratch's rows, one a run of the kernel's tokens, as the source
    # counts them
    part = (torch.empty((lib.causal_conv_scratch_rows(bt, s), wc + 1, ch),
                        dtype=torch.float32, device=dev)
            if needs[3] or needs[4] else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.causal_conv_bwd_launch(
            *args, w.data_ptr(), b.data_ptr(), _ptr(part), _ptr(grads[3]),
            _ptr(grads[4]), bt, s, wc, _DTYPES[xin.dtype], stream)
    _build.check(lib, SOURCE, rc, "causal_conv backward")
    causal_conv.backward_launches += 1
    return tuple(grads)


def causal_conv_backward(xin, B, C, w, b, dx=None, dB=None, dC=None,
                         needs=(True,) * 5):
    """The gradients (dx, dB, dC, dw, db) of :func:`causal_conv` at the
    cotangents of xbc's x, B and C parts (each shaped as its input, None:
    zero); None where ``needs`` says an input wants none. CUDA tensors
    launch the backward kernel on the current stream; CPU tensors run
    ``causal_conv_bwd_ref``."""
    ins = (xin, B, C, w, b)
    douts = (dx, dB, dC)
    if all(t.device.type == "cpu" for t in ins):
        dy = torch.cat([torch.zeros_like(t) if d is None else d
                        for t, d in zip(ins[:3], douts)], dim=-1)
        gx, gw, gb = causal_conv_bwd_ref(torch.cat(ins[:3], dim=-1), w, b,
                                         dy)
        got = (*split(gx, xin.shape[-1], B.shape[-1]), gw, gb)
        return tuple(g if need else None for g, need in zip(got, needs))
    _build.refuse_grad("causal_conv_backward", *ins, *douts)
    check_inputs(*ins)
    douts = list(douts)
    for i, (name, t) in enumerate(zip(("x", "B", "C"), ins)):
        d = douts[i]
        if d is None:
            continue
        if (tuple(d.shape) != tuple(t.shape) or d.dtype != t.dtype
                or d.device != t.device):
            raise ValueError(f"causal_conv_backward takes d{name} shaped as "
                             f"{name} {tuple(t.shape)} in {t.dtype} on "
                             f"{t.device}, got {tuple(d.shape)} {d.dtype} "
                             f"{d.device}")
        if d.stride(-1) != 1 and d.shape[-1] > 1:
            douts[i] = d.contiguous()
    return _launch_backward(ins, douts, needs)


class CausalConv(torch.autograd.Function):
    """The conv under autograd: :func:`causal_conv` forward, returning
    xbc's x, B and C parts (views of one buffer),
    :func:`causal_conv_backward` backward (see the module's docstring)."""

    @staticmethod
    def forward(ctx, xin, B, C, w, b):
        # an unused part's cotangent comes as None: the kernel reads it as
        # zero
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(xin, B, C, w, b)
        return split(causal_conv(xin, B, C, w, b), xin.shape[-1],
                     B.shape[-1])

    @staticmethod
    def backward(ctx, dx, dB, dC):
        return causal_conv_backward(*ctx.saved_tensors, dx, dB, dC,
                                    needs=ctx.needs_input_grad)
