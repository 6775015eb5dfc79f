"""K2, the fused base + LoRA projection y = x@W + scale*(x@A)@B, as a
hand-written CUDA kernel.

Replaces the TPU kernel ``src/repro/kernels/lora_matmul.py:_kernel``. The
source is ``csrc/lora_matmul.cu`` (design and bound in its header), built and
loaded by :mod:`repro_torch.kernels.build`.

:func:`lora_matmul` launches the kernel for CUDA tensors and runs the plain
version (:func:`repro_torch.kernels.ref.lora_matmul_ref`) for CPU tensors.
There is no fallback: on a CUDA tensor a missing compiler, a failed build
or a failed launch raises. ``lora_matmul.launches`` counts kernel launches.
Under grad mode it refuses an input that requires grad (its output would
carry no gradient).

:class:`LoRAMatmul` is the way in under autograd (``ops.lora_matmul`` takes
it). The base weight W is frozen, so the backward needs dx, dA and dB:

- ``dx = dy W^T + s (dy B^T) A^T`` is K2 itself on (dy, W^T, B^T, A^T)
  (profiler range :data:`BACKWARD_DX`). W^T is made contiguous first,
  inside the range :data:`W_TRANSPOSE`, so a trace shows what the copy
  costs.
- ``dA = s x^T (dy B^T)`` and ``dB = s (x A)^T dy`` are rank-r products,
  in f32 through ``torch.matmul`` (the reference leaves them to XLA), in
  the range :data:`BACKWARD_RANK_R`. They come back in the dtype A and B
  came in (the model casts its f32 adapters to the activations' dtype).

The reference has no backward kernel (its models train through XLA), so
this is K2's own backward, not a port of one. ``lora_matmul.
backward_launches`` counts the backward's K2 launches apart from
``launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import lora_matmul_ref
from repro_torch.obs import ranges

SOURCE = "lora_matmul.cu"
W_TRANSPOSE = "K2 backward W transpose"
BACKWARD_DX = "K2 backward dx"
BACKWARD_RANK_R = "K2 backward dA dB"
MAX_RANK = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "lora_matmul_launch": ([_P, _P, _P, _P, _P, _I, _I, _I, _I,
                            ctypes.c_float, _I, _P], ctypes.c_int),
}


def build() -> tuple:
    """Compile csrc/lora_matmul.cu unless that exact source is built
    already. Returns (library path, compiler output)."""
    return _build.build(SOURCE)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load K2's shared library, once per process."""
    return _build.load(SOURCE, _SIGNATURES)


def _check(x, w, a, b):
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in (w, a, b)):
        raise ValueError(
            "lora_matmul takes all tensors on one CUDA device, got "
            f"{[str(t.device) for t in (x, w, a, b)]}")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (w, a, b)):
        raise TypeError("lora_matmul takes float32 or bfloat16, all of one "
                        f"dtype, got {[t.dtype for t in (x, w, a, b)]}")
    if any(t.dim() != 2 for t in (x, w, a, b)):
        raise ValueError("lora_matmul takes 2-D x, W, A, B, got "
                         f"{[tuple(t.shape) for t in (x, w, a, b)]}")
    (m, k), (k2, n), (k3, r) = x.shape, w.shape, a.shape
    if k2 != k or k3 != k or tuple(b.shape) != (r, n):
        raise ValueError(
            f"lora_matmul shapes do not match: x {tuple(x.shape)}, W "
            f"{tuple(w.shape)}, A {tuple(a.shape)}, B {tuple(b.shape)}")
    if not 1 <= r <= MAX_RANK or k < 1:
        raise ValueError(f"lora_matmul takes rank 1..{MAX_RANK} and K >= 1, "
                         f"got r={r}, K={k}")
    if not all(t.is_contiguous() for t in (x, w, a, b)):
        raise ValueError("lora_matmul takes contiguous tensors")


def _run(x, w, a, b, scale):
    """One K2 launch on CUDA tensors (or the plain version on CPU ones);
    counts nothing."""
    if all(t.device.type == "cpu" for t in (x, w, a, b)):
        return lora_matmul_ref(x, w, a, b, scale)
    _check(x, w, a, b)
    lib = load_library()
    (m, k), n, r = x.shape, w.shape[1], a.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.lora_matmul_launch(
            x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            y.data_ptr(), m, n, k, r, float(scale), _DTYPES[x.dtype], stream)
    _build.check(lib, SOURCE, rc, "lora_matmul")
    return y


def lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, scale: float) -> torch.Tensor:
    """y (M, N) = x (M, K) @ W (K, N) + scale * (x @ A (K, r)) @ B (r, N),
    f32 accumulation, in x's dtype. CUDA tensors launch K2 on the current
    stream; CPU tensors run the plain version. Refuses, under grad mode, an
    input that requires grad: use :class:`LoRAMatmul` there."""
    _build.refuse_grad("lora_matmul", x, w, a, b)
    y = _run(x, w, a, b, scale)
    lora_matmul.launches += x.device.type == "cuda"
    return y


lora_matmul.launches = 0
lora_matmul.backward_launches = 0


class LoRAMatmul(torch.autograd.Function):
    """K2 under autograd: :func:`lora_matmul` forward, K2 again for dx and
    f32 rank-r products for dA and dB (see the module's docstring). W must
    not require grad: the base model is frozen."""

    @staticmethod
    def forward(ctx, x, w, a, b, scale: float):
        if w.requires_grad:
            raise RuntimeError("LoRAMatmul takes a frozen base weight W "
                               "(W.requires_grad is True); only the LoRA "
                               "factors A and B are trained")
        ctx.scale = scale
        ctx.save_for_backward(x, w, a, b)
        return lora_matmul(x, w, a, b, scale)

    @staticmethod
    def backward(ctx, dy):
        x, w, a, b = ctx.saved_tensors
        s = ctx.scale
        dy = dy.contiguous()
        dx = None
        if ctx.needs_input_grad[0]:
            with ranges.span(W_TRANSPOSE):
                wt = w.t().contiguous()
            with ranges.span(BACKWARD_DX):
                dx = _run(dy, wt, b.t().contiguous(), a.t().contiguous(), s)
            lora_matmul.backward_launches += dy.device.type == "cuda"
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            return dx, None, *_rank_r_grads(ctx, x, a, b, dy, s), None
        return dx, None, None, None, None


def _rank_r_grads(ctx, x, a, b, dy, s):
    """(dA, dB): f32 products, each rounded once to its factor's dtype."""
    da = db = None
    with ranges.span(BACKWARD_RANK_R):
        xf, dyf = x.float(), dy.float()
        if ctx.needs_input_grad[2]:
            da = (s * torch.matmul(xf.t(), torch.matmul(dyf, b.float().t()))
                  ).to(a.dtype)
        if ctx.needs_input_grad[3]:
            db = (s * torch.matmul(torch.matmul(xf, a.float()).t(), dyf)
                  ).to(b.dtype)
    return da, db
