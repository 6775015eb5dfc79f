"""K4, the Mamba2 SSD chunk scan, as a hand-written CUDA kernel.

Replaces the TPU kernel ``src/repro/kernels/ssd_scan.py:_kernel``. The
source is ``csrc/ssd_scan.cu`` (design and bound in its header), built and
loaded by :mod:`repro_torch.kernels.build`. Two entry points launch the
same kernel:

- :func:`ssd_scan_grouped`, the model's layout: x (Bt, S, H, P), dt
  (Bt, S, H), A (H,), B and C (Bt, S, G, N), each read where it lies
  through its strides (the Mamba2 layer's x, B and C are views of one conv
  output), head h reading group ``h // (H / G)``; y comes back as a
  contiguous (Bt, S, H, P), h_final as (Bt, H, N, P) f32.
- :func:`ssd_scan`, the TPU kernel's flattened layout: x (BH, S, P), dt
  (BH, S), A (BH,), B and C (BH, S, N), contiguous; the case Bt = BH,
  H = G = 1.

The kernel picks its own chunk length (64 steps); a ragged S is masked
inside the kernel. CPU tensors run the plain version
(:mod:`repro_torch.kernels.ref`, step by step). There is no fallback: on a
CUDA tensor a missing compiler, a failed build, a layout the kernel does
not take or a failed launch raises. ``ssd_scan.launches`` counts kernel
launches of both entry points. Under grad mode both refuse an input that
requires grad (their outputs would carry no gradient).

:class:`SSDScan` is the way in under autograd (``ops.ssd`` takes it): its
forward launches K4 on the model's layout, its backward calls
:func:`ssd_scan_grouped_backward` inside the profiler range
:data:`BACKWARD`. On CUDA tensors that launches K4's backward kernel
(``csrc/ssd_scan_bwd.cu``, design and bound in its header): the gradients
of the function the forward computes (64-step chunks, exponents clipped
to [-60, 0]), dB and dC summed over the heads of their group and dA over
the batch in a fixed order, with no float atomics. In bf16 (training)
three kernels on the tensor cores: the chunks' entry states and the state
gradients by two scans over the chunks into a scratch, then every
chunk's gradients in parallel (one block per run of heads of a group, a
chunk and a batch row; :func:`backward_runs` picks the runs), then the
runs' partial dB / dC and the chunks' dA summed; in f32 one block per
(b, h) on the CUDA cores. Its plain version at full size is
:func:`repro_torch.kernels.ref.ssd_scan_grouped_bwd_ref` (the same scan in
torch ops); on CPU tensors the backward is autograd through
:func:`repro_torch.kernels.ref.ssd_scan_grouped_ref`. There is no
fallback: on a CUDA tensor a failed build or launch raises.
``ssd_scan.backward_launches`` counts the backward's launches (bf16:
three kernels each; f32: a main kernel and a finishing one) apart from
``launches``. The
reference has no backward kernel (its models train through XLA), so this
is K4's own backward, not a port of one.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import (SSD_CHUNK, ssd_scan_grouped_ref,
                                     ssd_scan_ref)
from repro_torch.obs import ranges

SOURCE = "ssd_scan.cu"
BACKWARD_SOURCE = "ssd_scan_bwd.cu"
BACKWARD = "K4 backward"
HEAD_DIMS = (32, 64)
MAX_STATE = 128
ALIGN = 8           # x, B and C strides and offsets, in elements
# the bf16 backward's gradient kernel: its grid's target, in blocks for each
# of the card's SMs (one block an SM at a time); 3 timed the same on an H100
# (tools/k4_bwd_phases.py)
RUN_WAVES = 2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "ssd_scan_launch": ([_P, _L, _L, _L,          # x and its strides
                         _P, _L, _L, _L,          # dt
                         _P, _L, _L,              # A (batch, head)
                         _P, _L, _L, _L,          # B
                         _P, _L, _L, _L,          # C
                         _P, _P,                  # y, h_final
                         _I, _I, _I, _I, _I, _I, _I, _P], ctypes.c_int),
}
_BACKWARD_SIGNATURES = {
    "ssd_scan_bwd_launch": ([_P, _L, _L, _L,      # x and its strides
                             _P, _L, _L, _L,      # dt
                             _P, _L,              # A (head)
                             _P, _L, _L, _L,      # B
                             _P, _L, _L, _L,      # C
                             _P, _L, _L, _L,      # dy
                             _P,                  # dh
                             _P, _P, _P, _P, _P,  # dx, ddt, dA, dB, dC
                             _P, _P, _P, _P,      # partials, states
                             _I, _I, _I, _I, _I, _I, _P], ctypes.c_int),
    "ssd_scan_bwd_bf16_launch": ([_P, _L, _L, _L,      # x and its strides
                                  _P, _L, _L, _L,      # dt
                                  _P, _L,              # A (head)
                                  _P, _L, _L, _L,      # B
                                  _P, _L, _L, _L,      # C
                                  _P, _L, _L, _L,      # dy
                                  _P,                  # dh
                                  _P, _P, _P, _P, _P,  # dx, ddt, dA, dB, dC
                                  _P, _P, _P,          # dA, dB, dC partials
                                  _P, _P,              # the state scratches
                                  _I, _I, _I, _I, _I, _I,  # bt s h g p n
                                  _I, _I, _P], ctypes.c_int),  # run, rpg
    "ssd_scan_bwd_bf16_smem_bytes": ([_I, _I], ctypes.c_int),
}


def build() -> tuple:
    """Compile csrc/ssd_scan.cu unless that exact source is built already.
    Returns (library path, compiler output)."""
    return _build.build(SOURCE)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load K4's shared library, once per process."""
    return _build.load(SOURCE, _SIGNATURES)


def load_backward_library() -> ctypes.CDLL:
    """Build (if needed) and load the library of K4's backward, once per
    process."""
    return _build.load(BACKWARD_SOURCE, _BACKWARD_SIGNATURES)


def _check_devices_and_dtypes(name, ts):
    x, dt, A, B, C = ts
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"{name} takes all tensors on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    if (x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype
            or dt.dtype != torch.float32 or A.dtype != torch.float32):
        raise TypeError(f"{name} takes x, B, C of one dtype, float32 or "
                        "bfloat16, and dt, A in float32, got "
                        f"{[t.dtype for t in ts]}")


def check_layout(x, dt, A, B, C) -> None:
    """Raise ValueError unless K4 takes this grouped layout: x (Bt, S, H,
    P), dt (Bt, S, H), A (H,), B and C (Bt, S, G, N) with P in HEAD_DIMS,
    N in [1, MAX_STATE], H a multiple of G, and x, B and C each with a
    contiguous last dimension and strides and offset multiples of ALIGN
    elements (rows are copied 16 bytes at a time). Any device, meta too."""
    shapes = [tuple(t.shape) for t in (x, dt, A, B, C)]
    if x.dim() != 4 or B.dim() != 4:
        raise ValueError("ssd_scan_grouped takes x (Bt, S, H, P), dt "
                         "(Bt, S, H), A (H,), B and C (Bt, S, G, N), got "
                         f"{shapes}")
    bt, s, hh, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if (tuple(dt.shape) != (bt, s, hh) or tuple(A.shape) != (hh,)
            or tuple(B.shape[:2]) != (bt, s) or C.shape != B.shape):
        raise ValueError(f"ssd_scan_grouped shapes do not match: {shapes}")
    if p not in HEAD_DIMS or not 1 <= n <= MAX_STATE:
        raise ValueError(f"ssd_scan takes head_dim P in {HEAD_DIMS} and "
                         f"state N in [1, {MAX_STATE}], got P={p}, N={n}")
    if g < 1 or hh % g:
        raise ValueError(f"ssd_scan_grouped takes H a multiple of G, got "
                         f"H={hh}, G={g}")
    _check_rows(x, B, C)


def _check_rows(x, B, C):
    """x's, B's and C's rows: a contiguous last dimension, strides and
    offset multiples of ALIGN elements."""
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"ssd_scan takes {name} with a "
                             f"contiguous last dimension, got strides "
                             f"{t.stride()}")
        strides = [st for st, sz in zip(t.stride()[:-1], t.shape[:-1])
                   if sz > 1]
        if t.storage_offset() % ALIGN or any(st % ALIGN for st in strides):
            raise ValueError(f"ssd_scan takes {name} with strides "
                             f"and offset multiples of {ALIGN} elements, got "
                             f"strides {t.stride()}, offset "
                             f"{t.storage_offset()}")


def _check_flat(x, dt, A, B, C):
    ts = (x, dt, A, B, C)
    _check_devices_and_dtypes("ssd_scan", ts)
    shapes = [tuple(t.shape) for t in ts]
    if x.dim() != 3 or B.dim() != 3:
        raise ValueError("ssd_scan takes x (BH, S, P), dt (BH, S), A (BH,), "
                         f"B and C (BH, S, N), got {shapes}")
    bh, s, p = x.shape
    n = B.shape[2]
    if (tuple(dt.shape) != (bh, s) or tuple(A.shape) != (bh,)
            or tuple(B.shape) != (bh, s, n) or C.shape != B.shape):
        raise ValueError(f"ssd_scan shapes do not match: {shapes}")
    if p not in HEAD_DIMS or not 1 <= n <= MAX_STATE:
        raise ValueError(f"ssd_scan takes head_dim P in {HEAD_DIMS} and "
                         f"state N in [1, {MAX_STATE}], got P={p}, N={n}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("ssd_scan takes contiguous tensors")
    _check_rows(x, B, C)


def _strides3(t):
    """The first three element strides of t, 0 where the size is 1."""
    return [st if sz > 1 else 0 for st, sz in zip(t.stride()[:3], t.shape)]


def _launch(x, dt, A, a_strides, B, C):
    """K4 on the grouped layout (checked by the caller); A's element
    strides over (batch, head) are given."""
    lib = load_library()
    bt, s, hh, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if x.data_ptr() % 16 or B.data_ptr() % 16 or C.data_ptr() % 16:
        raise ValueError("ssd_scan takes x, B and C 16-byte aligned")
    y = torch.empty((bt, s, hh, p), dtype=x.dtype, device=x.device)
    hfin = torch.empty((bt, hh, n, p), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.ssd_scan_launch(
            x.data_ptr(), *_strides3(x), dt.data_ptr(), *_strides3(dt),
            A.data_ptr(), *a_strides, B.data_ptr(), *_strides3(B),
            C.data_ptr(), *_strides3(C), y.data_ptr(), hfin.data_ptr(), bt,
            s, hh, g, p, n, _DTYPES[x.dtype], stream)
    _build.check(lib, SOURCE, rc, "ssd_scan")
    ssd_scan.launches += 1
    return y, hfin


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor):
    """Flattened layout. Returns (y (BH, S, P) in x's dtype, h_final
    (BH, N, P) f32). CUDA tensors launch K4 on the current stream; CPU
    tensors run the plain version."""
    _build.refuse_grad("ssd_scan", x, dt, A, B, C)
    if all(t.device.type == "cpu" for t in (x, dt, A, B, C)):
        return ssd_scan_ref(x, dt, A, B, C)
    _check_flat(x, dt, A, B, C)
    bh, s, p = x.shape
    n = B.shape[2]
    y, hfin = _launch(x[:, :, None], dt[:, :, None], A, (1, 0),
                      B[:, :, None], C[:, :, None])
    return y.reshape(bh, s, p), hfin.reshape(bh, n, p)


def ssd_scan_grouped(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     B: torch.Tensor, C: torch.Tensor):
    """The model's layout, read in place. Returns (y (Bt, S, H, P)
    contiguous in x's dtype, h_final (Bt, H, N, P) f32). CUDA tensors
    launch K4 on the current stream; CPU tensors run the plain version."""
    _build.refuse_grad("ssd_scan_grouped", x, dt, A, B, C)
    if all(t.device.type == "cpu" for t in (x, dt, A, B, C)):
        return ssd_scan_grouped_ref(x, dt, A, B, C)
    _check_devices_and_dtypes("ssd_scan_grouped", (x, dt, A, B, C))
    check_layout(x, dt, A, B, C)
    return _launch(x, dt, A, (0, A.stride(0)), B, C)


ssd_scan.launches = 0
ssd_scan.backward_launches = 0


def backward_runs(bt: int, s: int, hh: int, g: int, sms: int) -> tuple:
    """(heads a run, runs a group) of the bf16 backward's gradient kernel,
    one block per (run, chunk, batch row): the fewest runs a group that
    give at least RUN_WAVES blocks for each of the card's ``sms`` SMs, a
    group's heads split into runs of equal length but the last, which may
    be shorter."""
    hpg = hh // g
    blocks = bt * max(-(-s // SSD_CHUNK), 1) * g
    want = min(hpg, max(1, -(-RUN_WAVES * sms // blocks)))
    run = -(-hpg // want)
    return run, -(-hpg // run)


def state_rows(n: int) -> int:
    """The bf16 backward's state tiles' rows: N padded to 64 or 128."""
    return 64 if n <= 64 else 128


def _launch_backward(x, dt, A, B, C, dy, dh):
    """K4's backward kernel on the grouped layout (checked by the caller).
    Returns (dx, ddt, dA, dB, dC)."""
    lib = load_backward_library()
    bt, s, hh, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nc = -(-s // SSD_CHUNK)
    dev, f32 = x.device, torch.float32
    dx = torch.empty((bt, s, hh, p), dtype=x.dtype, device=dev)
    ddt = torch.empty((bt, s, hh), dtype=f32, device=dev)
    dA = torch.empty((hh,), dtype=f32, device=dev)
    dB = torch.empty((bt, s, g, n), dtype=B.dtype, device=dev)
    dC = torch.empty((bt, s, g, n), dtype=C.dtype, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    common = (x.data_ptr(), *_strides3(x), dt.data_ptr(), *_strides3(dt),
              A.data_ptr(), A.stride(0), B.data_ptr(), *_strides3(B),
              C.data_ptr(), *_strides3(C), dy.data_ptr(), *_strides3(dy),
              ptr(dh), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
              dB.data_ptr(), dC.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    if x.dtype == torch.bfloat16:
        # scratch: the (b, chunk) dA partials, the runs' dB / dC partials,
        # the states entering and the state gradients leaving each chunk
        # as hi + lo bf16 halves (their tiles come by TMA: 16-byte aligned)
        if any(t.data_ptr() % 16 for t in (x, B, C)):
            raise ValueError("ssd_scan backward takes x, B and C 16-byte "
                             "aligned")
        run, rpg = backward_runs(
            bt, s, hh, g,
            torch.cuda.get_device_properties(dev).multi_processor_count)
        dA_part = torch.empty((bt * nc, hh), dtype=f32, device=dev)
        parts = torch.empty((2, bt, s, g * rpg, n), dtype=f32, device=dev)
        states = torch.empty((2, bt, hh, nc, 2, state_rows(n), 64),
                             dtype=torch.bfloat16, device=dev)
        with torch.cuda.device(dev):
            rc = lib.ssd_scan_bwd_bf16_launch(
                *common, dA_part.data_ptr(), parts[0].data_ptr(),
                parts[1].data_ptr(), states[0].data_ptr(),
                states[1].data_ptr(), bt, s, hh, g, p, n, run, rpg, stream)
    else:
        # scratch: per-block dA, per-head dB / dC when G < H, the states
        # entering chunks 1 .. nc - 1
        dA_part = torch.empty((bt, hh), dtype=f32, device=dev)
        parts = ([torch.empty((bt, s, hh, n), dtype=f32, device=dev)
                  for _ in range(2)] if g < hh else [None, None])
        states = torch.empty((bt, hh, max(nc - 1, 0), n, p), dtype=f32,
                             device=dev)
        with torch.cuda.device(dev):
            rc = lib.ssd_scan_bwd_launch(
                *common, dA_part.data_ptr(), ptr(parts[0]), ptr(parts[1]),
                states.data_ptr(), bt, s, hh, g, p, n, stream)
    _build.check(lib, BACKWARD_SOURCE, rc, "ssd_scan backward")
    ssd_scan.backward_launches += 1
    return dx, ddt, dA, dB, dC


def ssd_scan_grouped_backward(x, dt, A, B, C, dy, dh=None,
                              needs=(True,) * 5):
    """The gradients (dx, ddt, dA, dB, dC) of :func:`ssd_scan_grouped`'s
    (y, h_final) at the cotangents dy (Bt, S, H, P) in x's dtype and dh
    (Bt, H, N, P) f32 (None: zero); None where ``needs`` says an input
    wants none. CUDA tensors launch K4's backward kernel on the current
    stream; CPU tensors run autograd through the plain version."""
    ins = (x, dt, A, B, C)
    if all(t.device.type == "cpu" for t in ins):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need)
                   for t, need in zip(ins, needs)]
            y, h = ssd_scan_grouped_ref(*ins)
            wanted = [t for t in ins if t.requires_grad]
            got = iter(torch.autograd.grad(
                (y, h), wanted,
                (torch.zeros_like(y) if dy is None else dy,
                 torch.zeros_like(h) if dh is None else dh)))
        return tuple(next(got) if t.requires_grad else None for t in ins)
    _build.refuse_grad("ssd_scan_grouped_backward", *ins, dy, dh)
    _check_devices_and_dtypes("ssd_scan_grouped_backward", ins)
    check_layout(*ins)
    bt, s, hh, p = x.shape
    n = B.shape[3]
    dy = (torch.zeros(x.shape, dtype=x.dtype, device=x.device) if dy is None
          else dy.contiguous())
    if dy.data_ptr() % 16:   # dy's tiles come by TMA: 16-byte aligned
        dy = dy.clone()
    if (tuple(dy.shape) != tuple(x.shape) or dy.dtype != x.dtype
            or dy.device != x.device):
        raise ValueError(f"ssd_scan_grouped_backward takes dy shaped as x "
                         f"{tuple(x.shape)} in {x.dtype} on {x.device}, got "
                         f"{tuple(dy.shape)} {dy.dtype} {dy.device}")
    if dh is not None:
        dh = dh.contiguous()
        if (tuple(dh.shape) != (bt, hh, n, p) or dh.dtype != torch.float32
                or dh.device != x.device):
            raise ValueError(f"ssd_scan_grouped_backward takes dh "
                             f"{(bt, hh, n, p)} float32 on {x.device}, got "
                             f"{tuple(dh.shape)} {dh.dtype} {dh.device}")
    grads = _launch_backward(x, dt, A, B, C, dy, dh)
    return tuple(gr if need else None for gr, need in zip(grads, needs))


class SSDScan(torch.autograd.Function):
    """K4 under autograd, on the model's layout: :func:`ssd_scan_grouped`
    forward, :func:`ssd_scan_grouped_backward` backward (see the module's
    docstring). Returns (y, h_final)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C):
        # an unused output's cotangent comes as None, not a zero tensor:
        # training uses y alone, and the kernel reads no state cotangent
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C)
        return ssd_scan_grouped(x, dt, A, B, C)

    @staticmethod
    def backward(ctx, dy, dh):
        with ranges.span(BACKWARD):
            return ssd_scan_grouped_backward(*ctx.saved_tensors, dy, dh,
                                             ctx.needs_input_grad)
