"""K1, the CHC window min-plus DP (Eq. 10), as a hand-written CUDA kernel.

Replaces the TPU kernel ``src/repro/kernels/window_dp.py:_kernel``. The
source is ``csrc/window_dp.cu`` (design and bound in its header), built and
loaded by :mod:`repro_torch.kernels.build`. It has two entries:

- :func:`window_dp` (table entry) takes the DP tables (slot_cost, gain) and
  returns (n_tot, obj). ``window_opt.solve_window`` (one shared scalar job)
  takes it, after building the tables in torch ops.
- :func:`window_dp_rows` (forecast entry) takes each row's forecast and job
  fields, builds the tables in registers, and returns the split plan and
  the un-biased objective (n_o, n_s, obj). ``window_opt.solve_window_batch``
  with one job per row takes it: that is the pool simulator's launch, one
  a market slot.

Each runs its plain version for CPU tensors: ``kernels.ref.window_dp_ref``,
and ``core.window_opt.window_dp_rows_ref``, the solver's own chain, which
owns the table arithmetic the forecast entry repeats. There is no
fallback: on a CUDA tensor a missing compiler, a failed build or a failed
launch raises. ``window_dp.launches`` counts the launches of both entries;
``window_dp_rows.launches`` counts the forecast entry's alone.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.configs.base import JobConfig, ThroughputConfig
from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import window_dp_ref

SOURCE = "window_dp.cu"
_SIGNATURES = {
    "window_dp_launch": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
    "window_dp_rows_launch": ([ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_float, ctypes.c_float,
                               ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p], ctypes.c_int),
}
# the forecast entry's job fields and their dtypes, in the order the kernel
# reads them (after prices, avail, z0 and slots_to_deadline)
_ROW_FIELDS = {
    "workload": torch.float32, "deadline": torch.int32,
    "n_min": torch.int32, "n_max": torch.int32, "value": torch.float32,
    "gamma": torch.float32, "on_demand_price": torch.float32,
}


def build() -> tuple:
    """Compile csrc/window_dp.cu unless that exact source is built already.
    Returns (library path, compiler output)."""
    return _build.build(SOURCE)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load K1's shared library, once per process."""
    return _build.load(SOURCE, _SIGNATURES)


def _check_tn(tn: int):
    if not 1 <= tn <= 127:
        raise ValueError(f"table width tn={tn} outside [1, 127]")


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
    _check_tn(kw - 1)
    if not (slot_cost.is_contiguous() and gain.is_contiguous()):
        raise ValueError("window_dp takes contiguous tensors")


def window_dp(slot_cost: torch.Tensor, gain: torch.Tensor):
    """Solve B independent CHC window DPs.

    slot_cost: (B, w1, tn+1) f32, costs >= 0 (infeasible k at BIG) with
    some plan below BIG/2 in every row; gain: (B, U+1) f32, U = w1*tn.
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


def _row_inputs(job: JobConfig, z0, slots_to_deadline, prices, avail):
    """The forecast entry's eleven inputs, in the kernel's order, with the
    dtype and shape each must have."""
    b = prices.shape[0] if prices.dim() == 2 else -1
    w1 = prices.shape[1] if prices.dim() == 2 else -1
    named = [("prices", prices, torch.float32, (b, w1)),
             ("avail", avail, torch.int32, (b, w1)),
             ("z0", z0, torch.float32, (b,)),
             ("slots_to_deadline", slots_to_deadline, torch.int32, (b,))]
    named += [(f, getattr(job, f), dt, (b,))
              for f, dt in _ROW_FIELDS.items()]
    return named


def _check_rows(named):
    dev = named[0][1].device
    for name, t, dtype, shape in named:
        if not torch.is_tensor(t) or t.device.type != "cuda" \
                or t.device != dev:
            where = t.device if torch.is_tensor(t) else type(t).__name__
            raise ValueError(f"window_dp_rows takes every input on one CUDA "
                             f"device, got {name} on {where} beside {dev}")
        if t.dtype != dtype:
            raise TypeError(f"window_dp_rows takes {name} as {dtype}, got "
                            f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"window_dp_rows takes {name} of shape {shape} "
                             f"(prices (B, w1)), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"window_dp_rows takes contiguous tensors; "
                             f"{name} is not")


def window_dp_rows(job: JobConfig, tput: ThroughputConfig, z0,
                   slots_to_deadline, prices, avail, tn: int):
    """Solve B window problems from their forecasts, one job per row.

    ``job`` holds (B,) tensors in the reference's dtypes (``_ROW_FIELDS``:
    workload, value, gamma and on_demand_price f32, deadline, n_min and
    n_max i32), its ``on_demand_price`` the rows' p_o; z0 (B,) f32,
    slots_to_deadline (B,) i32, prices (B, w1) f32 >= 0, avail (B, w1) i32;
    ``tput.alpha`` and ``tput.beta`` enter as f32. Returns (n_o (B, w1)
    i32, n_s (B, w1) i32, obj (B,) f32), bit-equal to
    :func:`repro_torch.core.window_opt.window_dp_rows_ref`. CUDA tensors
    launch K1's forecast entry on the current stream; CPU tensors run the
    plain chain."""
    tn = int(tn)
    named = _row_inputs(job, z0, slots_to_deadline, prices, avail)
    if all(torch.is_tensor(t) and t.device.type == "cpu"
           for _, t, _, _ in named):
        # imported here: window_opt imports this module
        from repro_torch.core.window_opt import window_dp_rows_ref
        return window_dp_rows_ref(job, tput, z0, slots_to_deadline, prices,
                                  avail, tn)
    _check_rows(named)
    _check_tn(tn)
    lib = load_library()
    b, w1 = prices.shape
    dev = prices.device
    n_o = torch.empty((b, w1), dtype=torch.int32, device=dev)
    n_s = torch.empty((b, w1), dtype=torch.int32, device=dev)
    obj = torch.empty((b,), dtype=torch.float32, device=dev)
    ins = (ctypes.c_void_p * len(named))(*[t.data_ptr()
                                           for _, t, _, _ in named])
    outs = (ctypes.c_void_p * 3)(n_o.data_ptr(), n_s.data_ptr(),
                                 obj.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.window_dp_rows_launch(ins, outs, float(tput.alpha),
                                       float(tput.beta), b, w1, tn, stream)
    _build.check(lib, SOURCE, rc, "window_dp_rows")
    window_dp.launches += 1
    window_dp_rows.launches += 1
    return n_o, n_s, obj


window_dp.launches = 0
window_dp_rows.launches = 0
