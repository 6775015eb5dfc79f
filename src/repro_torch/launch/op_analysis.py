"""Per-device accounting of a step from its op stream: the port's
counterpart of the JAX package's ``launch/hlo_analysis.py``.

The port has no HLO. A step runs on fake tensors (``FakeTensorMode``: no
memory, no arithmetic) under :class:`OpCounter`, a dispatch mode that logs
every aten op one rank runs, with the dtypes and shapes of its inputs and
outputs. On a sharded step the parameters are DTensors: the counter lets
DTensor handle its own ops and logs the local ops it issues for rank 0,
so the counts are per device. DTensor also runs each op once on global
shapes to propagate its metadata; those runs are not the rank's work and
are not logged. :func:`analyze` reduces a log to:

  * dot FLOPs            (``torch.utils.flop_counter``'s formulas: mm,
                          bmm, addmm, baddbmm, convolution)
  * traffic bytes        (operand + result bytes of every op that is not
                          a view: eager PyTorch launches each op unfused,
                          so this is what the plain path moves)
  * collective bytes     (result bytes of each ``_c10d_functional``
                          collective, by kind)

With ``kernels=True`` (:func:`count_ops`) the step runs the card's path
and each launch of K2, K3, K3's backward, K4 or K4's backward is logged as
one op, ``kernel.<name>``: its inputs read once, its outputs written once,
and the operations the function does on this step's inputs (``lora_flops``,
``attention_flops``, ``attention_backward_flops``, ``ssd_flops``,
``ssd_backward_flops``). The plain body that stands in for a kernel off
the card is not run, so the S x S scores of the plain attention, which
neither K3 nor its backward writes, are not counted. What the kernels do
not cover (the decode step's attention is plain) is counted op by op.

An eager loop runs every iteration, so nothing is multiplied by a trip
count: ``while_trips`` holds the repeat counts the caller reports (the
dry run's layer loops and microbatches) and ``unknown_trip_whiles`` is
always 0. :func:`save_log` / :func:`load_log` keep a log as zlib-compressed
JSON lines, so ``launch.reanalyze`` can count it again.
"""
from __future__ import annotations

import contextlib
import functools
import json
import weakref
import zlib
from typing import Dict, List, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils._pytree import tree_leaves

from repro_torch.kernels.ref import SSD_CHUNK

COLLECTIVE_KINDS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# _c10d_functional op name -> kind
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}

# ops that alias their input or only allocate: no traffic (the
# reference's _SKIP_TRAFFIC)
_NO_TRAFFIC = {"_unsafe_view", "empty", "empty_strided", "empty_like",
               "lift_fresh", "wait_tensor", "detach", "alias"}


def type_bytes(dtype, shape, f32_as: int = 4) -> int:
    """Bytes of a tensor of ``dtype`` (a torch.dtype or its name, as the
    log keeps it) and ``shape``. ``f32_as=2`` gives the bf16-equivalent
    count, the reference's yardstick for its CPU backend's f32 promotion;
    the port's f32 tensors are f32 on the card too."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype.split(".")[-1])
    n = 1
    for d in shape:
        n *= int(d)
    size = f32_as if dtype == torch.float32 else dtype.itemsize
    return n * size


def _tensors(x) -> list:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _spec(t: torch.Tensor) -> list:
    return [str(t.dtype).split(".")[-1], list(t.shape)]


class OpCounter(TorchDispatchMode):
    """Log each aten op this rank runs, and the most live bytes.

    ``log`` is a list of {"op", "in", "out", "view", "flops"} records.
    ``peak_bytes`` is the largest sum of the sizes of the storages alive
    at once, counting from the storages of ``arguments`` (the tensors
    that exist before the step: parameters, optimizer state, inputs) and
    adding every storage an op creates until it is freed."""

    def __init__(self, arguments=()):
        super().__init__()
        self.log: List[dict] = []
        self.live = 0
        self.peak_bytes = 0
        self._seen: Dict[int, int] = {}
        for t in _tensors(arguments):
            self._track(_local(t))

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        self.live += n
        self.peak_bytes = max(self.peak_bytes, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _UNLOGGED[0] or func.namespace not in ("aten",
                                                     "_c10d_functional"):
            return out
        flops = 0.0
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            flops = float(formula(*args, **kwargs, out_val=out))
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        self.log.append({
            "op": f"{func.namespace}.{func._schema.name.split('::')[-1]}",
            "in": [_spec(t) for t in _tensors((args, kwargs))],
            "out": [_spec(t) for t in outs],
            "view": bool(func.is_view),
            "flops": flops,
        })
        return out

    def kernel(self, name: str, ins, outs, flops: float) -> None:
        """Log one kernel launch as one op, ``kernel.<name>``."""
        self.log.append({"op": f"kernel.{name}",
                         "in": [_spec(t) for t in _tensors(ins)],
                         "out": [_spec(t) for t in _tensors(outs)],
                         "view": False, "flops": float(flops)})


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


# set while an op runs that is not the rank's work: DTensor propagating an
# op's metadata on global shapes, a kernel's stand-in reading its positions
_UNLOGGED = [False]


@contextlib.contextmanager
def unlogged():
    """Ops run inside are not the rank's work: the counter passes them
    through unlogged."""
    outer = _UNLOGGED[0]
    _UNLOGGED[0] = True
    try:
        yield
    finally:
        _UNLOGGED[0] = outer


@contextlib.contextmanager
def count_ops(arguments=(), kernels: bool = False):
    """``with count_ops(arguments) as counter:`` runs the body under an
    :class:`OpCounter`, with DTensor's metadata propagation (its one
    private hook, restored on exit) kept out of the log. ``kernels``
    logs each kernel launch (K2, K3, K4 and the backwards) as one op
    (:func:`kernels_logged`)."""
    prop = DTensor._op_dispatcher.sharding_propagator
    # the uncached propagation where this PyTorch has it (the cached one
    # calls it), else the one method older versions have
    name = next(n for n in ("_propagate_tensor_meta_non_cached",
                            "_propagate_tensor_meta") if hasattr(prop, n))
    inner = getattr(prop, name)

    def quiet(*args, **kwargs):
        with unlogged():
            return inner(*args, **kwargs)

    setattr(prop, name, quiet)
    try:
        with OpCounter(arguments) as counter:
            with (kernels_logged(counter) if kernels
                  else contextlib.nullcontext()):
                yield counter
    finally:
        delattr(prop, name)


# ---------------------------------------------------------------------------
# The kernels, each launch one op
# ---------------------------------------------------------------------------

def lora_flops(m: int, k: int, n: int, r: int) -> int:
    """K2's products: x @ W, x @ A and (x @ A) @ B."""
    return 2 * m * k * n + 2 * m * k * r + 2 * m * r * n


@functools.lru_cache(maxsize=None)
def attention_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """Unmasked (query, key) pairs of one head, query and key positions
    counting from 0 (K3's index path)."""
    n = 0
    for i in range(sq):
        hi = min(i, sk - 1) if causal else sk - 1
        lo = 0 if window is None else max(0, i - window + 1)
        n += max(0, hi - lo + 1)
    return n


def _position_pairs(q_pos, k_pos, causal: bool, window) -> int:
    qp, kp = q_pos.tolist(), k_pos.tolist()
    return sum(1 for i in qp for j in kp
               if (not causal or j <= i) and (window is None
                                              or j > i - window))


def _pairs(sq, sk, causal, window, q_pos, k_pos) -> int:
    """Unmasked pairs of one head; positions are read where they hold
    data, and on fake tensors (the dry run) taken to count from 0."""
    from torch._subclasses.fake_tensor import is_fake

    if q_pos is None or is_fake(q_pos) or q_pos.device.type == "meta":
        return attention_pairs(sq, sk, causal, window)
    return _position_pairs(q_pos, k_pos, causal, window)


def attention_flops(bh: int, sq: int, sk: int, d: int, causal: bool,
                    window, q_pos=None, k_pos=None) -> int:
    """K3's products, 4 D operations for each unmasked (query, key) pair
    of each of the BH heads (q k^T and p v)."""
    return 4 * d * bh * _pairs(sq, sk, causal, window, q_pos, k_pos)


def attention_backward_flops(bh: int, sq: int, sk: int, d: int,
                             causal: bool, window, q_pos=None,
                             k_pos=None) -> int:
    """The products of attention's gradient, 10 D operations for each
    unmasked pair of each head: q k^T recomputed, dO V^T, P^T dO, dS K and
    dS^T Q (K3's backward kernel recomputes q k^T and dO V^T in each of
    its passes and halves P and dS into hi + lo; those repeats are its own
    work, not the function's)."""
    return 10 * d * bh * _pairs(sq, sk, causal, window, q_pos, k_pos)


def ssd_flops(bt: int, h: int, g: int, s: int, p: int, n: int) -> int:
    """K4's products over its chunks of SSD_CHUNK steps: the score tile
    C B^T once a group (its H / G heads share B and C), and for each head
    its product with x, C against the state and the state update."""
    c = SSD_CHUNK
    return bt * -(-s // c) * 2 * (g * c * c * n
                                  + h * (c * c * p + 2 * c * n * p))


def ssd_backward_flops(bt: int, h: int, g: int, s: int, p: int,
                       n: int) -> int:
    """K4's backward products over its chunks of SSD_CHUNK steps: per
    chunk and group the three score-shaped products over N (S = C B^T,
    (sum dS)^T C and (sum dS) B: B and C are the group's, so dB's and dC's
    score terms are linear in the heads' dS); per chunk and head dy x^T,
    M^T dy and four state-sized products (B G, x G^T, dy H^T, G's update);
    per head the forward's state update again for every chunk but the
    last."""
    c, nc = SSD_CHUNK, -(-s // SSD_CHUNK)
    per_group = 3 * c * c * n
    per_head = 2 * c * c * p + 4 * c * n * p
    return bt * 2 * (nc * (g * per_group + h * per_head)
                     + h * max(nc - 1, 0) * c * n * p)


@contextlib.contextmanager
def kernels_logged(counter: "OpCounter"):
    """Inside, K2's launch (``lora_matmul._run``, forward and backward
    dx), K3's (``flash_attention.flash_attention``, with or without the
    row statistics), K3's backward's
    (``flash_attention.flash_attention_backward``), K4's
    (``ssd_scan.ssd_scan_grouped``), K4's backward's
    (``ssd_scan.ssd_scan_grouped_backward``) and the Mamba-2 conv's, each
    way (``causal_conv.causal_conv``, ``causal_conv.causal_conv_backward``;
    no products: no FLOPs) make their outputs empty and log one op each on
    ``counter``. Their plain bodies do not run: the count is of the
    kernels' traffic and operations. Restored on exit."""
    from repro_torch.kernels import causal_conv as kconv
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels import lora_matmul as k2
    from repro_torch.kernels import ssd_scan as k4

    def lora(x, w, a, b, scale):
        (m, k), n, r = x.shape, w.shape[1], a.shape[1]
        y = torch.empty((m, n), dtype=x.dtype, device=x.device)
        counter.kernel("lora_matmul", (x, w, a, b), y, lora_flops(m, k, n, r))
        return y

    def flash(q, k, v, *, causal=True, window=None, q_pos=None, k_pos=None,
              stats=False):
        bh, sq, d = q.shape
        outs = (torch.empty_like(q),) + tuple(
            torch.empty((bh, sq), dtype=torch.float32, device=q.device)
            for _ in range(2 if stats else 0))
        with unlogged():  # reading the positions is not K3's work
            flops = attention_flops(bh, sq, k.shape[1], d, causal, window,
                                    q_pos, k_pos)
        counter.kernel("flash_attention", (q, k, v, q_pos, k_pos), outs,
                       flops)
        return outs if stats else outs[0]

    def flash_backward(q, k, v, m, l, do, *, causal=True, window=None,
                       q_pos=None, k_pos=None, needs=(True,) * 3):
        grads = tuple(torch.empty_like(t) for t in (q, k, v))
        bh, sq, d = q.shape
        with unlogged():
            flops = attention_backward_flops(bh, sq, k.shape[1], d, causal,
                                             window, q_pos, k_pos)
        counter.kernel("flash_attention_backward",
                       (q, k, v, m, l, do, q_pos, k_pos), grads, flops)
        return tuple(g if need else None for g, need in zip(grads, needs))

    def ssd(x, dt, A, B, C):
        bt, s, h, p = x.shape
        g, n = B.shape[2:]
        y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        hfin = torch.empty((bt, h, n, p), dtype=torch.float32,
                           device=x.device)
        counter.kernel("ssd_scan", (x, dt, A, B, C), (y, hfin),
                       ssd_flops(bt, h, g, s, p, n))
        return y, hfin

    def ssd_backward(x, dt, A, B, C, dy, dh=None, needs=(True,) * 5):
        bt, s, h, p = x.shape
        g, n = B.shape[2:]
        grads = tuple(torch.empty(t.shape, dtype=dtype, device=x.device)
                      for t, dtype in ((x, x.dtype), (dt, torch.float32),
                                       (A, torch.float32), (B, B.dtype),
                                       (C, C.dtype)))
        counter.kernel("ssd_scan_backward", (x, dt, A, B, C, dy, dh), grads,
                       ssd_backward_flops(bt, h, g, s, p, n))
        return tuple(gr if need else None for gr, need in zip(grads, needs))

    def conv(xin, B, C, w, b):
        y = torch.empty((*xin.shape[:2], w.shape[0]), dtype=xin.dtype,
                        device=xin.device)
        counter.kernel("causal_conv", (xin, B, C, w, b), y, 0)
        return y

    def conv_backward(xin, B, C, w, b, dx=None, dB=None, dC=None,
                      needs=(True,) * 5):
        grads = tuple(torch.empty_like(t) if need else None
                      for t, need in zip((xin, B, C, w, b), needs))
        counter.kernel("causal_conv_backward", (xin, B, C, w, b, dx, dB, dC),
                       grads, 0)
        return grads

    saved = (k2._run, k3.flash_attention, k3.flash_attention_backward,
             k4.ssd_scan_grouped, k4.ssd_scan_grouped_backward,
             kconv.causal_conv, kconv.causal_conv_backward)
    (k2._run, k3.flash_attention, k3.flash_attention_backward,
     k4.ssd_scan_grouped, k4.ssd_scan_grouped_backward, kconv.causal_conv,
     kconv.causal_conv_backward) = (lora, flash, flash_backward, ssd,
                                    ssd_backward, conv, conv_backward)
    try:
        yield
    finally:
        (k2._run, k3.flash_attention, k3.flash_attention_backward,
         k4.ssd_scan_grouped, k4.ssd_scan_grouped_backward,
         kconv.causal_conv, kconv.causal_conv_backward) = saved


def analyze(log: List[dict], while_trips=(), top_k: int = 0) -> dict:
    """A log's totals, under the reference's keys. ``while_trips`` is
    passed through (see the module docstring). ``kernels`` tallies the
    kernel launches (``kernel.<name>`` records: count, bytes, FLOPs).
    ``top_k`` > 0 also returns the ops that move the most bytes."""
    acc = {
        "dot_flops": 0.0,
        "traffic_bytes": 0.0,
        "traffic_bytes_bf16eq": 0.0,
        "collectives": {k: {"bytes": 0.0, "bytes_bf16eq": 0.0, "count": 0.0}
                        for k in COLLECTIVE_KINDS},
        "while_trips": list(while_trips),
        "unknown_trip_whiles": 0,
        "kernels": {},
    }
    contrib: Dict[tuple, float] = {}
    for rec in log:
        ns, name = rec["op"].split(".", 1)
        acc["dot_flops"] += rec["flops"]
        if ns == "_c10d_functional" and name in _COLLECTIVE_OPS:
            kind = acc["collectives"][_COLLECTIVE_OPS[name]]
            kind["bytes"] += sum(type_bytes(*o) for o in rec["out"])
            kind["bytes_bf16eq"] += sum(type_bytes(*o, f32_as=2)
                                        for o in rec["out"])
            kind["count"] += 1
        if rec["view"] or name in _NO_TRAFFIC:
            continue
        ins = rec["in"][1:] if name == "copy_" else rec["in"]  # dst written
        b = sum(type_bytes(*t) for t in ins + rec["out"])
        acc["traffic_bytes"] += b
        if ns == "kernel":
            k = acc["kernels"].setdefault(name, {"count": 0, "bytes": 0.0,
                                                 "flops": 0.0})
            k["count"] += 1
            k["bytes"] += b
            k["flops"] += rec["flops"]
        acc["traffic_bytes_bf16eq"] += sum(type_bytes(*t, f32_as=2)
                                           for t in ins + rec["out"])
        if top_k:
            key = (rec["op"], str(rec["out"][:1]))
            contrib[key] = contrib.get(key, 0.0) + b
    acc["collective_bytes_total"] = sum(
        v["bytes"] for v in acc["collectives"].values())
    acc["collective_bytes_bf16eq"] = sum(
        v["bytes_bf16eq"] for v in acc["collectives"].values())
    if top_k:
        acc["top_traffic"] = sorted(((v, k) for k, v in contrib.items()),
                                    reverse=True)[:top_k]
    return acc


def save_log(log: List[dict], path: str, meta: Optional[dict] = None) -> None:
    """The log as zlib-compressed JSON lines, ``meta`` (the loop counts)
    first."""
    lines = [json.dumps(meta or {})] + [json.dumps(r) for r in log]
    with open(path, "wb") as f:
        f.write(zlib.compress("\n".join(lines).encode(), 6))


def load_log(path: str):
    """-> (log, meta) of :func:`save_log`."""
    with open(path, "rb") as f:
        lines = zlib.decompress(f.read()).decode().split("\n")
    return [json.loads(x) for x in lines[1:]], json.loads(lines[0])
