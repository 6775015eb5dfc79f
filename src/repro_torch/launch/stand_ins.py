"""The dry run's DTensor versions of the model functions that DTensor has
no sharding strategy for, or no cheap one, and the layout rules that make
a sharded step do, per device, the work of the reference's program as
XLA's SPMD partitioner lays it out. ``launch.dryrun`` installs them
around a sharded step (:func:`installed`); the model layers keep only the
reference's ``shard`` sites, and every unsharded path runs them as they
are. Each stand-in calls the model's own function, on plain tensors as it
is and on DTensors block by block:

  * attention: each rank attends its own (batch rows, heads) block, whole
    along the sequence (merging batch and heads would make strided
    shards); K and V are first repeated to every query head when their
    heads are not laid out as the queries' are;
  * the Mamba2 SSD scan: each rank scans its own (batch rows, heads)
    block;
  * MoE dispatch and combine, per batch row (a stable sort, a scatter and
    ``index_add_``);
  * the embedding: the tokens gathered where the table's width is split,
    each rank's lookup in its width block, then its own rows whole; the
    tied output head sliced to the logits' vocabulary split;
  * the cache: made as DTensors whose local blocks alone exist; prefill,
    decode and the stacked Mamba2 writes land in each rank's block.

Below autograd (:class:`_Layouts`), so that the backward and the layers
it recomputes follow them too: every product with a DTensor operand is
laid out by :func:`_plan` (GSPMD's choices for a dot, where DTensor's
cost model would rather move activations than gather a weight), its
partial sums reduced at once; a mean or logsumexp over a split dimension
is reduced across the split. DTensor's CPU fallback for a shard-to-shard
move (an all-gather, as gloo has no all-to-all) is counted as the one
all-to-all a card's mesh runs, and an op input's redistribution is
reused by the next op that asks the same of the same tensor.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import ops
from repro_torch.launch import op_analysis
from repro_torch.sharding import (current_ctx, named_sharding, shard,
                                  str_to_axes)
from repro_torch.utils.tree import flatten, unflatten


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def rows(x) -> tuple:
    """The logical axes of an array that leads with the batch."""
    return ("batch",) + (None,) * (x.ndim - 1)


def whole(x):
    """A plain tensor of the full value: a DTensor gathered; ``x`` itself
    otherwise."""
    return x.full_tensor() if is_dtensor(x) else x


def zeros(shape, logical_axes, dtype, device):
    """``torch.zeros(shape)``; inside a sharding context a DTensor laid out
    by ``logical_axes`` whose local blocks are made as zeros (no global
    buffer is made)."""
    ctx = current_ctx()
    if ctx is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor

    mesh, pl = named_sharding(logical_axes, shape, ctx)
    local = list(shape)
    for m, p in enumerate(pl):
        if p.is_shard():
            local[p.dim] //= mesh.size(m)
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=device),
                              mesh, pl, run_check=False)


def _block(x, dim: int) -> Tuple[int, int]:
    """(offset, length) of this rank's block of a DTensor along ``dim``:
    the blocks are the row-major product of the mesh dimensions that
    shard it, in mesh order (DTensor's even sharding)."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    count, index = 1, 0
    for m, p in enumerate(x.placements):
        if p.is_shard(dim):
            index = index * mesh.size(m) + coord[m]
            count *= mesh.size(m)
    length = x.shape[dim] // count
    return index * length, length


def write(dst, dim: int, start: int, src) -> None:
    """``dst.narrow(dim, start, n).copy_(src)`` in place (n = src's size
    along ``dim``), on a DTensor ``dst``: ``src`` is laid out as ``dst``;
    when it covers part of ``dim``, it is whole along ``dim`` on every
    rank, and each rank writes the part of the range that its block holds
    (a rank whose block misses the range writes nothing)."""
    from torch.distributed.tensor import DTensor, Replicate

    n = src.shape[dim]
    mesh = dst.device_mesh
    full = start == 0 and n == dst.shape[dim]
    pl = tuple(p if full or not p.is_shard(dim) else Replicate()
               for p in dst.placements)
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    src = src.redistribute(mesh, pl).to_local()
    loc = dst.to_local()
    if full:
        loc.copy_(src)
        return
    lo, length = _block(dst, dim)
    a, b = max(start, lo), min(start + n, lo + length)
    if a < b:
        loc.narrow(dim, a - lo, b - a).copy_(src.narrow(dim, a - start,
                                                        b - a))


def blockwise(fn, axes, *xs):
    """``fn(*xs)`` block by block: each input is laid out by its logical
    axes (``axes[i]``), ``fn`` runs on this rank's blocks, and every
    output comes back as a DTensor with the first input's placements. The
    caller picks axes under which the blocks are independent (batch rows,
    heads)."""
    from torch.distributed.tensor import DTensor

    xs = [shard(x, *ax) for x, ax in zip(xs, axes)]
    mesh, pl = xs[0].device_mesh, xs[0].placements
    out = fn(*[x.to_local() for x in xs])
    leaves, treedef = flatten(out)
    return unflatten(treedef, [DTensor.from_local(o, mesh, pl,
                                                  run_check=False)
                               for o in leaves])


# ---------------------------------------------------------------------------
# The stand-ins: each wraps the model's function ``orig``
# ---------------------------------------------------------------------------

def _attend(orig):
    def attend(q, k, v, q_pos, k_pos, causal, window, kcfg=ops.DEFAULT):
        if not is_dtensor(q):
            return orig(q, k, v, q_pos, k_pos, causal, window, kcfg)
        q_pos, k_pos = whole(q_pos), whole(k_pos)
        q_axes = ("batch", None, "heads", None)
        kv_axes = ("batch", None, "kv_heads", None)
        heads = named_sharding(q_axes, q.shape)[1]
        kv = named_sharding(kv_axes, k.shape)[1]
        if [p.is_shard(2) for p in heads] != [p.is_shard(2) for p in kv]:
            rep = q.shape[2] // k.shape[2]
            k, v = k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)
            kv_axes = q_axes
        return blockwise(
            lambda q, k, v: orig(q, k, v, q_pos, k_pos, causal, window,
                                 kcfg),
            (q_axes, kv_axes, kv_axes), q, k, v)

    return attend


def _dispatch(orig):
    def dispatch(cfg, x, idx, cap):
        if not is_dtensor(x):
            return orig(cfg, x, idx, cap)
        return blockwise(lambda xs, ids: orig(cfg, xs, ids, cap),
                         (rows(x), rows(idx)), x, idx)

    return dispatch


def _combine(orig):
    def combine(cfg, out, info, wts, s):
        if not is_dtensor(out):
            return orig(cfg, out, info, wts, s)
        n = len(info)
        return blockwise(
            lambda o, *rest: orig(cfg, o, rest[:n], rest[n], s),
            [rows(t) for t in (out, *info, wts)], out, *info, wts)

    return combine


def _ssd_chunked(orig):
    def ssd_chunked(x, dt, A, B, C, chunk):
        if not is_dtensor(x):
            return orig(x, dt, A, B, C, chunk)
        from torch.distributed.tensor import DTensor, Partial, Shard

        # each rank scans its own (batch rows, heads) block, as XLA
        # partitions the einsums; B and C are the groups' (one group: whole
        # on every rank), so their gradient is a partial sum over the
        # ranks that split the heads
        x = shard(x, "batch", None, "ssm_heads", None)
        cut = [p.is_shard(2) for p in x.placements]
        if B.shape[2] > 1 and any(cut):
            return orig(x, dt, A, B, C, chunk)
        dt = shard(dt, "batch", None, "ssm_heads")
        A = shard(A, "ssm_heads")
        B, C = (shard(t, "batch", None, None, None) for t in (B, C))
        mesh, pl = x.device_mesh, x.placements
        if [p.is_shard(0) for p in pl] != [p.is_shard(0)
                                           for p in B.placements]:
            return orig(x, dt, A, B, C, chunk)
        grads = [Partial() if c else p for c, p in zip(cut, B.placements)]
        y, h = orig(x.to_local(), dt.to_local(), A.to_local(),
                    B.to_local(grad_placements=grads),
                    C.to_local(grad_placements=grads), chunk)
        return (DTensor.from_local(y, mesh, pl, run_check=False),
                DTensor.from_local(h, mesh, [Shard(1) if c else p for c, p
                                             in zip(cut, pl)],
                                   run_check=False))

    return ssd_chunked


def _embed_inputs(orig):
    def embed_inputs(cfg, params, batch):
        if cfg.embed_inputs or not is_dtensor(batch["tokens"]):
            return orig(cfg, params, batch)
        from torch.distributed.tensor import DTensor, Replicate, Shard

        from repro_torch.models.transformer import model_dtype

        # the table's rows are never split (its axes are (None, "fsdp"));
        # XLA's lookup: the tokens gathered along the axes that split the
        # table's width, each rank's tokens looked up in its width block,
        # then the constraint below hands every rank its own rows whole
        # (an all-to-all on each of those axes)
        table, tokens = params["embed"], batch["tokens"]
        mesh = tokens.device_mesh
        split = [p.is_shard(1) for p in table.placements]
        tokens = tokens.redistribute(mesh, [
            Replicate() if cut else p
            for cut, p in zip(split, tokens.placements)])
        h = table.to_local()[tokens.to_local()]
        h = DTensor.from_local(h, mesh, [
            Shard(2) if cut else p for cut, p in zip(split,
                                                     tokens.placements)],
            run_check=False)
        return shard(h.to(model_dtype(cfg)), "batch", "seq", "embed")

    return embed_inputs


def _reuse(orig):
    def redistribute_local_tensor(local, current, target, *args, **kwargs):
        # an op input's redistribution, kept for the next op that asks the
        # same of the same unchanged tensor (the three slices of one
        # tensor): XLA reshards a value once, whatever reads it
        key = (id(local), local._version, current.placements,
               target.placements)
        if last and last[0] == key and last[1]() is local and \
                last[2]._version == last[3]:
            return last[2]
        out = orig(local, current, target, *args, **kwargs)
        last[:] = [key, weakref.ref(local), out, out._version]
        return out

    last = []
    return redistribute_local_tensor


def _alltoall(orig):
    def shard_dim_alltoall(x, gather_dim, shard_dim, mesh, mesh_dim):
        # DTensor takes a CPU mesh's shard-to-shard move as an all-gather
        # and a slice (gloo has no all-to-all), n times the bytes of the
        # all-to-all a card's mesh runs: the dry run counts the latter
        n = mesh.size(mesh_dim)
        if x.shape[shard_dim] % n:
            return orig(x, gather_dim, shard_dim, mesh, mesh_dim)
        from torch.distributed import _functional_collectives as funcol

        pieces = torch.stack(x.chunk(n, dim=shard_dim)).contiguous()
        got = funcol.all_to_all_single(pieces, None, None, (mesh, mesh_dim))
        if isinstance(got, funcol.AsyncCollectiveTensor):
            got = got.wait()
        return torch.cat(got.unbind(0), dim=gather_dim).contiguous()

    return shard_dim_alltoall


def _unembed(orig):
    def unembed(cfg, params, h):
        if "head" in params or not is_dtensor(h):
            return orig(cfg, params, h)
        # the logits' constraint splits the vocabulary: the tied table's
        # replicated rows are sliced to it before the product (no
        # collective), as GSPMD carries the constraint back into the dot
        table = shard(params["embed"], "vocab", "fsdp")
        return orig(cfg, {**params, "embed": table}, h)

    return unembed


def _init_cache(orig):
    def init_cache(cfg, batch, max_len, device):
        if current_ctx() is None:
            return orig(cfg, batch, max_len, device)
        from repro_torch.models.transformer import cache_axes

        with op_analysis.unlogged():  # shapes and dtypes only
            c = orig(cfg, batch, max_len, device)
        axes = cache_axes(cfg)
        return {k: zeros(v.shape, str_to_axes(axes[k]), v.dtype, v.device)
                if isinstance(v, torch.Tensor) else v for k, v in c.items()}

    return init_cache


def _write_prefill(orig):
    def write_prefill(cfg, cache_k, cache_v, k, v):
        if not is_dtensor(cache_k):
            return orig(cfg, cache_k, cache_v, k, v)
        w, s = cache_k.shape[1], k.shape[1]
        if s >= w:
            k = torch.roll(k[:, -w:], s % w, dims=1)
            v = torch.roll(v[:, -w:], s % w, dims=1)
        write(cache_k, 1, 0, k)
        write(cache_v, 1, 0, v)
        return cache_k, cache_v

    return write_prefill


def _write_decode(orig):
    def write_decode(cache_k, cache_v, k1, v1, index):
        if not is_dtensor(cache_k):
            return orig(cache_k, cache_v, k1, v1, index)
        slot = index % cache_k.shape[1]
        write(cache_k, 1, slot, k1)
        write(cache_v, 1, slot, v1)
        return cache_k, cache_v

    return write_decode


def _write_mamba(orig):
    def write_mamba(cache, at, mc):
        if not is_dtensor(cache["conv"]):
            return orig(cache, at, mc)
        for k in ("conv", "ssd"):
            write(cache[k][at], 0, 0, mc[k])

    return write_mamba


# ---------------------------------------------------------------------------
# Products laid out as XLA's SPMD partitioner lays them out
# ---------------------------------------------------------------------------

def _roles(x, w):
    """The role of each dimension of the operands of ``mm`` (x (M, K)
    against w (K, N)) or ``bmm`` (x (E, M, K) against w (E, K, N)): rows
    keep their index in the output, N is its last dimension. -> ({x dim:
    role}, {w dim: role})."""
    if w.ndim == 2:
        return {0: "row", 1: "k"}, {0: "k", 1: "n"}
    return {0: "batch", 1: "row", 2: "k"}, {0: "batch", 1: "k", 2: "n"}


def _dim(p):
    """The tensor dimension a placement splits (a strided split too), or
    None."""
    return None if p.is_replicate() or p.is_partial() else p.dim


def _plan(x, w):
    """Per mesh axis, which block of each operand a rank takes and what
    the output is, as GSPMD partitions a dot:

      * against rows split on an axis, the other operand is gathered
        there (the weight's ``fsdp`` block); when that block splits the
        contraction, an axis of the same size splits neither operand and
        the output's block and the weight's are no larger than the whole
        weight, the contraction is split on that free axis instead (XLA
        moves the block there by a collective-permute, and reduces the
        output rather than gathering the weight);
      * a contraction split on one side only is split on the other by
        slicing its replicated block (no collective) into partial sums;
        when both sides split it and an axis of the same size is free,
        the rows are split on that axis (the transpose of the move
        above: a weight gradient comes out split where its weight was
        moved to);
      * a K split against an N split gathers x, unless x is larger than
        w and the output together (then w is split on K and the partial
        output reduced);
      * a batch dimension takes the split of the side that has one.

    A partial sum is reduced first. -> (x placements, w placements,
    output placements), or None for a strided split (an einsum's merged
    dimensions) of K or N, or of a batch dimension split two different
    ways: DTensor's own strategy takes those."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    xr, wr = _roles(x, w)
    rx = ["R" if _dim(p) is None else xr[p.dim] for p in x.placements]
    rw = ["R" if _dim(p) is None else wr[p.dim] for p in w.placements]
    if any(r == "k" and not p.is_shard() for r, p in zip(rx, x.placements)) \
            or any(r in ("k", "n") and not p.is_shard()
                   for r, p in zip(rw, w.placements)):
        return None  # a strided split of K or N
    mesh = x.device_mesh
    free = [m for m in range(mesh.ndim) if rx[m] == rw[m] == "R"]
    w_local = w._local_tensor.numel()
    out_local = x._local_tensor.shape[0] * w.shape[-1]
    moved = {}  # free axis -> "k" (contraction moved) or "row"
    for m in range(mesh.ndim):
        if x.ndim == 2 and rw[m] == "k" and (
                rx[m] == "row" and out_local + w_local <= w.numel()
                or rx[m] == "k"):
            to = next((f for f in free if f not in moved
                       and mesh.size(f) == mesh.size(m)), None)
            if to is not None and (rx[m] == "row" or "row" not in rx):
                moved[to] = "k" if rx[m] == "row" else "row"
    rep, part, n_out = Replicate(), Partial(), Shard(x.ndim - 1)
    out_numel = x.numel() // x.shape[-1] * w.shape[-1]
    k = (Shard(x.ndim - 1), Shard(w.ndim - 2), part)
    plans = []
    for m, (px, pw) in enumerate(zip(x.placements, w.placements)):
        pw = rep if rw[m] == "R" else pw
        if moved.get(m) == "k":
            plans.append(k)
        elif moved.get(m) == "row":
            plans.append((Shard(0), rep, Shard(0)))
        elif rx[m] == "row":
            plans.append((px, rep, px))
        elif "batch" in (rx[m], rw[m]):
            b = pw if rx[m] == "R" else px
            if rw[m] not in ("R", "batch") or rw[m] == "batch" and b != pw:
                if not (px.is_shard() and pw.is_shard()):
                    return None
                b = Shard(0)
            plans.append((b, b, b))
        elif rx[m] == "R" and rw[m] != "k":
            plans.append((rep, pw, n_out if rw[m] == "n" else rep))
        elif rw[m] == "n" and x.numel() <= w.numel() + out_numel:
            plans.append((rep, pw, n_out))  # x split on K: gathered
        else:  # a K split on both sides, one of them by slicing
            plans.append(k)
    return tuple(tuple(p[i] for p in plans) for i in range(3))


def _dtensor(local, mesh, placements, shape, stride):
    """A DTensor made below autograd (no autograd Function)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta

    spec = DTensorSpec(mesh, tuple(placements), tensor_meta=TensorMeta(
        torch.Size(shape), tuple(stride), local.dtype))
    return DTensor(local, spec, requires_grad=False)


def _moved(t, placements):
    """The DTensor ``t`` laid out by ``placements`` below autograd: the
    collectives of DTensor's own redistribution, partial sums reduced by
    all-reduce."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._redistribute import \
        redistribute_local_tensor

    placements = tuple(placements)
    if tuple(t.placements) == placements:
        return t
    spec = DTensorSpec(t.device_mesh, placements,
                       tensor_meta=t._spec.tensor_meta)
    return DTensor(redistribute_local_tensor(t._local_tensor, t._spec, spec),
                   spec, requires_grad=False)


def _reduced(t):
    """``t`` with its partial sums reduced (all-reduce)."""
    from torch.distributed.tensor import Replicate

    return _moved(t, [Replicate() if p.is_partial() else p
                      for p in t.placements])


def _product(func, x, w):
    """``func(x, w)`` on this rank's blocks as :func:`_plan` lays them
    out, as a DTensor whose partial sums are reduced; None where
    :func:`_plan` leaves the product to DTensor."""
    from torch.distributed.tensor import Replicate

    mesh = (x if is_dtensor(x) else w).device_mesh
    x, w = [t if is_dtensor(t) else _dtensor(
        t, mesh, [Replicate()] * mesh.ndim, t.shape, t.stride())
        for t in (x, w)]
    plan = _plan(x, w)
    if plan is None:
        return None
    px, pw, pout = plan
    y = func(_moved(x, px)._local_tensor, _moved(w, pw)._local_tensor)
    shape = x.shape[:-1] + w.shape[-1:]
    strides, n = [], 1
    for d in reversed(shape):
        strides.append(n)
        n *= d
    # GSPMD reduces a dot's partial sums at once (all-reduce): none is
    # left for the ops after it to redistribute as they choose
    return _reduced(_dtensor(y, mesh, pout, shape, reversed(strides)))


def _split_reduction(x, dims) -> bool:
    """Whether a DTensor is split along one of the dimensions ``dims``."""
    return any(p.is_shard() and p.dim in [d % x.ndim for d in dims]
               for p in x.placements)


def _mean(x, dim, keepdim=False, dtype=None):
    """``mean`` of a DTensor over a split dimension, as XLA partitions it:
    partial sums reduced across the split (an all-reduce of the reduced
    shape), not the input resharded along another dimension. None when
    no reduced dimension is split."""
    if dim is None or not _split_reduction(x, dim):
        return None
    n = 1
    for d in dim:
        n *= x.shape[d]
    return _reduced(torch.sum(x, dim, keepdim, dtype=dtype)) / n


def _logsumexp(x, dim, keepdim=False):
    """``logsumexp`` of a DTensor split along a reduced dimension, as XLA
    partitions it: the maximum and the sum of exponentials reduced across
    the split (two all-reduces of the reduced shape), not the whole
    tensor gathered. None when no reduced dimension is split."""
    if not _split_reduction(x, dim):
        return None
    dims = [d % x.ndim for d in dim]
    m = _reduced(torch.amax(x, dims, keepdim=True))
    out = _reduced(torch.sum(torch.exp(x - m), dims, keepdim=True)).log() + m
    return out if keepdim else out.reshape(
        [n for d, n in enumerate(x.shape) if d not in dims])


class _Layouts(TorchDispatchMode):
    """Runs every ``mm`` and ``bmm`` with a DTensor operand through
    :func:`_product`, a ``logsumexp`` or ``mean`` over a split dimension
    through :func:`_logsumexp` or :func:`_mean`, and everything else as it
    is. It acts below autograd, so the products of the backward, and of
    the layers it recomputes, are laid out by the same rules as the
    forward's."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        aten = torch.ops.aten
        reduction = {aten.logsumexp.default: _logsumexp,
                     aten.mean.dim: _mean}.get(func)
        if reduction is not None and any(issubclass(t, DTensor)
                                         for t in types):
            with torch.no_grad():
                out = reduction(*args, **kwargs)
            if out is not None:
                return out
        if (func in (aten.mm.default, aten.bmm.default)
                and any(issubclass(t, DTensor) for t in types)):
            x, w = args
            with torch.no_grad():
                if func is aten.bmm.default and w.stride(0) == 0:
                    # a 2-D weight broadcast over x's leading dimensions
                    # (``matmul`` of (B, 1, K) by (K, N)): one product
                    out = _product(aten.mm.default,
                                   x.reshape(-1, x.shape[-1]), w[0])
                    out = out.reshape(x.shape[:-1] + w.shape[-1:])
                else:
                    out = _product(func, x, w)
            if out is not None:
                return out
        return func(*args, **kwargs)


@contextlib.contextmanager
def installed():
    """The stand-ins in place of the model's and DTensor's functions, and
    :class:`_Layouts`; restored on exit."""
    from torch.distributed.tensor import _dispatch as dtensor_dispatch
    from torch.distributed.tensor import placement_types

    from repro_torch.models import attention as attn
    from repro_torch.models import moe, ssm
    from repro_torch.models import transformer as tf

    sites = ((attn, "attend", _attend), (attn, "write_prefill",
                                          _write_prefill),
             (attn, "write_decode", _write_decode),
             (moe, "_dispatch", _dispatch), (moe, "_combine", _combine),
             (ssm, "ssd_chunked", _ssd_chunked),
             (tf, "embed_inputs", _embed_inputs),
             (tf, "unembed", _unembed), (tf, "init_cache", _init_cache),
             (placement_types, "shard_dim_alltoall", _alltoall),
             (dtensor_dispatch, "redistribute_local_tensor", _reuse),
             (tf, "_write_mamba", _write_mamba))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in sites]
    for mod, name, make in sites:
        setattr(mod, name, make(getattr(mod, name)))
    try:
        with _Layouts():
            yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
