"""The dry run's DTensor versions of the model functions that DTensor has
no sharding strategy for, or no cheap one. ``launch.dryrun`` installs
them around a sharded step (:func:`installed`); the model layers keep
only the reference's ``shard`` sites, and every unsharded path runs them
as they are. Each stand-in calls the model's own function, on plain
tensors as it is and on DTensors block by block:

  * attention: each rank attends its own (batch rows, heads) block, whole
    along the sequence (merging batch and heads would make strided
    shards); K and V are first repeated to every query head when their
    heads are not laid out as the queries' are;
  * MoE dispatch and combine, per batch row (a stable sort, a scatter and
    ``index_add_``);
  * the embedding: each rank looks up its own batch rows in the whole
    table (PyTorch refuses an index on a batch over two mesh axes);
  * the cache: made as DTensors whose local blocks alone exist; prefill,
    decode and the stacked Mamba2 writes land in each rank's block.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import torch

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


def _embed_inputs(orig):
    def embed_inputs(cfg, params, batch):
        if cfg.embed_inputs or not is_dtensor(batch["tokens"]):
            return orig(cfg, params, batch)
        from repro_torch.models.transformer import model_dtype

        table = whole(params["embed"])
        tokens = batch["tokens"]
        h = blockwise(lambda t: table[t], (rows(tokens),), tokens)
        return shard(h.to(model_dtype(cfg)), "batch", "seq", "embed")

    return embed_inputs


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


@contextlib.contextmanager
def installed():
    """The stand-ins in place of the model's functions; restored on
    exit."""
    from repro_torch.models import attention as attn
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf

    sites = ((attn, "attend", _attend), (attn, "write_prefill",
                                          _write_prefill),
             (attn, "write_decode", _write_decode),
             (moe, "_dispatch", _dispatch), (moe, "_combine", _combine),
             (tf, "embed_inputs", _embed_inputs),
             (tf, "init_cache", _init_cache),
             (tf, "_write_mamba", _write_mamba))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in sites]
    for mod, name, make in sites:
        setattr(mod, name, make(getattr(mod, name)))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
