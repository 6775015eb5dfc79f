"""Logical-axis sharding rules with a divisibility fallback (the JAX
package's ``sharding.py``).

Code names the logical axes of an array ("batch", "heads", "jobs", ...);
the rules map each to mesh axes, dropping any mesh axis that does not
evenly divide the dimension (fallback: replicate). The pool simulator
resolves its (jobs, lanes) grid this way over the pool mesh
(``launch.mesh``). The models record each parameter's axes (:class:`Param`)
and constrain their activations with :func:`shard`, which is the identity
outside a sharding context (:func:`use_sharding`) and on plain tensors, so
every unsharded path runs exactly as without it. Inside one, on a DTensor
(``torch.distributed.tensor``), it redistributes to the placements the
axes resolve to: one ``Shard(d)`` or ``Replicate()`` per mesh dimension.
The dry run (``launch.dryrun``) is the one user of that path.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Sequence, Tuple

from repro_torch.utils.tree import flatten, unflatten

# logical axis -> tuple of mesh axes (tried in order, divisibility permitting)
DEFAULT_RULES = {
    # activations
    "batch": ("pod", "data"),
    "seq": (),
    # KV caches are sequence-parallel over the model axis: kv_heads (1..8)
    # rarely divide a 16-way axis, and sharding the cache length costs only
    # small softmax-combine collectives.
    "kv_seq": ("model",),
    "window": (),
    "embed": (),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ssm_heads": ("model",),
    "ssm_state": (),
    "pos": (),
    # policy-pool simulator (fast_sim.simulate_pool_jobs_sharded): jobs ride
    # the pool mesh's "jobs" axis (or the production data axes). On a 2-D
    # (jobs, lanes) pool mesh (launch.mesh.make_pool_mesh(shape=(a, b))) the
    # policy-lane axis shards over "lanes": the kind partition isolates AHAP
    # from cheap lanes first, so every lane shard carries a uniform DP-heavy
    # or cheap workload.
    "jobs": ("jobs", "pod", "data"),
    "lanes": ("lanes",),
    # weights
    "fsdp": ("data",),
    "tensor": ("model",),
    "vocab": ("model",),
    "experts": (),
    "layers": (),
    "lora_rank": (),
}


def resolve_spec(
    logical_axes: Sequence[Optional[str]],
    shape: Sequence[int],
    mesh,
    rules: dict,
) -> Tuple:
    """Logical axes -> a tuple with one entry per dimension: None
    (replicated), a mesh-axis name, or a tuple of names, dropping mesh
    axes that do not divide the dimension or are already used. ``mesh``
    is a DeviceMesh (its ``mesh_dim_names`` and shape)."""
    if len(logical_axes) != len(shape):
        raise ValueError(f"axes {logical_axes} against shape {shape}")
    used = set()
    out = []
    axis_sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    for name, dim in zip(logical_axes, shape):
        if name is None:
            out.append(None)
            continue
        mesh_axes = rules.get(name, ())
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        picked = []
        extent = 1
        for ax in mesh_axes:
            if ax in used or ax not in axis_sizes:
                continue
            if dim % (extent * axis_sizes[ax]) == 0:
                picked.append(ax)
                extent *= axis_sizes[ax]
        used.update(picked)
        if not picked:
            out.append(None)
        elif len(picked) == 1:
            out.append(picked[0])
        else:
            out.append(tuple(picked))
    return tuple(out)


def shard_block(entry, mesh, coord=None) -> Tuple[int, int]:
    """One dimension's resolved entry as (block count, block index): the
    blocks are the row-major product of the entry's mesh axes at ``coord``
    (None: this rank's coordinate); a replicated (None) dimension is one
    block."""
    if entry is None:
        return 1, 0
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate() if coord is None else coord
    count, index = 1, 0
    for ax in axes:
        size = int(mesh.mesh.shape[names.index(ax)])
        index = index * size + int(coord[names.index(ax)])
        count *= size
    return count, index


# ---------------------------------------------------------------------------
# Context
# ---------------------------------------------------------------------------

class ShardingCtx(NamedTuple):
    mesh: object  # a DeviceMesh
    rules: dict


_CTX: list = []  # stack


def current_ctx() -> Optional[ShardingCtx]:
    return _CTX[-1] if _CTX else None


@contextlib.contextmanager
def use_sharding(mesh, rules: Optional[dict] = None):
    """Install ``mesh`` (a DeviceMesh) and the rules (DEFAULT_RULES updated
    with ``rules``) for :func:`shard` and the sharded constructors."""
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    _CTX.append(ShardingCtx(mesh, merged))
    try:
        yield
    finally:
        _CTX.pop()


def placements(logical_axes, shape, mesh, rules: dict) -> tuple:
    """Logical axes -> DTensor placements, one per mesh dimension:
    ``Shard(d)`` where :func:`resolve_spec` gives tensor dimension d that
    mesh axis, else ``Replicate()``. An entry naming two mesh axes (batch
    over ("pod", "data")) shards one dimension over both, the first
    outermost, which is the mesh's own order; an entry against it
    raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(resolve_spec(logical_axes, shape, mesh,
                                             rules)):
        if entry is None:
            continue
        idx = [names.index(a) for a in ((entry,) if isinstance(entry, str)
                                        else entry)]
        if idx != sorted(idx):
            raise ValueError(f"entry {entry} is against the mesh order "
                             f"{names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def named_sharding(logical_axes, shape, ctx: Optional[ShardingCtx] = None):
    """(mesh, placements) of an array of ``shape`` with these axes."""
    ctx = ctx or current_ctx()
    if ctx is None:
        raise RuntimeError("named_sharding outside a sharding context")
    return ctx.mesh, placements(logical_axes, shape, ctx.mesh, ctx.rules)


def shard(x, *logical_axes: Optional[str]):
    """Activation sharding constraint: ``x`` itself outside a sharding
    context or when ``x`` is a plain tensor; a DTensor redistributed to
    the placements of ``logical_axes`` inside one."""
    if current_ctx() is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh, pl = named_sharding(logical_axes, x.shape)
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(mesh, pl)


# ---------------------------------------------------------------------------
# Param annotation
# ---------------------------------------------------------------------------

class Param:
    """A parameter leaf paired with its logical axes. The models' init
    functions build trees of these; :func:`split_params` separates the
    values (what the model runs on) from the axes (how a mesh lays them
    out)."""

    __slots__ = ("value", "axes")

    def __init__(self, value, axes: Tuple[Optional[str], ...]):
        self.value = value
        self.axes = tuple(axes)

    def __repr__(self):
        shape = tuple(getattr(self.value, "shape", ()))
        return f"Param(shape={shape}, axes={self.axes})"


def is_param(x) -> bool:
    return isinstance(x, Param)


# axes trees use ','-joined string leaves, so they are leaves of a tree
def axes_to_str(axes: Tuple[Optional[str], ...]) -> str:
    return ",".join("" if a is None else a for a in axes)


def str_to_axes(s: str) -> Tuple[Optional[str], ...]:
    if s == "":
        return ()
    return tuple(None if a == "" else a for a in s.split(","))


def split_params(tree):
    """Tree of Param -> (values tree, logical-axes tree with string
    leaves)."""
    leaves, treedef = flatten(tree)
    return (unflatten(treedef, [p.value for p in leaves]),
            unflatten(treedef, [axes_to_str(p.axes) for p in leaves]))


def tree_shardings(values_tree, axes_tree, mesh, rules: Optional[dict] = None):
    """A tree of placement tuples (:func:`placements`), one per leaf of
    ``values_tree``, resolved against its shape; ``axes_tree`` has the
    same structure with string (or tuple) leaves, "" for a leaf whose
    every dimension is replicated."""
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    values, treedef = flatten(values_tree)
    axes, _ = flatten(axes_tree)
    if len(axes) != len(values):
        raise ValueError(f"{len(axes)} axes leaves for {len(values)} values")
    out = []
    for v, ax in zip(values, axes):
        ax = str_to_axes(ax) if isinstance(ax, str) else tuple(ax)
        if len(ax) == 0:
            ax = (None,) * len(v.shape)
        out.append(placements(ax, tuple(v.shape), mesh, merged))
    return unflatten(treedef, out)
