"""Logical-axis sharding rules with a divisibility fallback. Port of the
pool-mesh half of the JAX package's ``sharding.py``: the rule table and
the resolution of logical axes against a mesh.

Code names the logical axes of an array ("jobs", "lanes", ...); the rules
map each to mesh axes, dropping any mesh axis that does not evenly divide
the dimension (fallback: replicate). The pool simulator resolves its
(jobs, lanes) grid this way over the pool mesh (``launch.mesh``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

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
    axis_sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
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
