"""The pool mesh: how the policy-pool simulator and the fleet engine lay
their grids over ranks. Port of the JAX package's ``launch/mesh.py`` (its
pool-mesh half).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the default
process group, one rank a shard (SPMD: every rank runs the same program on
its own shard, with its own host thread). Nothing here touches
``torch.distributed`` at import time; the callers start the process group
(``torchrun``, or ``init_process_group`` with an address, a world size and
a rank). On one card several ranks may share it: NCCL refuses two ranks on
one GPU, so such a world runs on the gloo backend, and :func:`all_gather`
stages its tensors through the host.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def make_pool_mesh(shape=None, device_type=None):
    """Mesh for the policy-pool simulator over the default process group.

    Default (``shape=None``): 1-D over every rank, named ``("jobs",)``:
    jobs ride the single axis and lanes stay whole per rank (the kind
    partition already balances DP-heavy against cheap work within each
    rank). ``shape=(n_jobs_dev, n_lane_dev)`` builds the 2-D ``("jobs",
    "lanes")`` mesh instead: jobs shard the first axis, each kind
    partition's lanes the second (``fast_sim.simulate_pool_jobs_sharded``
    pads both axes to divisibility). ``shape=(n,)`` is the explicit 1-D
    form. The shape must multiply out to the world size.

    ``device_type`` is where each rank simulates: "cuda" (each rank on
    ``cuda:{local_rank % device_count}``, see :func:`rank_device`) or
    "cpu". None means the card, as every entry point of the port, and
    raises without one."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_pool_mesh needs an initialized default "
                           "process group (torch.distributed)")
    world = dist.get_world_size()
    if shape is None:
        shape = (world,)
    shape = tuple(int(s) for s in shape)
    if len(shape) not in (1, 2) or any(s < 1 for s in shape):
        raise ValueError(
            f"pool mesh shape must be (jobs,) or (jobs, lanes): {shape}")
    if int(np.prod(shape)) != world:
        raise ValueError(f"pool mesh shape {shape} does not cover {world} "
                         "ranks")
    if device_type is None:
        from repro_torch.device import resolve_device

        device_type = resolve_device(None).type
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"pool mesh device_type {device_type!r} is neither "
                         "'cuda' nor 'cpu'")
    if device_type == "cuda":
        # the rank's card is current before the mesh starts its groups
        torch.cuda.set_device(_local_rank() % torch.cuda.device_count())
    axes = ("jobs", "lanes")[: len(shape)]
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def default_pool_mesh(device=None):
    """The 1-D pool mesh over the default process group when one is
    initialized (on ``device``'s type: None is the card), else None: the
    ``mesh=None`` of the sharded entry points."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    from repro_torch.device import resolve_device

    return make_pool_mesh(device_type=resolve_device(device).type)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def pool_mesh_job_axes(mesh):
    """How a pool mesh splits the simulation grid.

    Returns ``(jobs_axes, n_jobs_dev, n_lane_dev)``: the mesh axis names
    that shard the job dimension, the rank count along them, and the
    lane-axis rank count (1 on a 1-D mesh). Shared by the pool simulator
    (jobs x lanes grids) and the fleet engine (jobs only, replicated over
    ``"lanes"``)."""
    sizes = axis_sizes(mesh)
    n_lane_dev = int(sizes.get("lanes", 1))
    jobs_axes = tuple(a for a in mesh.mesh_dim_names if a != "lanes")
    n_jobs_dev = int(np.prod([sizes[a] for a in jobs_axes])) \
        if jobs_axes else 1
    return jobs_axes, n_jobs_dev, n_lane_dev


def parse_pool_mesh_shape(spec: str):
    """``"4"`` -> (4,), ``"2x2"`` -> (2, 2). Empty / ``"auto"`` -> None
    (make_pool_mesh's 1-D default)."""
    spec = (spec or "").strip().lower()
    if spec in ("", "auto"):
        return None
    return tuple(int(s) for s in spec.split("x"))


def _local_rank() -> int:
    """``LOCAL_RANK`` as torchrun sets it, else the global rank."""
    import torch.distributed as dist

    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def mesh_coordinates(mesh) -> dict:
    """{global rank: its coordinate tuple} over every rank of ``mesh``."""
    grid = mesh.mesh.numpy()
    return {int(r): tuple(int(i) for i in idx)
            for idx, r in np.ndenumerate(grid)}


def rank_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: ``cuda:{local_rank %
    device_count}`` on a CUDA mesh (``LOCAL_RANK`` as torchrun sets it,
    else the global rank), the CPU on a CPU mesh. Ranks beyond the card
    count share cards; nothing falls back to the CPU on a CUDA mesh."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    if mesh.device_type != "cuda":
        raise ValueError(f"mesh device_type {mesh.device_type!r}")
    return torch.device("cuda", _local_rank() % torch.cuda.device_count())


def all_gather(tensors, group=None):
    """Every rank's ``tensors`` (a list, each the same shape and dtype on
    every rank) gathered over ``group``: a list, in group-rank order, of
    each rank's list, on the devices the tensors came from, bit for bit.

    The tensors travel as one byte buffer, so a call is one collective
    whatever their dtypes. The backend picks the route: NCCL gathers on
    the card; gloo, whose collectives do not all take CUDA tensors, stages
    the buffer through the host (the only copy off the card)."""
    import torch.distributed as dist

    flat = [(t.to(torch.uint8) if t.dtype == torch.bool else t)
            .contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    # each tensor starts on an 8-byte boundary, so it views back in place
    widths = [f.numel() for f in flat]
    pads = [-w % 8 for w in widths]
    buf = torch.cat([piece for f, pad in zip(flat, pads) for piece in (
        f, torch.zeros(pad, dtype=torch.uint8, device=f.device))])
    device = buf.device
    if dist.get_backend(group) != "nccl":
        buf = buf.cpu()
    parts = [torch.empty_like(buf)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    out = []
    for part in parts:
        part = part.to(device)
        items, at = [], 0
        for t, width, pad in zip(tensors, widths, pads):
            raw = part[at:at + width]
            at += width + pad
            if t.dtype == torch.bool:
                items.append(raw.to(torch.bool).reshape(t.shape))
            else:
                items.append(raw.view(t.dtype).reshape(t.shape))
        out.append(items)
    return out
