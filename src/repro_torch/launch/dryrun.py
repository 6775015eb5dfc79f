"""The dry run: count one step of every (architecture x input shape x
mesh) without running it (the JAX package's ``launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh single --out experiments/dryrun_torch

Each combination builds its parameters, optimizer state, batch and cache
as fake tensors (``FakeTensorMode``: shapes and dtypes, no memory), laid
out as DTensors on the production mesh over a ``fake`` process group of
256 (or 512) ranks (``launch.mesh.fake_group``), and runs the step of its
mode under ``launch.op_analysis.count_ops``: what rank 0 computes, moves
and sends. The models' ``shard`` constraints redistribute activations as
the reference's ``with_sharding_constraint`` does; the few model
functions DTensor has no strategy for run block by block, and every
product, forward and backward, is laid out as XLA's SPMD partitioner
lays out the reference's (``launch.stand_ins``, installed for the
sharded step alone), so the per-device counts are the reference's
(``tests/test_torch_dryrun_sharded.py``). Plain
tensors a step makes for itself (positions, masks, constants) are the
same on every rank and join DTensor ops replicated
(``implicit_replication``); an op with no DTensor sharding strategy fails
the combination, it is not replicated.

The step runs the plain versions of the kernels (``KernelConfig(use_cuda=
False)``), as the reference's CPU HLO counts XLA's path, not Pallas: the
records are counts and bounds, not runs. ``mesh=None`` (:func:`count`)
counts the unsharded step on one device, there also as the card runs it
(``kernels=True``: each K2 / K3 / K4 launch counted by its own traffic
and operations, ``op_analysis.kernels_logged``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time

import torch

from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES, TrainConfig,
                                 get_config, get_smoke_config,
                                 shape_applicable)
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import ops
from repro_torch.launch import op_analysis, stand_ins
from repro_torch.launch.mesh import fake_group, make_production_mesh
from repro_torch.launch.specs import batch_axes, input_specs
from repro_torch.models import transformer as tf
from repro_torch.sharding import str_to_axes, use_sharding
from repro_torch.train.step import (init_opt_state, make_decode_step,
                                    make_prefill_step, make_train_step)
from repro_torch.utils.tree import flatten, unflatten

PLAIN = ops.KernelConfig(use_cuda=False)

_SMOKE_SHAPES = {
    "train_4k": ("train_4k", 128, 8, "train"),
    "prefill_32k": ("prefill_32k", 256, 4, "prefill"),
    "decode_32k": ("decode_32k", 256, 8, "decode"),
    "long_500k": ("long_500k", 512, 1, "decode"),
}


def _place(tree, axes_tree, mesh, rules):
    """Zeros of each tensor leaf's shape and dtype on the meta device:
    plain with no mesh, else a DTensor laid out by the leaf's axes whose
    local block alone is made (``stand_ins.zeros``). Other leaves (the
    cache index) pass through."""
    leaves, treedef = flatten(tree)
    axes, _ = flatten(axes_tree)
    ctx = contextlib.nullcontext() if mesh is None else use_sharding(mesh,
                                                                     rules)
    with ctx:
        return unflatten(treedef, [
            stand_ins.zeros(x.shape, str_to_axes(ax) or (None,) * x.ndim,
                           x.dtype, "meta")
            if isinstance(x, torch.Tensor) else x
            for x, ax in zip(leaves, axes)])


def _loop_trips(cfg, shape, microbatches: int = 1) -> list:
    """The step's loop counts: microbatches (train, when > 1), then the
    layer loop (super-blocks and their Mamba2 layers for a hybrid)."""
    trips = [microbatches] if shape.mode == "train" and microbatches > 1 \
        else []
    if cfg.arch_type == "hybrid":
        ns, per = tf.super_blocks(cfg)
        return trips + [ns, per]
    return trips + [cfg.num_layers]


def build_step(cfg, shape, mesh, microbatches=None, rules=None,
               kcfg: ops.KernelConfig = PLAIN):
    """-> (step, args, microbatches): ``step(*args)`` runs one step of the
    shape's mode on fake tensors laid out on ``mesh`` (None: one device)
    inside its sharding context, with the stand-ins installed.

    ``microbatches`` / ``rules`` override the defaults (``launch.perf``'s
    variants): training cuts the global batch into one sequence per batch
    shard, as the reference does."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():  # shapes and axes only
        values, axes = tf.init_model(torch.Generator().manual_seed(0), cfg)
    params = _place(values, axes, mesh, rules)
    batch_spec, cache_spec = input_specs(cfg, shape)
    batch = _place(batch_spec, batch_axes(batch_spec), mesh, rules)

    if shape.mode == "train":
        sizes = {} if mesh is None else dict(zip(mesh.mesh_dim_names,
                                                 mesh.shape))
        batch_shards = sizes.get("data", 1) * sizes.get("pod", 1)
        mb = microbatches or max(1, shape.global_batch // batch_shards)
        tcfg = TrainConfig(remat="full", seq_len=shape.seq_len,
                           global_batch=shape.global_batch, microbatches=mb)
        step = make_train_step(cfg, tcfg, kcfg)
        args = (params, init_opt_state(params), batch)
    elif shape.mode == "prefill":
        mb = 1
        if cfg.encoder_only:
            # encoder inference over the full window: no cache to build
            def step(p, b):
                with torch.no_grad():
                    return tf.forward(cfg, p, b, kcfg=kcfg)[0]
        else:
            step = make_prefill_step(cfg, max_len=shape.seq_len, kcfg=kcfg)
        args = (params, batch)
    elif shape.mode == "decode":
        mb = 1
        step = make_decode_step(cfg, kcfg)
        args = (params, _place(cache_spec, tf.cache_axes(cfg), mesh, rules),
                batch)
    else:
        raise ValueError(shape.mode)
    if mesh is None:
        return step, args, mb

    def sharded(*a):
        from torch.distributed.tensor.experimental import implicit_replication

        with use_sharding(mesh, rules), implicit_replication(), \
                stand_ins.installed(a[0]):
            return step(*a)

    return sharded, args, mb


def _local_bytes(tree) -> int:
    """Bytes of the distinct storages of a tree's tensors (each DTensor's
    local block)."""
    from torch.distributed.tensor import DTensor

    seen = {}
    for t in flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            t = t.to_local() if isinstance(t, DTensor) else t
            st = t.untyped_storage()
            seen[id(st)] = st.nbytes()
    return sum(seen.values())


def count(cfg, shape, mesh=None, microbatches=None, rules=None,
          trace_path: str = "", kernels: bool = False) -> dict:
    """Count one step of ``shape``'s mode on ``mesh`` (None: one device):
    ``op_analysis.analyze``'s totals for rank 0, its loop counts, the
    ``memory`` dict (argument, output and peak live bytes of rank 0;
    temp = peak - arguments) and ``run_s``. ``trace_path`` also saves the
    op log there. ``kernels`` (one device only) counts the card's path:
    K2, K3 and K4 by their own traffic and operations, not their plain
    versions'."""
    if kernels and mesh is not None:
        raise ValueError("kernels=True counts one device (mesh=None)")
    t0 = time.time()
    step, args, mb = build_step(cfg, shape, mesh, microbatches, rules,
                                ops.KernelConfig(use_cuda=kernels))
    arg_bytes = _local_bytes(args)
    with op_analysis.count_ops(args, kernels=kernels) as counter:
        out = step(*args)
    out_bytes = _local_bytes(out)
    trips = _loop_trips(cfg, shape, mb)
    if trace_path:
        op_analysis.save_log(counter.log, trace_path, {"while_trips": trips})
    acc = op_analysis.analyze(counter.log, trips)
    acc["memory"] = {
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": out_bytes,
        "peak_size_in_bytes": counter.peak_bytes,
        "temp_size_in_bytes": counter.peak_bytes - arg_bytes,
    }
    acc["run_s"] = time.time() - t0
    return acc


def _smoke_mesh(multi_pod: bool):
    from torch.distributed.device_mesh import init_device_mesh

    if multi_pod:
        return init_device_mesh("cpu", (2, 2, 2),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))


def run_one(arch: str, shape_name: str, multi_pod: bool, verbose=True,
            smoke: bool = False, trace_dir: str = "", microbatches=None,
            rules=None, variant: str = "", cfg_overrides=None) -> dict:
    """One combination's record (the reference's keys; ``status`` "ok" or
    "skipped" with its ``reason``). ``smoke`` takes the smoke config and
    shape on a (2, 2) or (2, 2, 2) mesh."""
    if smoke:
        cfg = get_smoke_config(arch)
        shape = ShapeConfig(*_SMOKE_SHAPES[shape_name])
        mesh_name = "2x2x2" if multi_pod else "2x2"
        world = 8 if multi_pod else 4
    else:
        cfg = get_config(arch)
        shape = INPUT_SHAPES[shape_name]
        mesh_name = "2x16x16" if multi_pod else "16x16"
        world = 512 if multi_pod else 256
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    ok, reason = shape_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "mode": shape.mode, "status": "skipped", "reason": reason}
    if variant:
        rec["variant"] = variant
    if not ok:
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: SKIP "
                  f"({reason})")
        return rec

    trace = ""
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        fname = f"{arch}_{shape_name}_{mesh_name}.ops.z".replace("/", "-")
        trace = os.path.join(trace_dir, fname)
    with fake_group(world):
        mesh = _smoke_mesh(multi_pod) if smoke else make_production_mesh(
            multi_pod=multi_pod, device_type="cpu")
        acc = count(cfg, shape, mesh, microbatches, rules, trace)
    rec.update(
        status="ok",
        run_s=round(acc["run_s"], 2),
        devices=world,
        kernels="plain",
        flops_per_device=float(acc["dot_flops"]),
        bytes_per_device=float(acc["traffic_bytes"]),
        bytes_per_device_bf16eq=float(acc["traffic_bytes_bf16eq"]),
        collectives=acc["collectives"],
        collective_bytes=float(acc["collective_bytes_total"]),
        collective_bytes_bf16eq=float(acc["collective_bytes_bf16eq"]),
        while_trips=acc["while_trips"],
        unknown_trip_whiles=acc["unknown_trip_whiles"],
        memory=acc["memory"],
    )
    if verbose:
        mem = rec["memory"]
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: OK "
              f"run={rec['run_s']:.1f}s "
              f"args={mem['argument_size_in_bytes'] / 2**30:.2f}GiB/dev "
              f"peak={mem['peak_size_in_bytes'] / 2**30:.2f}GiB/dev "
              f"flops/dev={rec['flops_per_device']:.3e} "
              f"bytes/dev={rec['bytes_per_device']:.3e} "
              f"coll={rec['collective_bytes'] / 2**20:.1f}MiB/dev "
              f"trips={rec['while_trips']}")
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke configs + a (2, 2) / (2, 2, 2) mesh")
    ap.add_argument("--trace-dir", default="",
                    help="also save each combination's op log "
                         "(zlib-compressed JSON lines)")
    args = ap.parse_args()

    archs = list(ASSIGNED_ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    rec = run_one(arch, shape, mp, smoke=args.smoke,
                                  trace_dir=args.trace_dir)
                except Exception as e:  # a failure here is a bug in the port
                    mesh = ("2x2x2" if mp else "2x2") if args.smoke else (
                        "2x16x16" if mp else "16x16")
                    rec = {"arch": arch, "shape": shape, "mesh": mesh,
                           "status": "FAILED", "error": repr(e)[:2000]}
                    n_fail += 1
                    print(f"[dryrun] {arch} x {shape} x {mesh} FAILED: {e!r}")
                fname = f"{arch}_{shape}_{rec['mesh']}.json".replace("/", "-")
                with open(os.path.join(args.out, fname), "w") as f:
                    json.dump(rec, f, indent=2)
    print(f"[dryrun] done, failures: {n_fail}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
