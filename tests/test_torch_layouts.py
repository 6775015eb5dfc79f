"""The port's layouts against the JAX package's, exactly: every parameter
leaf's DTensor placements on the production meshes (from the port's
``tree_shardings``) against the reference's ``resolve_spec``, ``init_model``'s
axes and values, the cache axes and the dry run's input specs. The
reference's resolution takes any object with ``axis_names`` and
``devices.shape``, so no JAX mesh is made; the port's meshes stand over a
``fake`` process group."""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import sharding as jsharding
from repro.configs import ASSIGNED_ARCHS as JARCHS
from repro.configs import INPUT_SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jsmoke
from repro.configs import shape_applicable as jshape_applicable
from repro.launch import specs as jspecs
from repro.models import attention as jattn
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch import sharding
from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES, get_config,
                                 get_smoke_config, list_archs,
                                 shape_applicable)
from repro_torch.kernels import ops
from repro_torch.launch import specs
from repro_torch.launch.mesh import fake_group, make_production_mesh
from repro_torch.models import attention, ssm
from repro_torch.models import transformer as tf
from repro_torch.utils.tree import flatten_with_path

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _norm(ax):
    """Axes with no name in them, whatever their length, as (): the string
    form keeps no length for them ("" is () and (None,) both)."""
    return ax if any(a is not None for a in ax) else ()


def _ref_leaves(tree, drop_layers: int):
    """{path: axes} of the reference's stacked axes tree, the leading
    stacked "layers" axes dropped from the layer subtrees."""
    out = {}
    for path, ax in flatten_with_path(tree):
        ax = jsharding.str_to_axes(ax)
        if path.startswith("layers/"):
            ax = ax[drop_layers:]
        out[path] = _norm(ax)
    return out


def _port_leaves(tree, cfg):
    """{reference path: axes} of the port's per-layer axes tree: every
    layer's leaves (and, for a hybrid, every Mamba2 layer's) must agree,
    and stand at the reference's stacked path."""
    hybrid = cfg.arch_type == "hybrid"
    out = {}
    for path, ax in flatten_with_path(tree):
        parts = path.split("/")
        if parts[0] == "layers":
            parts = ["layers"] + parts[3 if hybrid else 2:]
        key = "/".join(parts)
        ax = _norm(sharding.str_to_axes(ax))
        assert out.setdefault(key, ax) == ax, (path, ax, out[key])
    return out


def _ref_axes(cfg_ref):
    abs_params = jax.eval_shape(
        lambda: jtf.init_params(jax.random.PRNGKey(0), cfg_ref))
    return jsharding.split_params(abs_params)


@pytest.mark.parametrize("arch", list_archs())
def test_init_model_axes_and_values_match_reference(arch):
    """Smoke configs: ``init_model``'s axes equal the reference's leaf for
    leaf (its stacked "layers" axis dropped), its values are
    ``init_params``' bit for bit, and the stacked form has the
    reference's axes with it."""
    cfg = get_smoke_config(arch)
    values, axes = tf.init_model(torch.Generator().manual_seed(3), cfg)
    plain = tf.init_params(torch.Generator().manual_seed(3), cfg)
    vl, pl = flatten_with_path(values), flatten_with_path(plain)
    assert [p for p, _ in vl] == [p for p, _ in pl]
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(vl, pl))
    drop = 2 if cfg.arch_type == "hybrid" else 1
    assert _port_leaves(axes, cfg) == _ref_leaves(
        _ref_axes(jsmoke(arch))[1], drop)
    # the stacked form: one "layers" axis ahead of each leaf's own
    if cfg.arch_type != "hybrid":
        trees = tf._param_tree(torch.Generator().manual_seed(3), cfg)
        stacked = tf.stack_param_trees(trees["layers"])
        for path, p in flatten_with_path(stacked):
            assert p.axes[0] == "layers" and p.value.shape[0] == \
                cfg.num_layers, path


@pytest.mark.parametrize("arch", list_archs())
def test_placements_match_reference_resolve_spec(arch):
    """Full configs on (16, 16) and (2, 16, 16): each leaf's placements
    put ``Shard(d)`` on exactly the mesh axes the reference's
    ``resolve_spec`` gives dimension d, in the entry's order."""
    from torch.distributed.tensor import Replicate, Shard

    cfg = get_config(arch)
    with FakeTensorMode():
        values, axes = tf.init_model(torch.Generator().manual_seed(0), cfg)
    ref_values, ref_axes = _ref_axes(jget_config(arch))
    ref_shapes = {p: tuple(v.shape) for p, v in flatten_with_path(ref_values)}
    drop = 2 if cfg.arch_type == "hybrid" else 1
    ref_ax = _ref_leaves(ref_axes, drop)
    for name, (shape, names) in MESHES.items():
        like = SimpleNamespace(axis_names=names, devices=np.empty(shape))
        with fake_group(int(np.prod(shape))):
            mesh = make_production_mesh(multi_pod=len(shape) == 3,
                                        device_type="cpu")
            tree = sharding.tree_shardings(values, axes, mesh)
        vals = dict(flatten_with_path(values))
        for path in vals:
            parts = path.split("/")
            pl = tree
            for part in parts:  # placement tuples are the tree's leaves
                pl = pl[int(part) if isinstance(pl, list) else part]
            key = "/".join(["layers"] + parts[3 if cfg.arch_type == "hybrid"
                                              else 2:]) \
                if parts[0] == "layers" else path
            v_shape = tuple(vals[path].shape)
            assert ref_shapes[key][drop if key.startswith("layers/")
                                   else 0:] == v_shape, (path, name)
            spec = jsharding.resolve_spec(ref_ax[key] or (None,) * len(v_shape),
                                          v_shape, like,
                                          dict(jsharding.DEFAULT_RULES))
            want = [Replicate()] * len(names)
            for dim, entry in enumerate(spec):
                for ax in ((entry,) if isinstance(entry, str)
                           else entry or ()):
                    want[names.index(ax)] = Shard(dim)
            assert list(pl) == want, (arch, name, path, spec, pl)


@pytest.mark.parametrize("arch", list_archs())
def test_cache_axes_match_reference(arch):
    cfg = get_smoke_config(arch)
    ref = jtf.cache_axes(jsmoke(arch))
    got = tf.cache_axes(cfg)
    want = {"index": ref["index"], **ref.get("kv", {}),
            **ref.get("mamba", {})}
    assert got == want
    assert attention.kv_cache_specs(cfg, 2, 16, 3) == \
        jattn.kv_cache_specs(jsmoke(arch), 2, 16, 3)
    assert ssm.mamba_cache_specs() == jssm.mamba_cache_specs()
    if cfg.supports_decode:
        cache = tf.init_cache(cfg, 2, 16, "meta")
        assert set(cache) == set(got)


def test_input_specs_match_reference():
    """Every (arch, shape) the skip rules admit: the batch's and the
    cache's shapes and dtypes equal the reference's ShapeDtypeStructs (the
    port's flat cache against the reference's kv / mamba subtrees)."""
    assert ASSIGNED_ARCHS == JARCHS
    assert list(INPUT_SHAPES) == list(JSHAPES)
    n = 0
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for name, shape in INPUT_SHAPES.items():
            ok, why = shape_applicable(cfg, shape)
            assert (ok, why) == jshape_applicable(jget_config(arch),
                                                  JSHAPES[name])
            if not ok:
                continue
            batch, cache = specs.input_specs(cfg, shape)
            jbatch, jcache = jspecs.input_specs(jget_config(arch),
                                                JSHAPES[name])
            assert set(batch) == set(jbatch)
            for k, v in batch.items():
                assert tuple(v.shape) == jbatch[k].shape
                assert str(v.dtype).split(".")[-1] == str(jbatch[k].dtype)
            assert specs.batch_axes(batch) == jspecs.batch_axes(jbatch)
            if cache is None:
                assert jcache is None
                continue
            flat = {**jcache.get("kv", {}), **jcache.get("mamba", {})}
            assert set(cache) == set(flat) | {"index"}
            for k, v in flat.items():
                assert tuple(cache[k].shape) == v.shape, (arch, name, k)
                assert str(cache[k].dtype).split(".")[-1] == str(v.dtype)
            assert cache["index"] == shape.seq_len - 1
            n += 1
    assert n >= 12


def test_shard_is_the_identity_outside_a_context():
    """``shard`` returns its argument itself with no context, and on a
    plain tensor inside one: every unsharded path runs as before."""
    x = torch.ones(4, 8)
    assert sharding.shard(x, "batch", "embed") is x
    with fake_group(4):
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        with sharding.use_sharding(mesh):
            assert sharding.shard(x, "batch", "embed") is x
            assert sharding.current_ctx().mesh is mesh
        assert sharding.current_ctx() is None
    assert not torch.distributed.is_initialized()


def test_stand_ins_leave_plain_paths_alone():
    """The dry run's DTensor stand-ins (``launch.stand_ins``) pass plain
    tensors to the model's own functions, and are gone after the block:
    a smoke llama2-7b prefill and decode step give bit-equal logits and
    caches with and without them."""
    from repro_torch.launch import stand_ins
    from repro_torch.models import moe

    cfg = get_smoke_config("llama2-7b")
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 12),
                           generator=torch.Generator().manual_seed(1))
    kcfg = ops.KernelConfig(use_cuda=False)

    def run():
        logits, cache = tf.prefill(cfg, params, {"tokens": tokens}, 16, kcfg)
        step, cache = tf.decode_step(cfg, params, {"tokens": tokens[:, :1]},
                                     cache, kcfg)
        return logits, step, cache["k"], cache["v"]

    sites = [(mod, name, getattr(mod, name)) for mod, name in (
        (attention, "attend"), (attention, "write_prefill"),
        (attention, "write_decode"), (moe, "_dispatch"), (moe, "_combine"),
        (tf, "embed_inputs"), (tf, "init_cache"), (tf, "_write_mamba"))]
    plain = run()
    with stand_ins.installed():
        assert all(getattr(mod, name) is not fn for mod, name, fn in sites)
        within = run()
    assert all(getattr(mod, name) is fn for mod, name, fn in sites)
    assert all(torch.equal(a, b) for a, b in zip(plain, within))
