"""Carry state across from the JAX reference: its objects, read as numpy
arrays, become the port's tensors on a given device, and a port selector
state goes back to numpy so a stream begun in one package can continue in
the other. Model weights cross in the reference's parameter layout (nested
dicts, layers stacked on a leading axis). Duck-typed on field and key names,
so this module imports nothing of the reference."""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import fast_sim, selector
from repro_torch.device import resolve_device, to_device
from repro_torch.models import attention
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import AdamWState
from repro_torch.utils.partition import (is_lora_path, partition_by_path,
                                         select_paths)

_POOL_DTYPES = {"kind": torch.int32, "omega": torch.int32, "v": torch.int32,
                "sigma": torch.float32, "rho": torch.float32,
                "cfrac": torch.float32, "rsel": torch.int32,
                "rmargin": torch.float32}
_EG_DTYPES = (torch.float32, torch.float32, torch.int32, torch.float32,
              torch.float32)


def pool_arrays(pool: dict, device) -> dict:
    """A ``specs_to_arrays`` pool dict -> the port's pool dict of tensors."""
    return {k: to_device(pool[k], dt, device)
            for k, dt in _POOL_DTYPES.items() if k in pool}


def job_arrays(jobs, device) -> fast_sim.JobArrays:
    """The reference's stacked ``fast_sim.JobArrays`` -> the port's."""
    return fast_sim.jobs_to(
        fast_sim.JobArrays(*[np.asarray(getattr(jobs, f))
                             for f in fast_sim.JobArrays._fields]),
        device,
    )


def eg_state(state, device) -> selector.EGState:
    """The reference's ``selector.EGState`` -> the port's."""
    return selector.EGState(*[
        to_device(np.asarray(getattr(state, f)), dt, device)
        for f, dt in zip(selector.EGState._fields, _EG_DTYPES)
    ])


def eg_state_to_numpy(state: selector.EGState) -> dict:
    """A port ``EGState`` -> ``{field: numpy array}``; the reference takes
    it back as ``EGState(**fields)``."""
    return {f: getattr(state, f).detach().cpu().numpy()
            for f in selector.EGState._fields}


# leaves the reference keeps in f32 whatever the model dtype: LoRA adapters,
# the MoE router and the SSM's per-head decay, skip and step-size bias
_F32_KEYS = ("lora", "router", "A_log", "D", "dt_bias")


def _tree_map(fn, tree, keep_f32: bool = False):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, keep_f32 or k in _F32_KEYS)
                for k, v in tree.items()}
    return fn(tree, keep_f32)


def _per_layer(values: dict, cfg, leaf) -> dict:
    """The reference's layout -> the port's: ``leaf(x, keep_f32)`` of every
    leaf, the stacked layers cut into a list of per-layer dicts (a list of
    super-blocks, each a list of layers, for hybrid)."""
    stacked = _tree_map(lambda x, _: x, values["layers"])

    def layer(at):
        return _tree_map(lambda x, keep_f32: leaf(x[at], keep_f32), stacked)

    out = {k: _tree_map(leaf, v) for k, v in values.items() if k != "layers"}
    if cfg.arch_type == "hybrid":
        ns, per = tf.super_blocks(cfg)
        out["layers"] = [[layer((si, j)) for j in range(per)]
                         for si in range(ns)]
    else:
        out["layers"] = [layer(i) for i in range(cfg.num_layers)]
    return out


def _stacked(params: dict, cfg) -> dict:
    """The port's layout -> the reference's, leaves as numpy (the
    inverse of :func:`_per_layer`)."""
    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        if isinstance(xs[0], list):
            return stack(*(stack(*x) for x in xs))
        return np.stack([np.asarray(x) for x in xs])

    out = {k: _tree_map(lambda x, _: np.asarray(x), v)
           for k, v in params.items() if k != "layers"}
    out["layers"] = stack(*params["layers"])
    return out


def _numpy(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if torch.is_tensor(t) else \
        np.asarray(t, np.float32)


def model_params(values: dict, cfg, device=None) -> dict:
    """The reference's parameter values (``repro.models.init_model(...)[0]``
    or :func:`random_model_params`, any array type numpy can read) -> the
    port's model: base weights (the MoE experts included) in the model
    dtype, adapters, the MoE router and the SSM's ``A_log``, ``D`` and
    ``dt_bias`` in f32, layers a list of per-layer dicts (a list of
    super-blocks, each a list of layers, for hybrid)."""
    dev = resolve_device(device)
    dt = tf.model_dtype(cfg)
    values = _tree_map(lambda x, _: np.asarray(x, np.float32), values)
    return _per_layer(values, cfg, lambda x, keep_f32: to_device(
        x, torch.float32 if keep_f32 else dt, dev))


def lora_leaves(leaves, values: dict, cfg, device=None) -> list:
    """A list over the reference's LoRA leaves (its gradients, its AdamW
    ``m`` or ``v``: layers stacked, in ``jax.tree_util``'s order over the
    parameter tree ``values``) -> the port's per-layer f32 leaves, in the
    order ``partition_by_path(params, is_lora_path)`` gives them."""
    dev = resolve_device(device)
    _, merge = partition_by_path(values, is_lora_path)
    tree = merge([np.asarray(x, np.float32) for x in leaves])
    port = _per_layer(tree, cfg, lambda x, _: x)
    return [to_device(x, torch.float32, dev)
            for _, x in select_paths(port, is_lora_path)]


def lora_leaves_to_numpy(leaves, params: dict, cfg) -> list:
    """The port's LoRA leaf list over ``params`` -> the reference's (f32
    numpy, layers stacked, in ``jax.tree_util``'s order)."""
    _, merge = partition_by_path(params, is_lora_path)
    tree = _stacked(merge([_numpy(x) for x in leaves]), cfg)
    return [x for _, x in select_paths(tree, is_lora_path)]


def opt_state(state, values: dict, cfg, device=None) -> AdamWState:
    """The reference's ``optim.adamw.AdamWState`` over the LoRA leaves of
    the parameter tree ``values`` -> the port's."""
    dev = resolve_device(device)
    return AdamWState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=dev),
        m=lora_leaves(state.m, values, cfg, dev),
        v=lora_leaves(state.v, values, cfg, dev))


def opt_state_to_numpy(state: AdamWState, params: dict, cfg) -> dict:
    """A port ``AdamWState`` over ``params`` -> ``{step, m, v}`` as numpy;
    the reference takes it back as ``AdamWState(**fields)``."""
    return {"step": np.int32(int(state.step)),
            "m": lora_leaves_to_numpy(state.m, params, cfg),
            "v": lora_leaves_to_numpy(state.v, params, cfg)}


def random_model_params(cfg, seed: int) -> dict:
    """Random parameter values for a config of any family, as f32 numpy
    arrays in the reference's layout (layers stacked; (super-blocks, layers)
    for hybrid; no input table and always an output head for an
    ``embed_inputs`` config), drawn from a numpy seed. Unlike the standard
    init, LoRA B, the norm parameters and the biases are non-zero and
    non-trivial, so the low-rank path and every parameter is exercised; the
    SSM's A_log and dt_bias are drawn near the reference's init."""
    rng = np.random.default_rng(seed)
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    f, r = cfg.d_ff, cfg.lora.rank

    def normal(shape, std):
        return (rng.standard_normal(shape, dtype=np.float32) * std).astype(
            np.float32)

    def norm():
        if cfg.norm_type == "layernorm_np":
            return {}
        p = {"scale": 1.0 + normal((d,), 0.1)}
        if cfg.norm_type == "layernorm":
            p["bias"] = normal((d,), 0.1)
        return p

    def lora_pair(in_dim, out_shape):
        return {"a": normal((in_dim, r), 1.0 / math.sqrt(in_dim)),
                "b": normal((r,) + out_shape, 0.02)}

    def layer():
        att = {"wq": normal((d, h, hd), 1.0 / math.sqrt(d)),
               "wk": normal((d, kv, hd), 1.0 / math.sqrt(d)),
               "wv": normal((d, kv, hd), 1.0 / math.sqrt(d)),
               "wo": normal((h, hd, d), 1.0 / math.sqrt(h * hd))}
        if cfg.qkv_bias:
            att.update(bq=normal((h, hd), 0.1), bk=normal((kv, hd), 0.1),
                       bv=normal((kv, hd), 0.1))
        if cfg.o_bias:
            att["bo"] = normal((d,), 0.1)
        lt = {t: lora_pair(*shape)
              for t, shape in attention.lora_shapes(cfg).items()
              if t in cfg.lora.targets}
        if lt:
            att["lora"] = lt
        if cfg.arch_type == "moe":
            e = cfg.moe.num_experts
            ffn = ("moe", {"router": normal((d, e), 0.02),
                           "w1": normal((e, d, f), 1.0 / math.sqrt(d)),
                           "w3": normal((e, d, f), 1.0 / math.sqrt(d)),
                           "w2": normal((e, f, d), 1.0 / math.sqrt(f))})
        else:
            mlp = {"w1": normal((d, f), 1.0 / math.sqrt(d)),
                   "w2": normal((f, d), 1.0 / math.sqrt(f))}
            if cfg.mlp_act == "silu":
                mlp["w3"] = normal((d, f), 1.0 / math.sqrt(d))
            if cfg.mlp_bias:
                mlp.update(b1=normal((f,), 0.1), b2=normal((d,), 0.1))
            if "mlp" in cfg.lora.targets:
                mlp["lora"] = lora_pair(d, (f,))
            ffn = ("mlp", mlp)
        # the norms are drawn last, as they always were: a seed gives the
        # dense configs the weights it gave them before MoE joined
        return {"attn_norm": norm(), "attn": att, "mlp_norm": norm(),
                ffn[0]: ffn[1]}

    def mamba_layer():
        ssm = cfg.ssm
        di, hh = ssm.d_inner(d), ssm.heads(d)
        g, n, wc = ssm.n_groups, ssm.state_size, ssm.conv_width
        conv = di + 2 * g * n
        m = {"wz": normal((d, di), 1.0 / math.sqrt(d)),
             "wx": normal((d, di), 1.0 / math.sqrt(d)),
             "wB": normal((d, g, n), 1.0 / math.sqrt(d)),
             "wC": normal((d, g, n), 1.0 / math.sqrt(d)),
             "wdt": normal((d, hh), 1.0 / math.sqrt(d)),
             "conv_w": normal((conv, wc), 0.3),
             "conv_b": normal((conv,), 0.1),
             "A_log": (np.log(np.linspace(1.0, np.e, hh))
                       + normal((hh,), 0.1)).astype(np.float32),
             "D": 1.0 + normal((hh,), 0.1),
             "dt_bias": (np.log(np.expm1(0.01))
                         + normal((hh,), 0.1)).astype(np.float32),
             "norm_scale": 1.0 + normal((di,), 0.1),
             "out_proj": normal((di, d), 1.0 / math.sqrt(di)),
             "lora": {"in": lora_pair(d, (di,)), "out": lora_pair(di, (d,))}}
        return {"norm": norm(), "mamba": m}

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return np.stack(xs)

    vals = {}
    if not cfg.embed_inputs:
        vals["embed"] = normal((cfg.vocab_size, d), 0.02)
    vals["final_norm"] = norm()
    if not cfg.tie_embeddings or cfg.embed_inputs:
        vals["head"] = normal((d, cfg.vocab_size), 0.02)
    if cfg.arch_type in ("dense", "moe", "vlm", "audio"):
        vals["layers"] = stack(*[layer() for _ in range(cfg.num_layers)])
    elif cfg.arch_type == "ssm":
        vals["layers"] = stack(*[mamba_layer()
                                 for _ in range(cfg.num_layers)])
    else:
        ns, per = tf.super_blocks(cfg)
        vals["layers"] = stack(*[stack(*[mamba_layer() for _ in range(per)])
                                 for _ in range(ns)])
        vals["shared"] = layer()
    return vals
