"""Model assembly for every family of the reference (dense, MoE, SSM,
hybrid, VLM, audio): init / forward / prefill / decode (the reference's
``models/transformer.py``).

Layers are a Python list of per-layer parameter dicts, not a stacked scan.
Hybrid (zamba2) layers are a list of super-blocks, each a list of
``hybrid_period`` Mamba2 layers followed by the one *shared* transformer
block (``params["shared"]``), whose every application keeps its own KV-cache
slot. The cache is a flat dict updated in place by prefill and decode:
``index`` (an int), ``k`` / ``v`` (applications, B, W, kv, hd) for
attention, ``conv`` / ``ssd`` (layers..., B, ...) for Mamba2. A MoE layer
is a transformer block whose MLP is ``models/moe.apply_moe``.

The VLM (Qwen2-VL) and audio (HuBERT) families are stacks of dense blocks
fed by a stubbed frontend: ``embed_inputs`` configs read ``batch["embeds"]``
(B, S, d_model) and have an output head but no input table. A batch may
bring its own ``positions`` ((B, S), or (B, S, 3) under M-RoPE); attention
then masks by batch row 0's positions (its temporal stream under M-RoPE),
as the reference does, through K3's position inputs. Encoder-only configs
(HuBERT) have ``forward`` only.

:func:`init_model` also gives every parameter's logical axes (the
reference's, without its leading stacked "layers" axis), and
:func:`cache_axes` the cache's: ``launch.dryrun`` lays both out on a mesh.
"""
from __future__ import annotations

import functools

import torch
import torch.utils.checkpoint

from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import blocks as blk
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import apply_norm, init_norm, normal_param
from repro_torch.models.rope import default_m_positions, default_positions
from repro_torch.sharding import Param, axes_to_str, shard, split_params
from repro_torch.utils.tree import flatten, unflatten

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the families whose layers are all transformer blocks (dense MLP or MoE)
_ATTENTION_STACKS = ("dense", "moe", "vlm", "audio")


def model_dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _require_decode(cfg) -> None:
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.name}: encoder-only arch has no prefill / "
                         "decode")


def super_blocks(cfg) -> tuple:
    """(super-blocks, Mamba2 layers in each) of a hybrid config."""
    per = cfg.hybrid_period
    return cfg.num_layers // per, per


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def stack_param_trees(trees):
    """Per-layer Param trees -> one tree of stacked Params with a leading
    "layers" axis (the reference's scanned layout)."""
    leaves = [flatten(t)[0] for t in trees]
    treedef = flatten(trees[0])[1]
    return unflatten(treedef, [
        Param(torch.stack([p.value for p in ps]), ("layers",) + ps[0].axes)
        for ps in zip(*leaves)])


def _param_tree(generator: torch.Generator, cfg) -> dict:
    """:func:`init_params` with :class:`~repro_torch.sharding.Param`
    leaves."""
    dt = model_dtype(cfg)
    p = {}
    if not cfg.embed_inputs:
        # vocab not sharded: the table is small once d_model is
        # FSDP-sharded (the reference's choice)
        p["embed"] = normal_param(generator, (cfg.vocab_size, cfg.d_model),
                                  (None, "fsdp"), dt, stddev=0.02)
    p["final_norm"] = init_norm(cfg, dt, generator.device)
    if not cfg.tie_embeddings or cfg.embed_inputs:
        p["head"] = normal_param(generator, (cfg.d_model, cfg.vocab_size),
                                 ("fsdp", "vocab"), dt, stddev=0.02)
    if cfg.arch_type in _ATTENTION_STACKS:
        p["layers"] = [blk.init_transformer_block(generator, cfg, dt)
                       for _ in range(cfg.num_layers)]
    elif cfg.arch_type == "ssm":
        p["layers"] = [blk.init_mamba_block(generator, cfg, dt)
                       for _ in range(cfg.num_layers)]
    else:
        ns, per = super_blocks(cfg)
        p["layers"] = [[blk.init_mamba_block(generator, cfg, dt)
                        for _ in range(per)] for _ in range(ns)]
        p["shared"] = blk.init_transformer_block(generator, cfg, dt)
    return p


def init_params(generator: torch.Generator, cfg) -> dict:
    """Random parameters drawn on the generator's device (each tensor in f32,
    then cast to the model dtype; adapters and the SSM's A_log, D and
    dt_bias stay f32). LoRA B is zero, as the standard init. An
    ``embed_inputs`` config has no input table and always an output head."""
    return init_model(generator, cfg)[0]


def init_model(generator: torch.Generator, cfg):
    """(parameter values, logical axes): the axes tree has the values'
    structure, with :func:`~repro_torch.sharding.axes_to_str` leaves."""
    return split_params(_param_tree(generator, cfg))


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_inputs(cfg, params, batch) -> torch.Tensor:
    if cfg.embed_inputs:
        h = batch["embeds"].to(model_dtype(cfg))
    else:
        h = params["embed"][batch["tokens"]].to(model_dtype(cfg))
    return shard(h, "batch", "seq", "embed")


def unembed(cfg, params, h) -> torch.Tensor:
    """Logits: the product in the model dtype, then cast to f32."""
    if "head" in params:
        logits = h @ params["head"]
    else:
        logits = h @ params["embed"].t()
    logits = shard(logits, "batch", "seq", "vocab")
    return logits.float()


def _positions(cfg, batch, seq: int, device):
    """(positions that rotate q and k, positions that mask attention). The
    batch's own when it brings them; else the default ones counted from 0,
    for which the mask positions are None (K3's index path)."""
    if "positions" in batch:
        pos = batch["positions"]
        return pos, blk.mask_positions(cfg, pos)
    b = (batch["tokens"] if "tokens" in batch else batch["embeds"]).shape[0]
    if cfg.m_rope:
        return default_m_positions(b, seq, 0, device), None
    return default_positions(b, seq, 0, device).expand(b, seq), None


def _decode_positions(cfg, batch, bsz: int, index: int, device):
    """A decode step's positions: the batch's own, else the cache index in
    every stream (also after an image span, as the reference does)."""
    if "positions" in batch:
        return batch["positions"]
    shape = (bsz, 1, 3) if cfg.m_rope else (bsz, 1)
    return torch.full(shape, index, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# Forward (full sequence)
# ---------------------------------------------------------------------------

def _layer_fn(fn, remat: str):
    """``fn`` as it is, or recomputed in the backward (the reference's
    ``jax.checkpoint`` for any ``remat`` but "none"): its activations are
    not kept, the layer runs again when its gradient is needed."""
    if remat == "none":
        return fn
    return functools.partial(torch.utils.checkpoint.checkpoint, fn,
                             use_reentrant=False)


def forward(cfg, params, batch, kcfg: ops.KernelConfig = ops.DEFAULT,
            remat: str = "none"):
    """-> (logits (B,S,V) f32, aux_loss f32 scalar: the MoE layers' load
    balance losses summed over layers, in layer order; 0 without MoE).
    ``remat`` other than "none" recomputes every layer in the backward."""
    h = embed_inputs(cfg, params, batch)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.arch_type in _ATTENTION_STACKS:
        positions, q_pos = _positions(cfg, batch, h.shape[1], h.device)
        block = _layer_fn(functools.partial(
            blk.transformer_block_full, cfg, positions=positions,
            q_pos=q_pos, kcfg=kcfg), remat)
        for lp in params["layers"]:
            h, a = block(lp, h)
            aux = aux + a
    elif cfg.arch_type == "ssm":
        block = _layer_fn(functools.partial(blk.mamba_block_full, cfg,
                                            kcfg=kcfg), remat)
        for lp in params["layers"]:
            h = block(lp, h)
    else:
        positions, q_pos = _positions(cfg, batch, h.shape[1], h.device)
        mblock = _layer_fn(functools.partial(blk.mamba_block_full, cfg,
                                             kcfg=kcfg), remat)
        sblock = _layer_fn(functools.partial(
            blk.transformer_block_full, cfg, positions=positions,
            q_pos=q_pos, kcfg=kcfg), remat)
        for mp in params["layers"]:
            for lp in mp:
                h = mblock(lp, h)
            h, a = sblock(params["shared"], h)
            aux = aux + a
    h = apply_norm(cfg, params["final_norm"], h)
    return unembed(cfg, params, h), aux


# ---------------------------------------------------------------------------
# Cache, prefill, decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, device) -> dict:
    dt = model_dtype(cfg)
    if cfg.arch_type in _ATTENTION_STACKS:
        c = attn.init_kv_cache(cfg, batch, max_len, dt, cfg.num_layers,
                               device)
    else:
        hybrid = cfg.arch_type == "hybrid"
        lead = super_blocks(cfg) if hybrid else (cfg.num_layers,)
        one = ssm_lib.init_mamba_cache(cfg, batch, dt, device)
        c = {k: v.new_zeros(lead + tuple(v.shape)) for k, v in one.items()}
        if hybrid:
            c.update(attn.init_kv_cache(cfg, batch, max_len, dt, lead[0],
                                        device))
    c["index"] = 0
    return c


def cache_axes(cfg) -> dict:
    """Logical axes of :func:`init_cache`'s tree (string leaves): the
    reference's, in the port's flat cache (its "kv" / "mamba" subtrees'
    leaves at the top)."""
    kv = axes_to_str(("layers", "batch", "kv_seq", "kv_heads", None))
    c = {"index": axes_to_str(())}
    if cfg.arch_type in _ATTENTION_STACKS:
        c.update(k=kv, v=kv)
    elif cfg.arch_type == "ssm":
        c.update(conv=axes_to_str(("layers", "batch", None, "tensor")),
                 ssd=axes_to_str(("layers", "batch", "ssm_heads", None,
                                  None)))
    else:
        c.update(conv=axes_to_str(("layers", "layers", "batch", None,
                                   "tensor")),
                 ssd=axes_to_str(("layers", "layers", "batch", "ssm_heads",
                                  None, None)),
                 k=kv, v=kv)
    return c


def _write_mamba(cache, at, mc) -> None:
    """One Mamba2 layer's new cache into the stacked cache slot ``at``."""
    cache["conv"][at].copy_(mc["conv"])
    cache["ssd"][at].copy_(mc["ssd"])


def _read_mamba(cache, at) -> dict:
    return {"conv": cache["conv"][at], "ssd": cache["ssd"][at]}


def prefill(cfg, params, batch, max_len: int,
            kcfg: ops.KernelConfig = ops.DEFAULT):
    """Full-prefix pass building the cache.
    -> (last-token logits (B,1,V) f32, cache)."""
    _require_decode(cfg)
    h = embed_inputs(cfg, params, batch)
    bsz, seq = h.shape[0], h.shape[1]
    cache = init_cache(cfg, bsz, max_len, h.device)
    cache["index"] = seq
    if cfg.arch_type in _ATTENTION_STACKS:
        positions, q_pos = _positions(cfg, batch, seq, h.device)
        for i, lp in enumerate(params["layers"]):
            h, _, (k, v) = blk.transformer_block_full(
                cfg, lp, h, positions, q_pos, want_cache=True, kcfg=kcfg)
            attn.write_prefill(cfg, cache["k"][i], cache["v"][i], k, v)
    elif cfg.arch_type == "ssm":
        for i, lp in enumerate(params["layers"]):
            h, mc = blk.mamba_block_full(cfg, lp, h, return_cache=True,
                                         kcfg=kcfg)
            _write_mamba(cache, i, mc)
    else:
        positions, q_pos = _positions(cfg, batch, seq, h.device)
        for si, mp in enumerate(params["layers"]):
            for j, lp in enumerate(mp):
                h, mc = blk.mamba_block_full(cfg, lp, h, return_cache=True,
                                             kcfg=kcfg)
                _write_mamba(cache, (si, j), mc)
            h, _, (k, v) = blk.transformer_block_full(
                cfg, params["shared"], h, positions, q_pos, want_cache=True,
                kcfg=kcfg)
            attn.write_prefill(cfg, cache["k"][si], cache["v"][si], k, v)
    h = apply_norm(cfg, params["final_norm"], h[:, -1:])
    return unembed(cfg, params, h), cache


def decode_step(cfg, params, batch, cache,
                kcfg: ops.KernelConfig = ops.DEFAULT):
    """One-token step. batch: tokens (B,1) or embeds (B,1,d). Updates the
    cache in place. -> (logits (B,1,V) f32, cache)."""
    _require_decode(cfg)
    h = embed_inputs(cfg, params, batch)
    index = cache["index"]
    positions = _decode_positions(cfg, batch, h.shape[0], index, h.device)
    if cfg.arch_type in _ATTENTION_STACKS:
        for i, lp in enumerate(params["layers"]):
            h = blk.transformer_block_decode(cfg, lp, h, cache["k"][i],
                                             cache["v"][i], index, positions,
                                             kcfg=kcfg)
    elif cfg.arch_type == "ssm":
        for i, lp in enumerate(params["layers"]):
            h, mc = blk.mamba_block_decode(cfg, lp, h, _read_mamba(cache, i),
                                           kcfg)
            _write_mamba(cache, i, mc)
    else:
        for si, mp in enumerate(params["layers"]):
            for j, lp in enumerate(mp):
                h, mc = blk.mamba_block_decode(
                    cfg, lp, h, _read_mamba(cache, (si, j)), kcfg)
                _write_mamba(cache, (si, j), mc)
            h = blk.transformer_block_decode(
                cfg, params["shared"], h, cache["k"][si], cache["v"][si],
                index, positions, kcfg=kcfg)
    cache["index"] = index + 1
    h = apply_norm(cfg, params["final_norm"], h)
    return unembed(cfg, params, h), cache
