"""Model assembly for the dense family: init / forward / prefill / decode
(the reference's ``models/transformer.py``, dense branches).

Layers are a Python list of per-layer parameter dicts, not a stacked scan.
The KV cache is ``{"index": int, "k": (L, B, W, kv, hd), "v": ...}`` and is
updated in place by prefill and decode. The other architecture families
raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import blocks as blk
from repro_torch.models.common import apply_norm, init_norm, normal_param
from repro_torch.models.rope import default_positions

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# where each family not ported yet is queued (ROADMAP Queue 1, item 10)
NOT_PORTED = {
    "moe": "ROADMAP Queue 1 item 10a (MoE)",
    "ssm": "ROADMAP Queue 1 item 10b (SSM and K4)",
    "hybrid": "ROADMAP Queue 1 item 10c (hybrid)",
    "vlm": "ROADMAP Queue 1 item 10d (VLM and M-RoPE)",
    "audio": "ROADMAP Queue 1 item 10e (audio)",
}


def model_dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def require_dense(cfg) -> None:
    if cfg.arch_type != "dense":
        raise NotImplementedError(
            f"{cfg.name}: arch_type {cfg.arch_type!r} is not ported yet; "
            f"{NOT_PORTED[cfg.arch_type]} ports it")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg) -> dict:
    """Random parameters drawn on the generator's device (each tensor in f32,
    then cast to the model dtype; adapters stay f32). LoRA B is zero, as the
    standard init."""
    require_dense(cfg)
    dt = model_dtype(cfg)
    p = {
        "embed": normal_param(generator, (cfg.vocab_size, cfg.d_model), dt,
                              stddev=0.02),
        "final_norm": init_norm(cfg, dt, generator.device),
    }
    if not cfg.tie_embeddings:
        p["head"] = normal_param(generator, (cfg.d_model, cfg.vocab_size), dt,
                                 stddev=0.02)
    p["layers"] = [blk.init_transformer_block(generator, cfg, dt)
                   for _ in range(cfg.num_layers)]
    return p


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_inputs(cfg, params, batch) -> torch.Tensor:
    return params["embed"][batch["tokens"]].to(model_dtype(cfg))


def unembed(cfg, params, h) -> torch.Tensor:
    """Logits: the product in the model dtype, then cast to f32."""
    if "head" in params:
        logits = h @ params["head"]
    else:
        logits = h @ params["embed"].t()
    return logits.float()


def _positions(batch, seq: int, device, offset: int = 0) -> torch.Tensor:
    if "positions" in batch:
        raise NotImplementedError(
            "a batch with its own positions: K3 counts query and key "
            "positions from 0; ROADMAP Queue 1 item 10d (VLM and M-RoPE) "
            "lifts this")
    b = batch["tokens"].shape[0]
    return default_positions(b, seq, offset, device).expand(b, seq)


# ---------------------------------------------------------------------------
# Forward (full sequence)
# ---------------------------------------------------------------------------

def forward(cfg, params, batch, kcfg: ops.KernelConfig = ops.DEFAULT):
    """-> (logits (B,S,V) f32, aux_loss scalar, always 0 for dense)."""
    require_dense(cfg)
    h = embed_inputs(cfg, params, batch)
    positions = _positions(batch, h.shape[1], h.device)
    for lp in params["layers"]:
        h = blk.transformer_block_full(cfg, lp, h, positions, kcfg=kcfg)
    h = apply_norm(cfg, params["final_norm"], h)
    return unembed(cfg, params, h), torch.zeros((), device=h.device)


# ---------------------------------------------------------------------------
# KV cache, prefill, decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, device) -> dict:
    require_dense(cfg)
    c = attn.init_kv_cache(cfg, batch, max_len, model_dtype(cfg),
                           cfg.num_layers, device)
    c["index"] = 0
    return c


def prefill(cfg, params, batch, max_len: int,
            kcfg: ops.KernelConfig = ops.DEFAULT):
    """Full-prefix pass building the cache.
    -> (last-token logits (B,1,V) f32, cache)."""
    require_dense(cfg)
    h = embed_inputs(cfg, params, batch)
    bsz, seq = h.shape[0], h.shape[1]
    positions = _positions(batch, seq, h.device)
    cache = init_cache(cfg, bsz, max_len, h.device)
    cache["index"] = seq
    for i, lp in enumerate(params["layers"]):
        h, (k, v) = blk.transformer_block_full(cfg, lp, h, positions,
                                               want_cache=True, kcfg=kcfg)
        attn.write_prefill(cfg, cache["k"][i], cache["v"][i], k, v)
    h = apply_norm(cfg, params["final_norm"], h[:, -1:])
    return unembed(cfg, params, h), cache


def decode_step(cfg, params, batch, cache,
                kcfg: ops.KernelConfig = ops.DEFAULT):
    """One-token step. batch: tokens (B,1). Updates the cache in place.
    -> (logits (B,1,V) f32, cache)."""
    require_dense(cfg)
    h = embed_inputs(cfg, params, batch)
    index = cache["index"]
    positions = _positions(batch, 1, h.device, offset=index)
    for i, lp in enumerate(params["layers"]):
        h = blk.transformer_block_decode(cfg, lp, h, cache["k"][i],
                                         cache["v"][i], index, positions,
                                         kcfg=kcfg)
    cache["index"] = index + 1
    h = apply_norm(cfg, params["final_norm"], h)
    return unembed(cfg, params, h), cache
