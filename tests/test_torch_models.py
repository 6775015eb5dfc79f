"""The port's dense model layer against ``repro.models`` on the CPU: norms,
activations, RoPE, the MLP, the KV-cache helpers, decode attention, and
forward / prefill / decode on the dense smoke configs. Weights come from
``convert.random_model_params`` (numpy seed, LoRA B non-zero) and reach both
packages as the same numpy arrays."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import decode_step as jdecode
from repro.models import forward as jforward
from repro.models import init_model
from repro.models import mlp as jmlp
from repro.models import prefill as jprefill
from repro.models import rope as jrope
from repro_torch import convert
from repro_torch.configs import LoRAConfig, get_smoke_config
from repro_torch.models import attention, common, mlp, rope
from repro_torch.models import decode_step, forward, init_params, prefill
from repro_torch.models import transformer

torch.set_num_threads(1)

B, S = 2, 64
# tests/test_models.py's prefill / decode parity tolerance
ATOL, RTOL = 2e-4, 2e-3

# five dense families (plain, non-parametric LN + tied, MQA, qkv_bias,
# parametric LN + tied with rope theta 7.5e7); olmo-1b also with a sliding
# window
CASES = [("llama2-7b", {}), ("olmo-1b", {}), ("granite-20b", {}),
         ("qwen1.5-110b", {}), ("olmo-1b", {"sliding_window": 16}),
         ("command-r-plus-104b", {})]
CASE_IDS = ["llama2-7b", "olmo-1b", "granite-20b", "qwen1.5-110b",
            "olmo-1b-window16", "command-r-plus-104b"]


def _cfgs(arch, over):
    cfg, jcfg = get_smoke_config(arch), jsmoke(arch)
    if over:
        cfg, jcfg = cfg.reduced(**over), jcfg.reduced(**over)
    return cfg, jcfg


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("arch", ["llama2-7b", "command-r-plus-104b",
                                  "olmo-1b"])
def test_norms_match_reference(arch):
    cfg = get_smoke_config(arch)
    vals = convert.random_model_params(cfg, 1)["final_norm"]
    x = np.random.default_rng(0).standard_normal((3, 5, cfg.d_model),
                                                 np.float32) * 3 + 1
    got = common.apply_norm(cfg, {k: _t(v) for k, v in vals.items()}, _t(x))
    want = jcommon.apply_norm(jsmoke(arch), jax.tree.map(jnp.asarray, vals),
                              jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_act_fn_matches_reference(name):
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    np.testing.assert_allclose(common.act_fn(name)(_t(x)).numpy(),
                               np.asarray(jcommon.act_fn(name)(x)),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("theta,offset", [(10000.0, 0), (1e6, 37)])
def test_rope_matches_reference(theta, offset):
    x = np.random.default_rng(2).standard_normal((2, 9, 3, 64), np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32)[None] + offset, (2, 9))
    got = rope.apply_rope(_t(x), _t(pos.copy()), theta)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(
        rope.default_positions(2, 9, offset).numpy(),
        np.asarray(jrope.default_positions(2, 9, offset)))


@pytest.mark.parametrize("over", [
    {},
    {"mlp_act": "gelu", "mlp_bias": True},
    {"mlp_bias": True, "lora": LoRAConfig(rank=8, targets=("q", "mlp"))},
])
def test_mlp_matches_reference(over):
    cfg, jcfg = _cfgs("llama2-7b", over)
    if "lora" in over:  # the reference's LoRAConfig is a distinct class
        jcfg = dataclasses.replace(jcfg, lora=type(jcfg.lora)(
            rank=8, targets=("q", "mlp")))
    p = jax.tree.map(lambda a: a[0],
                     convert.random_model_params(cfg, 3)["layers"]["mlp"])
    x = np.random.default_rng(3).standard_normal((2, 7, cfg.d_model),
                                                 np.float32)
    got = mlp.apply_mlp(cfg, convert.model_params(
        {"layers": {"mlp": jax.tree.map(lambda a: a[None], p)}},
        dataclasses.replace(cfg, num_layers=1), "cpu")["layers"][0]["mlp"],
        _t(x))
    want = jmlp.apply_mlp(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("seq,width", [(5, 16), (16, 16), (37, 16)])
def test_write_prefill_matches_reference(seq, width):
    cfg = get_smoke_config("olmo-1b").reduced(sliding_window=width)
    rng = np.random.default_rng(seq)
    k, v = (rng.standard_normal((2, seq, 4, 8), np.float32) for _ in "kv")
    ck = np.zeros((2, width, 4, 8), np.float32)
    got = attention.write_prefill(cfg, _t(ck.copy()), _t(ck.copy()), _t(k),
                                  _t(v))
    want = jattn.write_prefill(jsmoke("olmo-1b"), jnp.asarray(ck),
                               jnp.asarray(ck), jnp.asarray(k), jnp.asarray(v))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    k1 = rng.standard_normal((2, 1, 4, 8), np.float32)
    got_d = attention.write_decode(got[0], got[1], _t(k1), _t(k1), seq)
    want_d = jattn.write_decode(want[0], want[1], jnp.asarray(k1),
                                jnp.asarray(k1), seq)
    for g, w in zip(got_d, want_d):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("index", [0, 1, 5, 16, 17, 40])
def test_ring_positions_match_reference(index):
    np.testing.assert_array_equal(
        attention.ring_positions(16, index).numpy(),
        np.asarray(jattn.ring_positions(16, jnp.int32(index))))


@pytest.mark.parametrize("window,index", [(None, 9), (6, 9), (6, 30)])
def test_decode_attend_matches_reference(window, index):
    cfg, jcfg = _cfgs("granite-20b", {"sliding_window": window})
    width = 12 if window is None else window
    rng = np.random.default_rng(index)
    q1 = rng.standard_normal((2, 1, 4, 64), np.float32)
    ck, cv = (rng.standard_normal((2, width, 1, 64), np.float32)
              for _ in "kv")
    got = attention.decode_attend(cfg, _t(q1), _t(ck), _t(cv), index)
    want = jattn.decode_attend(jcfg, jnp.asarray(q1), jnp.asarray(ck),
                               jnp.asarray(cv), jnp.int32(index))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("arch", ["llama2-7b", "tiny-100m", "olmo-1b",
                                  "granite-20b", "qwen1.5-110b",
                                  "command-r-plus-104b"])
def test_random_params_have_reference_layout(arch):
    """random_model_params builds the reference's tree (same structure and
    shapes as init_model's values); the port's init_params builds what
    model_params makes of it, with LoRA B zero."""
    cfg = get_smoke_config(arch)
    vals = convert.random_model_params(cfg, 0)
    ref_vals, _ = init_model(jax.random.PRNGKey(0), jsmoke(arch))
    assert jax.tree.structure(vals) == jax.tree.structure(ref_vals)
    for a, b in zip(jax.tree.leaves(vals), jax.tree.leaves(ref_vals)):
        assert a.shape == b.shape
    assert all(np.any(p["b"]) for p in vals["layers"]["attn"]["lora"].values())
    ported = convert.model_params(vals, cfg, "cpu")
    fresh = init_params(torch.Generator().manual_seed(0), cfg)
    assert len(fresh["layers"]) == cfg.num_layers
    shapes = jax.tree.map(lambda t: (tuple(t.shape), t.dtype), ported)
    assert jax.tree.map(lambda t: (tuple(t.shape), t.dtype), fresh) == shapes
    for lp in fresh["layers"]:
        assert all(not p["b"].any() for p in lp["attn"]["lora"].values())


@pytest.mark.parametrize("arch,over", CASES, ids=CASE_IDS)
def test_forward_matches_reference(arch, over):
    cfg, jcfg = _cfgs(arch, over)
    vals = convert.random_model_params(cfg, 0)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    want, _ = jforward(jcfg, jax.tree.map(jnp.asarray, vals),
                       {"tokens": jnp.asarray(toks, jnp.int32)})
    got, aux = forward(cfg, convert.model_params(vals, cfg, "cpu"),
                       {"tokens": _t(toks)})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("arch,over", CASES, ids=CASE_IDS)
def test_prefill_decode_match_reference(arch, over):
    """prefill on S-4 tokens, then 4 decode steps, against the reference
    step by step (logits and the KV cache)."""
    cfg, jcfg = _cfgs(arch, over)
    vals = convert.random_model_params(cfg, 0)
    jp = jax.tree.map(jnp.asarray, vals)
    params = convert.model_params(vals, cfg, "cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S))
    jtoks = jnp.asarray(toks, jnp.int32)
    want, jcache = jprefill(jcfg, jp, {"tokens": jtoks[:, :S - 4]}, max_len=S)
    got, cache = prefill(cfg, params, {"tokens": _t(toks[:, :S - 4])}, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    for i in range(S - 4, S):
        want, jcache = jdecode(jcfg, jp, {"tokens": jtoks[:, i:i + 1]}, jcache)
        got, cache = decode_step(cfg, params, {"tokens": _t(toks[:, i:i + 1])},
                                 cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL)
    assert cache["index"] == int(jcache["index"]) == S
    np.testing.assert_allclose(cache["k"].numpy(),
                               np.asarray(jcache["kv"]["k"]), atol=ATOL,
                               rtol=RTOL)


def test_unported_families_and_positions_raise():
    """What the old refusals became: every family of the reference
    initialises and runs forward in the port (NOT_PORTED is gone), a batch's
    own positions are taken (explicit default positions give the default
    run's logits), and an encoder-only config's prefill raises."""
    from repro.configs import list_archs as jlist_archs

    assert not hasattr(transformer, "NOT_PORTED")
    gen = torch.Generator().manual_seed(0)
    for arch in jlist_archs():
        cfg = get_smoke_config(arch)
        params = init_params(gen, cfg)
        if cfg.embed_inputs:
            batch = {"embeds": torch.randn((1, 8, cfg.d_model),
                                           generator=gen)}
        else:
            batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, 8),
                                             generator=gen)}
        logits, aux = forward(cfg, params, batch)
        assert logits.shape == (1, 8, cfg.vocab_size), arch
        assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))
    cfg = get_smoke_config("llama2-7b")
    params = convert.model_params(convert.random_model_params(cfg, 0), cfg,
                                  "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    pos = torch.arange(16, dtype=torch.int32).expand(2, 16)
    want, _ = forward(cfg, params, {"tokens": toks})
    got, _ = forward(cfg, params, {"tokens": toks, "positions": pos})
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    enc = get_smoke_config("hubert-xlarge")
    with pytest.raises(ValueError, match="encoder-only"):
        prefill(enc, init_params(gen, enc),
                {"embeds": torch.zeros((1, 4, enc.d_model))}, 8)
