"""The port's Mamba2 layer and the SSM and hybrid model families against
``repro.models`` on the CPU: the causal conv and its decode step, the
chunked SSD and its decode step, the Mamba2 block (prefill with its cache,
decode), and forward / prefill / decode of the mamba2-370m and zamba2-2.7b
smoke configs. Weights come from ``convert.random_model_params`` (numpy
seed, LoRA B non-zero, A_log and dt_bias near the reference's init) and
reach both packages as the same numpy arrays.

Tolerances: the layer pieces at 1e-5 (f32, the same operations in another
order), the SSD at 2e-4 (tests/test_ssm_moe.py's for chunked against
sequential and across chunk sizes), the models at atol 2e-4 / rtol 2e-3
(tests/test_models.py's prefill / decode parity, as the dense models)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.models import decode_step as jdecode
from repro.models import forward as jforward
from repro.models import init_model
from repro.models import prefill as jprefill
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import decode_step, forward, init_params, prefill
from repro_torch.models import ssm

torch.set_num_threads(1)

B, S = 2, 70
ATOL, RTOL = 2e-4, 2e-3
SSD_TOL = dict(atol=2e-4, rtol=2e-4)
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = ["mamba2-370m", "zamba2-2.7b"]
KCFGS = [ops.KernelConfig(use_cuda=True), ops.KernelConfig(use_cuda=False)]
KCFG_IDS = ["ops-ssd", "ssd-chunked"]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _ssd_inputs(b=2, s=96, h=4, p=16, g=2, n=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.5).astype(
        np.float32)
    A = (-np.exp(rng.standard_normal(h)) * 0.5).astype(np.float32)
    B_ = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    C_ = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    return x, dt, A, B_, C_


def _layer0(arch, seed=0):
    """(port config, reference config, the port's layer-0 Mamba2 params,
    the reference's)."""
    cfg = get_smoke_config(arch)
    vals = convert.random_model_params(cfg, seed)
    ported = convert.model_params(vals, cfg, "cpu")["layers"][0]
    jlayers = vals["layers"]
    if cfg.arch_type == "hybrid":
        ported = ported[0]
        jlayers = jax.tree.map(lambda a: a[0], jlayers)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), jlayers)["mamba"]
    return cfg, jsmoke(arch), ported["mamba"], jp


def test_causal_conv_and_step_match_reference():
    rng = np.random.default_rng(1)
    xbc = rng.standard_normal((2, 9, 24), np.float32)
    w = rng.standard_normal((24, 4), np.float32) * 0.3
    b = rng.standard_normal(24).astype(np.float32) * 0.1
    got = ssm._causal_conv(_t(xbc), _t(w), _t(b))
    want = jssm._causal_conv(jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    state = rng.standard_normal((2, 3, 24), np.float32)
    st, y = ssm._conv_step(_t(state), _t(xbc[:, :1]), _t(w), _t(b))
    jst, jy = jssm._conv_step(jnp.asarray(state), jnp.asarray(xbc[:, :1]),
                              jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **LAYER_TOL)


@pytest.mark.parametrize("chunk,s", [(32, 96), (64, 96), (32, 75)])
def test_ssd_chunked_matches_reference(chunk, s):
    """chunk 32 and 64, and a ragged S (zero-padded with dt = 0)."""
    ins = _ssd_inputs(s=s, seed=chunk + s)
    y, h = ssm.ssd_chunked(*map(_t, ins), chunk)
    jy, jh = jssm.ssd_chunked(*map(jnp.asarray, ins), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SSD_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **SSD_TOL)


def test_ssd_step_matches_reference():
    x, dt, A, B_, C_ = _ssd_inputs(b=2, s=1, seed=3)
    state = np.random.default_rng(4).standard_normal((2, 4, 16, 8)).astype(
        np.float32)
    new, y = ssm.ssd_step(_t(state), _t(x[:, 0]), _t(dt[:, 0]), _t(A),
                          _t(B_[:, 0]), _t(C_[:, 0]))
    jnew, jy = jssm.ssd_step(jnp.asarray(state), jnp.asarray(x[:, 0]),
                             jnp.asarray(dt[:, 0]), jnp.asarray(A),
                             jnp.asarray(B_[:, 0]), jnp.asarray(C_[:, 0]))
    np.testing.assert_allclose(new.numpy(), np.asarray(jnew), **LAYER_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **LAYER_TOL)


@pytest.mark.parametrize("kcfg", KCFGS, ids=KCFG_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_mamba_and_decode_match_reference(arch, kcfg):
    """The Mamba2 layer on 20 tokens with its cache (ops.ssd, whose wrapper
    runs the plain version on the CPU, or ssd_chunked), then 3 decode
    steps from that cache."""
    cfg, jcfg, p, jp = _layer0(arch)
    x = np.random.default_rng(5).standard_normal((2, 23, cfg.d_model),
                                                 np.float32) * 0.5
    got, cache = ssm.apply_mamba(cfg, p, _t(x[:, :20]), return_cache=True,
                                 kcfg=kcfg)
    want, jcache = jssm.apply_mamba(jcfg, jp, jnp.asarray(x[:, :20]),
                                    return_cache=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    for k in ("conv", "ssd"):
        assert tuple(cache[k].shape) == jcache[k].shape
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   atol=ATOL, rtol=RTOL)
    for t in range(20, 23):
        got, cache = ssm.apply_mamba_decode(cfg, p, _t(x[:, t:t + 1]), cache,
                                            kcfg)
        want, jcache = jssm.apply_mamba_decode(jcfg, jp,
                                               jnp.asarray(x[:, t:t + 1]),
                                               jcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL)
    np.testing.assert_allclose(cache["ssd"].numpy(),
                               np.asarray(jcache["ssd"]), atol=ATOL,
                               rtol=RTOL)


def test_apply_mamba_short_prompt_pads_conv_cache():
    """S < conv width - 1: the conv cache is left-padded with zeros."""
    cfg, jcfg, p, jp = _layer0("mamba2-370m", seed=2)
    x = np.random.default_rng(6).standard_normal((1, 2, cfg.d_model),
                                                 np.float32)
    _, cache = ssm.apply_mamba(cfg, p, _t(x), return_cache=True)
    _, jcache = jssm.apply_mamba(jcfg, jp, jnp.asarray(x), return_cache=True)
    assert cache["conv"].shape == (1, 3, jcache["conv"].shape[-1])
    np.testing.assert_allclose(cache["conv"].numpy(),
                               np.asarray(jcache["conv"]), **LAYER_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_random_params_have_reference_layout(arch):
    """random_model_params builds the reference's tree (structure and
    shapes of init_model's values); the port's init_params builds what
    model_params makes of it."""
    cfg = get_smoke_config(arch)
    vals = convert.random_model_params(cfg, 0)
    ref_vals, _ = init_model(jax.random.PRNGKey(0), jsmoke(arch))
    assert jax.tree.structure(vals) == jax.tree.structure(ref_vals)
    for a, b in zip(jax.tree.leaves(vals), jax.tree.leaves(ref_vals)):
        assert a.shape == b.shape
    ported = convert.model_params(vals, cfg, "cpu")
    fresh = init_params(torch.Generator().manual_seed(0), cfg)
    shapes = jax.tree.map(lambda t: (tuple(t.shape), t.dtype), ported)
    assert jax.tree.map(lambda t: (tuple(t.shape), t.dtype), fresh) == shapes


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_model_params_keep_ssm_scalars_f32(arch):
    """At bf16 the base weights are bf16 while A_log, D, dt_bias and the
    adapters stay f32, as the reference keeps them."""
    cfg = get_smoke_config(arch).reduced(dtype="bfloat16")
    params = convert.model_params(convert.random_model_params(cfg, 0), cfg,
                                  "cpu")
    layer = params["layers"][0]
    layer = layer[0] if cfg.arch_type == "hybrid" else layer
    m = layer["mamba"]
    assert {k: m[k].dtype for k in ("A_log", "D", "dt_bias")} == dict.fromkeys(
        ("A_log", "D", "dt_bias"), torch.float32)
    assert m["lora"]["in"]["b"].dtype == torch.float32
    assert m["wx"].dtype == m["conv_w"].dtype == torch.bfloat16
    assert params["embed"].dtype == torch.bfloat16
    fresh = init_params(torch.Generator().manual_seed(0), cfg)
    fl = fresh["layers"][0]
    fl = fl[0] if cfg.arch_type == "hybrid" else fl
    assert fl["mamba"]["A_log"].dtype == torch.float32


@pytest.mark.parametrize("kcfg", KCFGS, ids=KCFG_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, kcfg):
    cfg, jcfg = get_smoke_config(arch), jsmoke(arch)
    vals = convert.random_model_params(cfg, 0)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    want, _ = jforward(jcfg, jax.tree.map(jnp.asarray, vals),
                       {"tokens": jnp.asarray(toks, jnp.int32)})
    got, aux = forward(cfg, convert.model_params(vals, cfg, "cpu"),
                       {"tokens": _t(toks)}, kcfg)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_match_reference(arch):
    """prefill on S-4 tokens, then 4 decode steps, against the reference
    step by step (logits, the Mamba2 conv and SSD caches, the shared
    block's KV cache)."""
    cfg, jcfg = get_smoke_config(arch), jsmoke(arch)
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
    pairs = [(cache["conv"], jcache["mamba"]["conv"]),
             (cache["ssd"], jcache["mamba"]["ssd"])]
    if cfg.arch_type == "hybrid":
        pairs += [(cache["k"], jcache["kv"]["k"]),
                  (cache["v"], jcache["kv"]["v"])]
    for got_c, want_c in pairs:
        assert tuple(got_c.shape) == want_c.shape
        np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                                   atol=ATOL, rtol=RTOL)
    assert ssd_scan.launches == 0


def test_hybrid_runs_every_super_block_and_the_shared_block():
    """zamba2 at 2 super-blocks of 2 Mamba2 layers (hybrid_period 2):
    prefill and decode against the reference."""
    over = dict(num_layers=4, hybrid_period=2)
    cfg = get_smoke_config("zamba2-2.7b").reduced(**over)
    jcfg = jsmoke("zamba2-2.7b").reduced(**over)
    vals = convert.random_model_params(cfg, 4)
    params = convert.model_params(vals, cfg, "cpu")
    assert [len(sb) for sb in params["layers"]] == [2, 2]
    jp = jax.tree.map(jnp.asarray, vals)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, 12))
    want, jcache = jprefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :11],
                                                             jnp.int32)},
                            max_len=16)
    got, cache = prefill(cfg, params, {"tokens": _t(toks[:, :11])}, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    want, jcache = jdecode(jcfg, jp, {"tokens": jnp.asarray(toks[:, 11:],
                                                            jnp.int32)},
                           jcache)
    got, cache = decode_step(cfg, params, {"tokens": _t(toks[:, 11:])}, cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    assert tuple(cache["ssd"].shape) == jcache["mamba"]["ssd"].shape
    assert tuple(cache["k"].shape) == jcache["kv"]["k"].shape


def test_remaining_families_raise_naming_their_item():
    """No family is left to port: the VLM and audio families are stacks of
    the dense block, so a dense config relabelled as either runs the same
    layers bit for bit; only an encoder-only config raises, naming why."""
    cfg = get_smoke_config("llama2-7b")
    params = convert.model_params(convert.random_model_params(cfg, 0), cfg,
                                  "cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 12),
                                     generator=torch.Generator().manual_seed(0))}
    want, _ = forward(cfg, params, batch)
    for arch in ("vlm", "audio"):
        other = dataclasses.replace(cfg, arch_type=arch)
        got, _ = forward(other, params, batch)
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    enc = dataclasses.replace(cfg, arch_type="audio", encoder_only=True)
    with pytest.raises(ValueError, match="encoder-only"):
        prefill(enc, params, batch, 16)
