"""The port's MoE layer (``repro_torch.models.moe``) and the Mixtral models
against ``repro.models`` on the CPU: ``expert_capacity``, ``route``,
``apply_moe`` (with a capacity small enough to drop tokens), the
``mixtral-8x7b`` and ``mixtral-8x22b`` smoke forwards with their aux loss,
prefill and decode past the smoke window (64), and ``ServingEngine``
tokens. Weights come from ``convert.random_model_params`` and reach both
packages as the same numpy arrays.

Tolerances. The routing (``idx``), the kept / dropped tokens and greedy
tokens are exact; a mismatch there is a fault, not a tolerance to widen.
Router weights and the aux loss hold to 1e-6, the layer's output to
1e-5, and the models' logits to tests/test_models.py's prefill / decode
tolerance (atol 2e-4, rtol 2e-3)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.models import decode_step as jdecode
from repro.models import forward as jforward
from repro.models import moe as jmoe
from repro.models import prefill as jprefill
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JServingEngine
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.lora_matmul import lora_matmul
from repro_torch.models import decode_step, forward, moe, prefill
from repro_torch.serve import Request, ServingEngine

torch.set_num_threads(2)

ARCHS = ["mixtral-8x7b", "mixtral-8x22b"]
ATOL, RTOL = 2e-4, 2e-3


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _layer(cfg, seed):
    """Layer 0's MoE parameters as numpy arrays."""
    vals = convert.random_model_params(cfg, seed)
    return {k: v[0] for k, v in vals["layers"]["moe"].items()}


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model), np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    from repro.configs import get_config as jget

    for full in (True, False):
        got = get_config(arch) if full else get_smoke_config(arch)
        want = jget(arch) if full else jsmoke(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()


@pytest.mark.parametrize("tokens", [1, 7, 64, 205, 1024, 4096])
@pytest.mark.parametrize("factor", [0.5, 1.25, 2.0])
def test_expert_capacity_matches_reference(tokens, factor):
    cfg = get_config("mixtral-8x7b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=factor))
    jcfg = jsmoke("mixtral-8x7b")
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, num_experts=8, capacity_factor=factor))
    assert moe.expert_capacity(cfg, tokens) == jmoe.expert_capacity(jcfg,
                                                                    tokens)
    # Mixtral's prefill and decode groups (PERF.md)
    assert moe.expert_capacity(get_config("mixtral-8x7b"), 1024) == 384
    assert moe.expert_capacity(get_config("mixtral-8x7b"), 1) == 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_route_matches_reference(seed):
    cfg, jcfg = get_smoke_config("mixtral-8x7b"), jsmoke("mixtral-8x7b")
    p = _layer(cfg, seed)
    x = _x(cfg, 3, 50, seed + 10)
    ji, jw, ja = jax.vmap(lambda xs: jmoe.route(
        jcfg, jnp.asarray(p["router"]), xs))(jnp.asarray(x))
    ti, tw, ta = moe.route(cfg, _t(p["router"]), _t(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-6,
                               rtol=1e-6)


def test_route_breaks_equal_gates_by_lower_index():
    """Equal gates (a zero router) take the lower expert ids, as lax.top_k
    does."""
    cfg = get_smoke_config("mixtral-8x7b")
    x = torch.randn(2, 5, cfg.d_model)
    idx, w, _ = moe.route(cfg, torch.zeros(cfg.d_model,
                                           cfg.moe.num_experts), x)
    assert (idx == torch.tensor([0, 1])).all()
    assert torch.equal(w, torch.full_like(w, 0.5))


@pytest.mark.parametrize("factor", [1.25, 0.5, 0.25])
def test_apply_moe_matches_reference(factor):
    """factor 1.25 is Mixtral's; 0.5 and 0.25 drop tokens, and which tokens
    are kept is compared exactly."""
    cfg, jcfg = get_smoke_config("mixtral-8x7b"), jsmoke("mixtral-8x7b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=factor))
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=factor))
    p = _layer(cfg, 4)
    x = _x(cfg, 2, 60, 5)
    y, aux = moe.apply_moe(cfg, {k: _t(v) for k, v in p.items()}, _t(x))
    jy, jaux = jmoe.apply_moe(jcfg, jax.tree.map(jnp.asarray, p),
                              jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6,
                               rtol=1e-6)
    cap = moe.expert_capacity(cfg, 60)
    assert cap == jmoe.expert_capacity(jcfg, 60)
    idx, _, _ = moe.route(cfg, _t(p["router"]), _t(x))
    _, (order, src, dest, keep) = moe._dispatch(cfg, _t(x), idx, cap)
    for row in range(2):
        jidx, jw, _ = jmoe.route(jcfg, jnp.asarray(p["router"]),
                                 jnp.asarray(x[row]))
        _, (jorder, jsrc, jdest, jkeep) = jmoe._dispatch_one(
            jcfg, jnp.asarray(x[row]), jidx, jw, cap)
        for a, b in ((order, jorder), (src, jsrc), (dest, jdest),
                     (keep, jkeep)):
            np.testing.assert_array_equal(a[row].numpy(), np.asarray(b))
    dropped = int((~keep).sum())
    assert (dropped > 0) == (factor < 1.0), dropped


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    cfg, jcfg = get_smoke_config(arch), jsmoke(arch)
    vals = convert.random_model_params(cfg, 7)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (2, 80)).astype(np.int32)
    want, jaux = jforward(jcfg, jax.tree.map(jnp.asarray, vals),
                          {"tokens": jnp.asarray(toks)})
    got, aux = forward(cfg, convert.model_params(vals, cfg, "cpu"),
                       {"tokens": _t(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6,
                               rtol=1e-6)
    assert float(aux) > 0


def test_bf16_model_keeps_the_router_f32():
    cfg = get_smoke_config("mixtral-8x7b").reduced(dtype="bfloat16")
    params = convert.model_params(convert.random_model_params(cfg, 0), cfg,
                                  "cpu")
    m = params["layers"][0]["moe"]
    assert m["router"].dtype == torch.float32
    assert {m[k].dtype for k in ("w1", "w2", "w3")} == {torch.bfloat16}
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models import init_params

    m = init_params(gen, cfg)["layers"][1]["moe"]
    assert m["router"].dtype == torch.float32 and m["w2"].shape == (
        cfg.moe.num_experts, cfg.d_ff, cfg.d_model)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_past_the_window_match_reference(arch):
    """A 70-token prompt and 6 decode steps: the smoke window (64) masks
    K3's prefill and wraps the ring-buffer cache."""
    cfg, jcfg = get_smoke_config(arch), jsmoke(arch)
    assert cfg.sliding_window == 64
    vals = convert.random_model_params(cfg, 8)
    params = convert.model_params(vals, cfg, "cpu")
    jp = jax.tree.map(jnp.asarray, vals)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                             (2, 76)).astype(np.int32)
    jtoks = jnp.asarray(toks)
    want, jcache = jprefill(jcfg, jp, {"tokens": jtoks[:, :70]}, max_len=96)
    got, cache = prefill(cfg, params, {"tokens": _t(toks[:, :70])}, 96)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    for i in range(70, 76):
        want, jcache = jdecode(jcfg, jp, {"tokens": jtoks[:, i:i + 1]},
                               jcache)
        got, cache = decode_step(cfg, params,
                                 {"tokens": _t(toks[:, i:i + 1])}, cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL)
    assert cache["k"].shape[2] == 64
    np.testing.assert_allclose(cache["k"].numpy(),
                               np.asarray(jcache["kv"]["k"]), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("arch,prompt", [("mixtral-8x7b", 12),
                                         ("mixtral-8x7b", 72),
                                         ("mixtral-8x22b", 72)])
def test_greedy_tokens_equal_reference(arch, prompt):
    cfg, jcfg = get_smoke_config(arch), jsmoke(arch)
    vals = convert.random_model_params(cfg, 5)
    prompts = np.random.default_rng(prompt).integers(
        0, cfg.vocab_size, (3, prompt)).astype(np.int32)
    want = JServingEngine(jcfg, jax.tree.map(jnp.asarray, vals),
                          max_len=96).generate_batch(
        [JRequest(p, 8) for p in prompts])
    eng = ServingEngine(cfg, convert.model_params(vals, cfg, "cpu"),
                        max_len=96, device="cpu")
    got = eng.generate_batch([Request(p, 8) for p in prompts])
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert lora_matmul.launches == 0 and flash_attention.launches == 0


def test_chip_smoke_moe_ref_tokens_are_current():
    """chip_smoke.py holds the port on the card to the JAX ServingEngine's
    tokens on the mixtral-8x7b smoke config (prompts past the window);
    recompute them so the constant cannot go stale."""
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    arch, seed, length, tokens = chip_smoke.MOE_REF
    assert length > get_smoke_config(arch).sliding_window
    vals = convert.random_model_params(get_smoke_config(arch), seed)
    prompts = chip_smoke.serve_ref_prompts(np, jsmoke(arch).vocab_size, seed,
                                           length)
    out = JServingEngine(jsmoke(arch), jax.tree.map(jnp.asarray, vals),
                         max_len=chip_smoke.MOE_REF_MAX_LEN).generate_batch(
        [JRequest(p, chip_smoke.SERVE_REF_NEW) for p in prompts])
    assert tuple(tuple(int(t) for t in o) for o in out) == tokens
