"""The port's audio family (HuBERT: an encoder fed frame embeddings,
bidirectional attention at head dim 64 in the smoke config, layernorm,
gelu, biases, no RoPE) against ``repro.models`` on the CPU, on numpy
inputs made from a seed; and its refusals: an encoder has ``forward``
only."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.models import forward as jforward
from repro.models import init_model
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import decode_step, forward, init_cache, prefill
from repro_torch.models import frontends
from repro_torch.serve import ServingEngine

torch.set_num_threads(1)

ARCH = "hubert-xlarge"
# tests/test_models.py's parity tolerance
ATOL, RTOL = 2e-4, 2e-3


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_random_params_have_reference_layout():
    cfg = get_smoke_config(ARCH)
    vals = convert.random_model_params(cfg, 0)
    ref_vals, _ = init_model(jax.random.PRNGKey(0), jsmoke(ARCH))
    assert "embed" not in vals and "head" in vals
    assert jax.tree.structure(vals) == jax.tree.structure(ref_vals)
    for a, b in zip(jax.tree.leaves(vals), jax.tree.leaves(ref_vals)):
        assert a.shape == b.shape
    layer = vals["layers"]
    assert {"bq", "bk", "bv", "bo"} <= set(layer["attn"])
    assert {"b1", "b2"} <= set(layer["mlp"]) and "w3" not in layer["mlp"]
    assert set(layer["attn_norm"]) == {"scale", "bias"}


@pytest.mark.parametrize("batch,seq,seed", [(2, 64, 0), (3, 37, 1)])
def test_forward_matches_reference(batch, seq, seed):
    cfg, jcfg = get_smoke_config(ARCH), jsmoke(ARCH)
    assert not cfg.causal and cfg.rope_theta == 0.0 and cfg.encoder_only
    vals = convert.random_model_params(cfg, seed + 10)
    embeds = (np.random.default_rng(seed).standard_normal(
        (batch, seq, cfg.d_model), np.float32) * 0.1).astype(np.float32)
    want, _ = jforward(jcfg, jax.tree.map(jnp.asarray, vals),
                       {"embeds": jnp.asarray(embeds)})
    got, aux = forward(cfg, convert.model_params(vals, cfg, "cpu"),
                       {"embeds": _t(embeds)})
    assert got.shape == (batch, seq, cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_prefill_decode_and_engine_refuse_an_encoder():
    cfg = get_smoke_config(ARCH)
    params = convert.model_params(convert.random_model_params(cfg, 2), cfg,
                                  "cpu")
    embeds = torch.zeros((1, 4, cfg.d_model))
    with pytest.raises(ValueError, match="encoder-only"):
        prefill(cfg, params, {"embeds": embeds}, 8)
    cache = init_cache(cfg, 1, 8, "cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        decode_step(cfg, params, {"embeds": embeds[:, :1]}, cache)
    with pytest.raises(ValueError, match="encoder-only"):
        ServingEngine(cfg, params, device="cpu")


def test_engine_refuses_embedding_inputs():
    """The reference's engine feeds token prompts only: the port's refuses
    the VLM rather than serve it."""
    cfg = get_smoke_config("qwen2-vl-7b")
    params = convert.model_params(convert.random_model_params(cfg, 3), cfg,
                                  "cpu")
    with pytest.raises(ValueError, match="embeddings"):
        ServingEngine(cfg, params, device="cpu")


def test_masked_prediction_batch_shapes_and_rate():
    cfg = get_smoke_config(ARCH)
    gen = torch.Generator().manual_seed(4)
    b = frontends.make_masked_prediction_batch(gen, cfg, 8, 512)
    assert set(b) == {"embeds", "targets", "loss_mask"}
    assert b["embeds"].shape == (8, 512, cfg.d_model)
    assert b["embeds"].dtype == torch.float32
    assert b["targets"].shape == (8, 512) and b["targets"].dtype == torch.int32
    assert int(b["targets"].min()) >= 0
    assert int(b["targets"].max()) < cfg.vocab_size
    assert b["loss_mask"].dtype == torch.bool
    # 4096 Bernoulli(0.08) draws: 327.7 expected, sd 17.4
    assert 0.06 < float(b["loss_mask"].float().mean()) < 0.10
    logits, _ = forward(cfg, convert.model_params(
        convert.random_model_params(cfg, 5), cfg, "cpu"),
        {"embeds": b["embeds"][:2, :32]})
    assert logits.shape == (2, 32, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())


def test_chip_smoke_audio_ref_is_current():
    """chip_smoke.py holds the port on the card to the JAX package's argmax
    codebook ids (CRC32) and sampled logits on the hubert-xlarge smoke
    config; recompute them, and run the port's CPU path to the same ids
    and within the same 1e-4."""
    import sys
    import zlib
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root / "tools"))
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
        import jax_vlm_audio_refs
    finally:
        sys.path.remove(str(root / "tools"))
        sys.path.remove(str(root))
    crc, sample = jax_vlm_audio_refs.audio_ref()
    assert crc == chip_smoke.AUDIO_REF_IDS_CRC
    # the constants as printed; XLA's CPU sums may round otherwise elsewhere
    np.testing.assert_allclose(sample, chip_smoke.AUDIO_REF_LOGITS,
                               atol=1e-6, rtol=0)
    arch, seed, batch, seq = chip_smoke.AUDIO_REF
    cfg = get_smoke_config(arch)
    embeds, _ = chip_smoke.frontend_ref_inputs(np, cfg.d_model,
                                               cfg.vocab_size, seed, batch,
                                               seq)
    logits, _ = forward(cfg, convert.model_params(
        convert.random_model_params(cfg, seed), cfg, "cpu"),
        {"embeds": _t(embeds)})
    ids = logits.argmax(-1).to(torch.int32).numpy()
    assert zlib.crc32(ids.tobytes()) == crc
    np.testing.assert_allclose(
        logits[chip_smoke.AUDIO_REF_SAMPLE].reshape(-1).numpy(),
        np.asarray(sample, np.float32), atol=chip_smoke.AUDIO_REF_ATOL, rtol=0)
