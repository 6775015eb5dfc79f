"""The port's VLM family (Qwen2-VL: M-RoPE, embeddings in, attention masked
by the tokens' positions) against ``repro.models`` on the CPU. Inputs are
numpy arrays made from a seed and reach both packages as the same values;
weights come from ``convert.random_model_params``. Without positions the
plain attention stays held against the Pallas kernel in interpret mode by
tests/test_torch_flash_attention.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.configs import list_archs as jlist_archs
from repro.models import attention as jattn
from repro.models import decode_step as jdecode
from repro.models import forward as jforward
from repro.models import frontends as jfrontends
from repro.models import init_model
from repro.models import prefill as jprefill
from repro.models import rope as jrope
from repro_torch import convert
from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models import blocks, decode_step, forward, prefill, rope
from repro_torch.models import frontends

torch.set_num_threads(1)

B, S = 2, 64
# tests/test_models.py's prefill / decode parity tolerance
ATOL, RTOL = 2e-4, 2e-3
ARCH = "qwen2-vl-7b"
# image spans (start, h, w) at the start, in the middle and at the end
SPANS = {"start": (0, 4, 8), "middle": (8, 4, 8), "end": (32, 4, 8)}


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _embeds(cfg, seed, batch=B, seq=S):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, seq, cfg.d_model), np.float32)
            * 0.1).astype(np.float32)


def test_list_archs_match_reference():
    assert sorted(list_archs()) == sorted(jlist_archs())


@pytest.mark.parametrize("span", [None, *SPANS.values()],
                         ids=["text", *SPANS])
def test_make_mrope_positions_equal_reference(span):
    got = frontends.make_mrope_positions(3, S, span)
    want = jfrontends.make_mrope_positions(3, S, span)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("span", list(SPANS.values()), ids=list(SPANS))
@pytest.mark.parametrize("sections,head_dim", [((8, 12, 12), 64),
                                               ((16, 24, 24), 128)])
def test_m_rope_matches_reference(sections, head_dim, span):
    x = np.random.default_rng(3).standard_normal((2, S, 3, head_dim),
                                                 np.float32)
    pos = frontends.make_mrope_positions(2, S, span)
    got = rope.apply_m_rope(_t(x), _t(pos), 1e6, sections)
    want = jrope.apply_m_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_m_rope_on_text_positions_equals_rope():
    x = np.random.default_rng(4).standard_normal((2, 9, 3, 64), np.float32)
    m = rope.default_m_positions(2, 9, 5)
    assert np.array_equal(m.numpy(),
                          np.asarray(jrope.default_m_positions(2, 9, 5)))
    got = rope.apply_m_rope(_t(x), m, 1e6, (8, 12, 12))
    want = rope.apply_rope(_t(x), m[..., 0], 1e6)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def _position_cases():
    """(q_pos, k_pos) int32 vectors of length S: M-RoPE temporal streams with
    an image span, a vector with repeated and non-monotone positions, and
    query positions that leave some rows no key."""
    rng = np.random.default_rng(5)
    cases = {name: np.ascontiguousarray(
        frontends.make_mrope_positions(1, S, span)[0, :, 0])
             for name, span in SPANS.items()}
    cases["repeated-non-monotone"] = rng.integers(0, S // 2, S).astype(
        np.int32)
    out = {k: (v, v) for k, v in cases.items()}
    # queries before every key: their rows are wholly masked (causal)
    out["rows-without-keys"] = (np.arange(S, dtype=np.int32) - 8,
                                np.arange(S, dtype=np.int32))
    return out


POSITION_CASES = _position_cases()


@pytest.mark.parametrize("causal,window", [(True, None), (True, 8),
                                           (False, None), (False, 5)])
@pytest.mark.parametrize("case", list(POSITION_CASES))
def test_attention_with_positions_matches_reference(case, causal, window):
    """flash_attention_ref and ops.attention's plain path with positions
    against the reference's XLA attention (which takes positions), GQA 4
    heads over 2, f32."""
    q_pos, k_pos = POSITION_CASES[case]
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, S, 4, 64), np.float32)
    k = rng.standard_normal((2, S, 2, 64), np.float32)
    v = rng.standard_normal((2, S, 2, 64), np.float32)
    want = np.asarray(jattn.attend(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(q_pos),
                                   jnp.asarray(k_pos), causal, window))
    qp, kp = _t(q_pos), _t(k_pos)
    got = ops.attention(_t(q), _t(k), _t(v), causal=causal, window=window,
                        q_pos=qp, k_pos=kp,
                        kcfg=ops.KernelConfig(use_cuda=False))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    # the wrapper's CPU branch and the plain version itself, per head
    kr = np.repeat(k, 2, axis=2)
    vr = np.repeat(v, 2, axis=2)
    ref = flash_attention_ref(*(_t(a).transpose(1, 2) for a in (q, kr, vr)),
                              causal=causal, window=window, q_pos=qp,
                              k_pos=kp).transpose(1, 2)
    np.testing.assert_allclose(ref.numpy(), want, atol=2e-5, rtol=2e-5)
    wrapped = ops.attention(_t(q), _t(k), _t(v), causal=causal,
                            window=window, q_pos=qp, k_pos=kp)
    np.testing.assert_allclose(wrapped.numpy(), want, atol=2e-5, rtol=2e-5)


def test_explicit_arange_equals_default_positions():
    rng = np.random.default_rng(7)
    q, k, v = (_t(rng.standard_normal((1, 2, 40, 64), np.float32))
               for _ in range(3))
    ar = torch.arange(40, dtype=torch.int32)
    for causal, window in ((True, None), (True, 9), (False, None)):
        torch.testing.assert_close(
            flash_attention_ref(q, k, v, causal=causal, window=window,
                                q_pos=ar, k_pos=ar),
            flash_attention_ref(q, k, v, causal=causal, window=window),
            atol=0, rtol=0)


def test_random_params_have_reference_layout():
    cfg = get_smoke_config(ARCH)
    vals = convert.random_model_params(cfg, 0)
    ref_vals, _ = init_model(jax.random.PRNGKey(0), jsmoke(ARCH))
    assert "embed" not in vals and "head" in vals
    assert jax.tree.structure(vals) == jax.tree.structure(ref_vals)
    for a, b in zip(jax.tree.leaves(vals), jax.tree.leaves(ref_vals)):
        assert a.shape == b.shape


def _vlm_batch(cfg, seed, span, seq=S):
    embeds = _embeds(cfg, seed, seq=seq)
    pos = frontends.make_mrope_positions(B, seq, span)
    return embeds, pos


@pytest.mark.parametrize("span", [None, *SPANS.values()],
                         ids=["default-positions", *SPANS])
def test_vlm_forward_matches_reference(span):
    cfg, jcfg = get_smoke_config(ARCH), jsmoke(ARCH)
    vals = convert.random_model_params(cfg, 1)
    embeds, pos = _vlm_batch(cfg, 2, span)
    jb = {"embeds": jnp.asarray(embeds)}
    tb = {"embeds": _t(embeds)}
    if span is not None:
        jb["positions"], tb["positions"] = jnp.asarray(pos), _t(pos)
    want, _ = jforward(jcfg, jax.tree.map(jnp.asarray, vals), jb)
    got, aux = forward(cfg, convert.model_params(vals, cfg, "cpu"), tb)
    assert got.shape == (B, S, cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("span", [(8, 4, 8), (20, 5, 6)],
                         ids=["middle", "tail-after-span"])
def test_vlm_prefill_decode_match_reference(span):
    """prefill on S-4 embeddings with an image span, then 4 decode steps on
    embeddings (positions from the cache index, as the reference), logits
    and the KV cache step by step."""
    cfg, jcfg = get_smoke_config(ARCH), jsmoke(ARCH)
    vals = convert.random_model_params(cfg, 3)
    jp = jax.tree.map(jnp.asarray, vals)
    params = convert.model_params(vals, cfg, "cpu")
    embeds, pos = _vlm_batch(cfg, 4, span)
    pre = S - 4
    want, jcache = jprefill(jcfg, jp, {
        "embeds": jnp.asarray(embeds[:, :pre]),
        "positions": jnp.asarray(pos[:, :pre])}, max_len=S)
    got, cache = prefill(cfg, params, {"embeds": _t(embeds[:, :pre]),
                                       "positions": _t(pos[:, :pre])}, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    for i in range(pre, S):
        want, jcache = jdecode(jcfg, jp,
                               {"embeds": jnp.asarray(embeds[:, i:i + 1])},
                               jcache)
        got, cache = decode_step(cfg, params,
                                 {"embeds": _t(embeds[:, i:i + 1])}, cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL)
    assert cache["index"] == int(jcache["index"]) == S
    for kv in ("k", "v"):
        np.testing.assert_allclose(cache[kv].numpy(),
                                   np.asarray(jcache["kv"][kv]), atol=ATOL,
                                   rtol=RTOL)


def test_dense_batch_with_own_positions_matches_reference():
    """A dense config given its own (B, S) positions (rows offset and with
    a repeated stretch): RoPE by each row's positions, the mask by row 0's,
    as the reference."""
    cfg, jcfg = get_smoke_config("llama2-7b"), jsmoke("llama2-7b")
    vals = convert.random_model_params(cfg, 5)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, S))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    pos[:, 20:30] = 20
    pos[1] += 3
    want, _ = jforward(jcfg, jax.tree.map(jnp.asarray, vals),
                       {"tokens": jnp.asarray(toks, jnp.int32),
                        "positions": jnp.asarray(pos)})
    got, _ = forward(cfg, convert.model_params(vals, cfg, "cpu"),
                     {"tokens": _t(toks), "positions": _t(pos)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_default_positions_take_the_index_path(monkeypatch):
    """The default positions reach attention as None (K3's index path, its
    tile skipping kept); a batch's own reach it as row 0's temporal
    stream."""
    cfg = get_smoke_config(ARCH)
    params = convert.model_params(convert.random_model_params(cfg, 7), cfg,
                                  "cpu")
    seen = []
    attend = ops.attention

    def spy(*args, **kwargs):
        seen.append(kwargs.get("q_pos"))
        return attend(*args, **kwargs)

    monkeypatch.setattr(ops, "attention", spy)
    embeds, pos = _vlm_batch(cfg, 8, SPANS["middle"], seq=48)
    forward(cfg, params, {"embeds": _t(embeds)})
    assert seen == [None] * cfg.num_layers
    seen.clear()
    forward(cfg, params, {"embeds": _t(embeds), "positions": _t(pos)})
    want = blocks.mask_positions(cfg, _t(pos))
    assert len(seen) == cfg.num_layers
    assert all(p.dtype == torch.int32 and torch.equal(p, want) for p in seen)
    assert torch.equal(want, _t(pos[0, :, 0]))


def test_frontend_embeddings_shape_and_scale():
    cfg = get_smoke_config(ARCH)
    x = frontends.make_frontend_embeddings(
        torch.Generator().manual_seed(0), cfg, 3, 50)
    assert x.shape == (3, 50, cfg.d_model) and x.dtype == torch.float32
    assert 0.015 < float(x.std()) < 0.025


def _tool():
    import sys
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
    return chip_smoke, jax_vlm_audio_refs


def test_chip_smoke_vlm_ref_tokens_are_current():
    """chip_smoke.py holds the port on the card to the JAX package's greedy
    tokens on the qwen2-vl-7b smoke config (an image span, embeddings in);
    recompute them so the constant cannot go stale, and run the port's
    CPU path on the same inputs to the same tokens."""
    chip_smoke, tool = _tool()
    assert tool.vlm_tokens() == chip_smoke.VLM_REF_TOKENS
    arch, seed, batch, seq, span, new, max_len = chip_smoke.VLM_REF
    cfg = get_smoke_config(arch)
    params = convert.model_params(convert.random_model_params(cfg, seed),
                                  cfg, "cpu")
    embeds, table = (_t(a) for a in chip_smoke.frontend_ref_inputs(
        np, cfg.d_model, cfg.vocab_size, seed, batch, seq))
    pos = _t(frontends.make_mrope_positions(batch, seq, span))
    logits, cache = prefill(cfg, params, {"embeds": embeds,
                                          "positions": pos}, max_len)
    toks = [logits[:, -1].argmax(-1)]
    for _ in range(new):
        logits, cache = decode_step(cfg, params,
                                    {"embeds": table[toks[-1]][:, None]},
                                    cache)
        toks.append(logits[:, -1].argmax(-1))
    got = tuple(tuple(int(t) for t in row)
                for row in torch.stack(toks, 1).tolist())
    assert got == chip_smoke.VLM_REF_TOKENS
