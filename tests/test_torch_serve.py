"""The port's ServingEngine against the JAX package's on the CPU: greedy
tokens equal exactly on the dense, SSM and hybrid smoke configs,
temperature sampling is reproducible from its seed, and chip_smoke.py's
recorded [serve-ref], [serve-ssm-ref], [serve-hybrid-ref] and
[serve-dense-ref] tokens are what the JAX engine gives today."""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JServingEngine
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.lora_matmul import lora_matmul
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.serve import Request, ServingEngine

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _prompts(vocab, n=3, s=12, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (n, s)).astype(
        np.int32)


@pytest.mark.parametrize("arch,over", [("llama2-7b", {}), ("olmo-1b", {}),
                                       ("granite-20b", {}),
                                       ("qwen1.5-110b", {}),
                                       ("tiny-100m", {"sliding_window": 8}),
                                       ("mamba2-370m", {}),
                                       ("zamba2-2.7b", {}),
                                       ("command-r-plus-104b", {})])
def test_greedy_tokens_equal_reference(arch, over):
    cfg, jcfg = get_smoke_config(arch), jsmoke(arch)
    if over:
        cfg, jcfg = cfg.reduced(**over), jcfg.reduced(**over)
    vals = convert.random_model_params(cfg, 5)
    prompts = _prompts(cfg.vocab_size)
    new = (6, 3, 6)
    want = JServingEngine(jcfg, jax.tree.map(jnp.asarray, vals),
                          max_len=32).generate_batch(
        [JRequest(p, n) for p, n in zip(prompts, new)])
    eng = ServingEngine(cfg, convert.model_params(vals, cfg, "cpu"),
                        max_len=32, device="cpu")
    got = eng.generate_batch([Request(p, n) for p, n in zip(prompts, new)])
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert lora_matmul.launches == 0 and flash_attention.launches == 0
    assert ssd_scan.launches == 0


def test_temperature_sampling_is_seeded():
    cfg = get_smoke_config("llama2-7b")
    params = convert.model_params(convert.random_model_params(cfg, 6), cfg,
                                  "cpu")
    reqs = [Request(p, 5, t) for p, t in
            zip(_prompts(cfg.vocab_size, seed=1), (1.0, 0.0, 0.7))]
    runs = [ServingEngine(cfg, params, max_len=32, seed=s,
                          device="cpu").generate_batch(reqs)
            for s in (3, 3)]
    assert [r.tolist() for r in runs[0]] == [r.tolist() for r in runs[1]]
    greedy = ServingEngine(cfg, params, max_len=32, device="cpu"
                           ).generate_batch([Request(r.prompt, 5)
                                             for r in reqs])
    assert runs[0][1].tolist() == greedy[1].tolist()   # temperature 0 row
    assert all(len(r) == 5 and ((r >= 0) & (r < cfg.vocab_size)).all()
               for r in runs[0])


def test_engine_refuses_unbucketed_batches_and_missing_card(monkeypatch):
    cfg = get_smoke_config("llama2-7b")
    params = convert.model_params(convert.random_model_params(cfg, 0), cfg,
                                  "cpu")
    eng = ServingEngine(cfg, params, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="length-bucketed"):
        eng.generate_batch([Request(np.zeros(4, np.int32)),
                            Request(np.zeros(5, np.int32))])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, params)


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_chip_smoke_serve_ref_tokens_are_current():
    """chip_smoke.py holds the port on the card to tokens recorded from the
    JAX ServingEngine; recompute them so the constant cannot go stale."""
    chip_smoke = _chip_smoke()
    cfg = jsmoke(chip_smoke.SERVE_REF_ARCH)
    vals = convert.random_model_params(
        get_smoke_config(chip_smoke.SERVE_REF_ARCH), chip_smoke.SERVE_REF_SEED)
    prompts = chip_smoke.serve_ref_prompts(np, cfg.vocab_size)
    out = JServingEngine(cfg, jax.tree.map(jnp.asarray, vals),
                         max_len=chip_smoke.SERVE_REF_MAX_LEN).generate_batch(
        [JRequest(p, chip_smoke.SERVE_REF_NEW) for p in prompts])
    got = tuple(tuple(int(t) for t in o) for o in out)
    assert got == chip_smoke.SERVE_REF_TOKENS


@pytest.mark.parametrize("phase", ["serve-ssm-ref", "serve-hybrid-ref"])
def test_chip_smoke_ssm_hybrid_ref_tokens_are_current(phase):
    """The same for the mamba2-370m and zamba2-2.7b smoke configs."""
    chip_smoke = _chip_smoke()
    arch, seed, tokens = chip_smoke.FAMILY_REFS[phase]
    vals = convert.random_model_params(get_smoke_config(arch), seed)
    prompts = chip_smoke.serve_ref_prompts(np, jsmoke(arch).vocab_size, seed)
    out = JServingEngine(jsmoke(arch), jax.tree.map(jnp.asarray, vals),
                         max_len=chip_smoke.SERVE_REF_MAX_LEN).generate_batch(
        [JRequest(p, chip_smoke.SERVE_REF_NEW) for p in prompts])
    assert tuple(tuple(int(t) for t in o) for o in out) == tokens


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-20b", "qwen1.5-110b",
                                  "command-r-plus-104b", "mixtral-8x22b"])
def test_chip_smoke_dense_ref_tokens_are_current(arch):
    """The same for [serve-dense-ref]'s five smoke configs (DENSE_REFS:
    each its seed, prompt length and max_len; Mixtral-8x22B's prompts past
    its window), and the port's engine on the CPU gives them too."""
    chip_smoke = _chip_smoke()
    seed, length, max_len, tokens = chip_smoke.DENSE_REFS[arch]
    cfg = get_smoke_config(arch)
    vals = convert.random_model_params(cfg, seed)
    prompts = chip_smoke.serve_ref_prompts(np, cfg.vocab_size, seed, length)
    reqs = [JRequest(p, chip_smoke.SERVE_REF_NEW) for p in prompts]
    out = JServingEngine(jsmoke(arch), jax.tree.map(jnp.asarray, vals),
                         max_len=max_len).generate_batch(reqs)
    assert tuple(tuple(int(t) for t in o) for o in out) == tokens
    eng = ServingEngine(cfg, convert.model_params(vals, cfg, "cpu"),
                        max_len=max_len, device="cpu")
    got = eng.generate_batch([Request(p, chip_smoke.SERVE_REF_NEW)
                              for p in prompts])
    assert tuple(tuple(int(t) for t in o) for o in got) == tokens
