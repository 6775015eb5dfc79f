"""LoRA fine-tuning of the last five architectures against the JAX package
on the CPU: olmo-1b (LayerNorm without parameters, a tied head),
granite-20b (one KV head for every query head), qwen1.5-110b (q / k / v
biases after the adapted projections), command-r-plus-104b (LayerNorm with
parameters, a tied head, rope theta 7.5e7) and mixtral-8x22b (the MoE
layer, a sliding window). The grad and train steps on their smoke configs
against the reference's jitted ones, and chip_smoke.py's
``[train-dense-ref]`` constants recomputed. Weights come from
``convert.random_model_params`` (numpy seed; LoRA B, biases and norm
parameters non-zero) and reach both packages as the same numpy arrays."""
import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_smoke_config as jsmoke
from repro.data import ShardedLMLoader as JLoader
from repro.train import step as jstep
from repro.utils import partition as jpartition
from repro_torch import convert
from repro_torch.configs import TrainConfig, get_smoke_config
from repro_torch.data import ShardedLMLoader
from repro_torch.kernels import ops
from repro_torch.train import step
from repro_torch.utils import partition

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

# tests/test_torch_train.py's bounds: f32 products summed in another order
# than XLA's (losses and gradients); 1% of an lr-2e-3 AdamW step for the
# leaves after 3 steps; Adam's moments through those gradients
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
PARAM_ATOL = 2e-5
MOMENT_ATOL, MOMENT_RTOL = 1e-7, 1e-3

ARCHS = ("olmo-1b", "granite-20b", "qwen1.5-110b", "command-r-plus-104b",
         "mixtral-8x22b")


def _setup(arch, microbatches, remat):
    cfg, jcfg = get_smoke_config(arch), jsmoke(arch)
    kw = dict(seq_len=32, global_batch=4, lr=2e-3, total_steps=20,
              warmup_steps=2, microbatches=microbatches, remat=remat)
    vals = convert.random_model_params(cfg, 3)
    return cfg, jcfg, TrainConfig(**kw), JTrainConfig(**kw), vals


def _adam_directions(state, t, tcfg):
    """AdamW's step direction m_hat / (sqrt(v_hat) + eps) of each LoRA leaf
    after step ``t`` (1-based) from the optimizer's moments, in f64."""
    bc1, bc2 = 1 - tcfg.b1 ** t, 1 - tcfg.b2 ** t
    return [np.float64(m.numpy()) / bc1
            / (np.sqrt(np.float64(v.numpy()) / bc2) + tcfg.eps)
            for m, v in zip(state.m, state.v)]


def _base(params):
    return partition.partition_by_path(
        params, lambda p: not partition.is_lora_path(p))[0]


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, microbatches, remat):
    """Loss, grad norm and lr of 3 steps of ``make_train_step`` against the
    reference's jitted one on the same weights and batches (MoE: its aux
    loss included); the LoRA leaves and AdamW moments after them, mapped
    per layer, the leaves as tests/test_torch_train_families.py holds them;
    the base leaves bit-unchanged and without ``.grad``."""
    cfg, jcfg, tcfg, jtcfg, vals = _setup(arch, microbatches, remat)
    loader = ShardedLMLoader(cfg.vocab_size, tcfg.global_batch,
                             tcfg.seq_len, seed=1)
    jp = jax.tree.map(jnp.asarray, vals)
    jo = jstep.init_opt_state(jp)
    jtrain = jax.jit(jstep.make_train_step(jcfg, jtcfg))
    params = convert.model_params(vals, cfg, "cpu")
    base0 = [x.clone() for x in _base(params)]
    opt = step.init_opt_state(params)
    train = step.make_train_step(cfg, tcfg)
    # where sqrt(v_hat) is near Adam's eps, a step's length turns on a
    # gradient's last bits, well inside GRAD_ATOL: so a leaf may differ by
    # what the two sides' moments account for, each step's lr times the
    # difference of their step directions, on top of PARAM_ATOL
    slack = None
    for i in range(3):
        batch = loader.batch_at(i)
        jp, jo, jm = jtrain(jp, jo, batch)
        params, opt, m = train(params, opt, batch)
        assert float(m.loss) == pytest.approx(float(jm.loss), rel=LOSS_RTOL)
        assert float(m.grad_norm) == pytest.approx(float(jm.grad_norm),
                                                   rel=10 * LOSS_RTOL)
        assert float(m.lr) == float(jm.lr)
        moved = [float(m.lr) * np.abs(a - b) for a, b in zip(
            _adam_directions(opt, i + 1, tcfg), _adam_directions(
                convert.opt_state(jo, vals, cfg, "cpu"), i + 1, tcfg))]
        slack = moved if slack is None else [
            a + b for a, b in zip(slack, moved)]
    assert int(opt.step) == 3
    lora, _ = partition.partition_by_path(params, partition.is_lora_path)
    jlora, _ = jpartition.partition_by_path(jp, jpartition.is_lora_path)
    want = convert.lora_leaves(jlora, vals, cfg, "cpu")
    assert len(lora) == len(want) == 2 * 2 * cfg.num_layers
    jopt = convert.opt_state(jo, vals, cfg, "cpu")
    for got, w in zip(opt.m + opt.v, jopt.m + jopt.v):
        np.testing.assert_allclose(got.numpy(), w.numpy(),
                                   rtol=MOMENT_RTOL, atol=MOMENT_ATOL)
    for got, w, extra in zip(lora, want, slack):
        assert np.all(np.abs(got.numpy() - w.numpy()) <= PARAM_ATOL + extra)
    # the slack exceeds PARAM_ATOL at a few elements, not whole leaves
    assert sum(int((x > PARAM_ATOL).sum()) for x in slack) <= sum(
        x.numel() for x in lora) // 100
    for a, b in zip(_base(params), base0):
        assert torch.equal(a, b) and a.grad is None and not a.requires_grad


@pytest.mark.parametrize("arch", ARCHS)
def test_grad_step_matches_reference(arch):
    """The LoRA gradients of ``make_grad_step``, mapped per layer, against
    the reference's, every leaf non-zero (the tied heads' gradient reaches
    every layer through the frozen table); remat full and the plain path
    give the port the same bits."""
    cfg, jcfg, tcfg, jtcfg, vals = _setup(arch, 1, "none")
    batch = JLoader(cfg.vocab_size, 4, 32, seed=2).batch_at(0)
    jloss, jgrads = jax.jit(jstep.make_grad_step(jcfg, jtcfg))(
        jax.tree.map(jnp.asarray, vals), batch)
    params = convert.model_params(vals, cfg, "cpu")
    loss, grads = step.make_grad_step(cfg, tcfg)(params, batch)
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    want = convert.lora_leaves(jgrads, vals, cfg, "cpu")
    assert len(grads) == len(want) == 2 * 2 * cfg.num_layers
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
        assert torch.count_nonzero(g) > 0
    remat = step.make_grad_step(
        cfg, TrainConfig(**{**tcfg.__dict__, "remat": "full"}))
    loss_r, grads_r = remat(params, batch)
    assert torch.equal(loss_r, loss)
    for a, b in zip(grads_r, grads):
        assert torch.equal(a, b)
    _, grads_p = step.make_grad_step(cfg, tcfg, ops.KernelConfig(False))(
        params, batch)
    for a, b in zip(grads_p, grads):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# chip_smoke.py's [train-dense-ref] constants
# ---------------------------------------------------------------------------

@functools.cache
def _chip_smoke_and_tool():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
        spec = importlib.util.spec_from_file_location(
            "jax_train_refs", ROOT / "tools" / "jax_train_refs.py")
        tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tool)
    finally:
        while str(ROOT) in sys.path:
            sys.path.remove(str(ROOT))
    return chip_smoke, tool


@pytest.mark.parametrize("arch", ARCHS)
def test_chip_smoke_train_dense_ref_is_current(arch):
    """chip_smoke.py's [train-dense-ref] holds the card to TRAIN_DENSE_REF,
    recorded from the JAX package's jitted train step on the smoke config
    (tools/jax_train_refs.py): recompute it, and hold the port's run of the
    same phase on the CPU to it within TRAIN_REF_RTOL."""
    chip_smoke, tool = _chip_smoke_and_tool()
    assert tuple(chip_smoke.TRAIN_DENSE_REF) == tuple(chip_smoke.DENSE_REFS)
    want = chip_smoke.TRAIN_DENSE_REF[arch]
    assert tool.train_ref(arch) == want
    for mb, row in want.items():
        got = chip_smoke.train_ref_run(torch, torch.device("cpu"), mb, arch)
        assert got["base_unchanged"]
        for key, rtol in chip_smoke.TRAIN_REF_RTOL.items():
            np.testing.assert_allclose(got[key], row[key], rtol=rtol)
