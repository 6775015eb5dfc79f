"""LoRA fine-tuning of the VLM and audio families (qwen2-vl-7b, hubert-xlarge)
against the JAX package on the CPU: the grad and train steps on the smoke
configs against the reference's jitted ones, on embedding batches (the
frontends are stubs in both packages): Qwen2-VL's with and without an
image span in its M-RoPE positions (attention masked by the positions:
K3's position path and its backward), HuBERT's with a loss mask
(masked prediction; attention non-causal). And chip_smoke.py's
``[train-fam-ref]`` constants recomputed (Mixtral's smoke config too; its
train step is held by tests/test_torch_train.py), and the MoE routing
that ``[train-moe]``'s gate replays held to ``moe.route``. Inputs are
numpy arrays from a seed (``chip_smoke.train_ref_batch``), handed to both
packages."""
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
from repro.train import step as jstep
from repro.utils import partition as jpartition
from repro_torch import convert
from repro_torch.configs import TrainConfig, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import moe
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

B, S = 4, 32
# an image span of 4 x 3 patches from position 4 (its patches share one
# temporal position, so they see each other), or none (text positions)
SPAN = (4, 3, 4)
CASES = {"qwen2-vl-span": ("qwen2-vl-7b", SPAN),
         "qwen2-vl-text": ("qwen2-vl-7b", None),
         "hubert-mask": ("hubert-xlarge", None)}


@functools.cache
def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        while str(ROOT) in sys.path:
            sys.path.remove(str(ROOT))
    return chip_smoke


def _batch(cfg, span, seed, step=0):
    """``chip_smoke.train_ref_batch``'s B x S batch: embeddings and targets;
    M-RoPE positions of ``span`` under M-RoPE; a loss mask for an
    encoder."""
    return _chip_smoke().train_ref_batch(np, cfg, B, S, step, seed, span)


def _adam_directions(state, t, tcfg):
    """AdamW's step direction m_hat / (sqrt(v_hat) + eps) of each LoRA leaf
    after step ``t`` (1-based) from the optimizer's moments, in f64."""
    bc1, bc2 = 1 - tcfg.b1 ** t, 1 - tcfg.b2 ** t
    return [np.float64(m.numpy()) / bc1
            / (np.sqrt(np.float64(v.numpy()) / bc2) + tcfg.eps)
            for m, v in zip(state.m, state.v)]


def _setup(arch, microbatches, remat):
    cfg, jcfg = get_smoke_config(arch), jsmoke(arch)
    kw = dict(seq_len=S, global_batch=B, lr=2e-3, total_steps=20,
              warmup_steps=2, microbatches=microbatches, remat=remat)
    vals = convert.random_model_params(cfg, 3)
    return cfg, jcfg, TrainConfig(**kw), JTrainConfig(**kw), vals


def _n_leaves(cfg):
    """A and B of each adapted projection of each layer."""
    return 2 * len(cfg.lora.targets) * cfg.num_layers


def _base(params):
    return partition.partition_by_path(
        params, lambda p: not partition.is_lora_path(p))[0]


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_reference(case, microbatches, remat):
    """Loss, grad norm and lr of 3 steps of ``make_train_step`` against the
    reference's jitted one on the same weights and batches; the LoRA
    leaves and AdamW moments after them; the base leaves bit-unchanged and
    without ``.grad``."""
    arch, span = CASES[case]
    cfg, jcfg, tcfg, jtcfg, vals = _setup(arch, microbatches, remat)
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
        batch = _batch(cfg, span, 10, i)
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
    assert len(lora) == len(want) == _n_leaves(cfg)
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


@pytest.mark.parametrize("use_cuda", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_grad_step_matches_reference(case, use_cuda):
    """The LoRA gradients of ``make_grad_step`` against the reference's,
    through the autograd Functions (K3's backward on the CPU: autograd
    through the plain version, with the batch's positions) and through
    the plain path; every leaf non-zero; remat full gives the same bits;
    the base leaves unchanged."""
    arch, span = CASES[case]
    cfg, jcfg, tcfg, jtcfg, vals = _setup(arch, 1, "none")
    kcfg = ops.KernelConfig(use_cuda)
    batch = _batch(cfg, span, 2)
    jloss, jgrads = jax.jit(jstep.make_grad_step(jcfg, jtcfg))(
        jax.tree.map(jnp.asarray, vals), batch)
    params = convert.model_params(vals, cfg, "cpu")
    base0 = [x.clone() for x in _base(params)]
    loss, grads = step.make_grad_step(cfg, tcfg, kcfg)(params, batch)
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    want = convert.lora_leaves(jgrads, vals, cfg, "cpu")
    assert len(grads) == len(want) == _n_leaves(cfg)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
        assert torch.count_nonzero(g) > 0
    remat = step.make_grad_step(
        cfg, TrainConfig(**{**tcfg.__dict__, "remat": "full"}), kcfg)
    loss_r, grads_r = remat(params, batch)
    assert torch.equal(loss_r, loss)
    for a, b in zip(grads_r, grads):
        assert torch.equal(a, b)
    for a, b in zip(_base(params), base0):
        assert torch.equal(a, b) and a.grad is None and not a.requires_grad


def test_image_span_changes_the_gradients():
    """The span's positions reach the mask: with the span, its patches see
    each other, so the gradients differ from the text positions'."""
    cfg, _, tcfg, _, vals = _setup("qwen2-vl-7b", 1, "none")
    params = convert.model_params(vals, cfg, "cpu")
    grad = step.make_grad_step(cfg, tcfg)
    span, text = _batch(cfg, SPAN, 5), _batch(cfg, None, 5)
    np.testing.assert_array_equal(span["embeds"], text["embeds"])
    _, g_span = grad(params, span)
    _, g_text = grad(params, text)
    assert any(not torch.equal(a, b) for a, b in zip(g_span, g_text))


# ---------------------------------------------------------------------------
# chip_smoke.py's [train-fam-ref] constants
# ---------------------------------------------------------------------------

def _chip_smoke_and_tool():
    chip_smoke = _chip_smoke()
    spec = importlib.util.spec_from_file_location(
        "jax_train_refs", ROOT / "tools" / "jax_train_refs.py")
    tool = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(tool)
    finally:
        while str(ROOT) in sys.path:
            sys.path.remove(str(ROOT))
    return chip_smoke, tool


def test_chip_smoke_train_fam_refs_are_current():
    """chip_smoke.py's [train-fam-ref] holds the card to TRAIN_FAM_REF,
    recorded from the JAX package's jitted train step on the mixtral-8x7b,
    qwen2-vl-7b and hubert-xlarge smoke configs: recompute it, and hold
    the port's run of the same phase on the CPU to it within
    TRAIN_REF_RTOL."""
    chip_smoke, tool = _chip_smoke_and_tool()
    assert tuple(chip_smoke.TRAIN_FAM_REF) == chip_smoke.TRAIN_FAM_ARCHS
    assert tool.train_fam_ref() == chip_smoke.TRAIN_FAM_REF
    for arch, runs in chip_smoke.TRAIN_FAM_REF.items():
        for mb, want in runs.items():
            got = chip_smoke.train_ref_run(torch, torch.device("cpu"), mb,
                                           arch)
            assert got["base_unchanged"]
            for key, rtol in chip_smoke.TRAIN_REF_RTOL.items():
                np.testing.assert_allclose(got[key], want[key], rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_replayed_routing_is_moe_route(dtype):
    """``[train-moe]``'s gate replays one run's experts into the others
    (``chip_smoke._replayed``: router weights and aux loss from the run's
    own gates). Given the experts ``moe.route`` picks, it must return
    ``moe.route``'s result bit for bit, so that a change to the routing
    function shows here and not as a silent drift of the gate."""
    cfg = get_smoke_config("mixtral-8x7b")
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((3, 64, cfg.d_model),
                                             np.float32)).to(dtype)
    router_w = torch.from_numpy(rng.standard_normal(
        (cfg.d_model, cfg.moe.num_experts), np.float32) * 0.1).to(dtype)
    want = moe.route(cfg, router_w, x)
    got = _chip_smoke()._replayed(torch, cfg, router_w, x, want[0])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
