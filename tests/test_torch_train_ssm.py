"""LoRA fine-tuning of the SSM and hybrid families (mamba2-370m,
zamba2-2.7b) against the JAX package on the CPU: the train and grad steps
on the smoke configs against the reference's jitted ones, K4's chunked
backward (``ref.ssd_scan_grouped_bwd_ref``, the plain version beside the
backward kernel ``csrc/ssd_scan_bwd.cu``) against autograd through the
step-by-step plain version and against ``jax.vjp`` of the reference's
``models/ssm.ssd_chunked``, and chip_smoke.py's ``[train-ssm-ref]``
constants recomputed. Inputs are numpy arrays from a seed, handed to both
packages."""
import dataclasses
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
from repro.models.ssm import ssd_chunked as jssd_chunked
from repro.train import step as jstep
from repro.utils import partition as jpartition
from repro_torch import convert
from repro_torch.configs import TrainConfig, get_smoke_config
from repro_torch.data import ShardedLMLoader
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as k4
from repro_torch.kernels.ref import (ssd_scan_grouped_bwd_ref,
                                     ssd_scan_grouped_ref)
from repro_torch.train import step
from repro_torch.utils import partition

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SSM_ARCHS = ("mamba2-370m", "zamba2-2.7b")

# The train step against the reference's (tests/test_torch_train.py's
# bounds, which these models meet with room to spare): f32 sums in another
# order; the SSD scan step by step here (the Function's CPU path) against
# XLA's 32-step chunks
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5
MOMENT_ATOL, MOMENT_RTOL = 1e-7, 1e-3
# LoRA gradients: |got - want| <= GRAD_RTOL |want| + GRAD_ATOL max|want|.
# A probe of both configs (seq 32, batch 4) measured at most 1.3e-6
# (mamba2) and 2.5e-6 (zamba2) of max|grad|, with and without
# KernelConfig(use_cuda); 1e-5 leaves four times that
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
# K4's chunked backward against autograd through the step-by-step version
# and against XLA's: f32 sums in other orders (the chunked scan
# reassociates the recurrence); chip_smoke.py's GRAD_TOL for f32. Measured
# at most 8% of it on these shapes
BWD_RTOL, BWD_ATOL = 1e-4, 1e-5


def _grads_close(got, want, rtol, atol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * np.abs(want).max())


# ---------------------------------------------------------------------------
# The train and grad steps on the smoke configs
# ---------------------------------------------------------------------------

def _setup(arch, microbatches, remat):
    cfg, jcfg = get_smoke_config(arch), jsmoke(arch)
    kw = dict(seq_len=32, global_batch=4, lr=2e-3, total_steps=20,
              warmup_steps=2, microbatches=microbatches, remat=remat)
    vals = convert.random_model_params(cfg, 3)
    return cfg, jcfg, TrainConfig(**kw), JTrainConfig(**kw), vals


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_train_step_matches_reference(arch, microbatches, remat):
    """Loss, grad norm and lr of 3 steps of ``make_train_step`` against the
    reference's jitted one on the same weights and batches; the LoRA
    leaves (Mamba2 ``in`` on wx and ``out`` on out_proj; zamba2's shared
    block's q and v too) and AdamW moments after them; the base leaves
    bit-unchanged and without ``.grad``."""
    cfg, jcfg, tcfg, jtcfg, vals = _setup(arch, microbatches, remat)
    loader = ShardedLMLoader(cfg.vocab_size, tcfg.global_batch,
                             tcfg.seq_len, seed=1)
    jp = jax.tree.map(jnp.asarray, vals)
    jo = jstep.init_opt_state(jp)
    jtrain = jax.jit(jstep.make_train_step(jcfg, jtcfg))
    params = convert.model_params(vals, cfg, "cpu")
    base0 = [x.clone() for x in partition.partition_by_path(
        params, lambda p: not partition.is_lora_path(p))[0]]
    opt = step.init_opt_state(params)
    train = step.make_train_step(cfg, tcfg)
    for i in range(3):
        batch = loader.batch_at(i)
        jp, jo, jm = jtrain(jp, jo, batch)
        params, opt, m = train(params, opt, batch)
        assert float(m.loss) == pytest.approx(float(jm.loss), rel=LOSS_RTOL)
        assert float(m.grad_norm) == pytest.approx(float(jm.grad_norm),
                                                   rel=10 * LOSS_RTOL)
        assert float(m.lr) == float(jm.lr)
    assert int(opt.step) == 3
    lora, _ = partition.partition_by_path(params, partition.is_lora_path)
    jlora, _ = jpartition.partition_by_path(jp, jpartition.is_lora_path)
    want = convert.lora_leaves(jlora, vals, cfg, "cpu")
    assert len(lora) == len(want) > 0
    for got, w in zip(lora, want):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0,
                                   atol=PARAM_ATOL)
    jopt = convert.opt_state(jo, vals, cfg, "cpu")
    for got, w in zip(opt.m + opt.v, jopt.m + jopt.v):
        np.testing.assert_allclose(got.numpy(), w.numpy(),
                                   rtol=MOMENT_RTOL, atol=MOMENT_ATOL)
    base = partition.partition_by_path(
        params, lambda p: not partition.is_lora_path(p))[0]
    for a, b in zip(base, base0):
        assert torch.equal(a, b) and a.grad is None and not a.requires_grad


@pytest.mark.parametrize("use_cuda", [True, False])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_grad_step_matches_reference(arch, use_cuda):
    """The LoRA gradients of ``make_grad_step`` against the reference's,
    through the autograd Functions (K4's backward: autograd through the
    step-by-step plain version on the CPU) and through the plain path
    (``ssd_chunked``); every leaf non-zero; remat full gives the same
    bits."""
    cfg, jcfg, tcfg, jtcfg, vals = _setup(arch, 1, "none")
    kcfg = ops.KernelConfig(use_cuda)
    batch = ShardedLMLoader(cfg.vocab_size, 4, 32, seed=2).batch_at(0)
    jloss, jgrads = jax.jit(jstep.make_grad_step(jcfg, jtcfg))(
        jax.tree.map(jnp.asarray, vals), batch)
    params = convert.model_params(vals, cfg, "cpu")
    loss, grads = step.make_grad_step(cfg, tcfg, kcfg)(params, batch)
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    want = convert.lora_leaves(jgrads, vals, cfg, "cpu")
    assert len(grads) == len(want) > 0
    for g, w in zip(grads, want):
        _grads_close(g.numpy(), w.numpy(), GRAD_RTOL, GRAD_ATOL)
        assert torch.count_nonzero(g) > 0
    remat = dataclasses.replace(tcfg, remat="full")
    loss_r, grads_r = step.make_grad_step(cfg, remat, kcfg)(params, batch)
    assert torch.equal(loss_r, loss)
    for a, b in zip(grads_r, grads):
        assert torch.equal(a, b)


def test_ssm_train_step_runs_k4_through_its_function(monkeypatch):
    """One grad step of the mamba2-370m smoke config through the Functions
    reaches K4 forward once a layer, and K4's backward (on the CPU: its
    plain route) once a layer; with remat full the forward twice."""
    cfg, _, tcfg, _, vals = _setup("mamba2-370m", 1, "none")
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = k4.ssd_scan_grouped, k4.ssd_scan_grouped_backward

    def count_fwd(*a):
        calls["fwd"] += 1
        return fwd(*a)

    def count_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(k4, "ssd_scan_grouped", count_fwd)
    monkeypatch.setattr(k4, "ssd_scan_grouped_backward", count_bwd)
    params = convert.model_params(vals, cfg, "cpu")
    batch = ShardedLMLoader(cfg.vocab_size, 2, 16, seed=2).batch_at(0)
    n = cfg.num_layers
    for remat, want in (("none", (n, n)), ("full", (2 * n, n))):
        calls.update(fwd=0, bwd=0)
        step.make_grad_step(cfg, dataclasses.replace(tcfg, remat=remat))(
            params, batch)
        assert (calls["fwd"], calls["bwd"]) == want


# ---------------------------------------------------------------------------
# K4's chunked backward, the kernel's plain version
# ---------------------------------------------------------------------------

def _views(buf, hh, p, g, n):
    """x (Bt, S, H, P), B, C (Bt, S, G, N): views of one (Bt, S, H P + 2 G
    N) buffer, as the Mamba2 layer slices its conv output."""
    bt, s, _ = buf.shape
    di = hh * p
    return (buf[..., :di].reshape(bt, s, hh, p),
            buf[..., di:di + g * n].reshape(bt, s, g, n),
            buf[..., di + g * n:].reshape(bt, s, g, n))


def _bwd_inputs(bt, s, hh, p, g, n, seed):
    rng = np.random.default_rng(seed)
    buf = rng.standard_normal((bt, s, hh * p + 2 * g * n)).astype(np.float32)
    buf[..., hh * p:] *= 0.3
    dt = (np.log1p(np.exp(rng.standard_normal((bt, s, hh)))) * 0.5
          ).astype(np.float32)
    A = (-np.exp(rng.standard_normal(hh)) * 0.5).astype(np.float32)
    dy = rng.standard_normal((bt, s, hh, p)).astype(np.float32)
    dh = rng.standard_normal((bt, hh, n, p)).astype(np.float32)
    return buf, dt, A, dy, dh


# (Bt, S, H, P, G, N): ragged S (not a multiple of the 64-step chunk), one
# and several chunks, G < H with 2 and 3 heads a group, G = H
BWD_SHAPES = [(2, 100, 4, 64, 2, 64), (2, 9, 4, 32, 2, 16),
              (1, 130, 6, 32, 3, 16), (2, 64, 2, 32, 2, 8),
              (1, 200, 4, 32, 1, 128)]


@pytest.mark.parametrize("with_dh", [True, False])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_chunked_backward_matches_autograd_through_plain(shape, with_dh):
    """``ssd_scan_grouped_bwd_ref`` against torch.autograd through the
    step-by-step ``ssd_scan_grouped_ref`` on the model's layout (x, B and
    C views of one buffer): dx, d(dt), dA, dB, dC, with and without a
    cotangent of the final state."""
    bt, s, hh, p, g, n = shape
    buf, dt, A, dy, dh = _bwd_inputs(*shape, seed=s * n + hh)
    leaves = [torch.from_numpy(z).requires_grad_(True) for z in (buf, dt, A)]
    x, B, C = _views(leaves[0], hh, p, g, n)
    y, h = ssd_scan_grouped_ref(x, leaves[1], leaves[2], B, C)
    dh_t = torch.from_numpy(dh) if with_dh else torch.zeros_like(h)
    want = torch.autograd.grad((y, h), (x, leaves[1], leaves[2], B, C),
                               (torch.from_numpy(dy), dh_t))
    x, B, C = _views(torch.from_numpy(buf), hh, p, g, n)
    got = ssd_scan_grouped_bwd_ref(x, torch.from_numpy(dt),
                                   torch.from_numpy(A), B, C,
                                   torch.from_numpy(dy),
                                   torch.from_numpy(dh) if with_dh else None)
    for gr, w in zip(got, want):
        assert gr.shape == w.shape and gr.dtype == w.dtype
        _grads_close(gr.numpy(), w.numpy(), BWD_RTOL, BWD_ATOL)



def test_chunked_backward_where_an_exponent_rounds_to_zero():
    """A step whose dt is so small that cum_i - cum_j rounds to 0 in f32 off
    the diagonal: the clip is not what holds there, and the gradient
    passes, as torch.clamp's backward passes it on the clip's edges (a
    strict inside test once put d(dt) of that step 2.5% of max|d(dt)|
    off)."""
    bt, s, hh, p, g, n = 1, 100, 2, 32, 1, 16
    buf, dt, A, dy, dh = _bwd_inputs(bt, s, hh, p, g, n, seed=3)
    dt[0, 4, :] = 1e-9
    A[:] = (-0.07, -0.9)
    leaves = [torch.from_numpy(z).requires_grad_(True) for z in (buf, dt, A)]
    x, B, C = _views(leaves[0], hh, p, g, n)
    y, h = ssd_scan_grouped_ref(x, leaves[1], leaves[2], B, C)
    want = torch.autograd.grad((y, h), (x, leaves[1], leaves[2], B, C),
                               (torch.from_numpy(dy), torch.from_numpy(dh)))
    cum = torch.cumsum(torch.from_numpy(dt[0, :64]) * torch.from_numpy(A), 0)
    assert bool((cum[4] == cum[3]).any())    # the tie this test is about
    x, B, C = _views(torch.from_numpy(buf), hh, p, g, n)
    got = ssd_scan_grouped_bwd_ref(x, torch.from_numpy(dt),
                                   torch.from_numpy(A), B, C,
                                   torch.from_numpy(dy), torch.from_numpy(dh))
    for gr, w in zip(got, want):
        _grads_close(gr.numpy(), w.numpy(), BWD_RTOL, BWD_ATOL)

@pytest.mark.parametrize("chunk", [32, 256])
@pytest.mark.parametrize("shape", BWD_SHAPES[:3])
def test_chunked_backward_matches_jax_vjp(shape, chunk):
    """``ssd_scan_grouped_bwd_ref`` (64-step chunks) against ``jax.vjp`` of
    the reference's ``ssd_chunked`` (its state (Bt, H, P, N), at the
    reference model's chunk and at the smoke configs'): the same function
    where no exponent is clipped."""
    bt, s, hh, p, g, n = shape
    buf, dt, A, dy, dh = _bwd_inputs(*shape, seed=7 * s + n)

    def f(x, dt, A, B, C):
        return jssd_chunked(x, dt, A, B, C, chunk)

    jx, jB, jC = _views(buf, hh, p, g, n)
    _, vjp = jax.vjp(f, *(jnp.asarray(np.ascontiguousarray(z))
                          for z in (jx, dt, A, jB, jC)))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh.transpose(0, 1, 3, 2))))
    x, B, C = _views(torch.from_numpy(buf), hh, p, g, n)
    got = ssd_scan_grouped_bwd_ref(x, torch.from_numpy(dt),
                                   torch.from_numpy(A), B, C,
                                   torch.from_numpy(dy), torch.from_numpy(dh))
    for gr, w in zip(got, want):
        _grads_close(gr.numpy(), np.asarray(w), BWD_RTOL, BWD_ATOL)


def test_chunked_backward_rounds_each_gradient_once():
    """bf16 x, B, C and dy: every sum in f32, each gradient rounded once
    to its input's dtype (the f32 run on the same values, rounded), dt's
    and A's in f32."""
    bt, s, hh, p, g, n = 2, 150, 4, 32, 2, 16
    buf, dt, A, dy, dh = _bwd_inputs(bt, s, hh, p, g, n, seed=11)
    bf = torch.from_numpy(buf).bfloat16()
    dyb = torch.from_numpy(dy).bfloat16()
    args = (torch.from_numpy(dt), torch.from_numpy(A))
    xb, Bb, Cb = _views(bf, hh, p, g, n)
    got = ssd_scan_grouped_bwd_ref(xb, *args, Bb, Cb, dyb,
                                   torch.from_numpy(dh))
    x32, B32, C32 = _views(bf.float(), hh, p, g, n)
    want = ssd_scan_grouped_bwd_ref(x32, *args, B32, C32, dyb.float(),
                                    torch.from_numpy(dh))
    for gr, w, dtype in zip(got, want, (torch.bfloat16, torch.float32,
                                        torch.float32, torch.bfloat16,
                                        torch.bfloat16)):
        assert gr.dtype == dtype
        assert torch.equal(gr, w.to(dtype))


def test_backward_entry_on_cpu_is_autograd_through_plain():
    """``ssd_scan_grouped_backward`` on CPU tensors: autograd through the
    step-by-step plain version, bit for bit; None where an input needs no
    gradient; no cotangent of the state is a zero one."""
    bt, s, hh, p, g, n = 2, 40, 4, 32, 2, 16
    buf, dt, A, dy, dh = _bwd_inputs(bt, s, hh, p, g, n, seed=5)
    x, B, C = _views(torch.from_numpy(buf), hh, p, g, n)
    ins = (x, torch.from_numpy(dt), torch.from_numpy(A), B, C)
    dy_t = torch.from_numpy(dy)
    leaves = [t.clone().requires_grad_(True) for t in ins]
    y, h = ssd_scan_grouped_ref(*leaves)
    want = torch.autograd.grad((y, h), leaves, (dy_t, torch.zeros_like(h)))
    got = k4.ssd_scan_grouped_backward(*ins, dy_t, None)
    for gr, w in zip(got, want):
        assert torch.equal(gr, w)
    part = k4.ssd_scan_grouped_backward(*ins, dy_t, torch.from_numpy(dh),
                                        needs=(True, False, False, True,
                                               False))
    assert part[1] is None and part[2] is None and part[4] is None
    assert part[0].shape == x.shape and part[3].shape == B.shape


# ---------------------------------------------------------------------------
# chip_smoke.py's [train-ssm-ref] constants
# ---------------------------------------------------------------------------

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


def test_chip_smoke_train_ssm_refs_are_current():
    """chip_smoke.py's [train-ssm-ref] holds the card to TRAIN_SSM_REF,
    recorded from the JAX package's jitted train step on the two smoke
    configs: recompute it, and hold the port's run of the same phase on
    the CPU to it within TRAIN_REF_RTOL."""
    chip_smoke, tool = _chip_smoke_and_tool()
    assert tuple(chip_smoke.TRAIN_SSM_REF) == chip_smoke.TRAIN_SSM_ARCHS
    assert tool.train_ssm_ref() == chip_smoke.TRAIN_SSM_REF
    for arch, runs in chip_smoke.TRAIN_SSM_REF.items():
        for mb, want in runs.items():
            got = chip_smoke.train_ref_run(torch, torch.device("cpu"), mb,
                                           arch)
            assert got["base_unchanged"]
            for key, rtol in chip_smoke.TRAIN_REF_RTOL.items():
                np.testing.assert_allclose(got[key], want[key], rtol=rtol)
