"""The port's training path against the JAX package on the CPU: the grad
guard of the raw kernel launchers, the kernels' autograd Functions (K2's
hand-derived backward, K3's and K4's backward through their plain
versions), AdamW, the schedule, the losses, the tree utilities, the
loader and token streams, remat, the train / grad / eval steps and
``calibrate`` / ``tokens_per_slot``. Weights come from
``convert.random_model_params`` (numpy seed, LoRA B non-zero) and reach
both packages as the same numpy arrays."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jsmoke
from repro.data import ShardedLMLoader as JLoader
from repro.data import synthetic as jsynthetic
from repro.kernels import ref as jref
from repro.optim import adamw as jadamw
from repro.optim import warmup_cosine as jwarmup_cosine
from repro.train import losses as jlosses
from repro.train import step as jstep
from repro.utils import partition as jpartition
from repro.utils import tree as jtree
from repro_torch import convert
from repro_torch.configs import TrainConfig, get_config, get_smoke_config
from repro_torch.configs import list_archs
from repro_torch.core import throughput
from repro_torch.data import MarkovLM, ShardedLMLoader, lm_batches
from repro_torch.data import token_stream
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import FlashAttention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.lora_matmul import LoRAMatmul, lora_matmul
from repro_torch.kernels.ref import (flash_attention_ref, lora_matmul_ref,
                                     ssd_scan_grouped_ref)
from repro_torch.kernels.ssd_scan import SSDScan, ssd_scan, ssd_scan_grouped
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.train import losses, step
from repro_torch.utils import partition, tree

torch.set_num_threads(1)

# repro.core re-exports a function under the module's name
jthroughput = importlib.import_module("repro.core.throughput")

# f32 products summed in another order than XLA's: losses and gradients
# (tests/test_models.py's forward tolerance, and the gradients' own scale)
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
# after 3 AdamW steps at lr 2e-3: each step moves a leaf by about lr, and
# Adam's m / sqrt(v) passes the gradients' reassociation on; 1% of a step
PARAM_ATOL = 2e-5
# Adam's moments through 3 steps of those gradients
MOMENT_ATOL, MOMENT_RTOL = 1e-7, 1e-3


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# The guard of the raw launchers, and the autograd Functions
# ---------------------------------------------------------------------------

def _guard_calls():
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(6, 8, generator=g), torch.randn(8, 4, generator=g)
    a, b = torch.randn(8, 2, generator=g), torch.randn(2, 4, generator=g)
    q = torch.randn(2, 5, 64, generator=g)
    sx, sdt = torch.randn(2, 5, 32, generator=g), torch.rand(2, 5, generator=g)
    sA, sB = -torch.rand(2, generator=g), torch.randn(2, 5, 16, generator=g)
    return {
        "lora_matmul": ((x, w, a, b), lambda x, w, a, b: lora_matmul(
            x, w, a, b, 2.0)),
        "flash_attention": ((q, q.clone(), q.clone()), flash_attention),
        "ssd_scan": ((sx, sdt, sA, sB, sB.clone()), ssd_scan),
        "ssd_scan_grouped": ((sx[:, :, None], sdt[:, :, None], sA[:1],
                              sB[:, :, None], sB[:, :, None].clone()),
                             ssd_scan_grouped),
    }


@pytest.mark.parametrize("name", ["lora_matmul", "flash_attention",
                                  "ssd_scan", "ssd_scan_grouped"])
def test_raw_launcher_refuses_grad(name):
    """A raw launcher fills its output through ctypes on the card, so under
    grad mode an input that requires grad would silently get no gradient:
    it raises, naming the kernel, on the CPU path as on the card. Under
    no_grad, or with no input requiring grad, it runs."""
    args, call = _guard_calls()[name]
    call(*args)
    grad_args = [t.clone().requires_grad_(True) if i == 0 else t
                 for i, t in enumerate(args)]
    with pytest.raises(RuntimeError, match=name):
        call(*grad_args)
    with torch.no_grad():
        call(*grad_args)


def _lora_inputs(m, k, n, r, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k), np.float32)
    w, a, b = (rng.standard_normal(s, np.float32) * 0.05
               for s in ((k, n), (k, r), (r, n)))
    dy = rng.standard_normal((m, n), np.float32)
    return x, w, a, b, dy


@pytest.mark.parametrize("m,k,n,r", [(64, 96, 80, 16), (37, 128, 48, 8),
                                     (5, 64, 200, 64)])
def test_k2_backward_matches_autograd_and_jax(m, k, n, r):
    """K2's hand-derived backward (dx by K2 on W^T, B^T, A^T; dA, dB rank-r
    f32 products) against autograd through the plain version, and against
    jax.vjp of the reference's plain version, in f32 (1e-5: sums in
    another order)."""
    x, w, a, b, dy = _lora_inputs(m, k, n, r, m + k + r)
    s = 1.7
    xs, as_, bs = (_t(v).requires_grad_(True) for v in (x, a, b))
    y = LoRAMatmul.apply(xs, _t(w), as_, bs, s)
    dx, da, db = torch.autograd.grad(y, (xs, as_, bs), _t(dy))
    xr, ar, br = (_t(v).requires_grad_(True) for v in (x, a, b))
    yr = lora_matmul_ref(xr, _t(w), ar, br, s)
    want = torch.autograd.grad(yr, (xr, ar, br), _t(dy))
    np.testing.assert_array_equal(y.detach().numpy(), yr.detach().numpy())
    for got, exp in zip((dx, da, db), want):
        np.testing.assert_allclose(got.numpy(), exp.numpy(), rtol=1e-5,
                                   atol=1e-5)
    _, vjp = jax.vjp(lambda x_, a_, b_: jref.lora_matmul_ref(x_, w, a_, b_, s),
                     x, a, b)
    for got, exp in zip((dx, da, db), vjp(jnp.asarray(dy))):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-5,
                                   atol=1e-5)


def test_k2_function_refuses_trainable_base_and_counts_apart():
    x, w, a, b, dy = _lora_inputs(16, 32, 24, 4, 0)
    with pytest.raises(RuntimeError, match="frozen base weight"):
        LoRAMatmul.apply(_t(x), _t(w).requires_grad_(True),
                         _t(a).requires_grad_(True), _t(b), 1.0)
    fwd, bwd = lora_matmul.launches, lora_matmul.backward_launches
    xs = _t(x).requires_grad_(True)
    y = LoRAMatmul.apply(xs, _t(w), _t(a).requires_grad_(True), _t(b), 1.0)
    y.backward(_t(dy))
    # the CPU runs the plain versions: no kernel launch is counted
    assert (lora_matmul.launches, lora_matmul.backward_launches) == (fwd,
                                                                     bwd)
    assert xs.grad is not None


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, None)])
def test_k3_function_gradients_equal_plain_autograd(causal, window):
    """K3's Function: forward K3 (the plain version on the CPU), backward
    autograd through the plain version: the input gradients equal those of
    autograd through the plain version, with GQA's repeat before it."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 11, 4, 64), np.float32)
    k, v = (rng.standard_normal((2, 11, 2, 64), np.float32) for _ in "kv")
    do = rng.standard_normal((2, 11, 4, 64), np.float32)
    grads = []
    for use_cuda in (True, False):
        ins = [_t(z).requires_grad_(True) for z in (q, k, v)]
        o = ops.attention(*ins, causal=causal, window=window,
                          kcfg=ops.KernelConfig(use_cuda=use_cuda))
        grads.append(torch.autograd.grad(o, ins, _t(do)))
    for got, want in zip(*grads):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_k4_function_gradients_equal_plain_autograd():
    """K4's Function on the model's layout (x, B, C views of one buffer):
    its input gradients equal autograd through the plain version."""
    rng = np.random.default_rng(4)
    bt, s, hh, p, g, n = 2, 9, 4, 32, 2, 16
    buf = rng.standard_normal((bt, s, hh * p + 2 * g * n), np.float32)
    dt = rng.random((bt, s, hh), np.float32) * 0.5
    A = -rng.random(hh, np.float32)
    dy = rng.standard_normal((bt, s, hh, p), np.float32)
    dh = rng.standard_normal((bt, hh, n, p), np.float32)
    grads = []
    for fn in (lambda *a: SSDScan.apply(*a), ssd_scan_grouped_ref):
        xbc, dt_t, A_t = (_t(z).requires_grad_(True) for z in (buf, dt, A))
        x = xbc[..., :hh * p].reshape(bt, s, hh, p)
        B = xbc[..., hh * p:hh * p + g * n].reshape(bt, s, g, n)
        C = xbc[..., hh * p + g * n:].reshape(bt, s, g, n)
        y, h = fn(x, dt_t, A_t, B, C)
        grads.append(torch.autograd.grad((y, h), (xbc, dt_t, A_t),
                                         (_t(dy), _t(dh))))
    for got, want in zip(*grads):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


# ---------------------------------------------------------------------------
# AdamW, the schedule, the losses
# ---------------------------------------------------------------------------

def _ulps(a, b):
    """Distance in f32 units in the last place."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


@pytest.mark.parametrize("step0,wd", [(0, 0.0), (3, 0.0), (7, 0.01)])
def test_adamw_update_matches_jitted_reference(step0, wd):
    """The moments bit-equal to the reference's jitted update (XLA's two
    FMAs repeated); the parameters within one ulp (XLA's division and
    update, repeated as far as measured: ~1 element in 30,000 lands one
    ulp off)."""
    rng = np.random.default_rng(step0)
    n = 20000
    p = rng.standard_normal(n).astype(np.float32)
    g = (rng.standard_normal(n) * 10.0 ** rng.uniform(-6, 1, n)).astype(
        np.float32)
    m = (rng.standard_normal(n) * 0.01).astype(np.float32)
    v = (rng.random(n) * 1e-4).astype(np.float32)
    jst = jadamw.AdamWState(jnp.int32(step0), [jnp.asarray(m)],
                            [jnp.asarray(v)])
    jp, jst2 = jax.jit(lambda g_, s_, p_: jadamw.update(
        g_, s_, p_, lr=jnp.float32(2e-3), weight_decay=wd))(
        [jnp.asarray(g)], jst, [jnp.asarray(p)])
    st = adamw.AdamWState(torch.tensor(step0, dtype=torch.int32), [_t(m)],
                          [_t(v)])
    tp, st2 = adamw.update([_t(g)], st, [_t(p)],
                           lr=torch.tensor(2e-3, dtype=torch.float32),
                           weight_decay=wd)
    assert int(st2.step) == int(jst2.step) == step0 + 1
    assert st2.step.dtype == torch.int32
    np.testing.assert_array_equal(st2.m[0].numpy(), np.asarray(jst2.m[0]))
    np.testing.assert_array_equal(st2.v[0].numpy(), np.asarray(jst2.v[0]))
    assert _ulps(tp[0].numpy(), np.asarray(jp[0])).max() <= 1
    # functional: the inputs are as they were
    np.testing.assert_array_equal(st.m[0].numpy(), m)


def test_adamw_behaviours_match_reference():
    """tests/test_substrate.py's adamw checks, on both packages: a first
    step of about lr against sign(g), convergence on a quadratic."""
    p = [torch.tensor([1.0, -2.0])]
    st = adamw.init(p)
    p2, st2 = adamw.update([torch.tensor([0.5, -0.5])], st, p, lr=0.1)
    jp2, _ = jadamw.update([jnp.array([0.5, -0.5])],
                           jadamw.init([jnp.array([1.0, -2.0])]),
                           [jnp.array([1.0, -2.0])], lr=0.1)
    np.testing.assert_allclose(p2[0].numpy(), [0.9, -1.9], atol=1e-4)
    np.testing.assert_allclose(p2[0].numpy(), np.asarray(jp2[0]), rtol=1e-6)
    assert int(st2.step) == 1
    q, jq = [torch.tensor(5.0)], [jnp.array(5.0)]
    st, jst = adamw.init(q), jadamw.init(jq)
    for _ in range(300):
        q, st = adamw.update([2.0 * q[0]], st, q, lr=0.05)
        jq, jst = jadamw.update([2.0 * jq[0]], jst, jq, lr=0.05)
    assert abs(float(q[0])) < 0.05
    np.testing.assert_allclose(float(q[0]), float(jq[0]), atol=1e-6)


def test_clip_by_global_norm_matches_reference():
    t = [torch.full((4,), 3.0), torch.arange(6.0).reshape(2, 3)]
    clipped, norm = adamw.clip_by_global_norm(t, 1.0)
    jclipped, jnorm = jadamw.clip_by_global_norm(
        [jnp.full((4,), 3.0), jnp.arange(6.0).reshape(2, 3)], 1.0)
    assert float(norm) == pytest.approx(float(jnorm), rel=1e-7)
    assert float(adamw.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    for a, b in zip(clipped, jclipped):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7)
    small, n2 = adamw.clip_by_global_norm([torch.full((4,), 0.1)], 1.0)
    np.testing.assert_array_equal(small[0].numpy(), np.full(4, 0.1,
                                                            np.float32))


def test_warmup_cosine_matches_reference():
    """The schedule at every step of a run, against the reference's: equal
    but for the cosine's last bit (libm against XLA's, 1e-6)."""
    kw = dict(base_lr=1.0, warmup_steps=10, total_steps=100)
    lrs = [float(warmup_cosine(torch.tensor(s, dtype=torch.int32), **kw))
           for s in range(110)]
    want = [float(jwarmup_cosine(jnp.asarray(s, jnp.int32), **kw))
            for s in range(110)]
    np.testing.assert_allclose(lrs, want, rtol=1e-6)
    np.testing.assert_array_equal(lrs[:10], want[:10])
    assert lrs[0] < lrs[9] <= 1.0 and max(lrs) <= 1.0
    assert 0.1 * 0.99 <= lrs[99] < 0.2


def test_cross_entropy_matches_reference():
    """The perfect-prediction and masking checks of tests/test_substrate.py
    on both packages, and random logits with a mask and z_loss."""
    logits = np.full((1, 3, 5), -20.0, np.float32)
    logits[0, np.arange(3), [1, 2, 3]] = 20.0
    tg = np.array([[1, 2, 3]], np.int32)
    assert float(losses.cross_entropy(_t(logits), _t(tg))) < 1e-3
    zeros, tg4 = np.zeros((1, 4, 5), np.float32), np.array([[0, 1, 2, 3]])
    mask = np.array([[True, True, False, False]])
    full = losses.cross_entropy(_t(zeros), _t(tg4))
    assert float(full) == pytest.approx(float(losses.cross_entropy(
        _t(zeros), _t(tg4), _t(mask))))
    assert np.isfinite(float(losses.cross_entropy(
        _t(zeros), _t(tg4), torch.zeros((1, 4), dtype=torch.bool))))
    rng = np.random.default_rng(5)
    lg = rng.standard_normal((3, 7, 11), np.float32) * 3
    tg = rng.integers(0, 11, (3, 7)).astype(np.int32)
    mk = rng.random((3, 7)) < 0.6
    for m_, z in ((None, 0.0), (mk, 0.0), (mk, 1e-3)):
        got = losses.cross_entropy(_t(lg), _t(tg),
                                   None if m_ is None else _t(m_), z)
        want = jlosses.cross_entropy(jnp.asarray(lg), jnp.asarray(tg),
                                     None if m_ is None else jnp.asarray(m_),
                                     z)
        assert float(got) == pytest.approx(float(want), rel=1e-6)
    cfg = get_smoke_config("tiny-100m")
    batch = {"tokens": tg}
    assert float(losses.task_loss(cfg, _t(lg), {"tokens": _t(tg)})) == \
        pytest.approx(float(jlosses.task_loss(jsmoke("tiny-100m"),
                                              jnp.asarray(lg), batch)),
                      rel=1e-6)
    enc = get_smoke_config("hubert-xlarge")
    b2 = {"targets": tg, "loss_mask": mk}
    assert float(losses.task_loss(enc, _t(lg), {k: _t(v) for k, v in
                                                b2.items()})) == \
        pytest.approx(float(jlosses.task_loss(jsmoke("hubert-xlarge"),
                                              jnp.asarray(lg), b2)), rel=1e-6)


# ---------------------------------------------------------------------------
# Trees, the data stream
# ---------------------------------------------------------------------------

def test_partition_selects_the_reference_lora_leaves():
    """``is_lora_path`` picks the same leaves: the reference's stacked
    leaves, cut per layer, are the port's, in the port's order; merge puts
    new leaves back; count_params / tree_bytes agree."""
    for arch in ("tiny-100m", "zamba2-2.7b", "mixtral-8x7b"):
        cfg = get_smoke_config(arch)
        vals = convert.random_model_params(cfg, 2)
        params = convert.model_params(vals, cfg, "cpu")
        lora, merge = partition.partition_by_path(params, partition.is_lora_path)
        jlora, _ = jpartition.partition_by_path(
            jax.tree.map(jnp.asarray, vals), jpartition.is_lora_path)
        mapped = convert.lora_leaves(jlora, vals, cfg, "cpu")
        assert len(mapped) == len(lora) > 0
        for a, b in zip(lora, mapped):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        back = convert.lora_leaves_to_numpy(lora, params, cfg)
        for a, b in zip(back, jlora):
            np.testing.assert_array_equal(a, np.asarray(b))
        assert all("lora" in p.split("/") for p, _ in
                   partition.select_paths(params, partition.is_lora_path))
        doubled = merge([2 * x for x in lora])
        again, _ = partition.partition_by_path(doubled,
                                               partition.is_lora_path)
        for a, b in zip(again, lora):
            np.testing.assert_array_equal(a.numpy(), 2 * b.numpy())
        assert tree.count_params(params) == jtree.count_params(vals)
        assert tree.tree_bytes(params) == jtree.tree_bytes(
            jax.tree.map(jnp.asarray, vals))


def test_flatten_unflatten_round_trip():
    st = adamw.AdamWState(torch.tensor(3, dtype=torch.int32),
                          [torch.ones(2)], [torch.zeros(2)])
    t = {"b": [1, (2.5, st)], "a": {"y": np.arange(3), "x": torch.ones(1)}}
    leaves, td = tree.flatten(t)
    assert [p for p, _ in tree.flatten_with_path(t)] == [
        "a/x", "a/y", "b/0", "b/1/0", "b/1/1/0", "b/1/1/1/0", "b/1/1/2/0"]
    back = tree.unflatten(td, leaves)
    assert isinstance(back["b"][1], tuple)
    assert isinstance(back["b"][1][1], adamw.AdamWState)
    assert back["b"][0] == 1 and back["b"][1][0] == 2.5
    # the reference's leaf order over the same structure
    jleaves = jax.tree_util.tree_leaves(
        {"b": [1, (2.5, (3, [1.0], [0.0]))], "a": {"y": 0, "x": 1}})
    assert len(jleaves) == len(leaves)
    with pytest.raises(ValueError):
        tree.unflatten(td, leaves + [0])
    named = tree.tree_map_with_path_names(lambda p, x: p, t)
    assert named["a"]["x"] == "a/x" and named["b"][1][1].m == ["b/1/1/1/0"]


def test_loader_and_streams_bit_equal_to_reference():
    """ShardedLMLoader, MarkovLM, token_stream and lm_batches are numpy
    copies: the same bits; the substrate tests' behaviours."""
    for seed, (v, gb, s) in enumerate(((512, 4, 32), (100, 8, 16))):
        ld, jld = ShardedLMLoader(v, gb, s, seed=seed), JLoader(v, gb, s,
                                                                seed=seed)
        for st in (0, 7, 123):
            np.testing.assert_array_equal(ld.batch_at(st)["tokens"],
                                          jld.batch_at(st)["tokens"])
        assert ld.batch_at(0)["tokens"].dtype == np.int32
        b = ld.batch_at(3)
        np.testing.assert_array_equal(ld.host_slice(b, 1, 2)["tokens"],
                                      jld.host_slice(b, 1, 2)["tokens"])
        it = iter(ld)
        np.testing.assert_array_equal(next(it)["tokens"],
                                      ld.batch_at(0)["tokens"])
    l1, l2 = ShardedLMLoader(512, 4, 32, seed=1), ShardedLMLoader(512, 4, 32,
                                                                  seed=1)
    np.testing.assert_array_equal(l1.batch_at(7)["tokens"],
                                  l2.batch_at(7)["tokens"])
    assert not np.array_equal(l1.batch_at(8)["tokens"],
                              l1.batch_at(7)["tokens"])
    assert np.array_equal(MarkovLM(64, 3).succ, jsynthetic.MarkovLM(64,
                                                                     3).succ)
    ts, jts = token_stream(100, 40, 2, 32), jsynthetic.token_stream(100, 40,
                                                                    2, 32)
    for _ in range(4):
        np.testing.assert_array_equal(next(ts), next(jts))
    got = list(lm_batches(100, 2, 16, num_batches=3))
    want = list(jsynthetic.lm_batches(100, 2, 16, num_batches=3))
    assert len(got) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        assert a["tokens"].shape == (2, 16)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

TRAIN_ARCHS = ("tiny-100m", "mixtral-8x7b")


def _train_setup(arch, microbatches, remat):
    cfg, jcfg = get_smoke_config(arch), jsmoke(arch)
    kw = dict(seq_len=32, global_batch=4, lr=2e-3, total_steps=20,
              warmup_steps=2, microbatches=microbatches, remat=remat)
    vals = convert.random_model_params(cfg, 3)
    return cfg, jcfg, TrainConfig(**kw), JTrainConfig(**kw), vals


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_matches_reference(arch, microbatches, remat):
    """Loss, grad norm and lr of 3 steps of ``make_train_step`` against the
    reference's jitted one on the same weights and batches (MoE: its aux
    loss included); the LoRA leaves and AdamW moments after them, mapped
    per layer; the base leaves bit-unchanged and without ``.grad``."""
    cfg, jcfg, tcfg, jtcfg, vals = _train_setup(arch, microbatches, remat)
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
    assert int(opt.step) == 3 and opt.step.dtype == torch.int32
    lora, _ = partition.partition_by_path(params, partition.is_lora_path)
    jlora, _ = jpartition.partition_by_path(jp, jpartition.is_lora_path)
    for got, want in zip(lora, convert.lora_leaves(jlora, vals, cfg, "cpu")):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=PARAM_ATOL)
    jopt = convert.opt_state(jo, vals, cfg, "cpu")
    for got, want in zip(opt.m + opt.v, jopt.m + jopt.v):
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   rtol=MOMENT_RTOL, atol=MOMENT_ATOL)
    base = partition.partition_by_path(
        params, lambda p: not partition.is_lora_path(p))[0]
    for a, b in zip(base, base0):
        assert torch.equal(a, b) and a.grad is None and not a.requires_grad


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_grad_step_matches_reference(arch):
    """The LoRA gradients of ``make_grad_step``, mapped per layer, against
    the reference's (remat none and full give the port the same bits)."""
    cfg, jcfg, tcfg, jtcfg, vals = _train_setup(arch, 1, "none")
    batch = ShardedLMLoader(cfg.vocab_size, 4, 32, seed=2).batch_at(0)
    jloss, jgrads = jax.jit(jstep.make_grad_step(jcfg, jtcfg))(
        jax.tree.map(jnp.asarray, vals), batch)
    params = convert.model_params(vals, cfg, "cpu")
    loss, grads = step.make_grad_step(cfg, tcfg)(params, batch)
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    want = convert.lora_leaves(jgrads, vals, cfg, "cpu")
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
        assert torch.count_nonzero(g) > 0
    remat = dataclasses.replace(tcfg, remat="full")
    loss_r, grads_r = step.make_grad_step(cfg, remat)(params, batch)
    assert torch.equal(loss_r, loss)
    for a, b in zip(grads_r, grads):
        assert torch.equal(a, b)
    # the plain versions give the same gradients as the Functions on CPU
    _, grads_p = step.make_grad_step(cfg, tcfg, ops.KernelConfig(False))(
        params, batch)
    for a, b in zip(grads_p, grads):
        assert torch.equal(a, b)
    # apply_grads is the optimizer half of the train step
    opt = step.init_opt_state(params)
    p2, o2 = step.apply_grads(cfg, tcfg, params, opt, grads)
    p3, o3, _ = step.make_train_step(cfg, tcfg)(params, opt, batch)
    for a, b in zip(partition.partition_by_path(p2, partition.is_lora_path)[0],
                    partition.partition_by_path(p3, partition.is_lora_path)[0]):
        assert torch.equal(a, b)


def test_eval_prefill_decode_steps_match_reference():
    cfg, jcfg, tcfg, jtcfg, vals = _train_setup("tiny-100m", 1, "none")
    batch = ShardedLMLoader(cfg.vocab_size, 2, 16, seed=3).batch_at(0)
    params = convert.model_params(vals, cfg, "cpu")
    jp = jax.tree.map(jnp.asarray, vals)
    got = step.make_eval_step(cfg)(params, batch)
    want = jstep.make_eval_step(jcfg)(jp, batch)
    assert float(got) == pytest.approx(float(want), rel=LOSS_RTOL)
    logits, cache = step.make_prefill_step(cfg, 24)(params, batch)
    jlogits, jcache = jstep.make_prefill_step(jcfg, 24)(jp, batch)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=2e-4, rtol=2e-3)
    nxt = {"tokens": np.argmax(np.asarray(jlogits), -1).astype(np.int32)}
    dl, _ = step.make_decode_step(cfg)(params, cache, nxt)
    jdl, _ = jstep.make_decode_step(jcfg)(jp, jcache, nxt)
    np.testing.assert_allclose(dl.numpy(), np.asarray(jdl), atol=2e-4,
                               rtol=2e-3)


def test_remat_recomputes_each_layer():
    """``remat="full"``: the layers run again in the backward (K2 forward
    calls 2x with remat, 1x without) and the gradients are the same bits."""
    cfg = get_smoke_config("tiny-100m")
    params = convert.model_params(convert.random_model_params(cfg, 4), cfg,
                                  "cpu")
    batch = step.batch_to(ShardedLMLoader(cfg.vocab_size, 2, 16,
                                          seed=0).batch_at(0), "cpu")
    calls = []
    orig = LoRAMatmul.forward

    def counting(ctx, *a):
        calls.append(1)
        return orig(ctx, *a)

    grads = {}
    for remat in ("none", "full"):
        calls.clear()
        lora, merge = partition.partition_by_path(params,
                                                  partition.is_lora_path)
        leaves = [x.detach().requires_grad_(True) for x in lora]
        LoRAMatmul.forward = staticmethod(counting)
        try:
            logits, _ = tf.forward(cfg, merge(leaves), batch, remat=remat)
            loss = losses.task_loss(cfg, logits, batch)
            grads[remat] = torch.autograd.grad(loss, leaves)
        finally:
            LoRAMatmul.forward = staticmethod(orig)
        assert len(calls) == 2 * cfg.num_layers * (2 if remat == "full"
                                                   else 1)
    for a, b in zip(grads["none"], grads["full"]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Throughput calibration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_calibrate_and_tokens_per_slot_equal_reference(arch):
    """``calibrate`` rounds through f32 as the reference does (x64 off), so
    mu1 and mu2 are the reference's floats exactly; tokens_per_slot is
    host arithmetic, also exact."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    for kw in ({}, {"bandwidth_bps": 200e9, "slot_seconds": 600.0},
               {"bandwidth_bps": 100e6}):
        assert dataclasses.astuple(throughput.calibrate(cfg, **kw)) == \
            dataclasses.astuple(jthroughput.calibrate(jcfg, **kw))
    assert throughput.tokens_per_slot(cfg) == jthroughput.tokens_per_slot(
        jcfg)
    assert throughput.tokens_per_slot(cfg, chip_flops=989e12, mfu=0.3) == \
        jthroughput.tokens_per_slot(jcfg, chip_flops=989e12, mfu=0.3)
