"""The port's profiler ranges (``repro_torch.obs.ranges``) on the CPU:
a LoRA train step of the Mamba-2 and Mixtral smoke configurations (two
layers each) under ``torch.profiler`` (CPU activity). Each stage's
forward range recurs in remat's recompute, its backward half occurs once
and holds the stage's backward ops, ``train step`` counts the steps, the
ranges nest, and with no profiler recording the step registers nothing
and computes the same bits as a traced one."""
import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import TrainConfig, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import transformer as tf
from repro_torch.obs import ranges
from repro_torch.train import step

torch.set_num_threads(1)

B = ranges.backward
# Ranges a step, with remat. Each layer runs twice (the forward and the
# recompute) and its backward halves once. Layer 0's input comes from the
# frozen embedding: its first norm has no backward half, its in-projection
# (Mamba-2) no dx, and its rotated k (Mixtral: k has no adapter) none.
COUNTS = {
    "mamba2-370m": {
        ranges.TRAIN_STEP: 1, ranges.EMBED: 1, ranges.OPTIM: 1,
        ranges.HEAD: 1, B(ranges.HEAD): 1, ranges.LOSS: 1, B(ranges.LOSS): 1,
        ranges.BLOCK: 4, B(ranges.BLOCK): 2,
        ranges.NORM: 5, B(ranges.NORM): 2,
        ranges.SSM_MIXER: 4, B(ranges.SSM_MIXER): 2,
        ranges.SSM_CONV: 4, B(ranges.SSM_CONV): 2,
        ranges.SSM_GATED_NORM: 4, B(ranges.SSM_GATED_NORM): 2,
        ranges.LORA_MATMUL: 8, B(ranges.LORA_MATMUL): 4,
        ranges.SSD: 4, B(ranges.SSD): 2, ops.SSD_COPIES: 4,
        "K2 backward W transpose": 3, "K2 backward dx": 3,
        "K2 backward dA dB": 4, "K4 backward": 2},
    "mixtral-8x22b": {
        ranges.TRAIN_STEP: 1, ranges.EMBED: 1, ranges.OPTIM: 1,
        ranges.HEAD: 1, B(ranges.HEAD): 1, ranges.LOSS: 1, B(ranges.LOSS): 1,
        ranges.BLOCK: 4, B(ranges.BLOCK): 2,
        ranges.NORM: 9, B(ranges.NORM): 4,
        ranges.ROPE: 8, B(ranges.ROPE): 3,
        ranges.LORA_MATMUL: 8, B(ranges.LORA_MATMUL): 4,
        ranges.ATTENTION: 4, B(ranges.ATTENTION): 2, ops.KV_REPEAT: 4,
        **{name: 4 for name in ("moe route", "moe dispatch", "moe experts",
                                "moe combine")},
        **{B(name): 2 for name in ("moe route", "moe dispatch",
                                   "moe experts", "moe combine")},
        "K2 backward W transpose": 2, "K2 backward dx": 2,
        "K2 backward dA dB": 4, "K3 backward": 2},
}
# a backward op of each stage (autograd's node name) and the half it lies
# in; ops that the CPU's plain attention backward also runs are left out
BACKWARD_OPS = {
    "mamba2-370m": [("CausalConvBackward", B(ranges.SSM_CONV)),
                    ("SoftplusBackward0", B(ranges.SSM_MIXER)),
                    ("LoRAMatmulBackward", B(ranges.LORA_MATMUL)),
                    ("SSDScanBackward", B(ranges.SSD)),
                    ("LogsumexpBackward0", B(ranges.LOSS))],
    "mixtral-8x22b": [("SiluBackward0", B("moe experts")),
                      ("IndexAddBackward0", B("moe combine")),
                      ("SortBackward1", B("moe route")),
                      ("CatBackward0", B(ranges.ROPE)),
                      ("ScatterBackward0", B("moe dispatch")),
                      ("FlashAttentionBackward", B(ranges.ATTENTION))],
}


def _step(name, remat="full"):
    cfg = get_smoke_config(name)
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    # LoRA B drawn non-zero, so that every adapter's gradient is
    for path_leaf in _lora_b(params):
        path_leaf.normal_(generator=torch.Generator().manual_seed(1))
    fn = step.make_train_step(cfg, TrainConfig(seq_len=16, global_batch=2,
                                               remat=remat),
                              ops.KernelConfig(use_cuda=True))
    tok = torch.randint(0, cfg.vocab_size, (2, 16),
                        generator=torch.Generator().manual_seed(2))
    batch = {"tokens": tok, "targets": torch.roll(tok, -1, 1)}
    return fn, params, step.init_opt_state(params), batch


def _lora_b(tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "lora":
                yield from (pair["b"] for pair in v.values())
            else:
                yield from _lora_b(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _lora_b(v)


def _profiled(fn, *args, steps=1):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(steps):
            out = fn(*args)
    events = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
               e.start_thread_id(), e.is_user_annotation())
              for e in prof.profiler.kineto_results.events()]
    return out, events


def _counts(events):
    return collections.Counter(n for _, _, n, _, user in events if user)


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_each_range_per_step_with_remat(name):
    fn, params, opt, batch = _step(name)
    _, events = _profiled(fn, params, opt, batch)
    assert dict(_counts(events)) == COUNTS[name]


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_without_remat_each_forward_range_occurs_once(name):
    fn, params, opt, batch = _step(name, remat="none")
    _, events = _profiled(fn, params, opt, batch)
    counts = _counts(events)
    for rng, n in COUNTS[name].items():
        once = rng.endswith(" backward") or rng in (
            ranges.TRAIN_STEP, ranges.EMBED, ranges.OPTIM, ranges.HEAD,
            ranges.LOSS) or rng.startswith("K")
        assert counts[rng] == (n if once else n // 2 + (rng == ranges.NORM)
                               ), rng


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_backward_ops_lie_inside_their_half(name):
    fn, params, opt, batch = _step(name)
    _, events = _profiled(fn, params, opt, batch)
    for op, half in BACKWARD_OPS[name]:
        # the node itself, not autograd's "evaluate_function" wrapper, which
        # also runs the hooks that close a half
        nodes = [e for e in events if e[2] == op]
        spans = [e for e in events if e[2] == half]
        assert nodes and spans, op
        for a, b, _, tid, _ in nodes:
            assert any(s <= a and b <= t and tid == th
                       for s, t, _, th, _ in spans), (op, half)


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_ranges_nest_on_each_thread(name):
    fn, params, opt, batch = _step(name)
    _, events = _profiled(fn, params, opt, batch)
    stacks = collections.defaultdict(list)
    for a, b, rng, tid, _ in sorted((e for e in events if e[4]),
                                    key=lambda e: (e[0], -e[1])):
        stack = stacks[tid]
        while stack and stack[-1][1] <= a:
            stack.pop()
        assert not stack or b <= stack[-1][1], (rng, stack[-1][2])
        stack.append((a, b, rng))


def test_train_step_counts_the_steps():
    fn, params, opt, batch = _step("mamba2-370m")

    def two_steps(params, opt, batch):
        params, opt, _ = fn(params, opt, batch)
        return fn(params, opt, batch)

    _, events = _profiled(two_steps, params, opt, batch, steps=2)
    assert _counts(events)[ranges.TRAIN_STEP] == 4


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_an_untraced_step_registers_nothing_and_computes_the_same_bits(
        name, monkeypatch):
    built = []

    class Counted(ranges._BackwardHalf):
        def __init__(self, *args):
            built.append(args[0])
            super().__init__(*args)

    monkeypatch.setattr(ranges, "_BackwardHalf", Counted)
    fn, params, opt, batch = _step(name)
    assert ranges.span(ranges.OPTIM) is ranges._NULL
    plain = fn(params, opt, batch)
    assert built == []
    traced, _ = _profiled(fn, params, opt, batch)
    assert built
    (p0, o0, m0), (p1, o1, m1) = plain, traced
    for a, b in [(m0.loss, m1.loss), (m0.grad_norm, m1.grad_norm),
                 *zip(o0.m, o1.m), *zip(o0.v, o1.v),
                 *zip(_lora_b(p0), _lora_b(p1))]:
        assert torch.equal(a, b)
