"""The port's op-stream accounting (``launch.op_analysis``), the
counterpart of ``tests/test_hlo_dryrun.py``'s HLO unit tests: FLOPs of one
product and of a loop, dtype bytes, traffic, and the per-device pin (a
sharded product counts the rank's local product, not the global one)."""
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.launch import op_analysis as oa
from repro_torch.launch.mesh import fake_group, make_production_mesh


def test_dot_flops_simple_matmul():
    with FakeTensorMode():
        a, b = torch.zeros(128, 256), torch.zeros(256, 64)
        with oa.count_ops((a, b)) as c:
            a @ b
    assert oa.analyze(c.log)["dot_flops"] == 2 * 128 * 256 * 64


def test_loop_counts_every_iteration():
    """An eager loop runs each iteration: nine (64, 64) products count
    nine times one; the caller's loop counts pass through."""
    with FakeTensorMode():
        x = torch.zeros(64, 64)
        with oa.count_ops() as c:
            for _ in range(9):
                x = x @ x * 0.5
    acc = oa.analyze(c.log, while_trips=[9])
    assert acc["dot_flops"] == 9 * 2 * 64 ** 3
    assert acc["while_trips"] == [9] and acc["unknown_trip_whiles"] == 0


def test_type_bytes():
    assert oa.type_bytes(torch.float32, (4, 8)) == 128
    assert oa.type_bytes("bfloat16", [10]) == 20
    assert oa.type_bytes(torch.float32, (4, 8), f32_as=2) == 64
    assert oa.type_bytes(torch.bool, ()) == 1
    assert oa.type_bytes("int32", (3,)) == 12


def test_traffic_counts_something():
    """A relu after a (256, 256) product moves at least two reads and a
    write; views move nothing."""
    with FakeTensorMode():
        x = torch.zeros(256, 256)
        with oa.count_ops((x,)) as c:
            torch.relu(x @ x)
            x.t().reshape(-1)
    acc = oa.analyze(c.log)
    assert acc["traffic_bytes"] >= 3 * 256 * 256 * 4
    assert acc["traffic_bytes_bf16eq"] == acc["traffic_bytes"] / 2
    assert c.peak_bytes >= 3 * 256 * 256 * 4


def test_sharded_product_counts_the_local_product(tmp_path):
    """A (16, 128, 4096) @ (4096, 4096) product, batch on "data" and
    columns on "model" over a fake (16, 16) mesh, counts the rank's
    2 * 128 * 4096 * 256 FLOPs (DTensor's metadata propagation on global
    shapes stays out of the log); gathering the result counts its
    collective bytes. The log round-trips through its file."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    with fake_group(256):
        mesh = make_production_mesh(device_type="cpu")
        x = DTensor.from_local(torch.zeros(1, 128, 4096, device="meta"),
                               mesh, [Shard(0), Replicate()],
                               run_check=False)
        w = DTensor.from_local(torch.zeros(4096, 256, device="meta"), mesh,
                               [Replicate(), Shard(1)], run_check=False)
        assert x.shape == (16, 128, 4096) and w.shape == (4096, 4096)
        with oa.count_ops((x, w)) as c:
            y = x @ w
            y.redistribute(mesh, [Replicate(), Replicate()])
        acc = oa.analyze(c.log)
    assert acc["dot_flops"] == 2 * 128 * 4096 * 256
    assert acc["collectives"]["all-gather"]["count"] == 2
    assert acc["collective_bytes_total"] == 4 * (16 * 128 * 256 +
                                                 16 * 128 * 4096)
    path = str(tmp_path / "log.ops.z")
    oa.save_log(c.log, path, {"while_trips": [3]})
    log, meta = oa.load_log(path)
    assert log == c.log and meta == {"while_trips": [3]}
    assert not torch.distributed.is_initialized()


def test_traffic_and_peak_are_exact_on_a_hand_counted_step():
    """Every op's bytes, summed by hand: views (t, select, reshape) move
    nothing; copy_ reads its source and writes its destination (not the
    destination's old value); an in-place add reads and writes its
    operand. The peak is the arguments plus the most that is alive at
    once (the kept product and the relu's result)."""
    with FakeTensorMode():
        x = torch.zeros(64, 128)                         # f32
        w = torch.zeros(128, 32, dtype=torch.bfloat16)
        cache = torch.zeros(4, 64, 32)                   # f32
        with oa.count_ops((x, w, cache)) as c:
            y = x.to(torch.bfloat16) @ w
            y = y.t().contiguous()
            cache[1].copy_(y.t())
            cache.add_(1.0)
            torch.relu(cache.reshape(-1))
    by_hand = (
        64 * 128 * (4 + 2)                     # the cast: f32 in, bf16 out
        + (64 * 128 + 128 * 32 + 64 * 32) * 2  # the product
        + 2 * 32 * 64 * 2                      # contiguous: read + write
        + 64 * 32 * (2 + 4)                    # copy_: bf16 in, f32 out
        + 2 * 4 * 64 * 32 * 4                  # add_: read + write
        + 2 * 4 * 64 * 32 * 4)                 # relu: read + write
    acc = oa.analyze(c.log)
    assert acc["traffic_bytes"] == by_hand == 229376
    assert acc["dot_flops"] == 2 * 64 * 128 * 32
    args = 64 * 128 * 4 + 128 * 32 * 2 + 4 * 64 * 32 * 4
    assert c.peak_bytes == args + 32 * 64 * 2 + 4 * 64 * 32 * 4


def test_kernel_launches_count_their_own_traffic_and_operations():
    """``kernels=True``: K2 and K3 (through ``ops`` with ``use_cuda``, as
    the card's path runs them) are one op each, their inputs read and
    outputs written once, K3's operations over its unmasked pairs only;
    the plain attention's (BH, S, S) scores never appear. The stand-ins
    are gone after the block."""
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels import lora_matmul as k2
    from repro_torch.kernels import ops

    saved = (k2._run, k3.flash_attention)
    cuda = ops.KernelConfig(use_cuda=True)
    bf16 = torch.bfloat16
    with FakeTensorMode():
        x = torch.zeros(2, 8, 64, dtype=bf16)
        w = torch.zeros(64, 4, 16, dtype=bf16)
        a, b = torch.zeros(64, 16), torch.zeros(16, 4, 16)
        q = torch.zeros(2, 32, 4, 16, dtype=bf16)
        kv = torch.zeros(2, 32, 2, 16, dtype=bf16)
        with oa.count_ops(kernels=True) as c:
            y = ops.lora_matmul(x, w, a, b, 2.0, kcfg=cuda)
            o = ops.attention(q, kv, kv, causal=True, kcfg=cuda)
    assert (k2._run, k3.flash_attention) == saved
    assert y.shape == (2, 8, 4, 16) and o.shape == q.shape
    kernels = [r for r in c.log if r["op"].startswith("kernel.")]
    assert [r["op"] for r in kernels] == ["kernel.lora_matmul",
                                          "kernel.flash_attention"]
    acc = oa.analyze(kernels)
    k2_bytes = 2 * (16 * 64 + 64 * 64 + 16 * 64) + 4 * (64 * 16 + 16 * 64)
    k3_bytes = 4 * (2 * 4) * 32 * 16 * 2      # q, k, v (GQA repeated), o
    assert acc["kernels"]["lora_matmul"] == {
        "count": 1, "bytes": k2_bytes, "flops": oa.lora_flops(16, 64, 64, 16)}
    assert acc["kernels"]["flash_attention"] == {
        "count": 1, "bytes": k3_bytes, "flops": 4 * 16 * 8 * (32 * 33 // 2)}
    assert not any(len(s) >= 2 and s[-2:] == [32, 32]
                   for r in c.log for _, s in r["in"] + r["out"])



def test_k4_backward_launch_counts_its_own_traffic_and_operations():
    """K4's Function through ``ops.ssd`` under autograd on the model's
    layout (x, B, C views of one buffer): one ``kernel.ssd_scan`` and one
    ``kernel.ssd_scan_backward`` op, each reading its inputs and writing
    its outputs once (the unused state's cotangent is none, and not read);
    the backward's operations are
    ``ssd_backward_flops``; the step-by-step plain route (a (BH, N, P)
    state a step) never runs. The stand-ins are gone after the block."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as k4

    saved = (k4.ssd_scan_grouped, k4.ssd_scan_grouped_backward)
    bt, s, h, p, g, n = 2, 100, 4, 32, 2, 16
    bf16 = torch.bfloat16
    with FakeTensorMode():
        buf = torch.zeros(bt, s, h * p + 2 * g * n, dtype=bf16,
                          requires_grad=True)
        dt = torch.zeros(bt, s, h, requires_grad=True)
        A = torch.zeros(h, requires_grad=True)
        x = buf[..., :h * p].unflatten(-1, (h, p))
        B = buf[..., h * p:h * p + g * n].unflatten(-1, (g, n))
        C = buf[..., h * p + g * n:].unflatten(-1, (g, n))
        with oa.count_ops(kernels=True) as c:
            y, hfin = ops.ssd(x, dt, A, B, C,
                              kcfg=ops.KernelConfig(use_cuda=True))
            grads = torch.autograd.grad(y.float().sum(), (buf, dt, A))
    assert (k4.ssd_scan_grouped, k4.ssd_scan_grouped_backward) == saved
    assert [gr.shape for gr in grads] == [buf.shape, dt.shape, A.shape]
    kernels = [r for r in c.log if r["op"].startswith("kernel.")]
    assert [r["op"] for r in kernels] == ["kernel.ssd_scan",
                                          "kernel.ssd_scan_backward"]
    acc = oa.analyze(kernels)
    xb, bcb = bt * s * h * p * 2, bt * s * g * n * 2
    dtb, ab, hb = bt * s * h * 4, h * 4, bt * h * n * p * 4
    fwd_bytes = xb + dtb + ab + 2 * bcb + xb + hb
    # the loss uses y alone: no state cotangent reaches the backward
    bwd_bytes = (xb + dtb + ab + 2 * bcb + xb) + (xb + dtb + ab + 2 * bcb)
    assert acc["kernels"]["ssd_scan"] == {
        "count": 1, "bytes": fwd_bytes,
        "flops": oa.ssd_flops(bt, h, g, s, p, n)}
    assert acc["kernels"]["ssd_scan_backward"] == {
        "count": 1, "bytes": bwd_bytes,
        "flops": oa.ssd_backward_flops(bt, h, g, s, p, n)}
    assert not any(s_ == [bt * h, n, p] for r in c.log
                   for _, s_ in r["in"] + r["out"])


def test_k3_backward_launch_counts_its_own_traffic_and_operations():
    """K3's Function through ``ops.attention`` under autograd (GQA: 4 query
    heads over 2 K / V heads): one ``kernel.flash_attention`` op, which
    also writes the row statistics m and l, and one
    ``kernel.flash_attention_backward`` op reading q, k, v (repeated), m,
    l and dO once and writing dq, dk, dv once, with 10 D operations an
    unmasked pair (``attention_backward_flops``); no (S, S) tensor of the
    plain attention's backward. The stand-ins are gone after the block."""
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels import ops

    saved = (k3.flash_attention, k3.flash_attention_backward)
    bf16 = torch.bfloat16
    with FakeTensorMode():
        q = torch.zeros(2, 32, 4, 16, dtype=bf16, requires_grad=True)
        k = torch.zeros(2, 32, 2, 16, dtype=bf16, requires_grad=True)
        v = torch.zeros(2, 32, 2, 16, dtype=bf16, requires_grad=True)
        with oa.count_ops(kernels=True) as c:
            o = ops.attention(q, k, v, causal=True,
                              kcfg=ops.KernelConfig(use_cuda=True))
            grads = torch.autograd.grad(o.float().sum(), (q, k, v))
    assert (k3.flash_attention, k3.flash_attention_backward) == saved
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    kernels = [r for r in c.log if r["op"].startswith("kernel.")]
    assert [r["op"] for r in kernels] == ["kernel.flash_attention",
                                          "kernel.flash_attention_backward"]
    acc = oa.analyze(kernels)
    head = 8 * 32 * 16 * 2                   # one (BH, S, D) bf16 tensor
    stats = 2 * 8 * 32 * 4                   # m and l, (BH, S) f32
    pairs = 32 * 33 // 2
    assert acc["kernels"]["flash_attention"] == {
        "count": 1, "bytes": 4 * head + stats, "flops": 4 * 16 * 8 * pairs}
    assert acc["kernels"]["flash_attention_backward"] == {
        "count": 1, "bytes": 7 * head + stats,
        "flops": 10 * 16 * 8 * pairs}
    assert oa.attention_backward_flops(8, 32, 32, 16, True, None) == \
        10 * 16 * 8 * pairs
    assert not any(len(s_) >= 2 and s_[-2:] == [32, 32]
                   for r in c.log for _, s_ in r["in"] + r["out"])


def test_ssd_backward_flops():
    """K4's backward products by hand: per 64-step chunk 3 L^2 N
    multiply-adds a group (S, (sum dS)^T C, (sum dS) B) and 2 L^2 P + 4 L N P
    a head, and the state update L N P a head again for every chunk but
    the last."""
    L = 64
    per_group, per_head = 3 * L * L * 128, 2 * L * L * 64 + 4 * L * 128 * 64
    assert oa.ssd_backward_flops(8, 32, 1, 2048, 64, 128) == 8 * 2 * (
        32 * (per_group + 32 * per_head) + 32 * 31 * L * 128 * 64)
    assert oa.ssd_backward_flops(3, 4, 2, 65, 32, 16) == 3 * 2 * (
        2 * (2 * 3 * L * L * 16 + 4 * (2 * L * L * 32 + 4 * L * 16 * 32))
        + 4 * L * 16 * 32)
    assert oa.ssd_backward_flops(1, 1, 1, 64, 32, 16) == 2 * (
        3 * L * L * 16 + 2 * L * L * 32 + 4 * L * 16 * 32)


def test_ssd_flops():
    """K4's forward products by hand: per 64-step chunk the score tile L^2 N
    a group, and L^2 P + 2 L N P a head."""
    L = 64
    assert oa.ssd_flops(8, 32, 1, 2048, 64, 128) == 8 * 32 * 2 * (
        L * L * 128 + 32 * (L * L * 64 + 2 * L * 128 * 64))
    assert oa.ssd_flops(2, 6, 3, 65, 32, 16) == 2 * 2 * 2 * (
        3 * L * L * 16 + 6 * (L * L * 32 + 2 * L * 16 * 32))


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b"])
def test_counted_kernel_path_of_an_ssm_train_step(arch, tmp_path):
    """``dryrun.count(kernels=True)`` of the SSM and hybrid smoke configs'
    training step (remat full) counts the card's path: K4 forward twice a
    layer (the remat recompute), K4's backward once a layer, the conv's
    kernel likewise (no cat in its place), K2 on wx and out_proj; no
    step-by-step plain route in the log."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    cfg = get_smoke_config(arch)
    seq, batch = 48, 2
    acc = dryrun.count(cfg, ShapeConfig("t", seq, batch, "train"), None,
                       microbatches=1, kernels=True,
                       trace_path=str(tmp_path / "ops.z"))
    n = cfg.num_layers
    ks = acc["kernels"]
    assert (ks["ssd_scan"]["count"], ks["ssd_scan_backward"]["count"]) == \
        (2 * n, n)
    assert (ks["causal_conv"]["count"],
            ks["causal_conv_backward"]["count"]) == (2 * n, n)
    assert ks["causal_conv"]["flops"] == 0
    sc = cfg.ssm
    heads = sc.heads(cfg.d_model)
    assert ks["ssd_scan_backward"]["flops"] == n * oa.ssd_backward_flops(
        batch, heads, sc.n_groups, seq, sc.head_dim, sc.state_size)
    assert ks["lora_matmul"]["count"] >= 4 * n
    log = oa.load_log(str(tmp_path / "ops.z"))[0]
    state = [batch * heads, sc.state_size, sc.head_dim]
    assert not any(s_ == state for r in log for _, s_ in r["in"] + r["out"])

def test_attention_pairs():
    """K3's unmasked pairs: causal, windowed, bidirectional, and counted
    from positions where they hold data (a span of equal positions sees
    itself whole)."""
    assert oa.attention_pairs(32, 32, True, None) == 32 * 33 // 2
    assert oa.attention_pairs(32, 32, True, 8) == sum(range(1, 9)) + 24 * 8
    assert oa.attention_pairs(8, 16, False, None) == 8 * 16
    pos = torch.tensor([0, 1, 2, 2, 2, 3], dtype=torch.int32)
    assert oa.attention_flops(1, 6, 6, 4, True, None, pos, pos) == \
        4 * 4 * (1 + 2 + 5 + 5 + 5 + 6)
    ar = torch.arange(6, dtype=torch.int32)
    assert oa.attention_flops(3, 6, 6, 4, True, 2, ar, ar) == \
        4 * 4 * 3 * oa.attention_pairs(6, 6, True, 2)


@pytest.mark.parametrize("mode", ["prefill", "decode", "train"])
def test_counted_kernel_path_of_a_llama_step(mode, tmp_path):
    """``dryrun.count(kernels=True)`` on the llama2-7b smoke config counts
    the card's path: K2 twice a layer a forward (q and v adapted), K3 once
    a layer at prefill and in training (its forward again under remat,
    none at decode, whose attention is plain), K2 once more a layer but
    the first in the backward, K3's backward once a layer in training. At
    prefill the dot FLOPs are the plain path's less each layer's masked
    half of the S x S products (K3 counts unmasked pairs), and at prefill
    and in training no (S, S) tensor is in the log; the plain path's is,
    and it moves more."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    cfg = get_smoke_config("llama2-7b")
    seq, batch = 48, 2
    shape = ShapeConfig("t", seq, batch, mode)
    logs = {}
    accs = {}
    for kernels in (False, True):
        path = str(tmp_path / f"{kernels}.ops.z")
        accs[kernels] = dryrun.count(cfg, shape, None, microbatches=1,
                                     trace_path=path, kernels=kernels)
        logs[kernels] = oa.load_log(path)[0]
    n = cfg.num_layers
    want = {"prefill": (2 * n, n), "decode": (2 * n, 0),
            "train": (4 * n + 2 * (n - 1), 2 * n)}[mode]
    ks = accs[True]["kernels"]
    assert (ks["lora_matmul"]["count"],
            ks.get("flash_attention", {}).get("count", 0)) == want
    assert ks.get("flash_attention_backward", {}).get("count", 0) == (
        n if mode == "train" else 0)
    assert accs[False]["kernels"] == {}
    assert accs[True]["traffic_bytes"] < accs[False]["traffic_bytes"]

    def square(log):  # a (B, H, S, S) tensor: scores
        return any(len(s) == 4 and s[-2:] == [seq, seq]
                   for r in log for _, s in r["in"] + r["out"])

    if mode == "prefill":
        bh, d = batch * cfg.num_heads, cfg.head_dim
        masked = 4 * d * bh * (seq * seq - seq * (seq + 1) // 2)
        assert accs[True]["dot_flops"] == accs[False]["dot_flops"] - n * masked
    if mode != "decode":
        assert square(logs[False]) and not square(logs[True])
