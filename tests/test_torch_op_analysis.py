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
    the first in the backward. At prefill the dot FLOPs are the plain
    path's less each layer's masked half of the S x S products (K3 counts
    unmasked pairs), and no (S, S) tensor is in the log; the plain
    path's is, and it moves more."""
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
    assert accs[False]["kernels"] == {}
    assert accs[True]["traffic_bytes"] < accs[False]["traffic_bytes"]

    def square(log):  # a (B, H, S, S) tensor: scores
        return any(len(s) == 4 and s[-2:] == [seq, seq]
                   for r in log for _, s in r["in"] + r["out"])

    if mode == "prefill":
        bh, d = batch * cfg.num_heads, cfg.head_dim
        masked = 4 * d * bh * (seq * seq - seq * (seq + 1) // 2)
        assert accs[True]["dot_flops"] == accs[False]["dot_flops"] - n * masked
        assert square(logs[False]) and not square(logs[True])
