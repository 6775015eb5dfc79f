"""The yardstick's operation and byte counts against hand-worked small
cases."""
import pytest

from port_bench import catalog, yardstick


def test_attention_pairs_by_hand():
    assert yardstick.attention_pairs(4, True, None) == 1 + 2 + 3 + 4
    # a window of 2: 1 + 2 + 2 + 2
    assert yardstick.attention_pairs(4, True, 2) == 7
    assert yardstick.attention_pairs(4, False, None) == 16
    assert yardstick.attention_pairs(3, True, 10) == 6


def test_bound_takes_the_larger_term():
    assert yardstick.bound_s(989e12, 0) == pytest.approx(1.0)
    assert yardstick.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert yardstick.bound_s(989e12, 6.7e12) == pytest.approx(2.0)


def test_k2_bound_by_hand():
    # M 2, K 3, N 4, r 1: 2*24 + 2*6 + 2*8 = 76 operations; bf16 bytes
    # x 6 + W 12 + A 3 + B 4 + y 8 = 33 elements
    got = yardstick.k2_bound_s("forward", 2, 3, 4, 1)
    assert got == pytest.approx(max(76 / 989e12, 66 / 3.35e12))


def test_k3_bounds_by_hand():
    model = {"num_heads": 2, "num_kv_heads": 1, "head_dim": 4,
             "causal": True, "sliding_window": None}
    traffic = {"batch": 1, "seq_len": 3}
    fwd, bwd = yardstick.k3_bounds_s(model, traffic)
    pairs, stats = 6, 4 * 2 * 2 * 3
    assert fwd == pytest.approx(max(4 * 4 * 2 * pairs / 989e12,
                                    (2 * (2 * 24 + 2 * 12) + stats) / 3.35e12))
    assert bwd == pytest.approx(max(10 * 4 * 2 * pairs / 989e12,
                                    (2 * (3 * 24 + 4 * 12) + stats) / 3.35e12))


def test_ssd_flops_one_chunk_by_hand():
    # one chunk of 64 steps, one head, P 2, N 3, one group:
    # C B^T 2*64*64*3, with x 2*64*64*2, state in / out 2*2*64*3*2
    want = 2 * 64 * 64 * 3 + 2 * 64 * 64 * 2 + 4 * 64 * 3 * 2
    assert yardstick.ssd_flops(1, 1, 1, 64, 2, 3) == want


def _dense_moe(layers):
    return {"arch_type": "moe", "num_layers": layers, "d_model": 8,
            "num_heads": 2, "num_kv_heads": 1, "head_dim": 4, "d_ff": 16,
            "vocab_size": 32, "causal": True, "sliding_window": None,
            "moe": {"num_experts": 4, "top_k": 2},
            "lora": {"rank": 2, "targets": ["q", "v"]}}


def test_useful_flops_of_one_moe_layer_by_hand():
    t, s = 6, 3                     # 2 rows of 3 tokens
    traffic = {"batch": 2, "seq_len": s}
    d, h, kv, hd, f, v, e, r = 8, 2, 1, 4, 16, 32, 4, 2
    head = 2 * (2 * t * d * v)
    # layer 0: q, k, v read the frozen embedding's norm: forward only
    proj = 2 * t * d * (h * hd + 2 * kv * hd) + 2 * (2 * t * h * hd * d)
    # LoRA q (N 8) and v (N 4), x needs no gradient: forward xA, (xA)B;
    # backward d(xA), dB, dA
    lora = sum(2 * t * d * r * 2 + 2 * t * r * n * 3 for n in (8, 4))
    pairs = 2 * 6                   # 2 rows x 6 causal pairs
    # forward 4 D; backward dQ, dP (q needs one), dV: 6 D
    attn = (4 + 6) * hd * h * pairs
    router = 2 * (2 * t * d * e)
    experts = 2 * (3 * 2 * (t * 2) * d * f)
    want = head + proj + lora + attn + router + experts
    assert yardstick.useful_flops(_dense_moe(1), traffic) == want


def test_a_later_layer_adds_every_input_gradient():
    traffic = {"batch": 2, "seq_len": 3}
    one = yardstick.useful_flops(_dense_moe(1), traffic)
    two = yardstick.useful_flops(_dense_moe(2), traffic)
    t, d, h, kv, hd, r = 6, 8, 2, 1, 4, 2
    extra = (2 * t * d * (h * hd + 2 * kv * hd)          # q k v input grads
             + sum(2 * t * d * r for _ in (8, 4))        # LoRA dx
             + 2 * hd * h * 2 * 6)                       # dK
    head = 2 * (2 * t * d * 32)
    assert two - one == (one - head) + extra


def test_k2_launches_match_the_programs_count():
    """Each LoRA forward twice (remat full), dx where the input needs a
    gradient: q and v lose layer 0's, Mamba-2's in_proj too, out_proj
    keeps it (chip_smoke's launch counts for these architectures)."""
    moe = catalog.config("mixtral-8x22b-l8")["model"]
    ssm = catalog.config("mamba2-370m")["model"]
    t = catalog.traffic("lora.b8s1k")
    assert sum(n for _, *_, n in yardstick.k2_launches(moe, t)) == 32 + 14
    t = catalog.traffic("lora.b24s2k")
    assert sum(n for _, *_, n in yardstick.k2_launches(ssm, t)) == 192 + 95
