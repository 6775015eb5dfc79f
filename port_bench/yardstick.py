"""The benchmark's yardstick: the card's peaks, and the operations and
bytes of a training step and of each kernel launch in it, worked out from
a configuration's shapes and a traffic mix.

Peaks are NVIDIA's data sheet for one H100 SXM (dense bf16 tensor cores,
HBM3), at the full 700 W. A launch's bound is the larger of its
operations over the peak rate and its bytes over the HBM rate, each input
read once and each output written once, at the operation's own shapes
(K and V at their KV heads under GQA, whatever copies an implementation
makes).

``useful_flops`` is what a step has to compute: every forward matrix
product, the input gradient of every product whose input needs one, the
LoRA factors' weight gradients, attention at its unmasked pairs (2 D a
pair for each of q k^T and p v forward, as much again for each operand
that needs a gradient), and the SSD scan as the products of its chunked
form over CHUNK steps (its backward twice that). No product is counted
twice for a recompute, and the frozen weights have no gradient. The
depthwise conv, norms and elementwise ops are not products and are not
counted.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12           # bf16 FLOP/s, dense tensor cores
HBM_BYTES_PER_S = 3.35e12
CHUNK = 64                    # SSD chunk of the yardstick's scan count
BF16, F32 = 2, 4


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)


def attention_pairs(s: int, causal: bool, window) -> int:
    """Unmasked (query, key) pairs of one head over a sequence of s."""
    if not causal:
        if window is not None:
            raise ValueError("a window on non-causal attention")
        return s * s
    w = s if window is None else min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def ssd_flops(bt, h, g, s, p, n) -> int:
    """The SSD scan's products over chunks of CHUNK steps: the score tile
    C B^T once a group, and per head its product with x, C against the
    entering state and the state each chunk leaves."""
    c = CHUNK
    return bt * -(-s // c) * 2 * (g * c * c * n
                                  + h * (c * c * p + 2 * c * n * p))


def ssd_backward_flops(bt, h, g, s, p, n) -> int:
    """The scan's gradient from its inputs and the output's gradient: per
    chunk and group three score-shaped products over N, per chunk and head
    dy x^T, M^T dy and four state-sized products, and per head the state
    recurrence again for every chunk but the last."""
    c, nc = CHUNK, -(-s // CHUNK)
    per_group = 3 * c * c * n
    per_head = 2 * c * c * p + 4 * c * n * p
    return bt * 2 * (nc * (g * per_group + h * per_head)
                     + h * max(nc - 1, 0) * c * n * p)


def lora_projections(model: dict) -> list:
    """(name, K, N, input needs a gradient in layer 0) of every LoRA
    projection a layer has. A projection that reads the layer's normalised
    input takes no input gradient in layer 0: the embedding is frozen."""
    if model["arch_type"] == "ssm":
        d = model["d_model"]
        di = model["ssm"]["expand"] * d
        return [("in", d, di, False), ("out", di, d, True)]
    d, h, kv, hd = (model["d_model"], model["num_heads"],
                    model["num_kv_heads"], model["head_dim"])
    shapes = {"q": (d, h * hd, False), "k": (d, kv * hd, False),
              "v": (d, kv * hd, False), "o": (h * hd, d, True)}
    return [(t, *shapes[t]) for t in model["lora"]["targets"]]


def k2_launches(model: dict, traffic: dict) -> list:
    """(kind, M, K, N, r, launches a step) of K2 in a remat-full training
    step: each forward twice (the recompute), dx once where the input needs
    a gradient. K and N of a dx launch are its forward's."""
    m = traffic["batch"] * traffic["seq_len"]
    r, n_layers = model["lora"]["rank"], model["num_layers"]
    out = []
    for _, k, n, first in lora_projections(model):
        out.append(("forward", m, k, n, r, 2 * n_layers))
        out.append(("dx", m, k, n, r, n_layers - (0 if first else 1)))
    return out


def k2_bound_s(kind, m, k, n, r) -> float:
    """y = x W + s (x A) B, or dx = dy W^T + s (dy B^T) A^T, all bf16."""
    flops = 2 * m * k * n + 2 * m * k * r + 2 * m * r * n
    return bound_s(flops, BF16 * (m * k + k * n + k * r + r * n + m * n))


def attention_shapes(model: dict, traffic: dict) -> dict:
    return {"b": traffic["batch"], "s": traffic["seq_len"],
            "h": model["num_heads"], "kv": model["num_kv_heads"],
            "d": model["head_dim"],
            "pairs": attention_pairs(traffic["seq_len"],
                                     model.get("causal", True),
                                     model.get("sliding_window"))}


def k3_bounds_s(model: dict, traffic: dict) -> tuple:
    """(forward, backward) bound of one launch over the batch: the forward
    writes o and each row's max and sum; the backward reads q, k, v, dO and
    the row statistics and writes dq, dk, dv, with q k^T recomputed (10 D
    a pair)."""
    a = attention_shapes(model, traffic)
    b, s, h, kv, d, pairs = (a["b"], a["s"], a["h"], a["kv"], a["d"],
                             a["pairs"])
    stats = F32 * 2 * b * h * s
    fwd = bound_s(4 * d * b * h * pairs,
                  BF16 * (2 * b * h * s * d + 2 * b * kv * s * d) + stats)
    bwd = bound_s(10 * d * b * h * pairs,
                  BF16 * (3 * b * h * s * d + 4 * b * kv * s * d) + stats)
    return fwd, bwd


def ssm_shapes(model: dict, traffic: dict) -> tuple:
    s = model["ssm"]
    di = s["expand"] * model["d_model"]
    return (traffic["batch"], di // s["head_dim"], s["n_groups"],
            traffic["seq_len"], s["head_dim"], s["state_size"])


def k4_bounds_s(model: dict, traffic: dict) -> tuple:
    """(forward, backward) bound of one launch: x, y, B, C (per group) in
    bf16; dt, A and the final state in f32; the backward reads x, B, C, dt,
    A, dy and the state's gradient and writes dx, dB, dC, d(dt), dA."""
    bt, h, g, s, p, n = ssm_shapes(model, traffic)
    bh = bt * h
    fwd = bound_s(ssd_flops(bt, h, g, s, p, n),
                  BF16 * (2 * bh * s * p + 2 * bt * g * s * n)
                  + F32 * (bh * s + h + bh * n * p))
    bwd = bound_s(ssd_backward_flops(bt, h, g, s, p, n),
                  BF16 * (3 * bh * s * p + 4 * bt * g * s * n)
                  + F32 * (2 * bh * s + 2 * h + bh * n * p))
    return fwd, bwd


def _product(t: int, k: int, n: int, input_grad: bool) -> int:
    return 2 * t * k * n * (2 if input_grad else 1)


def _lora(t, k, n, r, input_grad) -> int:
    """Forward x A and (x A) B; backward d(xA), dB, dA and, where x needs
    one, dx."""
    return 2 * t * k * r * (3 if input_grad else 2) + 2 * t * r * n * 3


def useful_flops(model: dict, traffic: dict) -> int:
    """The operations one training step has to do (module docstring)."""
    t = traffic["batch"] * traffic["seq_len"]
    d, v, n_layers = model["d_model"], model["vocab_size"], \
        model["num_layers"]
    r = model["lora"]["rank"]
    total = _product(t, d, v, True)                   # the head
    for layer in range(n_layers):
        later = layer > 0
        for _, k, n, first in lora_projections(model):
            total += _lora(t, k, n, r, later or first)
        if model["arch_type"] == "ssm":
            bt, h, g, s, p, n_state = ssm_shapes(model, traffic)
            di = h * p
            for n in (di, di, g * n_state, g * n_state, h):  # z x B C dt
                total += _product(t, d, n, later)
            total += _product(t, di, d, True)          # out_proj
            total += 3 * ssd_flops(bt, h, g, s, p, n_state)
            continue
        a = attention_shapes(model, traffic)
        h, kv, hd = a["h"], a["kv"], a["d"]
        lora = set(model["lora"]["targets"])
        for n in (h * hd, kv * hd, kv * hd):           # q k v
            total += _product(t, d, n, later)
        total += _product(t, h * hd, d, True)           # o
        grad = {x: later or x in lora for x in "qkv"}
        per_pair = 4 + 2 * (grad["q"] + grad["k"]
                            + (grad["q"] or grad["k"]) + grad["v"])
        total += per_pair * hd * a["b"] * h * a["pairs"]
        moe = model["moe"]
        total += _product(t, d, moe["num_experts"], True)   # the router
        total += 3 * _product(t * moe["top_k"], d, model["d_ff"], True)
    return total
