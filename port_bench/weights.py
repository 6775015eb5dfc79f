"""The benchmark's weights, drawn on the device from ``--seed``.

Every tensor a model configuration names is drawn here, by the benchmark,
so that the program and the plain reference start from the same values and
the reference takes nothing the program made. The leaves are grouped (the
embedding, the head, the final norm, each layer); a group is drawn from its
own generator, seeded by (seed, group name), in a few large calls in the
type the tensor is served in: one normal draw for the group's model-dtype
leaves, one for its f32 leaves, one uniform draw for the leaves that take a
uniform init. Each leaf is then a view of those buffers, scaled in place.
So the reference can draw any one group again, alone, and get the same
bits: it never holds more than one layer at a time.

A leaf's path is the port's path of that parameter ("layers/3/attn/wq"),
so :func:`program_tree` nests the flat dict into the tree the port's train
step takes. Inits (fan-in scaled normals, norm scales 1 + N(0, 0.1), LoRA
B ~ N(0, 0.02) so that A's first gradient is not zero, Mamba-2's published
A and dt inits) are chosen so that a random model's activations stay of
order one through its depth.
"""
from __future__ import annotations

import hashlib
import math

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LORA_B_STD = 0.02
AFFINE_STD = 0.1
_ALIGN = 128            # elements between two leaves of a buffer


def seed_for(seed: int, *tags) -> int:
    """A 63-bit generator seed for ``tags`` under the run's ``seed``."""
    text = "/".join(str(t) for t in (seed, *tags))
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") & (2 ** 63 - 1)


def _normal(shape, std, dtype):
    return (tuple(shape), dtype, ("normal", std))


def _attention(m, dt) -> dict:
    d, h, kv, hd, r = (m["d_model"], m["num_heads"], m["num_kv_heads"],
                       m["head_dim"], m["lora"]["rank"])
    out = {"wq": _normal((d, h, hd), d ** -0.5, dt),
           "wk": _normal((d, kv, hd), d ** -0.5, dt),
           "wv": _normal((d, kv, hd), d ** -0.5, dt),
           "wo": _normal((h, hd, d), (h * hd) ** -0.5, dt)}
    shapes = {"q": (h, hd), "k": (kv, hd), "v": (kv, hd), "o": (d,)}
    for t in m["lora"]["targets"]:
        fan_in = h * hd if t == "o" else d
        out[f"lora/{t}/a"] = _normal((fan_in, r), fan_in ** -0.5,
                                     torch.float32)
        out[f"lora/{t}/b"] = _normal((r, *shapes[t]), LORA_B_STD,
                                     torch.float32)
    return out


def _norm(m, dt) -> tuple:
    return ((m["d_model"],), dt, ("one_plus", AFFINE_STD))


def _moe_layer(m, dt) -> dict:
    d, f, e = m["d_model"], m["d_ff"], m["moe"]["num_experts"]
    leaves = {"attn_norm/scale": _norm(m, dt), "mlp_norm/scale": _norm(m, dt),
              "moe/router": _normal((d, e), 0.02, torch.float32),
              "moe/w1": _normal((e, d, f), d ** -0.5, dt),
              "moe/w3": _normal((e, d, f), d ** -0.5, dt),
              "moe/w2": _normal((e, f, d), f ** -0.5, dt)}
    leaves.update({f"attn/{k}": v for k, v in _attention(m, dt).items()})
    return leaves


def ssm_sizes(m) -> dict:
    s, d = m["ssm"], m["d_model"]
    di = s["expand"] * d
    return {"d": d, "di": di, "H": di // s["head_dim"], "P": s["head_dim"],
            "G": s["n_groups"], "N": s["state_size"], "wc": s["conv_width"],
            "conv": di + 2 * s["n_groups"] * s["state_size"]}


def _ssm_layer(m, dt) -> dict:
    z = ssm_sizes(m)
    d, di, H, G, N, r = z["d"], z["di"], z["H"], z["G"], z["N"], \
        m["lora"]["rank"]
    f32 = torch.float32
    mamba = {"wz": _normal((d, di), d ** -0.5, dt),
             "wx": _normal((d, di), d ** -0.5, dt),
             "wB": _normal((d, G, N), d ** -0.5, dt),
             "wC": _normal((d, G, N), d ** -0.5, dt),
             "wdt": _normal((d, H), d ** -0.5, dt),
             "conv_w": _normal((z["conv"], z["wc"]), z["wc"] ** -0.5, dt),
             "conv_b": _normal((z["conv"],), AFFINE_STD, dt),
             # Mamba-2's init: A ~ U[1, 16], dt ~ log-uniform [1e-3, 1e-1]
             "A_log": ((H,), f32, ("log_uniform_a", 1.0, 16.0)),
             "D": ((H,), f32, ("one_plus", AFFINE_STD)),
             "dt_bias": ((H,), f32, ("dt_bias", 1e-3, 1e-1)),
             "norm_scale": ((di,), dt, ("one_plus", AFFINE_STD)),
             "out_proj": _normal((di, d), di ** -0.5, dt),
             "lora/in/a": _normal((d, r), d ** -0.5, f32),
             "lora/in/b": _normal((r, di), LORA_B_STD, f32),
             "lora/out/a": _normal((di, r), di ** -0.5, f32),
             "lora/out/b": _normal((r, d), LORA_B_STD, f32)}
    leaves = {"norm/scale": _norm(m, dt)}
    leaves.update({f"mamba/{k}": v for k, v in mamba.items()})
    return leaves


_LAYERS = {"moe": _moe_layer, "ssm": _ssm_layer}


def groups(model: dict) -> dict:
    """{group name: {path: (shape, dtype, init)}} of a configuration's
    ``model`` section, in drawing order."""
    if model["arch_type"] not in _LAYERS:
        raise ValueError(f"no weights for arch_type {model['arch_type']!r}")
    dt = DTYPES[model["dtype"]]
    d, v = model["d_model"], model["vocab_size"]
    out = {"embed": {"embed": _normal((v, d), 0.02, dt)}}
    layer = _LAYERS[model["arch_type"]]
    for i in range(model["num_layers"]):
        out[f"layers/{i}"] = {f"layers/{i}/{k}": spec
                              for k, spec in layer(model, dt).items()}
    out["final_norm"] = {"final_norm/scale": _norm(model, dt)}
    if not model.get("tie_embeddings", False):
        out["head"] = {"head": _normal((d, v), d ** -0.5, dt)}
    return out


def _init(view: torch.Tensor, init: tuple) -> None:
    kind = init[0]
    if kind == "normal":
        view.mul_(init[1])
    elif kind == "one_plus":
        view.mul_(init[1]).add_(1.0)
    elif kind == "log_uniform_a":          # log(A), A ~ U[lo, hi]
        lo, hi = init[1], init[2]
        view.mul_(hi - lo).add_(lo).log_()
    elif kind == "dt_bias":                # softplus^-1 of a log-uniform dt
        lo, hi = math.log(init[1]), math.log(init[2])
        dt = view.mul_(hi - lo).add_(lo).exp_().clamp_(min=1e-4)
        view.copy_(dt + torch.log(-torch.expm1(-dt)))
    else:
        raise ValueError(kind)


def draw_group(model: dict, seed: int, name: str, device) -> dict:
    """{path: tensor} of one group, drawn on ``device``."""
    specs = groups(model)[name]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_for(seed, "weights", name))
    buffers, spans = {}, {}
    for key in ("normal", "uniform"):
        for dtype in dict.fromkeys((DTYPES[model["dtype"]], torch.float32)):
            n = 0
            for path, (shape, dt, init) in specs.items():
                uniform = init[0] in ("log_uniform_a", "dt_bias")
                if dt != dtype or uniform != (key == "uniform"):
                    continue
                size = math.prod(shape)
                spans[path] = (key, dtype, n, size)
                n += -(-size // _ALIGN) * _ALIGN
            if n:
                draw = torch.rand if key == "uniform" else torch.randn
                buffers[key, dtype] = draw(n, generator=gen, dtype=dtype,
                                           device=device)
    out = {}
    for path, (shape, dt, init) in specs.items():
        key, dtype, at, size = spans[path]
        view = buffers[key, dtype][at:at + size].view(shape)
        _init(view, init)
        out[path] = view
    return out


def draw_all(model: dict, seed: int, device) -> dict:
    """Every group's leaves, one flat {path: tensor}."""
    out = {}
    for name in groups(model):
        out.update(draw_group(model, seed, name, device))
    return out


def is_lora(path: str) -> bool:
    return "lora" in path.split("/")


def program_tree(flat: dict) -> dict:
    """The port's parameter tree of a flat {path: tensor}: dicts, and a list
    under "layers"."""
    tree: dict = {}
    for path, x in flat.items():
        node, keys = tree, path.split("/")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = x
    tree["layers"] = [tree["layers"][str(i)]
                      for i in range(len(tree["layers"]))]
    return tree


def tree_leaves(tree, prefix: str = ""):
    """(path, leaf) of a port parameter tree, in the port's order (dict keys
    sorted, lists in order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from tree_leaves(x, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree
