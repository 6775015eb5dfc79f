"""Attention's share of its roofline: K3's forward launches (the forward
and the recompute) and its backward launches at their bounds, over the
device time of K3, of the ``K3 backward`` range's kernels and of the K / V
copies to every query head. Silent where the trace holds another count of
launches than the configuration gives, or none."""
import sys

from port_bench import yardstick

UNIT = "%"
LAYER = "kernels: attention (kernels/flash_attention, K3 and its backward)"
MOVES = "train_tokens_per_s"


def read(s):
    model = s["model"]
    if not model.get("num_heads") or not s["class_s"]["attention"]:
        return None
    n = model["num_layers"] * s["steps"]
    got = (s["named"].get("flash_fwd_|", 0),
           s["range_spans"].get("K3 backward", 0))
    if got != (2 * n, n):
        print(f"roofline_pct.attention: K3 forward / backward launches "
              f"{got}, the configuration gives {(2 * n, n)}: not read",
              file=sys.stderr)
        return None
    fwd, bwd = yardstick.k3_bounds_s(model, s["traffic"])
    return 100.0 * n * (2 * fwd + bwd) / s["class_s"]["attention"]
