"""The SSD scan's share of its roofline: K4's forward launches (the
forward and the recompute) and its backward launches at their bounds, over
the device time of K4 and of the ``K4 backward`` range's kernels. Silent
where the trace holds another count of launches than the configuration
gives, or none."""
import sys

from port_bench import yardstick

UNIT = "%"
LAYER = "kernels: SSD scan (kernels/ssd_scan, K4 and its backward)"
MOVES = "train_tokens_per_s"


def read(s):
    model = s["model"]
    if model.get("ssm") is None or not s["class_s"]["ssd"]:
        return None
    n = model["num_layers"] * s["steps"]
    got = (s["named"].get("ssd_scan_|", 0),
           s["range_spans"].get("K4 backward", 0))
    if got != (2 * n, n):
        print(f"roofline_pct.ssd_scan: K4 forward / backward launches "
              f"{got}, the configuration gives {(2 * n, n)}: not read",
              file=sys.stderr)
        return None
    fwd, bwd = yardstick.k4_bounds_s(model, s["traffic"])
    return 100.0 * n * (2 * fwd + bwd) / s["class_s"]["ssd"]
