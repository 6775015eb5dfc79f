"""The step's share of the card's bf16 peak: the useful operations of the
traced steps (``yardstick.useful_flops``: no recompute, no frozen-weight
gradient) over their wall time at 989e12 FLOP/s."""
from port_bench import yardstick

UNIT = "%"
LAYER = "train step (train/step, optim/adamw)"
MOVES = "train_tokens_per_s"


def read(s):
    flops = yardstick.useful_flops(s["model"], s["traffic"]) * s["steps"]
    return 100.0 * flops / (s["window_s"] * yardstick.PEAK_FLOPS)
