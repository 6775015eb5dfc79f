"""The share of the traced steps' wall time in which no device activity
ran on the card."""
UNIT = "%"
LAYER = "device"
MOVES = "train_tokens_per_s"


def read(s):
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
