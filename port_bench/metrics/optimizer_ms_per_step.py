"""Device ms a step from the first to the last kernel of the ``optim``
range (the global-norm clip and AdamW over the LoRA leaves), the gaps
between them included: its many small launches pace it."""
from port_bench import ranges

UNIT = "ms"
LAYER = "optimizer (train/step._apply, optim/adamw)"
MOVES = "train_tokens_per_s"


def read(s):
    r = ranges.of(s, "optimizer_ms_per_step")
    if r is None:
        return None
    return 1e3 * r["span_s"].get("optim", 0.0) / r["steps"]
