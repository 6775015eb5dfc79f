"""Device ms a step of the kernels whose innermost program range is
``head`` (the logits' product, their f32 cast; the final norm counts
under ``norm``) or ``loss`` (the cross-entropy over every position's
logits and the MoE aux loss), forward and backward half."""
from port_bench import ranges

UNIT = "ms"
LAYER = "head and loss (models/transformer.forward, train/step._loss)"
MOVES = "train_tokens_per_s"


def read(s):
    r = ranges.of(s, "head_loss_ms_per_step")
    if r is None:
        return None
    return 1e3 * ranges.device_in(r, ranges.halves("head", "loss")) / r["steps"]
