"""Device ms a step in kernels that are neither the library's matrix
products nor the program's K2-K4, nor inside the ranges another metric
reads: the model layers' own PyTorch ops (norms, rotary positions, the
conv and gated norm, casts, residuals, the loss, the optimizer)."""
UNIT = "ms"
LAYER = "model layers' torch ops (models/common, models/ssm, models/rope, train/losses)"
MOVES = "train_tokens_per_s"


def read(s):
    return 1e3 * s["class_s"]["elementwise"] / s["steps"]
