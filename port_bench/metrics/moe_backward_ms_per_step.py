"""Device ms a step of the kernels inside the backward halves of the MoE
layer's four stages (``moe route`` / ``dispatch`` / ``experts`` /
``combine backward``): the backward that ``moe_ms_per_step`` leaves to
the classes by name. Remat's recompute inside them counts under the
forward ranges."""
from port_bench import ranges

UNIT = "ms"
LAYER = "MoE layer (models/moe.apply_moe)"
MOVES = "train_tokens_per_s"


def read(s):
    r = ranges.of(s, "moe_backward_ms_per_step")
    if r is None:
        return None
    return 1e3 * ranges.device_in(r, [
        f"moe {n} backward" for n in ("route", "dispatch", "experts",
                                      "combine")]) / r["steps"]
