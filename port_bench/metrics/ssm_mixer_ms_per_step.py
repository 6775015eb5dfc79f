"""Device ms a step of the kernels whose innermost program range is the
Mamba-2 mixer's own (``ssm mixer``, ``ssm conv``, ``ssm gated norm``:
forward, recompute and backward half): the mixer less its products
through ``ops.lora_matmul`` (K2) and ``ops.ssd`` (K4). Its frozen
projections (z, B, C, dt), the f32 causal conv, softplus, the D skip and
the gated norm, and their backward."""
from port_bench import ranges

UNIT = "ms"
LAYER = "Mamba-2 mixer (models/ssm.apply_mamba)"
MOVES = "train_tokens_per_s"


def read(s):
    r = ranges.of(s, "ssm_mixer_ms_per_step")
    if r is None:
        return None
    return 1e3 * ranges.device_in(r, ranges.halves(
        "ssm mixer", "ssm conv", "ssm gated norm")) / r["steps"]
