"""Device ms a step of the kernels inside the MoE layer's four ranges
(route, dispatch, experts, combine): its forward and the recompute."""
UNIT = "ms"
LAYER = "MoE layer (models/moe.apply_moe)"
MOVES = "train_tokens_per_s"


def read(s):
    if s["model"].get("moe") is None or not s["class_s"]["moe"]:
        return None
    return 1e3 * s["class_s"]["moe"] / s["steps"]
