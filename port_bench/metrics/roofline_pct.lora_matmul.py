"""K2's share of its roofline: the sum of each forward and dx launch's
bound over the device time of those launches and of the W^T copies made
for dx. Silent where the trace holds another count of K2 launches than
the configuration gives."""
import sys

from port_bench import yardstick

UNIT = "%"
LAYER = "kernels: LoRA projection (kernels/lora_matmul, K2)"
MOVES = "train_tokens_per_s"


def read(s):
    launches = yardstick.k2_launches(s["model"], s["traffic"])
    want = {"": 0, "K2 backward dx": 0}
    bound = 0.0
    for kind, m, k, n, r, count in launches:
        want["" if kind == "forward" else "K2 backward dx"] += \
            count * s["steps"]
        bound += count * s["steps"] * yardstick.k2_bound_s(kind, m, k, n, r)
    got = {rng: s["named"].get(f"lora_|{rng}", 0) for rng in want}
    if got != want or not s["class_s"]["lora"]:
        print(f"roofline_pct.lora_matmul: K2 kernels {got}, the "
              f"configuration gives {want}: not read", file=sys.stderr)
        return None
    return 100.0 * bound / s["class_s"]["lora"]
