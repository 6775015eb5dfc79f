"""Device idle ms a step while a host thread was inside a decoder layer
(``block`` or ``block backward``) at the gap's middle: the layers'
launches failing to keep the card busy."""
from port_bench import ranges

UNIT = "ms"
LAYER = "decoder layers (models/blocks)"
MOVES = "train_tokens_per_s"


def read(s):
    r = ranges.of(s, "layer_idle_ms_per_step")
    if r is None:
        return None
    return 1e3 * ranges.idle_in(r, ranges.halves("block")) \
        / r["steps"]
