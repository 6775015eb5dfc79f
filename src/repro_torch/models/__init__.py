"""The model layer of the port, dense, SSM and hybrid families (the
reference's ``repro.models``)."""
from repro_torch.models.transformer import (decode_step, forward, init_cache,
                                            init_params, prefill)

__all__ = ["decode_step", "forward", "init_cache", "init_params", "prefill"]
