"""The model layer of the port, dense, SSM and hybrid families (the
reference's ``repro.models``)."""
from repro_torch.models.transformer import (cache_axes, decode_step, forward,
                                            init_cache, init_model,
                                            init_params, prefill)

__all__ = ["cache_axes", "decode_step", "forward", "init_cache", "init_model",
           "init_params", "prefill"]
