"""Where the port's entry points run."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA card.

    Entry points run on the card unless the caller names another device
    (the CPU tests pass ``device="cpu"``). Without a card and without an
    explicit device this raises: nothing quietly runs on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry points run on a CUDA device by default and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the CPU"
        )
    return torch.device("cuda")


def to_device(x, dtype: torch.dtype, device) -> torch.Tensor:
    """A tensor, numpy array or python number as a ``dtype`` tensor on
    ``device`` (host arrays are copied, so read-only views are fine)."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)
