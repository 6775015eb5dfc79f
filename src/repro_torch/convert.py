"""Carry state across from the JAX reference: its objects, read as numpy
arrays, become the port's tensors on a given device, and a port selector
state goes back to numpy so a stream begun in one package can continue in
the other. Duck-typed on field names, so this module imports nothing of the
reference."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import fast_sim, selector
from repro_torch.device import to_device

_POOL_DTYPES = {"kind": torch.int32, "omega": torch.int32, "v": torch.int32,
                "sigma": torch.float32, "rho": torch.float32,
                "cfrac": torch.float32}
_EG_DTYPES = (torch.float32, torch.float32, torch.int32, torch.float32,
              torch.float32)


def pool_arrays(pool: dict, device) -> dict:
    """A ``specs_to_arrays`` pool dict -> the port's pool dict of tensors.
    Keys the single-region port does not read (the region slots) are
    dropped."""
    return {k: to_device(pool[k], dt, device)
            for k, dt in _POOL_DTYPES.items() if k in pool}


def job_arrays(jobs, device) -> fast_sim.JobArrays:
    """The reference's stacked ``fast_sim.JobArrays`` -> the port's."""
    return fast_sim.jobs_to(
        fast_sim.JobArrays(*[np.asarray(getattr(jobs, f))
                             for f in fast_sim.JobArrays._fields]),
        device,
    )


def eg_state(state, device) -> selector.EGState:
    """The reference's ``selector.EGState`` -> the port's."""
    return selector.EGState(*[
        to_device(np.asarray(getattr(state, f)), dt, device)
        for f, dt in zip(selector.EGState._fields, _EG_DTYPES)
    ])


def eg_state_to_numpy(state: selector.EGState) -> dict:
    """A port ``EGState`` -> ``{field: numpy array}``; the reference takes
    it back as ``EGState(**fields)``."""
    return {f: getattr(state, f).detach().cpu().numpy()
            for f in selector.EGState._fields}
