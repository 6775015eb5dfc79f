"""The sharded dry run's stand-ins computed on real values: one-token decode
against the ring cache (``stand_ins._decode_attend``), the Mamba2 causal
conv (``_causal_conv``) and its decode step's SSD update (``_ssd_step``),
each run on DTensors over a (2, 2) ("data", "model") mesh of four gloo ranks
on the CPU, gathered, and held against the model's own function on the
whole tensors.

The inputs are drawn from numpy at seed 0 on every rank. The conv and the
SSD step do the same arithmetic per element as the plain functions, so they
are held bit for bit; the decode's softmax is split across the cache slots
(maximum, sum and weighted values reduced across the split), which changes
the summation order: f32 within rtol 1e-5, atol 1e-6. The decode cases
cover a ring cache with empty slots (index below the width), a wrapped
ring, and a sliding window over both.

The ranks run as processes of the test (a ``file://`` rendezvous in
``tmp_path``, a timeout on each), as ``tests/test_torch_sharded.py`` runs
its own; rank 0 writes each case's gathered result and the plain one."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 120  # seconds, each rank's process
RTOL, ATOL = 1e-5, 1e-6

# name -> (sliding window, cache width, tokens written): slots at and past
# the index are empty below the width; the window masks the oldest slots
DECODE = {
    "empty_slots": (None, 16, 10),
    "wrapped": (None, 16, 37),
    "window_wrapped": (6, 8, 21),
    "window_empty_slots": (6, 8, 5),
}
# name -> (dtype, xbc's channel placement on "model" as it arrives)
CONV = {
    "f32_whole": ("float32", "whole"),
    "f32_split": ("float32", "split"),
    "bf16_whole": ("bfloat16", "whole"),
    "bf16_split": ("bfloat16", "split"),
}

# Runs as every rank. argv: rank, world, rendezvous file, out .npz.
_WORKER = r'''
import datetime, json, sys, types
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, rdv, out_path = int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:5]
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=120))
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.launch import stand_ins
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.sharding import named_sharding, use_sharding

DECODE, CONV = json.loads(sys.argv[5]), json.loads(sys.argv[6])
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
rng = np.random.default_rng(0)
plain = {"decode": attn.decode_attend, "conv": ssm._causal_conv,
         "step": ssm.ssd_step}
res = {}


def normal(*shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))


def laid_out(t, axes):
    """``t`` as a DTensor laid out by its logical axes; each rank slices
    its own block."""
    return distribute_tensor(t, mesh, named_sharding(axes, t.shape)[1],
                             src_data_rank=None)


def keep(name, got, want):
    res[name + ".got"] = got.full_tensor().float().numpy()
    res[name + ".want"] = want.float().numpy()


with use_sharding(mesh), stand_ins.installed():
    kv_axes = ("batch", "kv_seq", "kv_heads", None)
    for name, (window, width, index) in DECODE.items():
        cfg = types.SimpleNamespace(sliding_window=window)
        q, k, v = normal(4, 1, 4, 16), normal(4, width, 2, 16), \
            normal(4, width, 2, 16)
        got = attn.decode_attend(
            cfg, laid_out(q, ("batch", "seq", "heads", None)),
            laid_out(k, kv_axes), laid_out(v, kv_axes), index)
        keep("decode." + name, got, plain["decode"](cfg, q, k, v, index))
    for name, (dtype, arrives) in CONV.items():
        dt = getattr(torch, dtype)
        xbc, w, b = normal(4, 12, 24).to(dt), (0.3 * normal(24, 4)).to(dt), \
            normal(24).to(dt)
        pl = (Shard(0), Shard(2) if arrives == "split" else Replicate())
        got = ssm._causal_conv(
            distribute_tensor(xbc, mesh, pl, src_data_rank=None),
            laid_out(w, ("tensor", None)), laid_out(b, ("tensor",)))
        keep("conv." + name, got, plain["conv"](xbc, w, b))
    state, x_t = normal(4, 4, 8, 16), normal(4, 4, 8)
    dt_t = torch.nn.functional.softplus(normal(4, 4))
    A = -torch.exp(normal(4))
    B_t, C_t = normal(4, 1, 16), normal(4, 1, 16)
    got = ssm.ssd_step(
        laid_out(state, ("batch", "ssm_heads", None, None)),
        laid_out(x_t, ("batch", "ssm_heads", None)),
        laid_out(dt_t, ("batch", "ssm_heads")), laid_out(A, ("ssm_heads",)),
        laid_out(B_t, ("batch", None, None)),
        laid_out(C_t, ("batch", None, None)))
    want = plain["step"](state, x_t, dt_t, A, B_t, C_t)
    for part, g, wt in zip(("state", "y"), got, want):
        keep("step." + part, g, wt)
if rank == 0:
    np.savez(out_path, **res)
dist.destroy_process_group()
print(f"RANK-{rank}-OK")
'''


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Rank 0's gathered stand-in results and the plain ones, by case."""
    tmp = tmp_path_factory.mktemp("stand_ins_values")
    worker = tmp / "worker.py"
    worker.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("JAX_PLATFORMS", None)
    rdv, out = tmp / "rendezvous", tmp / "rank0.npz"
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), "4", str(rdv), str(out),
         json.dumps(DECODE), json.dumps(CONV)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    t0 = time.perf_counter()
    try:
        logs = [p.communicate(timeout=RANK_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert time.perf_counter() - t0 < RANK_TIMEOUT
    for r, (p, (so, se)) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"RANK-{r}-OK" in so, \
            f"rank {r} rc {p.returncode}\n{so}\n{se[-4000:]}"
    return dict(np.load(out))


@pytest.mark.parametrize("case", list(DECODE))
def test_decode_attend_split_softmax_matches_plain(results, case):
    got, want = results[f"decode.{case}.got"], results[f"decode.{case}.want"]
    assert got.shape == want.shape == (4, 1, 4, 16)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", list(CONV))
def test_causal_conv_blockwise_is_bit_equal(results, case):
    got, want = results[f"conv.{case}.got"], results[f"conv.{case}.want"]
    assert got.shape == want.shape == (4, 12, 24)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("part", ["state", "y"])
def test_ssd_step_blockwise_is_bit_equal(results, part):
    np.testing.assert_array_equal(results[f"step.{part}.got"],
                                  results[f"step.{part}.want"])
