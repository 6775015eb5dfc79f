"""K1 and the port's entry points on a CUDA card, against the plain PyTorch
path. Imports neither JAX nor the JAX package, so it also runs where JAX is
not installed:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Every test skips, saying why, when no CUDA device is present."""
import numpy as np
import pytest
import torch

from repro_torch.core import engine, window_opt
from repro_torch.core.policy_pool import (baseline_specs, paper_pool,
                                          rand_deadline_pool, specs_to_arrays)
from repro_torch.kernels.ref import window_dp_ref
from repro_torch.kernels.window_dp import window_dp
from repro_torch.workload import PAPER_TPUT, job_stream_arrays, paper_market

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 is a CUDA kernel with no CPU "
                    "mode (chip_smoke.py runs these checks on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tables(b, w1, tn):
    rng = np.random.default_rng(b * 131 + w1)
    kw, u1 = tn + 1, w1 * tn + 1
    slot_cost = rng.uniform(0.0, 3.0, (b, w1, kw)).astype(np.float32)
    slot_cost = np.where(rng.random((b, w1, kw)) < 0.3, 1.0e9, slot_cost)
    slot_cost[:, :, 0] = 0.0
    gain = np.cumsum(rng.uniform(0.0, 2.0, (b, u1)), axis=1).astype(
        np.float32)
    return torch.from_numpy(slot_cost), torch.from_numpy(gain)


@pytest.mark.parametrize("b,w1,tn", [(1, 6, 16), (8, 6, 16), (13, 3, 5),
                                     (40, 1, 4), (4096, 6, 16)])
def test_k1_bit_equal_to_plain_dp(cuda, b, w1, tn):
    c, g = _tables(b, w1, tn)
    before = window_dp.launches
    n_k, o_k = window_dp(c.to(cuda), g.to(cuda))
    torch.cuda.synchronize()
    assert window_dp.launches == before + 1
    n_r, o_r = window_dp_ref(c, g)
    assert torch.equal(n_k.cpu(), n_r)
    assert torch.equal(o_k.cpu(), o_r)


def test_k1_rejects_what_it_does_not_take(cuda):
    c, g = _tables(8, 6, 16)
    c, g = c.to(cuda), g.to(cuda)
    with pytest.raises(TypeError, match="float32"):
        window_dp(c.double(), g)
    with pytest.raises(ValueError, match="contiguous"):
        window_dp(c.transpose(1, 2).contiguous().transpose(1, 2), g)
    with pytest.raises(ValueError, match="does not match"):
        window_dp(c, g[:, :-1].contiguous())
    with pytest.raises(ValueError, match="one CUDA device"):
        window_dp(c, g.cpu())


def test_solve_window_batch_cuda_equals_cpu(cuda):
    """The unit-cost tables built on the card and solved by K1 give the CPU
    plain path's bits."""
    rng = np.random.default_rng(0)
    b = 3000
    prices = rng.uniform(0.05, 1.5, (b, 6)).astype(np.float32)
    avail = rng.integers(0, 17, (b, 6)).astype(np.int32)
    z0 = rng.uniform(0, 120, b).astype(np.float32)
    std = rng.integers(0, 7, b).astype(np.int32)
    jobs = job_stream_arrays(rng, b)
    from repro_torch.configs.base import JobConfig
    job = JobConfig(workload=jobs.workload, deadline=jobs.deadline,
                    n_min=jobs.n_min, n_max=jobs.n_max, value=jobs.value,
                    gamma=jobs.gamma, on_demand_price=jobs.p_o)
    got = window_opt.solve_window_batch(job, PAPER_TPUT, z0, std, prices,
                                        avail, jobs.p_o, 16)
    want = window_opt.solve_window_batch(job, PAPER_TPUT, z0, std, prices,
                                         avail, jobs.p_o, 16, device="cpu")
    for x, y in zip(got, want):
        assert x.device.type == "cuda"
        assert torch.equal(x.cpu(), y)


def test_engine_cuda_matches_cpu(cuda):
    """simulate_and_select on the card (K1) against the CPU plain path on
    the 124-lane pool: allocations and utilities bit-equal (elementwise
    IEEE ops and a bit-equal DP); the EG weights to f32 tolerance (sums and
    exp/log differ between the CPU and CUDA libraries)."""
    rng = np.random.default_rng(7)
    trace = paper_market(seed=21, days=40)
    jobs = job_stream_arrays(rng, 64)
    t0s = rng.integers(0, len(trace) - 11, size=64)
    prices, avail, preds = engine.prepare_noisy_inputs(
        trace, t0s, 10, "fixed_heavytail", 0.3, 11 + np.arange(64))
    pool = specs_to_arrays(paper_pool() + rand_deadline_pool()
                           + baseline_specs())
    before = window_dp.launches
    got = engine.simulate_and_select(pool, jobs, PAPER_TPUT, prices, avail,
                                     preds, return_utilities=True)
    assert window_dp.launches == before + 10
    want = engine.simulate_and_select(pool, jobs, PAPER_TPUT, prices, avail,
                                      preds, device="cpu",
                                      return_utilities=True)
    np.testing.assert_array_equal(got.utilities, want.utilities)
    assert got.best_policy() == want.best_policy()
    assert got.iters_to_half() == want.iters_to_half()
    np.testing.assert_allclose(got.max_weight, want.max_weight, atol=1e-6)
