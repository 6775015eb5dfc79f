"""K1, K2, K3, K4 and the port's entry points on a CUDA card, against the
plain PyTorch path. Imports neither JAX nor the JAX package, so it also runs where JAX is
not installed:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Every test skips, saying why, when no CUDA device is present."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import engine, window_opt
from repro_torch.core.window_opt import window_dp_rows_ref
from repro_torch.core.policy_pool import (baseline_specs, paper_pool,
                                          rand_deadline_pool, specs_to_arrays)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.lora_matmul import lora_matmul
from repro_torch.configs.base import JobConfig, ThroughputConfig
from repro_torch.kernels.ref import (flash_attention_ref, lora_matmul_ref,
                                     ssd_scan_grouped_ref, ssd_scan_ref,
                                     window_dp_ref)
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_grouped
from repro_torch.kernels.window_dp import window_dp, window_dp_rows
from repro_torch.workload import PAPER_TPUT, job_stream_arrays, paper_market

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1-K4 are CUDA kernels with no "
                    "CPU mode (chip_smoke.py runs these checks on the H100)")
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


def _tie_tables(b, w1, tn, seed):
    """Integer costs and gains (ties in the DP and the objective), 30% BIG,
    and half the rows with every k >= 1 priced out."""
    rng = np.random.default_rng(seed)
    kw, u1 = tn + 1, w1 * tn + 1
    cost = rng.integers(0, 4, (b, w1, kw)).astype(np.float32)
    cost = np.where(rng.random((b, w1, kw)) < 0.3, 1.0e9, cost)
    cost[: b // 2, :, 1:] = 1.0e9
    cost[:, :, 0] = 0.0
    gain = np.cumsum(rng.integers(0, 3, (b, u1)), axis=1).astype(np.float32)
    return torch.from_numpy(cost.astype(np.float32)), torch.from_numpy(gain)


@pytest.mark.parametrize("b,w1,tn", [(64, 6, 16), (5000, 6, 16),
                                     (64, 3, 5)])
def test_k1_bit_equal_on_ties_and_priced_out_rows(cuda, b, w1, tn):
    c, g = _tie_tables(b, w1, tn, b + w1)
    n_k, o_k = window_dp(c.to(cuda), g.to(cuda))
    n_r, o_r = window_dp_ref(c, g)
    assert torch.equal(n_k.cpu(), n_r)
    assert torch.equal(o_k.cpu(), o_r)


def _forecast_rows(b, w1, tn, seed, dev):
    """Forecast rows with ties (prices on a 1/8 grid), prices above p_o,
    slots past the deadline, n_min > 1 and progress past the workload, as
    (job, z0, slots_to_deadline, prices, avail) on ``dev``."""
    rng = np.random.default_rng(seed)
    cols = {
        "workload": rng.uniform(5.0, 150.0, b).astype(np.float32),
        "deadline": rng.integers(2, 12, b).astype(np.int32),
        "n_min": rng.integers(1, 4, b).astype(np.int32),
        "n_max": rng.integers(2, tn + 3, b).astype(np.int32),
        "value": rng.uniform(10.0, 300.0, b).astype(np.float32),
        "gamma": rng.uniform(1.1, 3.0, b).astype(np.float32),
        "on_demand_price": rng.choice(
            np.array([1.0, 0.875, 1.3], np.float32), b),
    }
    prices = np.round(rng.uniform(0.05, 1.6, (b, w1)) * 8) / 8
    arrays = (rng.uniform(0, 1.2 * cols["workload"]).astype(np.float32),
              rng.integers(-1, w1 + 2, b).astype(np.int32),
              prices.astype(np.float32),
              rng.integers(0, tn + 3, (b, w1)).astype(np.int32))
    job = JobConfig(**{f: torch.from_numpy(v).to(dev)
                       for f, v in cols.items()})
    return (job,) + tuple(torch.from_numpy(a).to(dev) for a in arrays)


@pytest.mark.parametrize("b,w1,tn", [(1, 6, 16), (8, 6, 16), (4096, 6, 16),
                                     (13, 3, 5), (40, 1, 4), (300, 6, 7)])
@pytest.mark.parametrize("tput", [ThroughputConfig(),
                                  ThroughputConfig(alpha=0.7, beta=0.3)],
                         ids=["paper", "odd"])
def test_k1_forecast_entry_bit_equal_to_plain_chain(cuda, b, w1, tn, tput):
    """(6, 16) runs the static kernel, the other shapes the generic one."""
    job, *rows = _forecast_rows(b, w1, tn, 31 * b + tn, cuda)
    before = (window_dp.launches, window_dp_rows.launches)
    got = window_dp_rows(job, tput, *rows, tn)
    torch.cuda.synchronize()
    assert (window_dp.launches, window_dp_rows.launches) == (
        before[0] + 1, before[1] + 1)
    want = window_dp_rows_ref(job, tput, *rows, tn)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_k1_forecast_entry_rejects_what_it_does_not_take(cuda):
    job, z0, std, prices, avail = _forecast_rows(8, 6, 16, 0, cuda)
    tput = ThroughputConfig()
    with pytest.raises(TypeError, match="prices as torch.float32"):
        window_dp_rows(job, tput, z0, std, prices.double(), avail, 16)
    with pytest.raises(TypeError, match="n_max as torch.int32"):
        window_dp_rows(dataclasses.replace(job, n_max=job.n_max.long()),
                       tput, z0, std, prices, avail, 16)
    with pytest.raises(ValueError, match="shape"):
        window_dp_rows(job, tput, z0, std, prices, avail[:, :5].contiguous(),
                       16)
    with pytest.raises(ValueError, match="shape"):
        window_dp_rows(job, tput, z0[:4].contiguous(), std, prices, avail,
                       16)
    with pytest.raises(ValueError, match="one CUDA device"):
        window_dp_rows(job, tput, z0.cpu(), std, prices, avail, 16)
    with pytest.raises(ValueError, match="contiguous"):
        window_dp_rows(job, tput, z0, std,
                       prices.t().contiguous().t(), avail, 16)
    with pytest.raises(ValueError, match="outside"):
        window_dp_rows(job, tput, z0, std, prices, avail, 128)


def test_solve_window_batch_per_row_takes_the_forecast_entry(cuda):
    """One job per row: one launch of K1's forecast entry, nothing else
    from K1, and the CPU plain chain's bits."""
    job, z0, std, prices, avail = _forecast_rows(2000, 6, 16, 5, cuda)
    before = (window_dp.launches, window_dp_rows.launches)
    got = window_opt.solve_window_batch(job, ThroughputConfig(), z0, std,
                                        prices, avail, job.on_demand_price,
                                        16)
    assert (window_dp.launches, window_dp_rows.launches) == (
        before[0] + 1, before[1] + 1)
    cpu = JobConfig(**{f.name: getattr(job, f.name).cpu()
                       for f in dataclasses.fields(job)})
    want = window_opt.solve_window_batch(
        cpu, ThroughputConfig(), z0.cpu(), std.cpu(), prices.cpu(),
        avail.cpu(), cpu.on_demand_price, 16, device="cpu")
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)


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


def _regional_workload(n_jobs):
    from repro_torch.core.region_market import vast_like_regions

    market = vast_like_regions(3, seed=13, days=2, delta_mig=1)
    rng = np.random.default_rng(7)
    jobs = job_stream_arrays(rng, n_jobs, 16)
    t0s = rng.integers(0, len(market) - 17, size=n_jobs)
    seeds = 700021 + np.arange(n_jobs)
    prep = lambda lo, hi: engine.prepare_noisy_inputs_regions(
        market, t0s[lo:hi], 16, "fixed_uniform", 0.2, seeds[lo:hi])
    return market, jobs, prep


@pytest.mark.parametrize("p_od", [None, (1.0, 1.3, 0.8)])
def test_regional_scan_k1_equals_plain_on_card(cuda, p_od):
    """The region scans on the card through K1's forecast entry, one launch
    a slot, against the same scans on the card with the plain chain
    (backend="torch"): every leaf bit-equal, per-row p_o included."""
    from repro_torch.core import fast_sim
    from repro_torch.core.policy_pool import region_pool

    market, jobs, prep = _regional_workload(40)
    pool = specs_to_arrays(region_pool())
    before = (window_dp.launches, window_dp_rows.launches)
    got = fast_sim.simulate_pool_regions(pool, jobs, PAPER_TPUT,
                                         *prep(0, 40), delta_mig=1,
                                         p_od=p_od, collect=True)
    assert (window_dp.launches, window_dp_rows.launches) == \
        (before[0] + 16, before[1] + 16)
    want = fast_sim.simulate_pool_regions(pool, jobs, PAPER_TPUT,
                                          *prep(0, 40), delta_mig=1,
                                          p_od=p_od, collect=True,
                                          backend="torch")
    for k in want:
        assert got[k].device.type == "cuda"
        assert torch.equal(got[k], want[k]), k


def test_side_stream_prep_bit_equal_to_arrays(cuda):
    """``prep=`` on the card (pinned host buffers copied on a side stream,
    the compute stream waiting on their event) against the prebuilt arrays
    sliced per chunk: the same result bit for bit, with the recorder on."""
    from repro_torch.core.policy_pool import region_pool

    market, jobs, prep = _regional_workload(50)
    pool = specs_to_arrays(region_pool())
    kw = dict(delta_mig=1, job_chunk=16, collect=True, p_od=(1.0, 1.3, 0.8))
    base = engine.simulate_and_select(pool, jobs, PAPER_TPUT, *prep(0, 50),
                                      **kw)
    streamed = engine.simulate_and_select(pool, jobs, PAPER_TPUT, None, None,
                                          None, prep=prep, **kw)
    assert torch.equal(base.state.weights, streamed.state.weights)
    np.testing.assert_array_equal(base.max_weight, streamed.max_weight)
    np.testing.assert_array_equal(base.regret, streamed.regret)
    np.testing.assert_array_equal(base.mean_utility, streamed.mean_utility)
    for k in base.sim_out:
        np.testing.assert_array_equal(base.sim_out[k], streamed.sim_out[k],
                                      err_msg=k)


def test_device_drawn_prep_through_prep_bit_equal_to_arrays(cuda):
    """The device-drawn forecast stack: its uniforms (integer hashes) have
    the CPU's bits, and a ``prep=`` closure returning card tensors, each
    chunk cast on the compute stream, gives the whole stack's result bit
    for bit."""
    from repro_torch.core.policy_pool import region_pool
    from repro_torch.core.predictor import _row_uniforms
    from repro_torch.core.region_market import vast_like_regions

    seeds = 700021 + np.arange(300)
    assert torch.equal(_row_uniforms(seeds, 500, cuda).cpu(),
                       _row_uniforms(seeds, 500, torch.device("cpu")))
    market = vast_like_regions(3, seed=13, days=2, delta_mig=1)
    rng = np.random.default_rng(7)
    jobs = job_stream_arrays(rng, 50, 16)
    t0s = rng.integers(0, len(market) - 17, size=50)
    prep = lambda lo, hi: engine.prepare_noisy_inputs_regions(
        market, t0s[lo:hi], 16, "magdep_heavytail", 0.2,
        700021 + np.arange(lo, hi), prep_backend="torch")
    assert prep(0, 50)[2].is_cuda
    pool = specs_to_arrays(region_pool())
    kw = dict(delta_mig=1, job_chunk=16, collect=True)
    base = engine.simulate_and_select(pool, jobs, PAPER_TPUT, *prep(0, 50),
                                      **kw)
    streamed = engine.simulate_and_select(pool, jobs, PAPER_TPUT, None, None,
                                          None, prep=prep, **kw)
    assert torch.equal(base.state.weights, streamed.state.weights)
    np.testing.assert_array_equal(base.regret, streamed.regret)
    for k in base.sim_out:
        np.testing.assert_array_equal(base.sim_out[k], streamed.sim_out[k],
                                      err_msg=k)


def test_solve_window_numpy_cuda_equals_cpu(cuda):
    """The python AHAP's window solve: K1's table entry on the card gives
    the CPU plain DP's plan and objective."""
    rng = np.random.default_rng(3)
    from repro_torch.configs.base import JobConfig
    for i in range(50):
        w1 = int(rng.integers(1, 7))
        job = JobConfig(workload=float(rng.uniform(20, 150)),
                        deadline=int(rng.integers(3, 15)),
                        n_min=int(rng.integers(1, 4)),
                        n_max=int(rng.integers(4, 17)),
                        value=float(rng.uniform(40, 150)))
        args = (job, PAPER_TPUT, float(rng.uniform(0, job.workload)),
                int(rng.integers(0, w1 + 2)), rng.uniform(0.1, 1.4, w1),
                rng.integers(0, 14, w1), 1.0)
        before = window_dp.launches
        got = window_opt.solve_window_numpy(*args)
        assert window_dp.launches == before + 1
        want = window_opt.solve_window_numpy(*args, device="cpu")
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2], i


# K2 tolerances: f32 accumulates in full f32 in both versions, so only the
# order of the K-sums differs (1e-4); bf16 rounds one f32 sum once in both,
# so an output may differ by one bf16 ulp (2^-7 relative at most) where the
# two f32 sums straddle a rounding boundary.
K2_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
          torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-3)}


def _lora_inputs(m, k, n, r, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k), np.float32)
    w, a, b = (rng.standard_normal(s, np.float32) * 0.05
               for s in ((k, n), (k, r), (r, n)))
    return [torch.from_numpy(t).to(dtype) for t in (x, w, a, b)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,r", [(128, 128, 128, 16), (256, 384, 128, 8),
                                     (128, 256, 256, 64), (200, 1000, 300, 16),
                                     (8, 4096, 4096, 16), (3, 40, 24, 5)])
def test_k2_matches_plain(cuda, m, k, n, r, dtype):
    x, w, a, b = (t.to(cuda) for t in _lora_inputs(m, k, n, r, dtype, m + n))
    before = lora_matmul.launches
    y = lora_matmul(x, w, a, b, 2.0)
    torch.cuda.synchronize()
    assert lora_matmul.launches == before + 1
    assert y.dtype == dtype and y.shape == (m, n)
    torch.testing.assert_close(y.float(), lora_matmul_ref(x, w, a, b,
                                                          2.0).float(),
                               **K2_TOL[dtype])


# The edges of K2's bf16 tiles: decode (M <= 64, 64-column blocks, K split
# over a cluster) and prefill (128 x 256 tiles, BK 64); K and N not
# multiples of a tile, N 4100 with a ragged row pitch (no 16-byte copies),
# N 4104 with whole 16-byte chunks; r 8, 16 and 64.
@pytest.mark.parametrize("kn", [(4104, 4100), (4104, 4104)])
@pytest.mark.parametrize("r", [8, 16, 64])
@pytest.mark.parametrize("m", [1, 8, 17, 64, 65, 200])
def test_k2_bf16_tile_edges(cuda, m, r, kn):
    k, n = kn
    x, w, a, b = (t.to(cuda) for t in _lora_inputs(m, k, n, r,
                                                   torch.bfloat16, m + r))
    before = lora_matmul.launches
    y = lora_matmul(x, w, a, b, 2.0)
    torch.cuda.synchronize()
    assert lora_matmul.launches == before + 1
    assert y.dtype == torch.bfloat16 and y.shape == (m, n)
    torch.testing.assert_close(y.float(), lora_matmul_ref(x, w, a, b,
                                                          2.0).float(),
                               **K2_TOL[torch.bfloat16])


# (M, K, N) of K2 on the three serving paths: llama2-7b's q / v, mamba2-370m's
# and zamba2-2.7b's wx, each at prefill and at decode (M = 8)
K2_SERVING = [(8192, 4096, 4096), (8, 4096, 4096), (16384, 1024, 2048),
              (8, 1024, 2048), (8192, 2560, 5120), (8, 2560, 5120)]


@pytest.mark.parametrize("m,k,n", K2_SERVING)
def test_k2_bf16_serving_shapes(cuda, m, k, n):
    x, w, a, b = (t.to(cuda) for t in _lora_inputs(m, k, n, 16,
                                                   torch.bfloat16, n))
    y = lora_matmul(x, w, a, b, 2.0)
    torch.testing.assert_close(y.float(), lora_matmul_ref(x, w, a, b,
                                                          2.0).float(),
                               **K2_TOL[torch.bfloat16])


def test_k2_decode_is_deterministic(cuda):
    """The decode path splits K over a cluster and adds the partial sums in
    a fixed order: two runs give the same bits."""
    x, w, a, b = (t.to(cuda) for t in _lora_inputs(8, 4096, 4096, 16,
                                                   torch.bfloat16, 3))
    assert torch.equal(lora_matmul(x, w, a, b, 2.0),
                       lora_matmul(x, w, a, b, 2.0))


def test_k2_rejects_what_it_does_not_take(cuda):
    x, w, a, b = (t.to(cuda) for t in _lora_inputs(16, 32, 32, 8,
                                                   torch.float32, 0))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        lora_matmul(x.double(), w.double(), a.double(), b.double(), 1.0)
    with pytest.raises(TypeError, match="one dtype"):
        lora_matmul(x.bfloat16(), w, a, b, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        lora_matmul(x, w.t().contiguous().t(), a, b, 1.0)
    with pytest.raises(ValueError, match="do not match"):
        lora_matmul(x, w[:-1].contiguous(), a, b, 1.0)
    with pytest.raises(ValueError, match="rank"):
        big_a = torch.zeros((32, 65), device=cuda)
        lora_matmul(x, w, big_a, torch.zeros((65, 32), device=cuda), 1.0)
    with pytest.raises(ValueError, match="one CUDA device"):
        lora_matmul(x, w.cpu(), a, b, 1.0)


# K3 tolerances: scores, softmax and both products are f32 in both versions,
# so only the order of the sums differs (2e-5); bf16 rounds the f32 output
# once in both, so an output may differ by one bf16 ulp (2^-7 relative at
# most), as for K2.
K3_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
          torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-3)}


def _qkv(bh, sq, sk, d, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, np.float32)).to(dtype)
            for s in ((bh, sq, d), (bh, sk, d), (bh, sk, d))]


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 100), (False, 37)])
@pytest.mark.parametrize("bh,sq,sk,d,dtype", [
    (4, 256, 256, 64, torch.float32), (2, 128, 512, 128, torch.float32),
    (2, 128, 128, 64, torch.bfloat16), (3, 200, 200, 128, torch.bfloat16),
    (2, 100, 300, 64, torch.float32), (3, 200, 200, 80, torch.float32),
    (4, 256, 256, 80, torch.bfloat16)])
def test_k3_matches_plain(cuda, bh, sq, sk, d, dtype, causal, window):
    q, k, v = (t.to(cuda) for t in _qkv(bh, sq, sk, d, dtype, bh * sq + sk))
    before = flash_attention.launches
    o = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_ref(q[None], k[None], v[None], causal=causal,
                               window=window)[0]
    assert o.dtype == dtype and o.shape == q.shape
    torch.testing.assert_close(o.float(), want.float(), **K3_TOL[dtype])


# The edges of K3's bf16 tiles (64 query rows, 64 keys): S around the
# tile, Sq = Sk and Sq < Sk, each head dim, causal, with and without a
# window.
@pytest.mark.parametrize("window", [None, 37])
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("extra", [0, 50])
@pytest.mark.parametrize("s", [1, 63, 65, 127, 129, 200])
def test_k3_bf16_tile_edges(cuda, s, extra, d, window):
    q, k, v = (t.to(cuda) for t in _qkv(2, s, s + extra, d, torch.bfloat16,
                                        s * d + extra))
    before = flash_attention.launches
    o = flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_ref(q[None], k[None], v[None], causal=True,
                               window=window)[0]
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    torch.testing.assert_close(o.float(), want.float(),
                               **K3_TOL[torch.bfloat16])


def test_k3_rejects_what_it_does_not_take(cuda):
    q, k, v = (t.to(cuda) for t in _qkv(2, 64, 64, 64, torch.float32, 0))
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                        v[..., :32].contiguous())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(0, 1).contiguous().transpose(0, 1), k, v)
    with pytest.raises(ValueError, match="window"):
        flash_attention(torch.cat([q, q, q], 1), k, v, window=8)
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attention(q, k.cpu(), v)


def _k3_positions(s, kind, seed):
    """(q_pos, k_pos) int32 of length s: Qwen2-VL's temporal stream with an
    image span at the start, middle or end; repeated, non-monotone
    positions; or queries 8 before their keys (rows with no key)."""
    from repro_torch.models.frontends import make_mrope_positions

    if kind in ("start", "middle", "end"):
        h, w = 4, 8
        start = {"start": 0, "middle": s // 3, "end": s - h * w}[kind]
        p = np.ascontiguousarray(
            make_mrope_positions(1, s, (start, h, w))[0, :, 0])
        return p, p
    if kind == "shuffled":
        p = np.random.default_rng(seed).integers(0, max(1, s // 2), s)
        return p.astype(np.int32), p.astype(np.int32)
    ar = np.arange(s, dtype=np.int32)
    return ar - 8, ar


@pytest.mark.parametrize("causal,window", [(True, None), (True, 37),
                                           (False, None)])
@pytest.mark.parametrize("kind", ["start", "middle", "end", "shuffled",
                                  "rows-without-keys"])
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_positions_match_plain(cuda, dtype, d, kind, causal, window):
    """K3's position path against the plain version with the same
    positions, S = 200 (ragged), Sq = Sk."""
    s = 200
    q, k, v = (t.to(cuda) for t in _qkv(3, s, s, d, dtype, d + s))
    q_pos, k_pos = (torch.from_numpy(p).to(cuda)
                    for p in _k3_positions(s, kind, d))
    before = flash_attention.launches
    o = flash_attention(q, k, v, causal=causal, window=window, q_pos=q_pos,
                        k_pos=k_pos)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_ref(q[None], k[None], v[None], causal=causal,
                               window=window, q_pos=q_pos, k_pos=k_pos)[0]
    torch.testing.assert_close(o.float(), want.float(), **K3_TOL[dtype])


@pytest.mark.parametrize("causal,window", [(True, None), (True, 37),
                                           (False, None), (False, 50)])
@pytest.mark.parametrize("sq,sk", [(1, 1), (65, 65), (200, 200), (64, 130),
                                   (129, 300)])
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_explicit_arange_bit_equal_to_index_path(cuda, dtype, d, sq, sk,
                                                    causal, window):
    """Positions 0, 1, ... passed explicitly give the index path's bits: the
    position path visits the tiles the index path skips, and each adds
    exactly 0."""
    q, k, v = (t.to(cuda) for t in _qkv(2, sq, sk, d, dtype, sq + sk))
    base = flash_attention(q, k, v, causal=causal, window=window)
    got = flash_attention(
        q, k, v, causal=causal, window=window,
        q_pos=torch.arange(sq, dtype=torch.int32, device=cuda),
        k_pos=torch.arange(sk, dtype=torch.int32, device=cuda))
    assert torch.equal(got, base)


def test_k3_positions_qwen2_vl_serving_shape(cuda):
    """Qwen2-VL's prefill: BH 8 x 28, S 1024, D 128, bf16, one 24 x 32
    image span at 64."""
    from repro_torch.models.frontends import make_mrope_positions

    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((224, 1024, 128), generator=gen,
                           device=cuda).bfloat16() for _ in range(3))
    p = torch.from_numpy(np.ascontiguousarray(
        make_mrope_positions(1, 1024, (64, 24, 32))[0, :, 0])).to(cuda)
    o = flash_attention(q, k, v, causal=True, q_pos=p, k_pos=p)
    want = flash_attention_ref(q[None], k[None], v[None], causal=True,
                               q_pos=p, k_pos=p)[0]
    torch.testing.assert_close(o.float(), want.float(),
                               **K3_TOL[torch.bfloat16])


def test_k3_refuses_positions_it_does_not_take(cuda):
    q, k, v = (t.to(cuda) for t in _qkv(2, 64, 80, 64, torch.float32, 0))
    qp = torch.arange(64, dtype=torch.int32, device=cuda)
    kp = torch.arange(80, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="both q_pos and k_pos"):
        flash_attention(q, k, v, q_pos=qp)
    with pytest.raises(TypeError, match="int32"):
        flash_attention(q, k, v, q_pos=qp.long(), k_pos=kp)
    with pytest.raises(ValueError, match=r"shape \(80,\)"):
        flash_attention(q, k, v, q_pos=qp, k_pos=kp[:64])
    with pytest.raises(ValueError, match="q's device"):
        flash_attention(q, k, v, q_pos=qp.cpu(), k_pos=kp)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, k, v, q_pos=qp, k_pos=torch.arange(
            160, dtype=torch.int32, device=cuda)[::2])


# ---------------------------------------------------------------------------
# K3's backward kernel
# ---------------------------------------------------------------------------

# K3's backward against its plain versions (K4_GRAD_TOL, chip_smoke.py's
# GRAD_TOL): elementwise rtol |want| + atol max|want|. f32 1e-4 / 1e-5:
# dK and dV sum over up to Sq queries in another order; bf16 one rounding
# of the f32 result (2^-7) / 2^-9: the plain routes run in f32 and round
# each gradient once, the kernel takes P and dS as hi + lo bf16 halves.
K3_BWD_MASKS = [dict(causal=True), dict(causal=True, window=37),
                dict(causal=False), dict(causal=False, window=50)]


def _k3_grad_close(got, want, dtype):
    """_grad_close, except where the plain route's gradient is f32 rounding
    noise around a true 0 (a single query that keeps a single key: P = 1,
    so dS = P (dP - rowsum(P o dP)) = 0; the plain route's sums leave
    ~1e-7, against which max|want| gives no scale): both then within 1e-5
    of 0."""
    if float(want.abs().max()) < 1e-5:
        assert float(got.abs().max()) < 1e-5
        return
    _grad_close(got, want, dtype)


def _k3_backward_case(cuda, bh, sq, sk, d, dtype, seed, **mask):
    """The kernel's (dq, dk, dv) from the forward's m and l, and both plain
    routes' on the same inputs: flash_attention_bwd_ref and autograd
    through flash_attention_ref."""
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels.ref import flash_attention_bwd_ref

    q, k, v = (t.to(cuda) for t in _qkv(bh, sq, sk, d, dtype, seed))
    do = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (bh, sq, d), np.float32)).to(dtype).to(cuda)
    o, m, l = flash_attention(q, k, v, stats=True, **mask)
    before = k3.flash_attention_backward.launches
    got = k3.flash_attention_backward(q, k, v, m, l, do, **mask)
    torch.cuda.synchronize()
    assert k3.flash_attention_backward.launches == before + 1
    bwd_ref = flash_attention_bwd_ref(q[None], k[None], v[None], m[None],
                                      l[None], do[None], **mask)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref_o = flash_attention_ref(*(t[None] for t in leaves), **mask)[0]
    autograd = torch.autograd.grad(ref_o, leaves, do)
    return got, [g[0] for g in bwd_ref], autograd


# (BH, Sq, Sk, mask) on the index path: ragged S, Sq < Sk and Sq > Sk,
# each mask kind; a window with Sq >= Sk + window (rows with no key) is
# the position path's case, which the index path refuses
K3_BWD_CASES = [(bh, sq, sk, mask)
                for bh, sq, sk in ((3, 200, 200), (2, 128, 300), (2, 150, 90))
                for mask in K3_BWD_MASKS
                if sq < sk + mask.get("window", sq)]


@pytest.mark.parametrize("bh,sq,sk,mask", K3_BWD_CASES)
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_backward_matches_plain(cuda, dtype, d, bh, sq, sk, mask):
    """The backward kernel's dq, dk, dv against flash_attention_bwd_ref and
    against autograd through the plain version, on the index path; every
    gradient in its input's dtype and shape."""
    got, bwd_ref, autograd = _k3_backward_case(cuda, bh, sq, sk, d, dtype,
                                               bh * sq + sk + d, **mask)
    for g, r, a in zip(got, bwd_ref, autograd):
        assert g.dtype == dtype and g.shape == a.shape
        _k3_grad_close(g, r, dtype)
        _k3_grad_close(g, a, dtype)


# The edges of the backward's tiles (a warpgroup's 64 rows a block, 64
# rows of the walked side a step, a ring of two stages that the third and
# fourth tiles reuse), as test_k3_bf16_tile_edges holds the forward's.
@pytest.mark.parametrize("window", [None, 37])
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("extra", [0, 50])
@pytest.mark.parametrize("s", [1, 63, 65, 127, 129, 191, 200, 257])
def test_k3_backward_bf16_tile_edges(cuda, s, extra, d, window):
    got, bwd_ref, autograd = _k3_backward_case(
        cuda, 2, s, s + extra, d, torch.bfloat16, s * d + extra,
        causal=True, window=window)
    for g, r, a in zip(got, bwd_ref, autograd):
        _k3_grad_close(g, r, torch.bfloat16)
        _k3_grad_close(g, a, torch.bfloat16)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 37),
                                           (False, None)])
@pytest.mark.parametrize("kind", ["start", "middle", "end", "shuffled",
                                  "rows-without-keys"])
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_backward_positions_match_plain(cuda, dtype, d, kind, causal,
                                           window):
    """The position path: every tile visited, the element mask on
    positions; rows whose keys are all masked (``rows-without-keys``) get
    dq = 0, no dk share and dV's share dO / Sk, as masked_fill's
    gradient gives."""
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels.ref import flash_attention_bwd_ref

    s = 200
    q, k, v = (t.to(cuda) for t in _qkv(3, s, s, d, dtype, d + s))
    do = torch.from_numpy(np.random.default_rng(d).standard_normal(
        (3, s, d), np.float32)).to(dtype).to(cuda)
    q_pos, k_pos = (torch.from_numpy(p).to(cuda)
                    for p in _k3_positions(s, kind, d))
    mask = dict(causal=causal, window=window, q_pos=q_pos, k_pos=k_pos)
    _, m, l = flash_attention(q, k, v, stats=True, **mask)
    got = k3.flash_attention_backward(q, k, v, m, l, do, **mask)
    want = flash_attention_bwd_ref(q[None], k[None], v[None], m[None],
                                   l[None], do[None], **mask)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    autograd = torch.autograd.grad(
        flash_attention_ref(*(t[None] for t in leaves), **mask)[0], leaves,
        do)
    for g, r, a in zip(got, want, autograd):
        _k3_grad_close(g, r[0], dtype)
        _k3_grad_close(g, a, dtype)
    if kind == "rows-without-keys" and causal:
        # queries 0-7 sit before every key: no key is kept
        assert torch.equal(got[0][:, :8], torch.zeros_like(got[0][:, :8]))


def test_k3_forward_statistics_match_plain(cuda):
    """The forward's m and l (stats=True) against the plain version's, on
    both paths and both dtypes; the output bit-equal to a launch without
    statistics."""
    from repro_torch.kernels.ref import flash_attention_fwd_stats_ref

    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (t.to(cuda) for t in _qkv(2, 150, 150, 80, dtype, 3))
        ar = torch.arange(150, dtype=torch.int32, device=cuda)
        for mask in (dict(causal=True, window=37),
                     dict(causal=True, q_pos=ar - 8, k_pos=ar)):
            o, m, l = flash_attention(q, k, v, stats=True, **mask)
            assert torch.equal(o, flash_attention(q, k, v, **mask))
            _, m_ref, l_ref = flash_attention_fwd_stats_ref(
                q[None], k[None], v[None], **mask)
            torch.testing.assert_close(m, m_ref[0], rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(l, l_ref[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("positions", [False, True])
@pytest.mark.parametrize("d", [64, 80, 128])
def test_k3_backward_is_deterministic(cuda, d, positions):
    """Two launches give the same bits at every head dim's shared-memory
    layout, on the index and the position path: no float atomics, every
    sum in a fixed order."""
    from repro_torch.kernels import flash_attention as k3

    q, k, v = (t.to(cuda) for t in _qkv(4, 300, 300, d, torch.bfloat16,
                                        5))
    do = torch.randn((4, 300, d), device=cuda).bfloat16()
    ar = torch.arange(300, dtype=torch.int32, device=cuda)
    mask = dict(q_pos=ar - 8, k_pos=ar) if positions else {}
    _, m, l = flash_attention(q, k, v, stats=True, **mask)
    g1 = k3.flash_attention_backward(q, k, v, m, l, do, **mask)
    g2 = k3.flash_attention_backward(q, k, v, m, l, do, **mask)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_k3_backward_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels import flash_attention as k3

    q, k, v = (t.to(cuda) for t in _qkv(2, 64, 64, 64, torch.float32, 0))
    do = torch.randn_like(q)
    _, m, l = flash_attention(q, k, v, stats=True)
    before = k3.flash_attention_backward.launches
    bwd = k3.flash_attention_backward
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bwd(q.half(), k.half(), v.half(), m, l, do.half())
    with pytest.raises(ValueError, match="head_dim"):
        bwd(*(t[..., :32].contiguous() for t in (q, k, v)), m, l,
            do[..., :32].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        bwd(q.transpose(0, 1).contiguous().transpose(0, 1), k, v, m, l, do)
    with pytest.raises(ValueError, match="do contiguous"):
        bwd(q, k, v, m, l, do.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="m and l"):
        bwd(q, k, v, None, None, do)
    with pytest.raises(ValueError, match="takes l"):
        bwd(q, k, v, m, l[:, :32].contiguous(), do)
    with pytest.raises(ValueError, match="takes do"):
        bwd(q, k, v, m, l, do.bfloat16())
    with pytest.raises(ValueError, match="window"):
        bwd(torch.cat([q, q, q], 1), k, v, m.repeat(1, 3), l.repeat(1, 3),
            torch.cat([do, do, do], 1), window=8)
    with pytest.raises(RuntimeError, match="requires grad"):
        bwd(q.clone().requires_grad_(True), k, v, m, l, do)
    assert k3.flash_attention_backward.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_function_backward_launches_the_kernel(cuda, dtype, monkeypatch):
    """FlashAttention through ops.attention (GQA, 8 query heads over 2 K / V
    heads): one forward and one backward launch, no plain attention on the
    card route, the gradients within GRAD_TOL of autograd through the
    plain route."""
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels import ops

    def refused(*a, **kw):
        raise AssertionError("the plain attention ran on the card route")

    gen = torch.Generator(device=cuda).manual_seed(1)
    ins = [torch.randn((2, 200, h, 128), generator=gen, device=cuda).to(dtype)
           for h in (8, 2, 2)]
    do = torch.randn((2, 200, 8, 128), generator=gen, device=cuda).to(dtype)
    grads = []
    for use_cuda in (True, False):
        leaves = [t.clone().requires_grad_(True) for t in ins]
        before = (k3.flash_attention.launches,
                  k3.flash_attention_backward.launches)
        with monkeypatch.context() as mp:
            if use_cuda:
                mp.setattr(k3, "flash_attention_ref", refused)
            o = ops.attention(*leaves, causal=True,
                              kcfg=ops.KernelConfig(use_cuda))
            grads.append(torch.autograd.grad(o, leaves, do))
        torch.cuda.synchronize()
        after = (k3.flash_attention.launches,
                 k3.flash_attention_backward.launches)
        assert (after[0] - before[0], after[1] - before[1]) == (
            (1, 1) if use_cuda else (0, 0))
    for g, w in zip(*grads):
        _grad_close(g, w, dtype)


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "hubert-xlarge"])
def test_vlm_audio_smoke_config_cuda_equals_cpu(cuda, arch):
    """The qwen2-vl-7b smoke config (an image span, prefill and 4 decode
    steps on embeddings) and the hubert-xlarge one (forward) on the card
    (K2, K3 with positions for the VLM, non-causal for HuBERT) against the
    CPU plain path, f32, at the dense models' tolerance."""
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.frontends import make_mrope_positions

    cfg = get_smoke_config(arch)
    vals = convert.random_model_params(cfg, 20)
    emb = np.random.default_rng(21).standard_normal(
        (2, 64, cfg.d_model), np.float32) * 0.1
    pos = make_mrope_positions(2, 60, (8, 4, 8))

    def run(dev):
        params = convert.model_params(vals, cfg, dev)
        e = torch.from_numpy(emb).to(dev)
        if cfg.encoder_only:
            return [tf.forward(cfg, params, {"embeds": e})[0].cpu()]
        logits, cache = tf.prefill(cfg, params, {
            "embeds": e[:, :60],
            "positions": torch.from_numpy(pos).to(dev)}, 64)
        outs = [logits.cpu()]
        for i in range(60, 64):
            logits, cache = tf.decode_step(cfg, params,
                                           {"embeds": e[:, i:i + 1]}, cache)
            outs.append(logits.cpu())
        return outs

    before = (lora_matmul.launches, flash_attention.launches)
    got = run(cuda)
    n_fwd = 1 if cfg.encoder_only else 5
    assert (lora_matmul.launches - before[0],
            flash_attention.launches - before[1]) == (
        len(cfg.lora.targets) * cfg.num_layers * n_fwd, cfg.num_layers)
    for g, w in zip(got, run("cpu")):
        torch.testing.assert_close(g, w, atol=2e-4, rtol=2e-3)


# K4 tolerances: both versions compute in f32, K4 in 64-step chunks and the
# plain version step by step, so the sums run in another order: 3e-4, the
# JAX kernel test's own for chunked against sequential. At bf16 y is one
# rounding of those f32 results, so one bf16 ulp (2^-7 relative) besides;
# the f32 state keeps 3e-4.
K4_TOL = {torch.float32: dict(rtol=3e-4, atol=3e-4),
          torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-3)}


def _ssd_inputs(bh, s, p, n, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bh, s, p), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bh, s)))) * 0.5
    a = -np.exp(rng.standard_normal(bh)) * 0.5
    b, c = (rng.standard_normal((bh, s, n)) * 0.3 for _ in "bc")
    return (torch.from_numpy(x).to(dtype), torch.tensor(dt, dtype=torch.float32),
            torch.tensor(a, dtype=torch.float32),
            torch.tensor(b, dtype=torch.float32).to(dtype),
            torch.tensor(c, dtype=torch.float32).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,p,n", [(4, 256, 64, 32), (2, 256, 32, 128),
                                      (3, 200, 64, 16), (2, 37, 32, 64),
                                      (5, 1, 64, 128), (64, 1024, 64, 64)])
def test_k4_matches_plain(cuda, bh, s, p, n, dtype):
    """The JAX kernel test's shapes, ragged S (200, 37, 1) and a
    zamba2-sized head count."""
    ins = [t.to(cuda) for t in _ssd_inputs(bh, s, p, n, dtype, bh * s + n)]
    before = ssd_scan.launches
    y, h = ssd_scan(*ins)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    want_y, want_h = ssd_scan_ref(*ins)
    assert y.dtype == dtype and y.shape == (bh, s, p)
    assert h.dtype == torch.float32 and h.shape == (bh, n, p)
    torch.testing.assert_close(y.float(), want_y.float(), **K4_TOL[dtype])
    torch.testing.assert_close(h, want_h, **K4_TOL[torch.float32])


def test_k4_rejects_what_it_does_not_take(cuda):
    x, dt, a, b, c = (t.to(cuda) for t in _ssd_inputs(2, 64, 32, 16,
                                                      torch.float32, 0))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ssd_scan(x.double(), dt, a, b.double(), c.double())
    with pytest.raises(TypeError, match="dt, A in float32"):
        ssd_scan(x, dt.bfloat16(), a, b, c)
    with pytest.raises(TypeError, match="one dtype"):
        ssd_scan(x.bfloat16(), dt, a, b, c)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x.transpose(0, 1).contiguous().transpose(0, 1), dt, a, b, c)
    with pytest.raises(ValueError, match="do not match"):
        ssd_scan(x, dt[:, :-1].contiguous(), a, b, c)
    with pytest.raises(ValueError, match="head_dim"):
        ssd_scan(torch.cat([x, x[..., :16]], -1), dt, a, b, c)
    with pytest.raises(ValueError, match="state N"):
        big = torch.zeros((2, 64, 129), device=cuda)
        ssd_scan(x, dt, a, big, big)
    with pytest.raises(ValueError, match="one CUDA device"):
        ssd_scan(x, dt.cpu(), a, b, c)


def _xbc_inputs(dev, bt, s, hh, p, g, n, dtype, seed, width=None):
    """x (bt, s, hh, p), B and C (bt, s, g, n) as views of one
    (bt, s, width) buffer on ``dev``, sliced as the Mamba2 layer slices its
    conv output (width hh p + 2 g n unless given); dt (bt, s, hh), A (hh,).
    (The buffer is moved before it is sliced: ``.to`` of a view copies it
    into a dense tensor.)"""
    rng = np.random.default_rng(seed)
    di = hh * p
    width = width or di + 2 * g * n
    xbc = rng.standard_normal((bt, s, width)).astype(np.float32)
    xbc[..., di:] *= 0.3
    xbc = torch.from_numpy(xbc).to(dev, dtype)
    x = xbc[..., :di].reshape(bt, s, hh, p)
    B = xbc[..., di:di + g * n].reshape(bt, s, g, n)
    C = xbc[..., di + g * n:di + 2 * g * n].reshape(bt, s, g, n)
    dt = torch.tensor(np.log1p(np.exp(rng.standard_normal((bt, s, hh))))
                      * 0.5, dtype=torch.float32, device=dev)
    a = torch.tensor(-np.exp(rng.standard_normal(hh)) * 0.5,
                     dtype=torch.float32, device=dev)
    return x, dt, a, B, C


def _flattened(x, dt, a, B, C):
    """The same operands as contiguous (Bt*H, ...) copies, B and C repeated
    to heads."""
    bt, s, hh, p = x.shape
    rep = hh // B.shape[2]
    B, C = (t.repeat_interleave(rep, dim=2) for t in (B, C))
    flat = (lambda t: t.transpose(1, 2).reshape(bt * hh, s, -1).contiguous())
    return (flat(x), dt.transpose(1, 2).reshape(bt * hh, s).contiguous(),
            a.repeat(bt), flat(B), flat(C))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 2049])
@pytest.mark.parametrize("n,p,g", [(16, 32, 2), (64, 64, 1), (128, 64, 2),
                                   (128, 32, 1)])
def test_k4_grouped_matches_plain_and_flattened(cuda, s, n, p, g, dtype):
    """The model's layout read in place (strided views, B and C per group)
    against the plain version, and bit-equal to the flattened entry on
    contiguous copies with B and C repeated to heads: S at the 64-step chunk
    edges, N, P and G over the kernel's range."""
    ins = _xbc_inputs(cuda, 2, s, 4, p, g, n, dtype, s * n + p + g)
    assert not ins[0].is_contiguous() and not ins[3].is_contiguous()
    before = ssd_scan.launches
    y, h = ssd_scan_grouped(*ins)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert y.dtype == dtype and y.shape == (2, s, 4, p) and y.is_contiguous()
    assert h.dtype == torch.float32 and h.shape == (2, 4, n, p)
    want_y, want_h = ssd_scan_grouped_ref(*ins)
    torch.testing.assert_close(y.float(), want_y.float(), **K4_TOL[dtype])
    torch.testing.assert_close(h, want_h, **K4_TOL[torch.float32])
    yf, hf = ssd_scan(*_flattened(*ins))
    assert torch.equal(yf.reshape(2, 4, s, p).transpose(1, 2), y)
    assert torch.equal(hf.reshape(2, 4, n, p), h)


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b"])
def test_k4_grouped_serving_layout_smoke_size(cuda, arch):
    """ops.ssd on the layer's own views at the smoke configs' widths (d 256,
    d_inner 512, N 16, P 32: rows of 544 elements), bf16, against the plain
    path of ops.ssd."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops

    cfg = get_smoke_config(arch)
    sc = cfg.ssm
    hh, p, g, n = (sc.heads(cfg.d_model), sc.head_dim, sc.n_groups,
                   sc.state_size)
    ins = _xbc_inputs(cuda, 3, 300, hh, p, g, n, torch.bfloat16, 5)
    assert ins[0].stride(1) == 544
    y, h = ops.ssd(*ins)
    want_y, want_h = ops.ssd(*ins, kcfg=ops.KernelConfig(use_cuda=False))
    torch.testing.assert_close(y.float(), want_y.float(),
                               **K4_TOL[torch.bfloat16])
    torch.testing.assert_close(h, want_h, **K4_TOL[torch.float32])


def test_k4_is_deterministic(cuda):
    """Two launches on the same inputs give the same bits (no atomics, a
    fixed order of sums)."""
    ins = _xbc_inputs(cuda, 2, 700, 8, 64, 1, 128, torch.bfloat16, 9)
    y1, h1 = ssd_scan_grouped(*ins)
    y2, h2 = ssd_scan_grouped(*ins)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)



# K4's backward against its plain version (the same chunked scan in torch
# ops: f32 sums in another order, each gradient rounded once on both
# sides) and against autograd through the step-by-step plain version:
# |got - want| <= rtol |want| + atol max|want| (chip_smoke.py's GRAD_TOL)
K4_GRAD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2.0 ** -7,
                                                             2.0 ** -9)}


def _grad_close(got, want, dtype):
    rtol, atol = K4_GRAD_TOL[dtype]
    torch.testing.assert_close(got.double(), want.double(), rtol=rtol,
                               atol=atol * float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bt,s,hh,p,g,n", [
    (2, 100, 4, 64, 2, 64), (2, 9, 4, 32, 2, 16), (1, 130, 6, 32, 3, 16),
    (3, 300, 16, 32, 1, 16), (2, 2049, 4, 64, 1, 128), (2, 65, 4, 64, 4, 128),
    (1, 1, 2, 64, 1, 96), (2, 63, 4, 32, 1, 24), (1, 1024, 80, 64, 1, 64),
    (2, 64, 8, 64, 1, 128), (2, 1600, 10, 64, 2, 64), (1, 300, 6, 32, 6, 32)])
def test_k4_backward_matches_plain(cuda, bt, s, hh, p, g, n, dtype):
    """The backward kernel on the model's layout (x, B, C views of one
    buffer) against ``ssd_scan_grouped_bwd_ref``: ragged S, one chunk and
    many, G < H (2, 3, 16 heads a group) and G = H, N off 16; every
    gradient in its input's dtype; one launch. The bf16 gradient kernel's
    runs of heads (``ssd_scan.backward_runs``, on 132 SMs): zamba2-2.7b's
    80 heads at S 1024 in runs of 5, S 64 (one chunk) at mamba2-370m's N,
    5 heads a group in runs of 2, 2, 1, and G = H (runs of one head)."""
    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.kernels.ref import ssd_scan_grouped_bwd_ref

    ins = _xbc_inputs(cuda, bt, s, hh, p, g, n, dtype, s * n + hh)
    gen = torch.Generator(device=cuda).manual_seed(s)
    dy = torch.randn((bt, s, hh, p), generator=gen, device=cuda).to(dtype)
    dh = torch.randn((bt, hh, n, p), generator=gen, device=cuda)
    before = k4.ssd_scan.backward_launches
    got = k4.ssd_scan_grouped_backward(*ins, dy, dh)
    torch.cuda.synchronize()
    assert k4.ssd_scan.backward_launches == before + 1
    want = ssd_scan_grouped_bwd_ref(*ins, dy, dh)
    for a, b, kind in zip(got, want, (dtype, torch.float32, torch.float32,
                                      dtype, dtype)):
        assert a.dtype == kind and a.shape == b.shape
        _grad_close(a, b, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_function_backward_matches_autograd_through_plain(cuda, dtype):
    """SSDScan through ops.ssd on views of one buffer: the buffer's, dt's
    and A's gradients (the kernel's) against autograd through the
    step-by-step plain route; no state cotangent is a zero one. The plain
    route runs in f32 on the same values and its gradients are rounded
    once to the input's dtype, the kernel's contract: run in bf16 it
    rounds each head's dB / dC to bf16 before the group's sum, which put
    one element 0.203 off where 0.188 is allowed (on the card)."""
    from repro_torch.kernels import ops

    bt, s, hh, p, g, n = 2, 150, 4, 64, 2, 64
    xbc = torch.randn((bt, s, hh * p + 2 * g * n), device=cuda).to(dtype)
    dt = torch.rand((bt, s, hh), device=cuda) * 0.5
    A = -torch.rand((hh,), device=cuda)
    dy = torch.randn((bt, s, hh, p), device=cuda).to(dtype)
    grads = []
    for use_cuda, wide in ((True, dtype), (False, torch.float32)):
        leaves = [t.to(kind, copy=True).requires_grad_(True)
                  for t, kind in ((xbc, wide), (dt, dt.dtype), (A, A.dtype))]
        buf = leaves[0]
        x = buf[..., :hh * p].unflatten(-1, (hh, p))
        B = buf[..., hh * p:hh * p + g * n].unflatten(-1, (g, n))
        C = buf[..., hh * p + g * n:].unflatten(-1, (g, n))
        y, _ = ops.ssd(x, leaves[1], leaves[2], B, C,
                       kcfg=ops.KernelConfig(use_cuda))
        grads.append(torch.autograd.grad(y, leaves, dy.to(wide)))
    for a, b in zip(*grads):
        _grad_close(a, b.to(a.dtype), dtype)


def test_k4_backward_is_deterministic(cuda):
    """Two launches give the same bits: per-head dB / dC and per-block dA
    partials summed in a fixed order, no float atomics."""
    from repro_torch.kernels import ssd_scan as k4

    ins = _xbc_inputs(cuda, 2, 700, 8, 64, 1, 128, torch.bfloat16, 9)
    dy = torch.randn((2, 700, 8, 64), device=cuda).bfloat16()
    g1 = k4.ssd_scan_grouped_backward(*ins, dy, None)
    g2 = k4.ssd_scan_grouped_backward(*ins, dy, None)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_backward_takes_a_misaligned_dy(cuda, dtype):
    """dy as a contiguous view one element past a 16-byte boundary (its
    tiles come by TMA) gives the bits of the same dy aligned."""
    from repro_torch.kernels import ssd_scan as k4

    ins = _xbc_inputs(cuda, 2, 130, 4, 64, 1, 64, dtype, 3)
    dy = torch.randn((2, 130, 4, 64), device=cuda).to(dtype)
    buf = torch.empty(dy.numel() + 1, dtype=dtype, device=cuda)
    shifted = buf[1:].view(dy.shape)
    shifted.copy_(dy)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    want = k4.ssd_scan_grouped_backward(*ins, dy, None)
    got = k4.ssd_scan_grouped_backward(*ins, shifted, None)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_k4_backward_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels import ssd_scan as k4

    x, dt, a, b, c = _xbc_inputs(cuda, 2, 64, 4, 32, 2, 16, torch.bfloat16,
                                 0)
    dy = torch.zeros((2, 64, 4, 32), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="takes dy"):
        k4.ssd_scan_grouped_backward(x, dt, a, b, c, dy.float())
    with pytest.raises(ValueError, match="takes dh"):
        k4.ssd_scan_grouped_backward(x, dt, a, b, c, dy,
                                     torch.zeros((2, 4, 32, 16), device=cuda))
    with pytest.raises(ValueError, match="H a multiple of G"):
        k4.ssd_scan_grouped_backward(x[:, :, :3], dt[:, :, :3], a[:3], b, c,
                                     dy[:, :, :3])
    with pytest.raises(RuntimeError, match="requires grad"):
        k4.ssd_scan_grouped_backward(x, dt, a.clone().requires_grad_(True),
                                     b, c, dy)

def test_k4_grouped_rejects_what_it_does_not_take(cuda):
    x, dt, a, b, c = _xbc_inputs(cuda, 2, 64, 4, 32, 2, 16, torch.bfloat16,
                                 0)
    with pytest.raises(ValueError, match="multiples of 8"):
        # rows of 196 elements: a stride that is not a multiple of 8
        ssd_scan_grouped(*_xbc_inputs(cuda, 2, 64, 4, 32, 2, 16,
                                      torch.bfloat16, 0, width=196))
    with pytest.raises(ValueError, match="multiples of 8"):
        buf = torch.zeros((2, 64, 2 * 16 + 4), dtype=torch.bfloat16,
                          device=cuda)
        ssd_scan_grouped(x, dt, a, buf[..., 4:].reshape(2, 64, 2, 16), c)
    with pytest.raises(ValueError, match="contiguous last dimension"):
        ssd_scan_grouped(x.transpose(2, 3).contiguous().transpose(2, 3),
                         dt, a, b, c)
    with pytest.raises(ValueError, match="H a multiple of G"):
        ssd_scan_grouped(x[:, :, :3], dt[:, :, :3], a[:3], b, c)
    with pytest.raises(ValueError, match="state N"):
        big = torch.zeros((2, 64, 2, 136), dtype=torch.bfloat16, device=cuda)
        ssd_scan_grouped(x, dt, a, big, big)
    with pytest.raises(ValueError, match="head_dim"):
        ssd_scan_grouped(x.reshape(2, 64, 2, 64)[..., :48], dt[:, :, :2],
                         a[:2], b, c)
    with pytest.raises(ValueError, match="do not match"):
        ssd_scan_grouped(x, dt[:, :-1], a, b, c)
    with pytest.raises(TypeError, match="dt, A in float32"):
        ssd_scan_grouped(x, dt.bfloat16(), a, b, c)


# The Mamba-2 conv's kernels: (batch, S, d_inner, G N, wc). mamba2-370m's
# training shape in the benchmark (24 x 2048, C = 2,304), zamba2-2.7b's
# (C = 5,248), and the edges: S = 1, S = 2 < wc - 1, widths off a multiple
# of 8, wc 1 to 3, more than one run of 32 tokens.
CONV_BIG = [(24, 2048, 2048, 128, 4), (8, 4096, 5120, 64, 4)]
CONV_EDGES = [(2, 1, 20, 6, 4), (1, 2, 12, 4, 4), (2, 9, 13, 3, 4),
              (2, 33, 24, 8, 2), (3, 40, 32, 16, 4), (2, 50, 16, 8, 1),
              (2, 50, 16, 8, 3), (2, 100, 64, 128, 4), (1, 70, 2048, 128, 4)]


def _conv_inputs(dev, shape, dtype, seed):
    """(x, B, C, w, b), then the cotangents of xbc's three parts."""
    bt, s, di, gn, wc = shape
    g = torch.Generator(device=dev).manual_seed(seed)

    def draw(*dims, scale=1.0):
        return (torch.randn(dims, generator=g, device=dev) * scale).to(dtype)

    ch = di + 2 * gn
    ins = (draw(bt, s, di), draw(bt, s, gn), draw(bt, s, gn),
           draw(ch, wc, scale=0.3), draw(ch, scale=0.1))
    return ins, (draw(bt, s, di), draw(bt, s, gn), draw(bt, s, gn))


def _conv_ids(shape):
    return "b{}s{}di{}gn{}wc{}".format(*shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", CONV_BIG + CONV_EDGES, ids=_conv_ids)
def test_causal_conv_bit_equal_to_plain(cuda, shape, dtype):
    """The forward kernel against ``models/ssm._causal_conv`` of the cat on
    the card: the same bits (the same IEEE roundings in the same order)."""
    from repro_torch.kernels.causal_conv import causal_conv, plain

    ins, _ = _conv_inputs(cuda, shape, dtype, 1)
    got = causal_conv(*ins)
    want = plain(*ins)
    assert got.is_contiguous() and torch.equal(got, want)


def _conv_oracle(x, B, C, w, b, douts):
    """The gradients (dx, dB, dC, dw, db) in f64, at the pre-activation u
    as the forward rounds it."""
    wc, s = w.shape[1], x.shape[1]
    pad = torch.nn.functional.pad(torch.cat([x, B, C], -1),
                                  (0, 0, wc - 1, 0))
    y = pad[:, 0:s].float() * w.float()[:, 0]
    for i in range(1, wc):
        y = y + pad[:, i:i + s].float() * w.float()[:, i]
    u = (y.to(x.dtype) + b).double()
    sig = torch.sigmoid(u)
    g = torch.cat(douts, -1).double() * sig * (1 + u * (1 - sig))
    del y, u, sig
    pad, wd = pad.double(), w.double()
    gp = torch.nn.functional.pad(g, (0, 0, 0, wc - 1))
    dxbc = sum(gp[:, wc - 1 - i:wc - 1 - i + s] * wd[:, i]
               for i in range(wc))
    dw = torch.stack([(g * pad[:, i:i + s]).sum((0, 1)) for i in range(wc)],
                     -1)
    di, gn = x.shape[-1], B.shape[-1]
    return (dxbc[..., :di], dxbc[..., di:di + gn], dxbc[..., di + gn:], dw,
            g.sum((0, 1)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", CONV_BIG + CONV_EDGES, ids=_conv_ids)
def test_causal_conv_backward_against_f64(cuda, shape, dtype):
    """dx, dB, dC, dw and db of the backward kernel against the f64
    gradients: in bf16 no further (in norm) than autograd's through the
    plain chain on the card, which rounds g, each shifted slice's gradient
    and their sums to bf16, and elementwise within one bf16 rounding of
    them (2^-7 |want| + 2^-7 max|want|: f32 sums, one rounding each); in
    f32 within 1e-5 |want| + 1e-5 max|want| (f32 sums in another order),
    as autograd's are."""
    from repro_torch.kernels.causal_conv import (causal_conv_backward,
                                                 plain, split)

    ins, douts = _conv_inputs(cuda, shape, dtype, 2)
    got = causal_conv_backward(*ins, *douts)
    leaves = [t.clone().requires_grad_(True) for t in ins]
    xbc = plain(*leaves)
    parts = split(xbc, shape[2], shape[3])
    auto = torch.autograd.grad(parts, leaves, douts)
    del xbc, parts, leaves
    want = _conv_oracle(*ins, douts)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    for name, k, a, o in zip(("dx", "dB", "dC", "dw", "db"), got, auto,
                             want):
        assert k.dtype == dtype and k.shape == o.shape, name
        scale = float(o.abs().max())
        torch.testing.assert_close(k.double(), o, rtol=tol, atol=tol * scale)
        if dtype == torch.float32:
            torch.testing.assert_close(a.double(), o, rtol=tol,
                                       atol=tol * scale)
    if dtype == torch.bfloat16:
        # the input's gradient (x, B and C together), dw, db
        for name, k, a, o in (("d(x, B, C)", torch.cat(got[:3], -1),
                               torch.cat(auto[:3], -1), torch.cat(want[:3],
                                                                  -1)),
                              ("dw", got[3], auto[3], want[3]),
                              ("db", got[4], auto[4], want[4])):
            err_k = float((k.double() - o).norm())
            err_a = float((a.double() - o).norm())
            assert err_k <= err_a, (name, err_k, err_a)


def test_causal_conv_backward_is_deterministic(cuda):
    """dw and db from per-run partials summed in a fixed order, no atomics:
    two launches give the same bits."""
    from repro_torch.kernels.causal_conv import causal_conv_backward

    ins, douts = _conv_inputs(cuda, (2, 700, 256, 64, 4), torch.bfloat16, 3)
    g1 = causal_conv_backward(*ins, *douts)
    g2 = causal_conv_backward(*ins, *douts)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_causal_conv_reads_strided_and_misaligned_rows(cuda, dtype):
    """x, B and C as views of one wider buffer, at offsets off 16 bytes (the
    element-by-element path) and with a padded row stride: the bits of the
    same values contiguous, both ways; an absent cotangent is zero."""
    from repro_torch.kernels.causal_conv import (causal_conv,
                                                 causal_conv_backward)

    shape = (2, 77, 64, 16, 4)
    ins, douts = _conv_inputs(cuda, shape, dtype, 4)
    x, B, C, w, b = ins
    buf = torch.zeros((2, 77, 64 + 2 * 16 + 11), dtype=dtype, device=cuda)
    views = (buf[..., 1:65], buf[..., 66:82], buf[..., 83:99])
    for v, t in zip(views, (x, B, C)):
        v.copy_(t)
    assert views[0].data_ptr() % 16
    assert torch.equal(causal_conv(*views, w, b), causal_conv(x, B, C, w, b))
    want = causal_conv_backward(x, B, C, w, b, douts[0], None, douts[2])
    got = causal_conv_backward(*views, w, b, douts[0], None, douts[2])
    assert all(torch.equal(a, c) for a, c in zip(got, want))
    zero = causal_conv_backward(x, B, C, w, b, douts[0],
                                torch.zeros_like(B), douts[2])
    assert all(torch.equal(a, c) for a, c in zip(zero, want))


def test_causal_conv_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels.causal_conv import (causal_conv,
                                                 causal_conv_backward)

    (x, B, C, w, b), douts = _conv_inputs(cuda, (2, 16, 32, 8, 4),
                                          torch.bfloat16, 5)
    with pytest.raises(TypeError, match="one dtype"):
        causal_conv(x.half(), B.half(), C.half(), w.half(), b.half())
    with pytest.raises(TypeError, match="one dtype"):
        causal_conv(x, B, C, w.float(), b)
    with pytest.raises(ValueError, match="one CUDA device"):
        causal_conv(x, B, C, w.cpu(), b)
    with pytest.raises(ValueError, match=r"wc in \[1, 4\]"):
        causal_conv(x, B, C, torch.zeros((48, 5), dtype=w.dtype,
                                         device=cuda), b)
    with pytest.raises(ValueError, match=r"wc in \[1, 4\]"):
        causal_conv(x, B, C, w, b[:-1])
    with pytest.raises(ValueError, match="w and b contiguous"):
        causal_conv(x, B, C, w.t().contiguous().t(), b)
    with pytest.raises(ValueError, match="contiguous last dimension"):
        causal_conv(x.transpose(1, 2).contiguous().transpose(1, 2), B, C, w,
                    b)
    with pytest.raises(ValueError, match="one \\(Bt, S\\)"):
        causal_conv(x, B[:, :-1], C, w, b)
    with pytest.raises(ValueError, match="shaped as"):
        causal_conv_backward(x, B, C, w, b, douts[0][:, :-1], *douts[1:])
    with pytest.raises(RuntimeError, match="requires grad"):
        causal_conv(x.clone().requires_grad_(True), B, C, w, b)


def test_causal_conv_function_launches_the_kernels(cuda):
    """``ops.causal_conv`` with ``use_cuda`` under autograd: one forward
    launch, and its backward one launch of the backward kernel, whose
    gradients are the raw entry's; the plain route launches nothing."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.causal_conv import (causal_conv,
                                                 causal_conv_backward)

    ins, douts = _conv_inputs(cuda, (2, 130, 64, 16, 4), torch.bfloat16, 6)
    leaves = [t.clone().requires_grad_(need)
              for t, need in zip(ins, (True, True, True, False, False))]
    before = (causal_conv.launches, causal_conv.backward_launches)
    outs = ops.causal_conv(*leaves, kcfg=ops.KernelConfig(use_cuda=True))
    got = torch.autograd.grad(outs, leaves[:3], douts)
    assert (causal_conv.launches - before[0],
            causal_conv.backward_launches - before[1]) == (1, 1)
    want = causal_conv_backward(*ins, *douts,
                                needs=(True, True, True, False, False))
    assert all(torch.equal(a, c) for a, c in zip(got, want[:3]))
    assert want[3:] == (None, None)
    before = (causal_conv.launches, causal_conv.backward_launches)
    ops.causal_conv(*ins, kcfg=ops.KernelConfig(use_cuda=False))
    assert (causal_conv.launches, causal_conv.backward_launches) == before


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b"])
def test_ssm_hybrid_serving_smoke_config_cuda_equals_cpu(cuda, arch):
    """The mamba2-370m and zamba2-2.7b smoke configs (f32) served greedily
    on the card (K2, K4, and K3 for zamba2) give the CPU plain path's
    tokens."""
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.serve import Request, ServingEngine

    cfg = get_smoke_config(arch)
    vals = convert.random_model_params(cfg, 14)
    prompts = np.random.default_rng(15).integers(0, cfg.vocab_size, (4, 16))
    reqs = [Request(p.astype(np.int32), 8) for p in prompts]
    before = (lora_matmul.launches, flash_attention.launches,
              ssd_scan.launches)
    got = ServingEngine(cfg, convert.model_params(vals, cfg, cuda),
                        max_len=64).generate_batch(reqs)
    hybrid = cfg.arch_type == "hybrid"
    assert (lora_matmul.launches - before[0],
            flash_attention.launches - before[1],
            ssd_scan.launches - before[2]) == (
        (8 if hybrid else 4) * 9, 2 if hybrid else 0, 2)
    want = ServingEngine(cfg, convert.model_params(vals, cfg, "cpu"),
                         max_len=64, device="cpu").generate_batch(reqs)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]


def test_serving_smoke_config_cuda_equals_cpu(cuda):
    """The llama2-7b smoke config (f32) served greedily on the card (K2, K3)
    gives the CPU plain path's tokens."""
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.serve import Request, ServingEngine

    cfg = get_smoke_config("llama2-7b")
    vals = convert.random_model_params(cfg, 12)
    prompts = np.random.default_rng(13).integers(0, cfg.vocab_size, (4, 16))
    reqs = [Request(p.astype(np.int32), 8) for p in prompts]
    before = (lora_matmul.launches, flash_attention.launches)
    got = ServingEngine(cfg, convert.model_params(vals, cfg, cuda),
                        max_len=64).generate_batch(reqs)
    assert (lora_matmul.launches - before[0],
            flash_attention.launches - before[1]) == (2 * 2 * 9, 2)
    want = ServingEngine(cfg, convert.model_params(vals, cfg, "cpu"),
                         max_len=64, device="cpu").generate_batch(reqs)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]


def test_full_width_two_layers_kernels_match_plain(cuda):
    """llama2-7b at full width, 2 layers, bf16: every forward's last-position
    logits with K2 / K3 against the same model on the plain versions,
    teacher-forced on the kernel run's tokens, within chip_smoke.py's bound
    (8 bf16 ulps of a logit in [4, 8))."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import KernelConfig
    from repro_torch.models import transformer as tf

    cfg = get_config("llama2-7b").reduced(
        num_layers=2, d_model=4096, num_heads=32, d_ff=11008,
        vocab_size=32000, dtype="bfloat16")
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = tf.init_params(gen, cfg)
    for lp in params["layers"]:
        for pair in lp["attn"]["lora"].values():
            pair["b"].normal_(0.0, 0.02, generator=gen)
    prompts = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen,
                            device=cuda)

    def run(kcfg, tokens=None):
        logits, cache = tf.prefill(cfg, params, {"tokens": prompts}, 256,
                                   kcfg)
        outs = [logits[:, -1]]
        for i in range(4):
            tok = (outs[-1].argmax(-1) if tokens is None else tokens[:, i])
            logits, cache = tf.decode_step(cfg, params,
                                           {"tokens": tok[:, None]}, cache,
                                           kcfg)
            outs.append(logits[:, -1])
        return torch.stack(outs)

    with torch.no_grad():
        kern = run(KernelConfig(True))
        tokens = kern[:-1].argmax(-1).T
        plain = run(KernelConfig(False), tokens)
    assert torch.isfinite(kern).all()
    assert float((kern - plain).abs().max()) <= 0.25


def test_fleet_cuda_bit_equal_to_plain_dp_on_card(cuda):
    """simulate_fleet on the card (one K1 forecast-entry launch a slot)
    against backend="torch" on the card: every leaf bit-equal, collect on.
    Arrivals in [0, 5) over 15 slots put rows before their job's arrival
    and past its deadline (eff_slots <= 0) into K1's batches."""
    from repro_torch.core import fast_sim, fleet
    from repro_torch.core.predictor import NoisyPredictor
    from repro_torch.workload import PAPER_JOB

    rng = np.random.default_rng(5)
    trace = paper_market(seed=29, days=3).window(0, 16)
    pred = NoisyPredictor(trace, "fixed_uniform", 0.1, seed=5).matrix(
        fast_sim.W1MAX - 1)[:15].astype(np.float32)
    prices = trace.prices[:15].astype(np.float32)
    avail = trace.avail[:15].astype(np.int64)
    n = 200
    arrivals = rng.integers(0, 5, size=n)
    pool = specs_to_arrays(paper_pool() + rand_deadline_pool()
                           + baseline_specs())
    idx = rng.integers(0, len(pool["kind"]), size=n)
    rows = {k: np.asarray(pool[k])[idx]
            for k in ("kind", "omega", "v", "sigma", "rho", "cfrac")}
    jobs = fast_sim.stack_jobs([PAPER_JOB] * n)
    seen = []
    solve = window_opt._solve_rows

    def spy(job, tput, z0, std, *rest):
        seen.append(int((std <= 0).sum()))
        return solve(job, tput, z0, std, *rest)

    before = window_dp_rows.launches
    got = fleet.simulate_fleet(rows, jobs, arrivals, PAPER_TPUT, prices,
                               avail, pred, collect=True)
    assert window_dp_rows.launches == before + 15
    window_opt._solve_rows = spy
    try:
        want = fleet.simulate_fleet(rows, jobs, arrivals, PAPER_TPUT, prices,
                                    avail, pred, backend="torch",
                                    collect=True)
    finally:
        window_opt._solve_rows = solve
    assert sum(seen) > 0, "no row past its deadline reached the DP"
    assert set(got) == set(want)
    for k in want:
        assert got[k].device.type == "cuda"
        assert torch.equal(got[k], want[k]), k


def test_apply_moe_cuda_matches_cpu_in_f32(cuda):
    """The MoE layer on the card against the CPU in f32: the routing (idx)
    and the kept tokens exact, also with a capacity that drops tokens; the
    output to f32 tolerance (cuBLAS's bmm sums in another order)."""
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe

    for factor in (1.25, 0.5):
        cfg = get_smoke_config("mixtral-8x7b")
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=factor))
        vals = convert.random_model_params(cfg, 4)["layers"]["moe"]
        p = {k: torch.from_numpy(v[0]) for k, v in vals.items()}
        x = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (3, 120, cfg.d_model), np.float32))
        cap = moe.expert_capacity(cfg, 120)
        runs = []
        for dev in ("cpu", cuda):
            pd = {k: v.to(dev) for k, v in p.items()}
            idx, _, _ = moe.route(cfg, pd["router"], x.to(dev))
            _, (_, _, _, keep) = moe._dispatch(cfg, x.to(dev), idx, cap)
            y, aux = moe.apply_moe(cfg, pd, x.to(dev))
            runs.append((idx.cpu(), keep.cpu(), y.cpu(), aux.cpu()))
        (i0, k0, y0, a0), (i1, k1, y1, a1) = runs
        assert torch.equal(i0, i1) and torch.equal(k0, k1)
        assert bool((~k0).any()) == (factor < 1.0)
        torch.testing.assert_close(y1, y0, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(a1, a0, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Training: the autograd Functions and the train step on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,r", [(256, 512, 384, 16), (333, 1024, 256, 64),
                                     (1000, 512, 768, 8)])
def test_k2_function_gradients_match_plain_autograd(cuda, m, k, n, r, dtype):
    """K2's Function on the card (forward K2, dx by K2 on W^T, B^T, A^T, dA
    and dB f32 rank-r products) against autograd through the plain version:
    y one rounding apart at bf16, the gradients within the sums' order
    (1e-4 relative, 1e-5 of the largest value in f32; a bf16 rounding)."""
    from repro_torch.kernels.lora_matmul import LoRAMatmul

    g = torch.Generator(device=cuda).manual_seed(m + r)
    x, dy = (torch.randn(s, generator=g, device=cuda).to(dtype)
             for s in ((m, k), (m, n)))
    w, a, b = ((torch.randn(s, generator=g, device=cuda) * 0.05).to(dtype)
               for s in ((k, n), (k, r), (r, n)))
    fwd, bwd = lora_matmul.launches, lora_matmul.backward_launches
    ins = [t.clone().requires_grad_(True) for t in (x, a, b)]
    y = LoRAMatmul.apply(ins[0], w, ins[1], ins[2], 2.0)
    got = torch.autograd.grad(y, ins, dy)
    torch.cuda.synchronize()
    assert (lora_matmul.launches - fwd, lora_matmul.backward_launches - bwd) \
        == (1, 1)
    ref = [t.clone().requires_grad_(True) for t in (x, a, b)]
    yr = lora_matmul_ref(ref[0], w, ref[1], ref[2], 2.0)
    want = torch.autograd.grad(yr, ref, dy)
    bf16 = dtype == torch.bfloat16
    torch.testing.assert_close(y.detach().float(), yr.detach().float(),
                               rtol=2.0 ** -7 if bf16 else 1e-4,
                               atol=1e-3 if bf16 else 1e-4)
    for gg, ww in zip(got, want):
        scale = float(ww.float().abs().max())
        torch.testing.assert_close(
            gg.float(), ww.float(), rtol=2.0 ** -7 if bf16 else 1e-4,
            atol=(2.0 ** -9 if bf16 else 1e-5) * scale)


def test_raw_launchers_refuse_grad_on_the_card(cuda):
    """The guard holds on CUDA tensors too: a direct launch under grad
    raises before launching."""
    x = torch.randn(64, 128, device=cuda, requires_grad=True)
    w = torch.randn(128, 128, device=cuda)
    a, b = torch.randn(128, 16, device=cuda), torch.randn(16, 128, device=cuda)
    before = lora_matmul.launches
    with pytest.raises(RuntimeError, match="lora_matmul"):
        lora_matmul(x, w, a, b, 1.0)
    q = torch.randn(2, 64, 64, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="flash_attention"):
        flash_attention(q, q.detach(), q.detach())
    xs = torch.randn(2, 64, 32, device=cuda, requires_grad=True)
    bs = torch.randn(2, 64, 16, device=cuda)
    with pytest.raises(RuntimeError, match="ssd_scan"):
        ssd_scan(xs, torch.rand(2, 64, device=cuda), -torch.rand(2,
                                                                 device=cuda),
                 bs, bs)
    assert lora_matmul.launches == before


@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_step_cuda_matches_cpu_in_f32(cuda, remat):
    """Three steps of make_train_step on the tiny-100m smoke config (f32):
    the card (K2 forward and backward, K3 forward) against the CPU's plain
    versions; losses and the LoRA leaves within f32 tolerance, the base
    leaves bit-unchanged."""
    from repro_torch import convert
    from repro_torch.configs import TrainConfig, get_smoke_config
    from repro_torch.data import ShardedLMLoader
    from repro_torch.train.step import init_opt_state, make_train_step
    from repro_torch.utils.partition import is_lora_path, partition_by_path

    cfg = get_smoke_config("tiny-100m")
    tcfg = TrainConfig(seq_len=64, global_batch=4, lr=2e-3, warmup_steps=2,
                       total_steps=20, remat=remat)
    vals = convert.random_model_params(cfg, 3)
    loader = ShardedLMLoader(cfg.vocab_size, 4, 64, seed=1)
    runs = []
    for dev in ("cpu", cuda):
        params = convert.model_params(vals, cfg, dev)
        base0 = [x.clone() for x in partition_by_path(
            params, lambda p: not is_lora_path(p))[0]]
        opt, step = init_opt_state(params), make_train_step(cfg, tcfg)
        losses = []
        for i in range(3):
            params, opt, m = step(params, opt, loader.batch_at(i))
            losses.append(float(m.loss))
        base = partition_by_path(params, lambda p: not is_lora_path(p))[0]
        assert all(torch.equal(x, y) for x, y in zip(base, base0))
        runs.append((losses, [x.cpu() for x in partition_by_path(
            params, is_lora_path)[0]]))
    (l0, p0), (l1, p1) = runs
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    for x, y in zip(p1, p0):
        torch.testing.assert_close(x, y, rtol=0, atol=2e-5)


def test_nccl_world_of_one_falls_through_bitwise(cuda, tmp_path):
    """A one-rank NCCL world on cuda:0: the pool mesh (1,) and (1, 1)
    sharded entry points (pool, regions, fleet) are their unsharded runs
    on the card, bit for bit, and the collective helper's NCCL route
    (gathered on the card) returns each dtype's bits."""
    import datetime

    import torch.distributed as dist

    from repro_torch.core import fast_sim, fleet
    from repro_torch.core.region_market import vast_like_regions
    from repro_torch.core.policy_pool import KIND_AHAP, region_pool
    from repro_torch.launch.mesh import all_gather, make_pool_mesh

    dist.init_process_group(
        "nccl", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        f = torch.tensor([-0.0, 1.5], device=cuda)
        b = torch.tensor([True, False], device=cuda)
        i = torch.arange(3, dtype=torch.int32, device=cuda)
        (got,) = all_gather([f, b, i])
        assert all(g.is_cuda for g in got)
        assert torch.equal(got[0].view(torch.int32), f.view(torch.int32))
        assert torch.equal(got[1], b) and torch.equal(got[2], i)
        rng = np.random.default_rng(3)
        jobs = job_stream_arrays(rng, 6)
        trace = paper_market(seed=21, days=2)
        t0s = rng.integers(0, len(trace) - 11, size=6)
        mkt = engine.prepare_noisy_inputs(trace, t0s, 10, "fixed_uniform",
                                          0.1, np.arange(6))
        pool = specs_to_arrays(paper_pool(omegas=(2, 3), sigmas=(0.3, 0.7))
                               + baseline_specs())
        regions = vast_like_regions(3, seed=1, days=1)
        rmkt = engine.prepare_noisy_inputs_regions(
            regions, np.arange(6) * 4, 10, "fixed_uniform", 0.1,
            np.arange(6))
        rpool = specs_to_arrays(region_pool())
        rows = {k: v[rng.integers(0, len(pool["kind"]), size=6)]
                for k, v in pool.items()}
        assert (rows["kind"] == KIND_AHAP).any()
        fargs = (rows, jobs, rng.integers(0, 4, size=6), PAPER_TPUT,
                 mkt[0][0], mkt[1][0], mkt[2][0])
        base = fast_sim.simulate_pool_jobs(pool, jobs, PAPER_TPUT, *mkt,
                                           collect=True)
        rbase = fast_sim.simulate_pool_regions(
            rpool, jobs, PAPER_TPUT, *rmkt, delta_mig=1, p_od=[1, 1.3, 0.8])
        fbase = fleet.simulate_fleet(*fargs, collect=True)
        for shape in ((1,), (1, 1)):
            mesh = make_pool_mesh(shape)
            for got, want in (
                    (fast_sim.simulate_pool_jobs_sharded(
                        pool, jobs, PAPER_TPUT, *mkt, mesh=mesh,
                        collect=True), base),
                    (fast_sim.simulate_pool_regions_sharded(
                        rpool, jobs, PAPER_TPUT, *rmkt, mesh=mesh,
                        delta_mig=1, p_od=[1, 1.3, 0.8]), rbase),
                    (fleet.simulate_fleet_sharded(*fargs, mesh=mesh,
                                                  collect=True), fbase)):
                assert set(got) == set(want)
                for k in want:
                    assert got[k].is_cuda and torch.equal(got[k], want[k]), k
    finally:
        dist.destroy_process_group()
