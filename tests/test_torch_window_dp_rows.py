"""K1's redesigned arithmetic on the CPU, against the JAX package.

K1 (``src/repro_torch/kernels/csrc/window_dp.cu``) runs only on a card. Its
redesign is emulated here in numpy, step for step as the kernel takes it:

- the forward pass keeps only the min (no argmin) and skips every candidate
  that reads a unit beyond the reachable region (u - k > tau * tn);
- the objective takes the first max over C < BIG/2;
- the backtrack recomputes the choice at the path's unit from the stored
  states C_1..C_{w1-1} (their reachable prefixes), first strict minimum in
  k order;
- the forecast entry builds each row's cost table and gain with the
  kernel's f32 op order, then splits the plan and un-biases the objective.

The emulation must be bit-equal to the plain DP (``window_dp_ref``) and to
the JAX kernel (interpret mode), and the forecast entry's plain chain
(``window_dp_rows_ref``) bit-equal to the emulation and to the solver's
``"torch"`` backend, and to the reference's compiled solver within the
tolerances of ``test_solve_window_batch_matches_reference``. States beyond
the reachable region start as NaN in the emulation, so a read of one
shows."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import JobConfig as RefJob
from repro.configs.base import ThroughputConfig as RefTput
from repro.core import window_opt as ref_wo
from repro.kernels.ref import window_dp_ref as jax_window_dp_ref
from repro.kernels.window_dp import window_dp as jax_window_dp
from repro_torch.configs.base import JobConfig, ThroughputConfig
from repro_torch.core import window_opt
from repro_torch.core.window_opt import TIE_EPS, window_dp_rows_ref
from repro_torch.kernels.ref import BIG, window_dp_ref
from repro_torch.kernels.window_dp import window_dp, window_dp_rows

torch.set_num_threads(1)

F32 = np.float32
REF_TPUT = RefTput(mu1=0.9, mu2=0.95)
TPUT = ThroughputConfig(mu1=0.9, mu2=0.95)
# a throughput model whose alpha and beta do not round to f32 exactly
ODD_TPUT = ThroughputConfig(alpha=0.7, beta=0.3, mu1=0.9, mu2=0.95)
W1S, TNS = (1, 3, 6), (4, 5, 16)


def emulate_dp(cost, gain):
    """K1's static kernel in numpy over rows: (n_tot (B, w1) i32, obj)."""
    b, w1, kw = cost.shape
    tn, u1 = kw - 1, gain.shape[1]
    rows = np.arange(b)
    c = np.full((b, u1), np.nan, F32)
    c[:, 0] = 0.0
    hist = []
    for tau in range(w1):
        reach = tau * tn
        nxt = c.copy()
        for u in range(reach + tn + 1):
            klo, khi = max(0, u - reach), min(tn, u)
            best = c[:, u - klo] + cost[:, tau, klo]
            for k in range(klo + 1, khi + 1):
                best = np.minimum(best, c[:, u - k] + cost[:, tau, k])
            nxt[:, u] = best
        c = nxt
        hist.append(c)
    keep = c < F32(BIG / 2)
    o = np.where(keep, gain - np.where(keep, c, 0), -np.inf).astype(F32)
    u_star = np.argmax(o, axis=1)
    obj = o[rows, u_star]
    n_tot = np.zeros((b, w1), np.int32)
    u = u_star.copy()
    for tau in range(w1 - 1, 0, -1):
        reach, h = tau * tn, hist[tau - 1]
        best = np.full(b, np.inf, F32)
        bk = np.zeros(b, np.int64)
        for k in range(tn + 1):
            j = u - k
            ok = (j >= 0) & (j <= reach)
            cand = np.where(ok, h[rows, np.clip(j, 0, u1 - 1)]
                            + cost[:, tau, k], np.inf).astype(F32)
            take = cand < best
            best = np.where(take, cand, best)
            bk = np.where(take, k, bk)
        n_tot[:, tau] = bk
        u = u - bk
    n_tot[:, 0] = u
    return n_tot, obj


def emulate_rows(cols, z0, std, prices, avail, tput, tn):
    """K1's forecast entry in numpy: the cost table and gain with the
    kernel's f32 op order (csrc/window_dp.cu RowSlot::cost,
    ForecastRow::gain), emulate_dp, the split and the un-bias. The slot
    cost's __fmaf_rn is taken as the f64 sum rounded once (exact here)."""
    b, w1 = prices.shape
    alpha, beta = F32(tput.alpha), F32(tput.beta)
    col = lambda f: cols[f][:, None]
    n_max, p_o = col("n_max"), col("on_demand_price")
    in_h = np.arange(w1)[None, :] < std[:, None]
    spot = np.where((prices <= p_o) & in_h, np.minimum(avail, n_max), 0)
    ks = np.arange(tn + 1, dtype=F32)[None, None, :]
    n_sp = np.minimum(ks, spot[..., None].astype(F32))
    t = (ks - n_sp) * p_o[..., None]
    c = (n_sp.astype(np.float64) * prices[..., None].astype(np.float64)
         + t.astype(np.float64)).astype(F32)
    ok = (ks == 0) | ((ks >= col("n_min")[..., None])
                      & (ks <= n_max[..., None]) & in_h[..., None])
    cost = np.where(ok, c, F32(BIG)).astype(F32)

    uf = np.arange(w1 * tn + 1, dtype=F32)[None, :]
    d = col("deadline").astype(F32)
    rate = n_max.astype(F32) * alpha + beta
    gm1d = (col("gamma") - F32(1.0)) * d
    pon = p_o * n_max.astype(F32)
    zs = z0[:, None] + alpha * uf
    rem = np.maximum(col("workload") - zs, F32(0.0))
    dt = rem / rate
    tt = d + dt
    with np.errstate(divide="ignore", invalid="ignore"):
        decay = col("value") * (F32(1.0) - (tt - d) / gm1d)
    val = np.where(tt <= d, col("value"),
                   np.minimum(np.maximum(decay, F32(0.0)), col("value")))
    gain = ((val - pon * dt) - F32(TIE_EPS) * uf).astype(F32)

    n_tot, obj = emulate_dp(cost, gain)
    n_s = np.minimum(n_tot, spot).astype(np.int32)
    obj = obj + F32(TIE_EPS) * n_tot.sum(axis=1).astype(F32)
    return n_tot - n_s, n_s, obj


def _tables(rng, b, w1, tn, kind):
    """DP tables: ``big`` uniform costs with 30% BIG entries; ``ties``
    integer costs and integer gains (ties in the DP and the objective);
    ``priced_out`` every k >= 1 at BIG in some rows and some slots. The
    zero-unit column is 0, as the unit-cost table has it."""
    kw, u1 = tn + 1, w1 * tn + 1
    if kind == "ties":
        cost = rng.integers(0, 4, (b, w1, kw)).astype(F32)
        gain = np.cumsum(rng.integers(0, 3, (b, u1)), axis=1).astype(F32)
    else:
        cost = rng.uniform(0.0, 3.0, (b, w1, kw)).astype(F32)
        gain = np.cumsum(rng.uniform(0.0, 2.0, (b, u1)), axis=1).astype(F32)
    cost = np.where(rng.random((b, w1, kw)) < 0.3, F32(BIG), cost)
    if kind == "priced_out":
        out = rng.random((b, w1)) < 0.5
        out[: b // 4] = True                       # whole rows priced out
        cost[:, :, 1:] = np.where(out[..., None], F32(BIG), cost[:, :, 1:])
    cost[:, :, 0] = 0.0
    return cost, gain


@pytest.mark.parametrize("w1", W1S)
@pytest.mark.parametrize("tn", TNS)
def test_redesigned_dp_bit_equal_to_plain_and_jax(w1, tn):
    rng = np.random.default_rng(100 * w1 + tn)
    parts = [_tables(rng, 12, w1, tn, kind)
             for kind in ("big", "ties", "priced_out")]
    cost = np.concatenate([p[0] for p in parts])
    gain = np.concatenate([p[1] for p in parts])
    n_e, o_e = emulate_dp(cost, gain)
    n_r, o_r = window_dp_ref(torch.from_numpy(cost), torch.from_numpy(gain))
    np.testing.assert_array_equal(n_e, n_r.numpy())
    np.testing.assert_array_equal(o_e, o_r.numpy())
    n_j, o_j = jax_window_dp(jnp.asarray(cost), jnp.asarray(gain),
                             interpret=True)
    np.testing.assert_array_equal(n_e, np.asarray(n_j))
    np.testing.assert_array_equal(o_e, np.asarray(o_j))
    n_o, o_o = jax_window_dp_ref(jnp.asarray(cost), jnp.asarray(gain))
    np.testing.assert_array_equal(n_e, np.asarray(n_o))
    np.testing.assert_array_equal(o_e, np.asarray(o_o))
    # the region is what the argument says: ties did occur, and some rows
    # took a plan of more than one slot
    assert (n_e.sum(axis=1) > 0).any()


def _random_rows(rng, b, w1, tn):
    """Forecast rows as the pool simulator passes them, widened to reach
    the cases the kernel branches on: prices on a 1/8 grid (ties) and above
    p_o, slots past the deadline (slots_to_deadline in [-1, w1 + 1]),
    n_min > 1, n_max above and below tn, progress past the workload."""
    cols = {
        "workload": rng.uniform(5.0, 150.0, b).astype(F32),
        "deadline": rng.integers(2, 12, b).astype(np.int32),
        "n_min": rng.integers(1, 4, b).astype(np.int32),
        "n_max": rng.integers(2, tn + 3, b).astype(np.int32),
        "value": rng.uniform(10.0, 300.0, b).astype(F32),
        "gamma": rng.uniform(1.1, 3.0, b).astype(F32),
        "on_demand_price": rng.choice(
            np.array([1.0, 0.875, 1.3], F32), b).astype(F32),
    }
    prices = (np.round(rng.uniform(0.05, 1.6, (b, w1)) * 8) / 8).astype(F32)
    avail = rng.integers(0, tn + 3, (b, w1)).astype(np.int32)
    z0 = rng.uniform(0, 1.2 * cols["workload"]).astype(F32)
    std = rng.integers(-1, w1 + 2, b).astype(np.int32)
    return cols, z0, std, prices, avail


def _torch_job(cols):
    return JobConfig(**{f: torch.from_numpy(v) for f, v in cols.items()})


@pytest.mark.parametrize("w1", W1S)
@pytest.mark.parametrize("tn", TNS)
@pytest.mark.parametrize("tput", [TPUT, ODD_TPUT], ids=["paper", "odd"])
def test_forecast_entry_emulation_bit_equal_to_plain_chain(w1, tn, tput):
    rng = np.random.default_rng(7 * w1 + tn)
    cols, z0, std, prices, avail = _random_rows(rng, 64, w1, tn)
    want = emulate_rows(cols, z0, std, prices, avail, tput, tn)
    args = (torch.from_numpy(z0), torch.from_numpy(std),
            torch.from_numpy(prices), torch.from_numpy(avail))
    got = window_dp_rows_ref(_torch_job(cols), tput, *args, tn)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    # the solver's "torch" backend is that chain
    solved = window_opt.solve_window_batch(
        _torch_job(cols), tput, *args, torch.from_numpy(
            cols["on_demand_price"]), tn, backend="torch", device="cpu")
    for s, g in zip(solved, got):
        assert torch.equal(s, g)


@pytest.mark.parametrize("seed", range(4))
def test_forecast_chain_matches_reference_solver(seed):
    """The forecast entry's plain chain against the reference's compiled
    per-row solver (``backend="xla"``): n_o / n_s exact, the objective to
    the rtol 1e-6 plus atol 1e-4 of
    test_torch_window_dp.py::test_solve_window_batch_matches_reference (XLA
    contracts the gain's value - p_o * n_max * dt into an FMA)."""
    rng = np.random.default_rng(50 + seed)
    w1 = (1, 3, 6, 6)[seed]
    cols, z0, std, prices, avail = _random_rows(rng, 48, w1, 16)
    std = np.clip(std, 0, None)
    per_row = jax.jit(lambda c, po, *a: ref_wo.solve_window_batch(
        RefJob(**c), REF_TPUT, *a, po, table_n=16, backend="xla"))
    ref_cols = {f: v for f, v in cols.items() if f != "on_demand_price"}
    want = per_row(ref_cols, cols["on_demand_price"], z0, std, prices, avail)
    got = window_dp_rows_ref(
        _torch_job(cols), TPUT, torch.from_numpy(z0), torch.from_numpy(std),
        torch.from_numpy(prices), torch.from_numpy(avail), 16)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-6, atol=1e-4)


def test_forecast_entry_on_cpu_tensors_launches_nothing():
    rng = np.random.default_rng(3)
    cols, z0, std, prices, avail = _random_rows(rng, 16, 6, 16)
    args = (torch.from_numpy(z0), torch.from_numpy(std),
            torch.from_numpy(prices), torch.from_numpy(avail))
    before = (window_dp.launches, window_dp_rows.launches)
    got = window_dp_rows(_torch_job(cols), TPUT, *args, 16)
    want = window_dp_rows_ref(_torch_job(cols), TPUT, *args, 16)
    assert (window_dp.launches, window_dp_rows.launches) == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_forecast_entry_refuses_a_device_mix_before_building():
    """A tensor off the CPU sends the call to the kernel, whose checks
    refuse a mix of devices before anything is built or launched."""
    rng = np.random.default_rng(4)
    cols, z0, std, prices, avail = _random_rows(rng, 4, 6, 16)
    before = window_dp.launches
    with pytest.raises(ValueError, match="one CUDA device"):
        window_dp_rows(_torch_job(cols), TPUT, torch.from_numpy(z0),
                       torch.from_numpy(std),
                       torch.from_numpy(prices).to("meta"),
                       torch.from_numpy(avail), 16)
    assert window_dp.launches == before


def test_pool_simulator_hands_k1_dense_rows():
    """The AHAP scaffolding lays prices and availability out so that the
    window solve's rows are dense views: K1 reads them in place."""
    from repro_torch.core import fast_sim

    rng = np.random.default_rng(5)
    k, p = 3, 4
    jobs = fast_sim.jobs_to(fast_sim.stack_jobs([JobConfig()] * k), "cpu")
    j3 = fast_sim._columns(jobs, 2)
    omega = torch.tensor([0, 2, 5, 5])
    sigma = torch.tensor([1.0, 0.9, 1.1, 1.0])
    rho = torch.tensor([1.0, 0.8, 0.6, 1.0])
    pred_t = torch.from_numpy(np.stack(
        [rng.uniform(0.2, 1.5, (k, 6)), rng.integers(0, 17, (k, 6))],
        axis=-1).astype(F32))
    pr, _, _, _ = fast_sim._ahap_precompute(j3, omega, sigma, rho, 0, pred_t)
    prices = pr[0].reshape(k * p, fast_sim.W1MAX)
    assert prices.is_contiguous()
    assert torch.equal(prices.reshape(k, p, -1)[:, 1], pred_t[..., 0])
