"""Window DP of the port: the plain torch DP (K1's reference) is bit-equal to
the JAX Pallas kernel (interpret mode) and to the JAX oracle, and the batched
window solver matches the reference's compiled solver and brute force. K1
itself is held against the plain DP on a card in test_torch_cuda.py."""
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
from repro_torch.kernels.ref import window_dp_ref
from repro_torch.kernels.window_dp import window_dp

torch.set_num_threads(1)

REF_TPUT = RefTput(mu1=0.9, mu2=0.95)
TPUT = ThroughputConfig(mu1=0.9, mu2=0.95)
SHAPES = [(1, 6, 16), (8, 6, 16), (13, 3, 5), (40, 1, 4)]


def _tables(b, w1, tn):
    """Random DP tables with BIG-priced entries, as the JAX kernel test
    builds them."""
    rng = np.random.default_rng(b * 131 + w1)
    kw, u1 = tn + 1, w1 * tn + 1
    slot_cost = rng.uniform(0.0, 3.0, (b, w1, kw)).astype(np.float32)
    slot_cost = np.where(rng.random((b, w1, kw)) < 0.3, 1.0e9, slot_cost)
    slot_cost[:, :, 0] = 0.0
    gain = np.cumsum(rng.uniform(0.0, 2.0, (b, u1)), axis=1).astype(
        np.float32)
    return slot_cost, gain


@pytest.mark.parametrize("b,w1,tn", SHAPES)
def test_plain_dp_bit_equal_to_jax_kernel_and_oracle(b, w1, tn):
    slot_cost, gain = _tables(b, w1, tn)
    n_tot, obj = window_dp_ref(torch.from_numpy(slot_cost),
                               torch.from_numpy(gain))
    for ref in (jax_window_dp(jnp.asarray(slot_cost), jnp.asarray(gain),
                              interpret=True),
                jax_window_dp_ref(jnp.asarray(slot_cost),
                                  jnp.asarray(gain))):
        np.testing.assert_array_equal(n_tot.numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(obj.numpy(), np.asarray(ref[1]))
    # the wrapper takes the plain version for CPU tensors, launching nothing
    before = window_dp.launches
    n2, o2 = window_dp(torch.from_numpy(slot_cost), torch.from_numpy(gain))
    assert torch.equal(n2, n_tot) and torch.equal(o2, obj)
    assert window_dp.launches == before


def test_plain_dp_rejects_bad_shapes():
    with pytest.raises(ValueError, match="does not match"):
        window_dp_ref(torch.zeros((2, 3, 5)), torch.zeros((2, 12)))
    with pytest.raises(ValueError, match="outside"):
        window_dp_ref(torch.zeros((1, 1, 129)), torch.zeros((1, 129)))


def _random_batch(rng, w1, b, job):
    prices = rng.uniform(0.05, 1.5, (b, w1)).astype(np.float32)
    avail = rng.integers(0, 17, (b, w1)).astype(np.int32)
    z0 = rng.uniform(0, job.workload, b).astype(np.float32)
    std = rng.integers(0, w1 + 1, b).astype(np.int32)
    return z0, std, prices, avail


def _random_job(rng):
    return dict(workload=float(rng.uniform(5.0, 150.0)),
                deadline=int(rng.integers(2, 12)),
                n_min=int(rng.integers(1, 3)), n_max=int(rng.integers(4, 16)),
                value=float(rng.uniform(10.0, 300.0)),
                gamma=float(rng.uniform(1.1, 3.0)))


@pytest.mark.parametrize("seed", range(6))
def test_solve_window_batch_matches_reference(seed):
    """Shared job (python scalars) and per-row (B,) job fields against the
    reference's compiled ``backend="xla"`` solver: n_o / n_s exact, the
    objective to rtol 1e-6 plus atol 1e-4. XLA contracts the gain's
    ``value - p_o * n_max * dt`` into an FMA and torch rounds the product
    first: one ulp of the gain (<= 3.1e-5 below 512), which survives in
    full when gain and cost nearly cancel."""
    rng = np.random.default_rng(seed)
    w1 = int(rng.integers(1, 7))
    b = int(rng.integers(1, 24))
    kw = _random_job(rng)
    z0, std, prices, avail = _random_batch(rng, w1, b, RefJob(**kw))
    ref_job, job = RefJob(**kw), JobConfig(**kw)

    shared = jax.jit(lambda *a: ref_wo.solve_window_batch(
        ref_job, REF_TPUT, *a, ref_job.on_demand_price, table_n=16,
        backend="xla"))
    want = shared(z0, std, prices, avail)
    got = window_opt.solve_window_batch(
        job, TPUT, z0, std, prices, avail, job.on_demand_price, 16,
        backend="torch", device="cpu")
    _assert_solution(got, want)

    # per-row jobs: every row its own job and on-demand price
    rows = [_random_job(rng) for _ in range(b)]
    cols = {f: np.array([r[f] for r in rows]) for f in rows[0]}
    dt = {"deadline": np.int32, "n_min": np.int32, "n_max": np.int32}
    cols = {f: v.astype(dt.get(f, np.float32)) for f, v in cols.items()}
    p_o = rng.uniform(0.6, 1.4, b).astype(np.float32)
    z0 = rng.uniform(0, cols["workload"]).astype(np.float32)
    per_row = jax.jit(lambda c, po, *a: ref_wo.solve_window_batch(
        RefJob(**c), REF_TPUT, *a, po, table_n=16, backend="xla"))
    want = per_row(cols, p_o, z0, std, prices, avail)
    got = window_opt.solve_window_batch(
        JobConfig(**{f: torch.from_numpy(v) for f, v in cols.items()}),
        TPUT, z0, std, prices, avail, torch.from_numpy(p_o), 16,
        backend="torch", device="cpu")
    _assert_solution(got, want)


def _assert_solution(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-6, atol=1e-4)


def test_unit_cost_table_feasibility_pricing():
    job = JobConfig(workload=80, deadline=10, n_min=2, n_max=4, value=120.0)
    prices = torch.tensor([[0.5, 2.0, 0.3]])
    avail = torch.tensor([[3, 5, 0]], dtype=torch.int32)
    slot_cost, spot_units, gain = window_opt._unit_cost_table(
        job, TPUT, torch.zeros(1), torch.tensor([2], dtype=torch.int32),
        prices, avail, 1.0, tn=4)
    slot_cost = slot_cost[0].numpy()
    assert np.all(slot_cost[:, 0] == 0.0)
    assert np.all(slot_cost[:, 1] >= 1.0e8)
    assert spot_units[0].tolist() == [3, 0, 0]
    assert slot_cost[2, 2] >= 1.0e8
    assert abs(slot_cost[0, 3] - 1.5) < 1e-6
    assert abs(slot_cost[1, 2] - 2.0) < 1e-6
    g = gain[0].numpy()
    assert g.shape == (13,) and np.all(np.diff(g) >= -1e-5)


@pytest.mark.parametrize("seed", range(5))
def test_solve_window_matches_brute_force(seed):
    """The achieved plan utility equals the brute-force optimum (alpha = 1,
    beta = 0: exact), and the port's brute force equals the reference's."""
    rng = np.random.default_rng(seed)
    kw = dict(workload=float(rng.uniform(5, 40)),
              deadline=int(rng.integers(2, 8)), n_min=1,
              n_max=int(rng.integers(2, 5)),
              value=float(rng.uniform(10, 100)),
              gamma=float(rng.uniform(1.2, 2.5)))
    job = JobConfig(**kw)
    w1 = int(rng.integers(1, 4))
    z0, std, prices, avail = _random_batch(rng, w1, 1, job)
    n_o, n_s, obj = window_opt.solve_window(
        job, TPUT, float(z0[0]), int(std[0]), prices[0], avail[0],
        job.on_demand_price, table_n=job.n_max, device="cpu")
    bf_obj, bf_plan = window_opt.brute_force_window(
        job, TPUT, float(z0[0]), int(std[0]), prices[0], avail[0],
        job.on_demand_price)
    ref_obj, ref_plan = ref_wo.brute_force_window(
        RefJob(**kw), REF_TPUT, float(z0[0]), int(std[0]), prices[0],
        avail[0], job.on_demand_price)
    assert bf_plan == ref_plan and abs(bf_obj - ref_obj) < 1e-9
    from repro_torch.core.job import tilde_value
    n_o, n_s = n_o.numpy(), n_s.numpy()
    z = float(z0[0]) + float((n_o + n_s).sum())
    cost = float((n_s * prices[0]).sum() + n_o.sum() * job.on_demand_price)
    u = float(tilde_value(job, TPUT, torch.tensor(z))) - cost
    tol = 1e-3 * (1 + abs(bf_obj))
    assert abs(u - bf_obj) < tol, (u, bf_obj, bf_plan)
    assert abs(float(obj) - bf_obj) < tol
