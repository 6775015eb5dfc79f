"""The port's EG selector and selection engine against the JAX package's.

The simulator's utilities match the reference to ~1e-5 (see
test_torch_fast_sim.py) and the EG loop takes its dot and its sums over M in
another order than XLA's, so weights and regret match to f32 tolerance; the
winner and the iters-to-half convergence metric match exactly."""
import dataclasses

import numpy as np
import pytest
import torch

from benchmarks.common import PAPER_TPUT as REF_TPUT
from benchmarks.fig9_convergence import _engine_inputs
from repro.core import engine as ref_engine
from repro.core import selector as ref_sel
from repro.core.policy_pool import paper_pool, specs_to_arrays
from repro_torch import convert
from repro_torch.configs.base import ThroughputConfig
from repro_torch.core import engine, selector

torch.set_num_threads(2)

TPUT = ThroughputConfig(**dataclasses.asdict(REF_TPUT))
POOL = specs_to_arrays(paper_pool())
N_JOBS = 48
# regret is the difference of two f32 running sums of up to K terms in
# [0, 1], accumulated in another order than XLA's: compare it to 1e-5 per
# job (the sums themselves match to ~1e-6 relative)
REGRET_ATOL = 1e-5


def _utilities(seed, k=60, m=30):
    rng = np.random.default_rng(seed)
    means = rng.uniform(0.2, 0.8, m)
    return np.clip(means + rng.normal(0, 0.2, (k, m)), -0.1, 1.1).astype(
        np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_eg_scan_matches_reference(seed):
    u = _utilities(seed)
    k, m = u.shape
    ref_state, ref_traj = ref_sel.run_eg_scan(ref_sel.eg_init(m, k), u,
                                              track_history=True)
    state, traj = selector.run_eg_scan(
        selector.eg_init(m, k, device="cpu"), torch.from_numpy(u),
        track_history=True)
    np.testing.assert_allclose(state.weights.numpy(),
                               np.asarray(ref_state.weights), atol=1e-6)
    np.testing.assert_allclose(state.cum_utils.numpy(),
                               np.asarray(ref_state.cum_utils), rtol=1e-6)
    np.testing.assert_allclose(float(state.cum_expected),
                               float(ref_state.cum_expected), rtol=1e-5)
    assert int(state.k) == int(ref_state.k) == k
    for key in ("max_weight", "weights"):
        np.testing.assert_allclose(traj[key].numpy(),
                                   np.asarray(ref_traj[key]), atol=1e-5,
                                   err_msg=key)
    np.testing.assert_allclose(traj["regret"].numpy(),
                               np.asarray(ref_traj["regret"]),
                               atol=REGRET_ATOL * k)
    assert selector.best_policy(state) == ref_sel.best_policy(ref_state)
    assert selector.iters_to_half(traj["max_weight"]) == \
        ref_sel.iters_to_half(ref_traj["max_weight"])


def test_eg_scan_exact_ties_pick_first():
    u = np.tile(np.array([[0.3, 0.9, 0.9, 0.1]], np.float32), (20, 1))
    state, _ = selector.run_eg_scan(selector.eg_init(4, 20, device="cpu"),
                                    torch.from_numpy(u))
    assert selector.best_policy(state) == 1
    state, traj = selector.run_eg_scan(state, torch.zeros((0, 4)))
    assert traj["max_weight"].shape == (0,) and int(state.k) == 20


@pytest.mark.parametrize("kind,level", [
    ("magdep_uniform", 0.1), ("fixed_uniform", 0.1),
    ("magdep_heavytail", 0.3), ("fixed_heavytail", 0.3),
])
def test_simulate_and_select_matches_reference(kind, level):
    jobs, prices, avail, preds = _engine_inputs(kind, level, N_JOBS, 7)
    want = ref_engine.simulate_and_select(POOL, jobs, REF_TPUT, prices,
                                          avail, preds, sharded=False,
                                          return_utilities=True)
    got = engine.simulate_and_select(POOL, jobs, TPUT, prices, avail, preds,
                                     device="cpu", return_utilities=True)
    assert got.best_policy() == want.best_policy()
    assert got.iters_to_half() == want.iters_to_half()
    np.testing.assert_allclose(got.utilities, want.utilities, rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(got.mean_utility, want.mean_utility,
                               rtol=1e-5)
    np.testing.assert_allclose(got.max_weight, want.max_weight, atol=1e-5)
    np.testing.assert_allclose(got.regret, want.regret,
                               atol=REGRET_ATOL * N_JOBS)
    assert abs(got.regret_ratio() - want.regret_ratio()) < 1e-3


def test_chunked_equals_unchunked_and_state_threads():
    jobs, prices, avail, preds = _engine_inputs("fixed_uniform", 0.1, 20, 3)
    full = engine.simulate_and_select(POOL, jobs, TPUT, prices, avail, preds,
                                      device="cpu", track_history=True)
    for chunk in (1, 7, 20, 64):
        part = engine.simulate_and_select(POOL, jobs, TPUT, prices, avail,
                                          preds, device="cpu",
                                          job_chunk=chunk,
                                          track_history=True)
        np.testing.assert_array_equal(part.max_weight, full.max_weight)
        np.testing.assert_array_equal(part.regret, full.regret)
        np.testing.assert_array_equal(part.weight_history,
                                      full.weight_history)
        np.testing.assert_allclose(part.mean_utility, full.mean_utility,
                                   rtol=1e-6)
    with pytest.raises(ValueError, match="job_chunk"):
        engine.simulate_and_select(POOL, jobs, TPUT, prices, avail, preds,
                                   device="cpu", job_chunk=-1)

    # state= continues a stream: two halves equal one run ...
    sl = lambda x, lo, hi: type(jobs)(*[f[lo:hi] for f in x])
    first = engine.simulate_and_select(
        POOL, sl(jobs, 0, 12), TPUT, prices[:12], avail[:12], preds[:12],
        device="cpu", state=selector.eg_init(112, 20, device="cpu"))
    second = engine.simulate_and_select(
        POOL, sl(jobs, 12, 20), TPUT, prices[12:], avail[12:], preds[12:],
        device="cpu", state=first.state)
    np.testing.assert_array_equal(
        np.concatenate([first.max_weight, second.max_weight]),
        full.max_weight)
    assert torch.equal(second.state.weights, full.state.weights)
    assert int(second.state.k) == 20

    # ... and a stream begun in the reference continues in the port and back
    ref_first = ref_engine.simulate_and_select(
        POOL, sl(jobs, 0, 12), REF_TPUT, prices[:12], avail[:12],
        preds[:12], sharded=False, state=ref_sel.eg_init(112, 20))
    cont = engine.simulate_and_select(
        POOL, sl(jobs, 12, 20), TPUT, prices[12:], avail[12:], preds[12:],
        device="cpu", state=convert.eg_state(ref_first.state, "cpu"))
    back = ref_sel.EGState(**convert.eg_state_to_numpy(cont.state))
    np.testing.assert_allclose(np.asarray(back.weights),
                               full.state.weights.numpy(), atol=1e-6)
    assert int(back.k) == 20
