"""The port's chaos layer against the JAX package's: fault injection and the
regime generators bit for bit, and the prediction-failure monitor in the
pool simulator held against the reference's compiled ``simulate_pool_jobs``
on the same numpy inputs (``_pool_setup`` of tests/test_chaos.py: 4 jobs,
a 7-lane pool, a storm + stale-forecast schedule).

Tolerances. Allocations (``n_od`` / ``n_spot``), ``completed``, the
monitor's ``tel_fallback`` and the event series are exact, and so is the
monitor's error EWMA ``tel_pred_err``: the port rounds both of its blends
once, as XLA's fused multiply-add does (an ulp there flips the strict
threshold test). ``cost`` / ``utility`` and the f32 telemetry hold to
rtol 1e-5, atol 1e-4 (ROADMAP Queue 3, entry 3: the slot bill's FMA)."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from benchmarks.common import PAPER_TPUT as REF_TPUT
from repro import chaos as ref_chaos
from repro.core import engine as ref_engine
from repro.core import fast_sim as ref_fs
from repro.data import synthetic as ref_syn
from repro.obs import pool_ledger as ref_pool_ledger
from repro.obs import selection_ledger as ref_selection_ledger
from repro_torch import chaos
from repro_torch.configs.base import ThroughputConfig
from repro_torch.core import engine, fast_sim
from repro_torch.core.policy_pool import KIND_AHAP
from repro_torch.data import synthetic
from repro_torch.obs import FALLBACK_KEYS, SLOT_KEYS, pool_ledger
from repro_torch.obs import selection_ledger
from test_chaos import _pool_setup

torch.set_num_threads(2)

TPUT = ThroughputConfig(**dataclasses.asdict(REF_TPUT))
STORM = dict(threshold=0.5, lam=0.5)
RTOL, ATOL = 1e-5, 1e-4


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _assert_matches(got: dict, want: dict):
    """Port result (tensors) against the reference's: integer and bool
    leaves and the monitor's EWMA exact, other floats to RTOL / ATOL."""
    assert set(got) == set(want)
    for k, w in want.items():
        w, g = np.asarray(w), got[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if w.dtype.kind in "biu" or k == "tel_pred_err":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=k)


def _cfg(ref=False, **kw):
    return (ref_chaos if ref else chaos).FallbackConfig(**kw)


def _run(setup, collect=False, fallback=None):
    arrs, jobs, prices, avail, preds = setup
    return fast_sim.simulate_pool_jobs(arrs, jobs, TPUT, prices, avail,
                                       preds, device="cpu", collect=collect,
                                       fallback=fallback)


# ---------------------------------------------------------------------------
# fault transforms, schedules and regime generators: bit-equal copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fault_transforms_bit_equal(seed):
    rng = np.random.default_rng(seed)
    prices = rng.uniform(0.05, 2.0, (3, 24))
    avail = rng.integers(0, 16, (3, 24))
    preds = rng.uniform(0, 8, (3, 24, 6, 2)).astype(np.float32)
    faults = tuple(
        ref_chaos.FaultSpec(str(k), int(rng.integers(0, 30)),
                            int(rng.integers(0, 12)),
                            float(rng.uniform(0, 5)))
        for k in rng.choice(ref_chaos.FAULT_KINDS, 3))
    port_faults = tuple(chaos.FaultSpec(**dataclasses.asdict(f))
                        for f in faults)
    for a, b in zip(ref_chaos.inject(prices, avail, preds, faults),
                    chaos.inject(prices, avail, preds, port_faults)):
        _eq(a, b)
    for a, b in zip(ref_chaos.inject_market(prices, avail, faults),
                    chaos.inject_market(prices, avail, port_faults)):
        _eq(a, b)
    _eq(ref_chaos.inject_forecasts(preds, faults),
        chaos.inject_forecasts(preds, port_faults))
    _eq(ref_chaos.sync_present(preds, prices, avail),
        chaos.sync_present(preds, prices, avail))
    for f, g in zip(faults, port_faults):
        _eq(ref_chaos.window_mask(24, f), chaos.window_mask(24, g))
    # a regional blackout on (R, T)
    av_r = rng.integers(0, 9, (4, 20))
    blk = ref_chaos.blackout_schedule(seed, 20, 4, n_events=2)
    pblk = chaos.blackout_schedule(seed, 20, 4, n_events=2)
    assert [dataclasses.asdict(f) for f in blk] == \
        [dataclasses.asdict(f) for f in pblk]
    _eq(ref_chaos.inject_market(np.ones(20), av_r, blk)[1],
        chaos.inject_market(np.ones(20), av_r, pblk)[1])


@pytest.mark.parametrize("kw", [
    dict(n_storms=2, storm_len=3), dict(n_storms=3, storm_len=4,
                                        spike_mag=2.5),
    dict(n_storms=1, storm_len=4, pred_fault="outage"),
    dict(n_storms=2, pred_fault=None), dict(n_storms=0)])
def test_storm_schedules_bit_equal(kw):
    for seed in (0, 7, 11):
        for n in (10, 48):
            a = ref_chaos.storm_schedule(seed, n, **kw)
            b = chaos.storm_schedule(seed, n, **kw)
            assert [dataclasses.asdict(f) for f in a] == \
                [dataclasses.asdict(f) for f in b]


def test_validation_matches_reference():
    assert chaos.FAULT_KINDS == ref_chaos.FAULT_KINDS
    assert sorted(chaos.__all__) == sorted(ref_chaos.__all__)
    for bad in (dict(kind="meteor", start=0, length=1),
                dict(kind="preempt_storm", start=-1, length=1),
                dict(kind="price_spike", start=0, length=1, magnitude=-2.0)):
        with pytest.raises(ValueError) as ref_err:
            ref_chaos.FaultSpec(**bad)
        with pytest.raises(ValueError) as port_err:
            chaos.FaultSpec(**bad)
        assert str(ref_err.value) == str(port_err.value)
    for bad in (dict(threshold=0.0), dict(lam=1.5), dict(price_weight=-0.1)):
        with pytest.raises(ValueError) as ref_err:
            _cfg(ref=True, **bad)
        with pytest.raises(ValueError) as port_err:
            _cfg(**bad)
        assert str(ref_err.value) == str(port_err.value)
    assert dataclasses.asdict(_cfg()) == dataclasses.asdict(_cfg(ref=True))
    assert hash(_cfg()) == hash(_cfg())
    with pytest.raises(ValueError, match="pred_fault"):
        chaos.storm_schedule(0, 48, pred_fault="bogus")


@pytest.mark.parametrize("kw", [
    dict(days=1.0), dict(days=2.0, mean_price=[0.3, 0.7, 0.5],
                         price_sigma=[0.25, 0.5, 0.3],
                         avail_mean=[3.5, 9.0, 5.5], avail_season_amp=3.0)])
def test_market_regime_batch_bit_equal(kw):
    seeds = np.array([11, 11, 4])
    for a, b in zip(ref_syn.market_regime_batch(seeds, **kw),
                    synthetic.market_regime_batch(seeds, **kw)):
        _eq(a, b)
    fs = np.array([100, 5, 7])
    a = ref_syn.market_regime_fault_batch(seeds, fs, n_storms=[0, 1, 2],
                                          spike_mag=2.0, **kw)
    b = synthetic.market_regime_fault_batch(seeds, fs, n_storms=[0, 1, 2],
                                            spike_mag=2.0, **kw)
    _eq(a[0], b[0])
    _eq(a[1], b[1])
    assert [[dataclasses.asdict(f) for f in s] for s in a[2]] == \
        [[dataclasses.asdict(f) for f in s] for s in b[2]]
    with pytest.raises(ValueError, match="fault_seeds"):
        synthetic.market_regime_fault_batch(seeds, fs[:2], days=1.0)


# ---------------------------------------------------------------------------
# the monitor in the pool simulator
# ---------------------------------------------------------------------------

def test_fallback_none_and_collect_false_are_the_plain_run():
    setup = _pool_setup()
    base = _run(setup)
    for kw in (dict(fallback=None), dict(collect=False),
               dict(collect=False, fallback=None)):
        again = _run(setup, **kw)
        assert set(again) == set(base)
        for k in base:
            assert torch.equal(base[k], again[k]), (kw, k)


def test_quiet_monitor_matches_baseline_and_reference():
    # threshold far above any error: armed, never fires
    setup = _pool_setup(fault_seed=0)
    base = _run(setup)
    quiet = _run(setup, fallback=_cfg(threshold=1e9))
    for k in base:
        assert torch.equal(base[k], quiet[k]), k
    arrs, jobs, prices, avail, preds = setup
    want = ref_fs.simulate_pool_jobs(arrs, jobs, REF_TPUT, prices, avail,
                                     preds,
                                     fallback=_cfg(ref=True, threshold=1e9))
    _assert_matches(quiet, want)


@pytest.mark.parametrize("n_jobs,seed,fault_seed,cfg", [
    (4, 3, 0, STORM),
    (6, 5, 1, STORM),
    # blend weights that do not round: the monitor's two FMAs decide
    (6, 9, 2, dict(threshold=0.3, lam=0.25, price_weight=0.3)),
    (5, 4, 3, dict(threshold=0.4, lam=0.35, price_weight=0.8)),
])
def test_monitor_matches_reference_under_storm(n_jobs, seed, fault_seed,
                                               cfg):
    setup = _pool_setup(n_jobs, seed, fault_seed=fault_seed)
    arrs, jobs, prices, avail, preds = setup
    kind = np.asarray(arrs["kind"])
    got = _run(setup, collect=True, fallback=_cfg(**cfg))
    want = ref_fs.simulate_pool_jobs(arrs, jobs, REF_TPUT, prices, avail,
                                     preds, collect=True,
                                     fallback=_cfg(ref=True, **cfg))
    _assert_matches(got, want)
    assert set(got) == {"utility", "value", "cost", "completion_time",
                        "z_ddl", "completed", "n_od", "n_spot",
                        *SLOT_KEYS, *FALLBACK_KEYS}
    fb = got["tel_fallback"].numpy()
    err = got["tel_pred_err"].numpy()
    # fires on AHAP lanes only; cheap lanes carry all-zero placeholders
    assert fb[:, kind == KIND_AHAP].any()
    assert not fb[:, kind != KIND_AHAP].any()
    assert not err[:, kind != KIND_AHAP].any()
    # one monitor per job: every AHAP lane of a job reads the same EWMA
    ahap_err = err[:, kind == KIND_AHAP]
    np.testing.assert_array_equal(ahap_err, ahap_err[:, :1].repeat(
        ahap_err.shape[1], axis=1))
    # the monitor changes AHAP decisions, never the cheap lanes'
    base = _run(setup)
    cheap = kind != KIND_AHAP
    assert not torch.equal(got["utility"], base["utility"])
    for k in base:
        assert torch.equal(got[k][:, cheap], base[k][:, cheap]), k
    # collect only adds keys to a monitored run
    plain = _run(setup, fallback=_cfg(**cfg))
    for k in plain:
        assert torch.equal(plain[k], got[k]), k


def test_monitor_state_is_one_value_per_job():
    """The EWMA update keeps (K, 1): one monitor per job, broadcast to the
    job's lanes, never a (K, P) state."""
    k = 3
    pred = torch.rand((k, 10, fast_sim.W1MAX, 2))
    prev1 = fast_sim._fallback_prev1(pred)
    assert prev1.shape == (k, 10, 2)
    torch.testing.assert_close(prev1[:, 0], pred[:, 0, 0])
    torch.testing.assert_close(prev1[:, 1:], pred[:, :-1, 1])
    err = torch.zeros((k, 1))
    price = torch.full((k, 1), 0.5)
    av = torch.full((k, 1), 4, dtype=torch.int32)
    for t in range(3):
        err = fast_sim._fallback_error(_cfg(**STORM), err, price, av,
                                       prev1[:, t])
        assert err.shape == (k, 1) and err.dtype == torch.float32


def test_single_job_pool_flags_match_reference():
    arrs, jobs, prices, avail, preds = _pool_setup(fault_seed=1)
    j = ref_fs.JobArrays(*[np.asarray(f)[1] for f in jobs])
    want = ref_fs.simulate_pool(arrs, j, REF_TPUT, prices[1], avail[1],
                                preds[1], collect=True,
                                fallback=_cfg(ref=True, **STORM))
    got = fast_sim.simulate_pool(arrs, j, TPUT, prices[1], avail[1],
                                 preds[1], device="cpu", collect=True,
                                 fallback=_cfg(**STORM))
    _assert_matches(got, want)


# ---------------------------------------------------------------------------
# the engine with the monitor, and the ledgers on its output
# ---------------------------------------------------------------------------

def assert_json_close(got, want, path=""):
    """Two JSON trees equal: same keys, lengths and non-float leaves; floats
    to RTOL / ATOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_json_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_json_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, float), path
        assert abs(got - want) <= ATOL + RTOL * abs(want), (path, got, want)
    else:
        assert got == want and type(got) is type(want), (path, got, want)


def test_engine_fallback_and_ledgers_match_reference():
    arrs, jobs, prices, avail, preds = _pool_setup(fault_seed=0)
    cfg, rcfg = _cfg(**STORM), _cfg(ref=True, **STORM)
    off = engine.simulate_and_select(arrs, jobs, TPUT, prices, avail, preds,
                                     device="cpu")
    on = engine.simulate_and_select(arrs, jobs, TPUT, prices, avail, preds,
                                    device="cpu", fallback=cfg, collect=True)
    want = ref_engine.simulate_and_select(arrs, jobs, REF_TPUT, prices,
                                          avail, preds, sharded=False,
                                          fallback=rcfg, collect=True)
    assert not np.array_equal(off.mean_utility, on.mean_utility)
    np.testing.assert_allclose(on.mean_utility, want.mean_utility,
                               rtol=RTOL)
    assert on.best_policy() == want.best_policy()
    assert on.iters_to_half() == want.iters_to_half()
    np.testing.assert_array_equal(on.top_policy, want.top_policy)
    np.testing.assert_allclose(on.entropy, want.entropy, rtol=0, atol=1e-5)
    assert on.top_policy.dtype == np.int32
    assert set(on.sim_out) == set(want.sim_out)
    for k, v in on.sim_out.items():
        assert isinstance(v, np.ndarray) and v.dtype == want.sim_out[k].dtype

    led = pool_ledger(on.sim_out, jobs, TPUT)
    fb = led["fallback"]
    assert fb["triggers"] > 0 and fb["events_reconciled"]
    assert 0.0 < fb["active_fraction"] < 1.0
    assert_json_close(json.loads(json.dumps(led)),
                      ref_pool_ledger(want.sim_out, jobs, REF_TPUT))
    # selection ledger: curves to f32 tolerance (entropy within 1e-5)
    assert_json_close(selection_ledger(on), ref_selection_ledger(want))
    # an unmonitored collect run has no fallback block
    plain = engine.simulate_and_select(arrs, jobs, TPUT, prices, avail,
                                       preds, device="cpu", collect=True)
    assert "fallback" not in pool_ledger(plain.sim_out, jobs, TPUT)
