"""The port's multi-region market layer against the JAX package's:
``RegionalMarket`` (views, windows, per-region on-demand multipliers,
``from_traces``), ``vast_like_regions`` and the regional forecast stacks,
array for array and bit for bit on the same seeds."""
import dataclasses

import numpy as np
import pytest

from repro.core import market as ref_market
from repro.core import predictor as ref_pred
from repro.core import region_market as ref_rm
from repro_torch.core import market, predictor, region_market


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(a).dtype == np.asarray(b).dtype


def _markets_equal(got, want):
    _eq(got.prices, want.prices)
    _eq(got.avail, want.avail)
    assert tuple(got.region_names) == tuple(want.region_names)
    assert (got.slot_seconds, got.slots_per_day, got.delta_mig) == \
        (want.slot_seconds, want.slots_per_day, want.delta_mig)
    assert got.meta == want.meta
    if want.p_od is None:
        assert got.p_od is None
    else:
        _eq(got.p_od, want.p_od)


@pytest.mark.parametrize("kw", [
    dict(n_regions=3, seed=13, days=8, phase_hours=(0.0, 8.0, 16.0),
         mean_price=0.7, price_sigma=0.5, avail_mean=5.5,
         avail_season_amp=3.0, delta_mig=1),
    dict(n_regions=2, seed=5, days=2, phase_hours=(0.0, 12.0),
         avail_season_amp=4.0, avail_sigma=0.5),
    dict(n_regions=3, seed=1, days=3, mean_prices=(0.3, 0.45, 0.6),
         price_sigma=0.2, delta_mig=2),
    dict(n_regions=4, seed=2, days=1.5, price_sigmas=(0.1, 0.2, 0.3, 0.4),
         avail_means=3.0),
])
def test_vast_like_regions_bit_equal(kw):
    want = ref_rm.vast_like_regions(**kw)
    got = region_market.vast_like_regions(**kw)
    _markets_equal(got, want)
    assert len(got) == len(want) and got.n_regions == want.n_regions
    for r in range(want.n_regions):
        g, w = got.region(r), want.region(r)
        _eq(g.prices, w.prices)
        _eq(g.avail, w.avail)
        assert g.meta == w.meta
    assert [dataclasses.asdict(s) for s in got.stats()] == \
        [dataclasses.asdict(s) for s in want.stats()]
    _markets_equal(got.window(5, 20), want.window(5, 20))


def test_from_traces_with_p_od_and_windows():
    traces = [(market.vast_like_trace(seed=s, days=1),
               ref_market.vast_like_trace(seed=s, days=1)) for s in (0, 1)]
    for p_od in (None, 1.0, (1.0, 2.0)):
        got = region_market.RegionalMarket.from_traces(
            [t for t, _ in traces], delta_mig=2, region_names=("us", "eu"),
            p_od=p_od)
        want = ref_rm.RegionalMarket.from_traces(
            [t for _, t in traces], delta_mig=2, region_names=("us", "eu"),
            p_od=p_od)
        _markets_equal(got, want)
        _markets_equal(got.window(10, 30), want.window(10, 30))


def test_regional_market_rejects_what_the_reference_rejects():
    t0 = market.vast_like_trace(seed=0, days=1)
    for bad in (market.vast_like_trace(seed=1, days=0.5),
                market.vast_like_trace(seed=1, days=1, slots_per_day=24)):
        with pytest.raises(ValueError):
            region_market.RegionalMarket.from_traces([t0, bad])
    m = region_market.vast_like_regions(2, seed=0, days=1)
    with pytest.raises(ValueError):
        m.window(40, 10)


@pytest.mark.parametrize("kind", predictor.NOISE_KINDS)
def test_regional_forecasts_bit_equal(kind):
    """RegionalPredictor over per-region NoisyPredictors, and the batched
    regional_noisy_matrix that replaces the per-(job, region) loop."""
    want_m = ref_rm.vast_like_regions(3, seed=4, days=1)
    got_m = region_market.vast_like_regions(3, seed=4, days=1)
    want = ref_pred.RegionalPredictor(
        want_m, lambda tr, r: ref_pred.NoisyPredictor(tr, kind, 0.3,
                                                      seed=10 + r)).matrix(5)
    got = predictor.RegionalPredictor(
        got_m, lambda tr, r: predictor.NoisyPredictor(tr, kind, 0.3,
                                                      seed=10 + r)).matrix(5)
    _eq(got, want)
    _eq(predictor.RegionalPredictor(got_m).matrix(3),
        ref_pred.RegionalPredictor(want_m).matrix(3))
    batch = predictor.regional_noisy_matrix(
        got_m.prices[None], got_m.avail[None], kind, 0.3,
        np.array([[10, 11, 12]]), 5)
    _eq(batch[0], want)
