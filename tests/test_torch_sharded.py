"""The port's sharded selection engines (``repro_torch.launch.mesh``,
``repro_torch.sharding``, ``fast_sim.simulate_pool_{jobs,regions}_sharded``,
``fleet.simulate_fleet_sharded``, ``engine.simulate_and_select(mesh=)``)
against the port's unsharded functions and the JAX package's.

The multi-rank half runs ranks as processes on the gloo backend (a
``file://`` rendezvous in ``tmp_path``, a timeout on every process and on
the process group, so a dead rank fails the test instead of hanging the
suite). Every rank holds each sharded result bit for bit against the
port's unsharded run on the same inputs; rank 0 writes one mesh's results
to an ``.npz`` and the parent holds those against the JAX package's
unsharded functions: integer and bool outputs exactly, f32 leaves within
ROADMAP Queue 3's stated tolerances (entry 3, the slot bill's FMA: rtol
1e-5, atol 1e-4; entry 4, the EG sums: 1e-5 a job). The inputs are the
reference's own sharded test's: 13 jobs and 15 AHAP + 3 cheap lanes, so
both axes pad on every mesh; R = 3 regions with per-region on-demand
prices; ``tests/test_fleet.py``'s contended fleet.

The single-process half checks the mesh's shape validation and the
one-rank fall-through, in a world of one."""
import dataclasses
import datetime
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks.common import job_stream
from repro.chaos import FallbackConfig as JFallbackConfig
from repro.chaos import inject, storm_schedule
from repro.configs.base import ThroughputConfig as JThroughputConfig
from repro.core import engine as jengine
from repro.core import fast_sim as jfs
from repro.core import fleet as jfleet
from repro.core.market import vast_like_trace
from repro.core.policy_pool import paper_pool, region_pool, specs_to_arrays
from repro.core.predictor import NoisyPredictor, RegionalPredictor
from repro.core.region_market import vast_like_regions
from repro_torch.configs.base import ThroughputConfig
from repro_torch.core import fast_sim, fleet
from test_fleet import TPUT as FLEET_TPUT
from test_fleet import _contended_fleet

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
JTPUT = JThroughputConfig(mu1=0.9, mu2=0.95)
RTOL, ATOL = 1e-5, 1e-4          # ROADMAP Queue 3, entry 3
EG_ATOL = 1e-5                   # Queue 3, entry 4
D = 10
RANK_TIMEOUT = 120               # seconds, each rank's process
FB = dict(threshold=0.5, lam=0.5)

# Runs as every rank. argv: rank, world, rendezvous file, inputs .npz, out
# .npz. Each case: the sharded call on each mesh, held bit for bit against
# the port's unsharded call on this rank; rank 0 saves the first mesh's
# result of each case.
_WORKER = r'''
import datetime, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, rdv, inp_path, out_path = (int(sys.argv[1]), int(sys.argv[2]),
                                        *sys.argv[3:6])
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=120))
from repro_torch.chaos import FallbackConfig
from repro_torch.configs.base import ThroughputConfig
from repro_torch.core import engine, fast_sim, fleet
from repro_torch.launch.mesh import make_pool_mesh

inp = np.load(inp_path)
group = lambda p: {k[len(p) + 1:]: inp[k] for k in inp.files
                   if k.startswith(p + ".")}
jobs_of = lambda p: fast_sim.JobArrays(**group(p))
TPUT = ThroughputConfig(mu1=0.9, mu2=0.95)
FTPUT = ThroughputConfig(**{k: float(v) for k, v in group("ftput").items()})
WORLD_MESHES = {4: [(4,), (2, 2), (1, 4)], 3: [(3,)]}[world]
meshes = {s: make_pool_mesh(s, device_type="cpu") for s in WORLD_MESHES}
saved = {}


def check(name, fn, ref, shapes):
    for i, s in enumerate(shapes):
        got = fn(meshes[s])
        assert set(got) == set(ref), (name, s, sorted(got), sorted(ref))
        for k in ref:
            assert got[k].dtype == ref[k].dtype and torch.equal(
                got[k], ref[k]), f"{name} {k} mesh {s} rank {rank}"
        if i == 0:
            saved.update({f"{name}.{k}": v.numpy() for k, v in got.items()})


pool, jobs = group("pool"), jobs_of("jobs")
mkt = (inp["prices"], inp["avail"], inp["preds"])
base = fast_sim.simulate_pool_jobs(pool, jobs, TPUT, *mkt, device="cpu")
check("pool", lambda m: fast_sim.simulate_pool_jobs_sharded(
    pool, jobs, TPUT, *mkt, mesh=m), base, WORLD_MESHES)

fmkt = (inp["pf"], inp["af"], inp["prf"])
kw = dict(collect=True, fallback=FallbackConfig(threshold=0.5, lam=0.5))
fb = fast_sim.simulate_pool_jobs(pool, jobs, TPUT, *fmkt, device="cpu", **kw)
assert bool(fb["tel_fallback"].any()), "monitor never armed"
check("fallback", lambda m: fast_sim.simulate_pool_jobs_sharded(
    pool, jobs, TPUT, *fmkt, mesh=m, **kw), fb,
    [(2, 2)] if world == 4 else WORLD_MESHES)

rpool, rjobs = group("rpool"), jobs_of("rjobs")
rmkt = (inp["rprices"], inp["ravail"], inp["rpreds"])
rkw = dict(delta_mig=1, collect=True, p_od=inp["p_od"])
rbase = fast_sim.simulate_pool_regions(rpool, rjobs, TPUT, *rmkt,
                                       device="cpu", **rkw)
check("regions", lambda m: fast_sim.simulate_pool_regions_sharded(
    rpool, rjobs, TPUT, *rmkt, mesh=m, **rkw), rbase, WORLD_MESHES[:2])

frows, fjobs = group("frows"), jobs_of("fjobs")
fargs = (inp["farrivals"], FTPUT, inp["fprices"], inp["favail"],
         inp["fpred"])
fbase = fleet.simulate_fleet(frows, fjobs, *fargs, device="cpu",
                             collect=True)
check("fleet", lambda m: fleet.simulate_fleet_sharded(
    frows, fjobs, *fargs, mesh=m, collect=True), fbase, WORLD_MESHES)

ekw = dict(return_utilities=True, track_history=True)
ebase = engine.simulate_and_select(pool, jobs, TPUT, *mkt, device="cpu",
                                   sharded=False, **ekw)
for s in WORLD_MESHES[-2:] + [None]:
    res = engine.simulate_and_select(
        pool, jobs, TPUT, *mkt, device="cpu",
        mesh=None if s is None else meshes[s], **ekw)
    for f in ("utilities", "weight_history", "max_weight", "regret",
              "mean_utility"):
        assert np.array_equal(getattr(res, f), getattr(ebase, f)), (f, s)
    assert torch.equal(res.state.weights, ebase.state.weights), s
saved.update({"engine.utilities": res.utilities,
              "engine.max_weight": res.max_weight,
              "engine.regret": res.regret,
              "engine.best": np.array(res.best_policy()),
              "engine.iters": np.array(res.iters_to_half())})

if rank == 0:
    np.savez(out_path, **saved)
dist.barrier()
dist.destroy_process_group()
print(f"RANK-{rank}-OK")
'''


def _inputs():
    """The numpy inputs (13 jobs x 15 AHAP + 3 cheap lanes, storm-faulted
    copies, a 3-region market, the contended fleet) and the JAX-side
    objects that describe them."""
    pool_specs = paper_pool(omegas=(2, 3), sigmas=(0.3, 0.7, 0.9))
    pool = specs_to_arrays(pool_specs)
    assert (pool["kind"] == 0).sum() == 15 and len(pool_specs) == 18
    rng = np.random.default_rng(0)
    n_jobs = 13
    jobs = list(job_stream(rng, n_jobs, deadline=D))
    traces = [vast_like_trace(seed=40 + i, days=1).window(0, D + 1)
              for i in range(n_jobs)]
    prices = np.stack([t.prices[:D] for t in traces]).astype(np.float32)
    avail = np.stack([t.avail[:D] for t in traces]).astype(np.int64)
    preds = np.stack([
        NoisyPredictor(t, "fixed_uniform", 0.2, seed=i).matrix(
            fast_sim.W1MAX - 1)[:D]
        for i, t in enumerate(traces)]).astype(np.float32)
    pf, af, prf = inject(prices, avail, preds, storm_schedule(
        1, D, n_storms=2, storm_len=4, spike_mag=2.5, pred_fault="stale"))

    mkt = vast_like_regions(3, seed=1, days=1)
    rpool = specs_to_arrays(region_pool())
    rjobs = list(job_stream(rng, 5, deadline=D))
    wins = [mkt.window(i * 4, D + 1) for i in range(5)]
    rprices = np.stack([w.prices[:, :D] for w in wins]).astype(np.float32)
    ravail = np.stack([w.avail[:, :D] for w in wins]).astype(np.int64)
    rpreds = np.stack([
        RegionalPredictor(w, lambda t, r: NoisyPredictor(
            t, "fixed_uniform", 0.2, seed=r)).matrix(
            fast_sim.W1MAX - 1)[:, :D]
        for w in wins]).astype(np.float32)
    p_od = np.array([1.0, 1.5, 0.7], np.float32)

    (_, _, fjobs, arrivals, _, fprices, favail, fpred, frows,
     _) = _contended_fleet()

    stack = lambda js: jfs.stack_jobs(js)
    arrays = {
        "prices": prices, "avail": avail, "preds": preds,
        "pf": np.asarray(pf), "af": np.asarray(af), "prf": np.asarray(prf),
        "rprices": rprices, "ravail": ravail, "rpreds": rpreds,
        "p_od": p_od, "farrivals": np.asarray(arrivals),
        "fprices": fprices, "favail": favail, "fpred": fpred,
    }
    for prefix, d in (("pool", pool), ("rpool", rpool), ("frows", frows),
                      ("ftput", dataclasses.asdict(FLEET_TPUT))):
        arrays.update({f"{prefix}.{k}": np.asarray(v) for k, v in d.items()})
    for prefix, js in (("jobs", jobs), ("rjobs", rjobs), ("fjobs", fjobs)):
        st = stack(js)
        arrays.update({f"{prefix}.{f}": np.asarray(getattr(st, f))
                       for f in st._fields})
    return arrays, dict(pool=pool, jobs=stack(jobs), rpool=rpool,
                        rjobs=stack(rjobs), fjobs=stack(fjobs),
                        frows=frows)


def _run_ranks(tmp_path, world: int) -> dict:
    """Run the worker as ``world`` gloo ranks; rank 0's results."""
    arrays, _ = _inputs()
    np.savez(tmp_path / "inputs.npz", **arrays)
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("JAX_PLATFORMS", None)
    rdv, out = tmp_path / "rendezvous", tmp_path / "rank0.npz"
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), str(world), str(rdv),
         str(tmp_path / "inputs.npz"), str(out)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    t0 = time.perf_counter()
    try:
        logs = [p.communicate(timeout=RANK_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
    wall = time.perf_counter() - t0
    for r, (p, (so, se)) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"RANK-{r}-OK" in so, \
            f"rank {r} rc {p.returncode}\n{so}\n{se[-4000:]}"
    assert wall < RANK_TIMEOUT
    return dict(np.load(out))


def _assert_close(got: dict, want: dict, prefix: str):
    """Rank 0's sharded leaves against the JAX package's unsharded ones:
    integer and bool exact, f32 within Queue 3, entry 3."""
    keys = {k[len(prefix) + 1:] for k in got if k.startswith(prefix + ".")}
    assert keys == set(want), (prefix, sorted(keys ^ set(want)))
    for k in want:
        g, w = got[f"{prefix}.{k}"], np.asarray(want[k])
        assert g.shape == w.shape, (prefix, k)
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=f"{prefix} {k}")
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{prefix} {k}")


def _jax_refs(arrays, refs):
    """The JAX package's unsharded results on the same inputs."""
    mkt = (arrays["prices"], arrays["avail"], arrays["preds"])
    out = {"pool": jfs.simulate_pool_jobs(refs["pool"], refs["jobs"], JTPUT,
                                          *mkt)}
    out["fallback"] = jfs.simulate_pool_jobs(
        refs["pool"], refs["jobs"], JTPUT, arrays["pf"], arrays["af"],
        arrays["prf"], collect=True, fallback=JFallbackConfig(**FB))
    out["regions"] = jfs.simulate_pool_regions(
        refs["rpool"], refs["rjobs"], JTPUT, arrays["rprices"],
        arrays["ravail"], arrays["rpreds"], delta_mig=1, collect=True,
        p_od=arrays["p_od"])
    out["fleet"] = jfleet.simulate_fleet(
        refs["frows"], refs["fjobs"], arrays["farrivals"], FLEET_TPUT,
        arrays["fprices"], arrays["favail"], arrays["fpred"], collect=True)
    out["engine"] = jengine.simulate_and_select(
        refs["pool"], refs["jobs"], JTPUT, *mkt, sharded=False,
        return_utilities=True)
    return out


def _check_against_jax(got: dict):
    arrays, refs = _inputs()
    want = _jax_refs(arrays, refs)
    for name in ("pool", "fallback", "regions", "fleet"):
        _assert_close(got, want[name], name)
    res = want["engine"]
    np.testing.assert_allclose(got["engine.utilities"], res.utilities,
                               rtol=RTOL, atol=ATOL)
    assert int(got["engine.best"]) == res.best_policy()
    assert int(got["engine.iters"]) == res.iters_to_half()
    np.testing.assert_allclose(got["engine.max_weight"], res.max_weight,
                               atol=EG_ATOL)
    np.testing.assert_allclose(got["engine.regret"], res.regret,
                               atol=EG_ATOL * len(res.regret))


def test_sharded_four_ranks_match_unsharded_and_reference(tmp_path):
    """Four gloo ranks: the pool on meshes (4,), (2, 2) and (1, 4) (13
    jobs, 15 AHAP + 3 cheap lanes: both axes pad); collect=True with the
    armed monitor on (2, 2); the regions (R = 3, p_od, collect) on (4,)
    and (2, 2); the fleet (collect) on (4,), (2, 2) and (1, 4); the
    engine on (2, 2), (1, 4) and the default mesh. Every rank bit-equal to
    the port's unsharded run; rank 0's against the JAX package."""
    _check_against_jax(_run_ranks(tmp_path, 4))


def test_sharded_three_ranks_pad_jobs(tmp_path):
    """Three gloo ranks on (3,): 13 jobs pad to 15, the regions' 5 to 6,
    the fleet's blocks to multiples of 3; every case as in the four-rank
    run."""
    _check_against_jax(_run_ranks(tmp_path, 3))


# ---------------------------------------------------------------------------
# One process: shape validation and the one-rank fall-through
# ---------------------------------------------------------------------------

@pytest.fixture
def world_of_one(tmp_path):
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_pool_mesh_shapes(world_of_one):
    """Shape validation and axis naming of the 1-D and 2-D pool meshes
    (as tests/test_sharded_pool.py pins the reference's)."""
    from repro_torch.launch.mesh import (make_pool_mesh,
                                         parse_pool_mesh_shape,
                                         pool_mesh_job_axes, rank_device)

    mesh = make_pool_mesh(device_type="cpu")
    assert mesh.mesh_dim_names == ("jobs",)
    assert tuple(mesh.mesh.shape) == (1,)
    assert pool_mesh_job_axes(mesh) == (("jobs",), 1, 1)
    assert rank_device(mesh) == torch.device("cpu")
    mesh2 = make_pool_mesh(shape=(1, 1), device_type="cpu")
    assert mesh2.mesh_dim_names == ("jobs", "lanes")
    assert pool_mesh_job_axes(mesh2) == (("jobs",), 1, 1)
    with pytest.raises(ValueError):
        make_pool_mesh(shape=(2, 3), device_type="cpu")   # not 1 rank
    with pytest.raises(ValueError):
        make_pool_mesh(shape=(1, 1, 1), device_type="cpu")
    assert parse_pool_mesh_shape("") is None
    assert parse_pool_mesh_shape("auto") is None
    assert parse_pool_mesh_shape("4") == (4,)
    assert parse_pool_mesh_shape("2x2") == (2, 2)


def test_make_pool_mesh_needs_a_process_group():
    from repro_torch.launch.mesh import make_pool_mesh

    with pytest.raises(RuntimeError, match="process group"):
        make_pool_mesh(device_type="cpu")


def test_resolve_spec_divisibility_fallback(world_of_one):
    """resolve_spec picks the mesh axes that divide a dimension, replicates
    otherwise, and never reuses an axis (the reference's rules)."""
    from repro_torch import sharding
    from repro_torch.launch.mesh import make_pool_mesh

    mesh = make_pool_mesh(shape=(1, 1), device_type="cpu")
    rules = dict(sharding.DEFAULT_RULES)
    assert sharding.resolve_spec(("jobs", "lanes"), (5, 7), mesh,
                                 rules) == ("jobs", "lanes")
    assert sharding.resolve_spec(("jobs", "jobs", None), (4, 4, 3), mesh,
                                 rules) == ("jobs", None, None)
    assert sharding.resolve_spec(("heads",), (8,), mesh, rules) == (None,)
    assert sharding.shard_block("jobs", mesh) == (1, 0)
    assert sharding.shard_block(None, mesh) == (1, 0)
    with pytest.raises(ValueError):
        sharding.resolve_spec(("jobs",), (4, 4), mesh, rules)


def _assert_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_one_rank_falls_through_bitwise(world_of_one):
    """In a world of one the sharded pool, region and fleet entry points
    are their unsharded twins, bit for bit: with no mesh (the default pool
    mesh), a 1-D and a 2-D one-rank mesh; and without a process group the
    engine's default path is the unsharded one."""
    from repro_torch.core import engine
    from repro_torch.launch.mesh import make_pool_mesh

    arrays, _ = _inputs()
    g = lambda p: {k[len(p) + 1:]: v for k, v in arrays.items()
                   if k.startswith(p + ".")}
    tput = ThroughputConfig(mu1=0.9, mu2=0.95)
    ftput = ThroughputConfig(**dataclasses.asdict(FLEET_TPUT))
    jobs = fast_sim.JobArrays(**g("jobs"))
    rjobs = fast_sim.JobArrays(**g("rjobs"))
    fjobs = fast_sim.JobArrays(**g("fjobs"))
    mkt = (arrays["prices"], arrays["avail"], arrays["preds"])
    rmkt = (arrays["rprices"], arrays["ravail"], arrays["rpreds"])
    fargs = (arrays["farrivals"], ftput, arrays["fprices"],
             arrays["favail"], arrays["fpred"])
    base = fast_sim.simulate_pool_jobs(g("pool"), jobs, tput, *mkt,
                                       device="cpu")
    rbase = fast_sim.simulate_pool_regions(
        g("rpool"), rjobs, tput, *rmkt, device="cpu", delta_mig=1,
        p_od=arrays["p_od"])
    fbase = fleet.simulate_fleet(g("frows"), fjobs, *fargs, device="cpu")
    meshes = (None, make_pool_mesh(device_type="cpu"),
              make_pool_mesh(shape=(1, 1), device_type="cpu"))
    for mesh in meshes:
        _assert_equal(fast_sim.simulate_pool_jobs_sharded(
            g("pool"), jobs, tput, *mkt, mesh=mesh, device="cpu"), base)
        _assert_equal(fast_sim.simulate_pool_regions_sharded(
            g("rpool"), rjobs, tput, *rmkt, mesh=mesh, device="cpu",
            delta_mig=1, p_od=arrays["p_od"]), rbase)
        _assert_equal(fleet.simulate_fleet_sharded(
            g("frows"), fjobs, *fargs, mesh=mesh, device="cpu"), fbase)
    res = engine.simulate_and_select(g("pool"), jobs, tput, *mkt,
                                     device="cpu", return_utilities=True)
    assert np.array_equal(res.utilities, base["utility"].numpy())


def test_no_process_group_falls_through_bitwise():
    """Without torch.distributed started, ``mesh=None`` is the unsharded
    path on ``device``."""
    arrays, _ = _inputs()
    g = lambda p: {k[len(p) + 1:]: v for k, v in arrays.items()
                   if k.startswith(p + ".")}
    tput = ThroughputConfig(mu1=0.9, mu2=0.95)
    ftput = ThroughputConfig(**dataclasses.asdict(FLEET_TPUT))
    jobs = fast_sim.JobArrays(**g("jobs"))
    fjobs = fast_sim.JobArrays(**g("fjobs"))
    mkt = (arrays["prices"], arrays["avail"], arrays["preds"])
    fargs = (arrays["farrivals"], ftput, arrays["fprices"],
             arrays["favail"], arrays["fpred"])
    _assert_equal(fast_sim.simulate_pool_jobs_sharded(
        g("pool"), jobs, tput, *mkt, device="cpu"),
        fast_sim.simulate_pool_jobs(g("pool"), jobs, tput, *mkt,
                                    device="cpu"))
    _assert_equal(fleet.simulate_fleet_sharded(
        g("frows"), fjobs, *fargs, device="cpu", collect=True),
        fleet.simulate_fleet(g("frows"), fjobs, *fargs, device="cpu",
                             collect=True))


def test_all_gather_keeps_every_dtype_bit_for_bit(world_of_one):
    """The collective helper packs tensors of several dtypes into one byte
    buffer and unpacks them bit for bit (negative zero, NaN payloads and
    bools included)."""
    from repro_torch.launch.mesh import all_gather

    f = torch.tensor([-0.0, float("nan"), 1e-45, -3.5], dtype=torch.float32)
    i = torch.tensor([[-7, 2 ** 31 - 1], [0, -(2 ** 31)]], dtype=torch.int32)
    b = torch.tensor([True, False, True])
    (got,) = all_gather([f, i, b])
    assert got[0].dtype == torch.float32 and torch.equal(
        got[0].view(torch.int32), f.view(torch.int32))
    assert got[1].dtype == torch.int32 and torch.equal(got[1], i)
    assert got[2].dtype == torch.bool and torch.equal(got[2], b)
