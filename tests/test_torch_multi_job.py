"""The port's ``MultiJobScheduler`` (``repro_torch.core.multi_job``) against
the JAX package's on ``tests/test_multi_job.py``'s cases, on the CPU: the
same jobs, policies and traces in both packages, every job's per-slot
allocations (spot and on-demand) exact, its utility, cost and completion
time to 1e-9 (both are host f64 loops around the same f32 execution
arithmetic; the python AHAP's window solves match the reference's
exactly, tests/test_torch_policies.py)."""
import dataclasses

import numpy as np
import pytest

from repro.configs.base import JobConfig as JJobConfig
from repro.core import market as jmarket
from repro.core import multi_job as jmulti
from repro.core import policies as jpol
from repro.core.predictor import PerfectPredictor as JPerfectPredictor
from repro_torch.configs.base import JobConfig, ThroughputConfig
from repro_torch.core import market, multi_job, policies
from repro_torch.core.predictor import PerfectPredictor
from repro_torch.core.simulator import simulate
from test_multi_job import JOB as JJOB
from test_multi_job import TPUT as JTPUT

TPUT = ThroughputConfig(**dataclasses.asdict(JTPUT))
JOB = JobConfig(**dataclasses.asdict(JJOB))
TOL = 1e-9


def _tight_loose():
    tight = dict(workload=40, deadline=5, n_min=1, n_max=10, value=80.0)
    loose = dict(workload=10, deadline=12, n_min=1, n_max=10, value=80.0)
    return tight, loose


def _case(name):
    """(trace kind + args, horizon, [(arrival, job dict, policy name)],
    forecasts?) of each of tests/test_multi_job.py's scenarios."""
    job = dataclasses.asdict(JJOB)
    tight, loose = _tight_loose()
    return {
        "single_up": (("vast", dict(seed=1, days=1), (0, 12)), 10,
                      [(0, job, "up")], False),
        "shared_capacity": (("constant", (0.4, 6, 20)), 16,
                            [(0, job, "up"), (0, job, "up")], False),
        "least_slack": (("constant", (0.3, 4, 30)), 25,
                        [(0, tight, "up"), (0, loose, "up")], False),
        "contention": (("arrays", (np.full(20, 0.4), np.full(20, 5))), 18,
                       [(0, job, "up"), (0, job, "up")], False),
        "ahap_forecasts": (("vast", dict(seed=3, days=1), None), 30,
                           [(0, job, "ahap"), (2, job, "ahap")], True),
    }[name]


def _trace(pkg, spec):
    kind, args = spec[0], spec[1]
    if kind == "vast":
        tr = pkg.vast_like_trace(**args)
        return tr.window(*spec[2]) if spec[2] else tr
    if kind == "constant":
        return pkg.constant_trace(*args)
    return pkg.from_arrays(*args)


def _run(name, port: bool):
    spec, horizon, jobs, forecasts = _case(name)
    if port:
        tr = _trace(market, spec)
        sched = multi_job.MultiJobScheduler(TPUT, tr)
        pred = PerfectPredictor(tr).matrix(5) if forecasts else None
        make = {"up": policies.UP,
                "ahap": lambda: policies.AHAP(policies.AHAPParams(3, 1, 0.7),
                                              device="cpu")}
        cfg = JobConfig
    else:
        tr = _trace(jmarket, spec)
        sched = jmulti.MultiJobScheduler(JTPUT, tr)
        pred = JPerfectPredictor(tr).matrix(5) if forecasts else None
        make = {"up": jpol.UP,
                "ahap": lambda: jpol.AHAP(jpol.AHAPParams(3, 1, 0.7))}
        cfg = JJobConfig
    handles = [sched.submit(a, cfg(**j), make[p](), pred=pred)
               for a, j, p in jobs]
    jobs_by_id = {aj.job_id: aj for aj in sched.active}
    results = {r.job_id: r for r in sched.run(horizon)}
    return handles, jobs_by_id, results


@pytest.mark.parametrize("name", ["single_up", "shared_capacity",
                                  "least_slack", "contention",
                                  "ahap_forecasts"])
def test_scheduler_matches_reference(name):
    ids, got_jobs, got = _run(name, port=True)
    jids, want_jobs, want = _run(name, port=False)
    assert ids == jids and set(got) == set(want)
    for i in ids:
        assert got_jobs[i].alloc_spot == want_jobs[i].alloc_spot, i
        assert got_jobs[i].alloc_od == want_jobs[i].alloc_od, i
        g, w = got[i], want[i]
        for field in ("utility", "value", "cost", "completion_time"):
            assert getattr(g, field) == pytest.approx(getattr(w, field),
                                                      abs=TOL), (i, field)
        assert g.completed_by_deadline == w.completed_by_deadline


def test_single_job_matches_port_simulator():
    """With one job the scheduler is the port's single-job simulator."""
    tr = market.vast_like_trace(seed=1, days=1).window(0, 12)
    sched = multi_job.MultiJobScheduler(TPUT, tr)
    sched.submit(0, JOB, policies.UP())
    res = sched.run(10)[0]
    ref = simulate(policies.UP(), JOB, TPUT, tr)
    assert res.utility == pytest.approx(ref.utility, abs=1e-6)
    assert res.cost == pytest.approx(ref.cost, abs=1e-6)
    assert res.completion_time == pytest.approx(ref.completion_time,
                                                abs=1e-6)


def test_slack_key_is_float32_and_matches_reference():
    tight, _ = _tight_loose()
    for z in (0.0, 3.3, 17.25, 40.0, 55.0):
        for t in range(0, 8):
            got = multi_job.ActiveJob(0, JobConfig(**tight), policies.UP(),
                                      arrival=1, z=z).slack(t, TPUT)
            want = jmulti.ActiveJob(0, JJobConfig(**tight), jpol.UP(),
                                    arrival=1, z=z).slack(t, JTPUT)
            assert isinstance(got, np.float32) and got == want
