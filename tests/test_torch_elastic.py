"""The port's elastic trainer (the scheduler driving LoRA fine-tuning)
against the reference's on the CPU, with the same weights, market and
forecasts: the slot plan, the utility and the step count exactly; the
losses within a stated tolerance; the global batch fixed under a change of
policy. Also the launcher and the example, run on the CPU."""
import dataclasses
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_smoke_config as jsmoke
from repro.configs.base import JobConfig as JJob
from repro.configs.base import ThroughputConfig as JTput
from repro.core import market as jmarket
from repro.core.policies import AHAP as JAHAP
from repro.core.policies import AHAPParams as JAHAPParams
from repro.core.policies import UP as JUP
from repro.core.predictor import ARIMAPredictor as JARIMA
from repro.core.predictor import PerfectPredictor as JPerfect
from repro.train import step as jstep
from repro.train.elastic import ElasticTrainer as JElastic
from repro_torch import convert
from repro_torch.configs import TrainConfig, get_smoke_config
from repro_torch.configs.base import JobConfig, ThroughputConfig
from repro_torch.core.market import from_arrays, vast_like_trace
from repro_torch.core.policies import AHAP, UP, AHAPParams
from repro_torch.core.predictor import PerfectPredictor
from repro_torch.launch import train as launch_train
from repro_torch.train.elastic import ElasticTrainer
from repro_torch.train.step import init_opt_state

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# per-step losses: f32 forward and backward summed in another order than
# XLA's, through a few AdamW steps (tests/test_torch_train.py's loss
# tolerance, widened for the steps' drift)
LOSS_RTOL = 1e-4


def _same_weights(port: ElasticTrainer, ref: JElastic, seed: int) -> None:
    """Both trainers start from the same numpy-drawn weights (their own
    inits draw from two different generators)."""
    vals = convert.random_model_params(port.cfg, seed)
    ref.params = jax.tree.map(jnp.asarray, vals)
    ref.opt = jstep.init_opt_state(ref.params)
    port.params = convert.model_params(vals, port.cfg, "cpu")
    port.opt = init_opt_state(port.params)


def _plan(rep):
    return [(s.t, s.n_od, s.n_spot, s.price, s.mu, s.steps, s.cost)
            for s in rep.slots]


def _check_against_reference(got, want):
    assert _plan(got) == _plan(want)
    assert (got.utility, got.value, got.cost, got.completion_time,
            got.z_final, got.completed, got.total_steps) == \
        (want.utility, want.value, want.cost, want.completion_time,
         want.z_final, want.completed, want.total_steps)
    assert [s.ckpt_bytes > 0 for s in got.slots] == \
        [s.ckpt_bytes > 0 for s in want.slots]
    np.testing.assert_allclose(got.losses, want.losses, rtol=LOSS_RTOL)


@pytest.fixture(scope="module")
def setups():
    kw = dict(seq_len=32, global_batch=2, total_steps=64, lr=2e-3)
    return (get_smoke_config("olmo-1b"), TrainConfig(**kw),
            jsmoke("olmo-1b"), JTrainConfig(**kw))


def test_elastic_trainer_matches_reference(setups, tmp_path):
    """tests/test_elastic_serve.py's end-to-end run on both packages."""
    cfg, tcfg, jcfg, jtcfg = setups
    kw = dict(workload=8, deadline=4, n_min=1, n_max=4, value=20.0)
    tr, jtr = vast_like_trace(seed=5, days=1), jmarket.vast_like_trace(
        seed=5, days=1)
    np.testing.assert_array_equal(tr.prices, jtr.prices)
    pred = PerfectPredictor(tr).matrix(5)
    port = ElasticTrainer(cfg, tcfg, JobConfig(**kw),
                          ThroughputConfig(mu1=0.9, mu2=0.95),
                          AHAP(AHAPParams(2, 1, 0.7), device="cpu"), tr,
                          pred, steps_per_unit=1.0,
                          ckpt_dir=str(tmp_path / "port"), device="cpu")
    ref = JElastic(jcfg, jtcfg, JJob(**kw), JTput(mu1=0.9, mu2=0.95),
                   JAHAP(JAHAPParams(2, 1, 0.7)), jtr,
                   JPerfect(jtr).matrix(5), steps_per_unit=1.0,
                   ckpt_dir=str(tmp_path / "ref"))
    _same_weights(port, ref, 11)
    got, want = port.run(), ref.run()
    _check_against_reference(got, want)
    assert got.total_steps > 0 and np.isfinite(got.utility)
    assert got.z_final <= JobConfig(**kw).workload + 1e-6
    assert all(np.isfinite(x) for x in got.losses)
    changes = [s for s in got.slots if s.ckpt_bytes > 0]
    assert len(changes) >= 1 and all(s.reconfig_s > 0 for s in changes)
    assert (tmp_path / "port" / "elastic.ckpt").exists()


def test_elastic_global_batch_fixed_under_policy_change(setups, tmp_path):
    """Different policies give the same update math for the same step
    index (paper III-B: convergence unaffected by scheduler decisions);
    each policy's plan equals the reference's."""
    cfg, tcfg, jcfg, jtcfg = setups
    kw = dict(workload=6, deadline=3, n_min=1, n_max=4, value=20.0)
    tr = from_arrays([0.4, 0.4, 0.4], [4, 0, 2])
    jtr = jmarket.from_arrays([0.4, 0.4, 0.4], [4, 0, 2])
    pred = PerfectPredictor(tr).matrix(5)
    reps = []
    for pol, jpol in ((AHAP(AHAPParams(2, 1, 0.7), device="cpu"),
                       JAHAP(JAHAPParams(2, 1, 0.7))), (UP(), JUP())):
        ahap = pol.name == "ahap"
        port = ElasticTrainer(cfg, tcfg, JobConfig(**kw), ThroughputConfig(),
                              pol, tr, pred if ahap else None,
                              steps_per_unit=0.5,
                              ckpt_dir=str(tmp_path), device="cpu")
        ref = JElastic(jcfg, jtcfg, JJob(**kw), JTput(), jpol, jtr,
                       JPerfect(jtr).matrix(5) if ahap else None,
                       steps_per_unit=0.5, ckpt_dir=str(tmp_path))
        _same_weights(port, ref, 12)
        reps.append(port.run())
        _check_against_reference(reps[-1], ref.run())
    n = min(len(reps[0].losses), len(reps[1].losses))
    assert n >= 2
    np.testing.assert_allclose(reps[0].losses[:n], reps[1].losses[:n],
                               rtol=1e-5)


def _example():
    spec = importlib.util.spec_from_file_location(
        "elastic_finetune_torch", ROOT / "examples" / "elastic_finetune_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_quick_plan_matches_reference(tmp_path, capsys):
    """examples/elastic_finetune_torch.py --quick on the CPU: its plan,
    utility and steps equal the reference example's setting (ARIMA
    forecasts, the calibrated switching cost); both start from the same
    weights here."""
    from repro.core.throughput import calibrate as jcalibrate

    ex = _example()
    port = ex.build(True, "cpu", str(tmp_path / "port"))
    cfg, tcfg, job, spu = ex.setting(True)
    jcfg = jsmoke("tiny-100m")
    jtcfg = JTrainConfig(**dataclasses.asdict(tcfg))
    jtr = jmarket.vast_like_trace(seed=4, days=2)
    ref = JElastic(jcfg, jtcfg, JJob(**dataclasses.asdict(job)),
                   jcalibrate(jcfg, bandwidth_bps=800e6),
                   JAHAP(JAHAPParams(omega=3, v=1, sigma=0.7)), jtr,
                   JARIMA(jtr).matrix(5), steps_per_unit=spu,
                   ckpt_dir=str(tmp_path / "ref"))
    assert dataclasses.astuple(port.tput) == dataclasses.astuple(ref.tput)
    np.testing.assert_array_equal(port.pred, ref.pred)
    _same_weights(port, ref, 13)
    _check_against_reference(port.run(), ref.run())
    rep = ex.main(["--quick", "--device", "cpu", "--ckpt-dir",
                   str(tmp_path / "main")])
    out = capsys.readouterr().out
    assert "optimizer steps" in out and rep.total_steps > 0


def test_launcher_runs_on_cpu(tmp_path):
    report = tmp_path / "rep.json"
    rep = launch_train.main([
        "--arch", "tiny-100m", "--smoke", "--policy", "ahap",
        "--steps-per-unit", "1", "--deadline", "4", "--workload", "6",
        "--seq-len", "16", "--global-batch", "2", "--device", "cpu",
        "--ckpt-dir", str(tmp_path), "--report", str(report)])
    assert rep.total_steps > 0 and report.exists()
    rep_up = launch_train.main([
        "--arch", "tiny-100m", "--smoke", "--policy", "up",
        "--steps-per-unit", "1", "--deadline", "4", "--workload", "6",
        "--seq-len", "16", "--global-batch", "2", "--device", "cpu",
        "--ckpt-dir", str(tmp_path)])
    n = min(len(rep.losses), len(rep_up.losses))
    assert n >= 2 and rep.losses[:n] == rep_up.losses[:n]


def _chip_smoke_and_tool():
    """chip_smoke.py and tools/jax_train_refs.py, imported from the repo
    root."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
        spec = importlib.util.spec_from_file_location(
            "jax_train_refs", ROOT / "tools" / "jax_train_refs.py")
        tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tool)
    finally:
        while str(ROOT) in sys.path:
            sys.path.remove(str(ROOT))
    return chip_smoke, tool


def test_chip_smoke_train_refs_are_current():
    """chip_smoke.py holds the port on the card to TRAIN_REF, recorded from
    the JAX package's jitted train step: recompute it, and hold the port's
    run of the same phase on the CPU to it within TRAIN_REF_RTOL."""
    chip_smoke, tool = _chip_smoke_and_tool()
    assert tool.train_ref() == chip_smoke.TRAIN_REF
    for mb, want in chip_smoke.TRAIN_REF.items():
        got = chip_smoke.train_ref_run(torch, torch.device("cpu"), mb)
        assert got["base_unchanged"]
        for key, rtol in chip_smoke.TRAIN_REF_RTOL.items():
            np.testing.assert_allclose(got[key], want[key], rtol=rtol)


def test_chip_smoke_elastic_ref_is_current(tmp_path):
    """ELASTIC_REF, the plan chip_smoke.py's [elastic] holds the card to,
    recomputed from the JAX package's trainer (its train step stubbed: the
    plan does not depend on the losses), and the port's example setting
    on the CPU, also stubbed, gives the same plan exactly."""
    from repro_torch.train.step import TrainMetrics

    chip_smoke, tool = _chip_smoke_and_tool()
    assert tool.elastic_ref() == chip_smoke.ELASTIC_REF
    trainer = _example().build(False, "cpu", str(tmp_path))
    zero = torch.zeros(())
    trainer._step = lambda p, o, b: (p, o, TrainMetrics(zero, zero, zero))
    rep = trainer.run()
    assert {"slots": tuple((s.t, s.n_od, s.n_spot, s.mu, s.steps)
                           for s in rep.slots),
            "total_steps": rep.total_steps, "utility": rep.utility,
            "cost": rep.cost, "completion_time": rep.completion_time} == \
        chip_smoke.ELASTIC_REF


def test_trainer_runs_on_the_card_by_default(monkeypatch):
    """Without a device the trainer draws its model on the card, and
    without a card it raises rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("tiny-100m")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ElasticTrainer(cfg, TrainConfig(seq_len=16, global_batch=2),
                       JobConfig(), ThroughputConfig(), UP(),
                       from_arrays([0.4], [2]))
