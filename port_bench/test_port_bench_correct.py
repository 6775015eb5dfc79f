"""``correct`` at a small size on the CPU: the f32 reference against the
port's plain path, whole runs of the harness (the look for a card
skipped) that come out correct, and the same runs with a fault planted
under the step, or with the control (the reference in fp8) in the
program's place, that come out not correct under limits set at that
size as the cells' are at theirs (``testing.LIMITS``)."""
import pytest
import torch

from port_bench import catalog, faults, program, testing, train_check
from port_bench.reference import common
from port_bench import weights
from port_bench.drivers import lora_train

SEED = 3_000_000_011      # above 32 signed bits, as a run's seed may be


def _port_gradients(model, tree, tokens, targets):
    configs, ops, step = program._port()
    cfg = program.model_config(model)
    tcfg = configs.TrainConfig(seq_len=tokens.shape[1],
                               global_batch=tokens.shape[0], remat="full")
    grad = step.make_grad_step(cfg, tcfg, ops.KernelConfig(use_cuda=False))
    return grad(tree, {"tokens": tokens, "targets": targets})


@pytest.mark.parametrize("model", [testing.MOE, testing.SSM],
                         ids=lambda m: m["name"])
def test_reference_matches_the_ports_plain_path(model):
    torch.manual_seed(0)
    flat = weights.draw_all(model, SEED, "cpu")
    tree = weights.program_tree({k: v.clone() for k, v in flat.items()})
    tokens, targets = train_check.feed(model, testing.traffic("lora.b8s1k"),
                                       SEED, 0, "cpu")
    loss_p, grads_p = _port_gradients(model, tree, tokens, targets)
    paths = [p for p, _ in weights.tree_leaves(tree) if weights.is_lora(p)]
    lora = {p: flat[p].clone() for p in paths}

    def draw(group):
        return weights.draw_group(model, SEED, group, "cpu")

    loss_r, grads_r = common.train_step(
        catalog.reference(model["arch_type"]), model, draw, lora,
        (tokens, targets), common.Precision("f32"))
    assert float(loss_p) == pytest.approx(loss_r, rel=1e-5)
    for p, g in zip(paths, grads_p, strict=True):
        want = grads_r[p]
        assert float((g - want).norm()) <= 1e-4 * float(want.norm()), p


def _run(workload, fault=""):
    res, info = testing.run_fresh(workload, SEED, fault)
    assert info["rc"] == 0
    return res


@pytest.mark.parametrize("workload", list(testing.CELLS))
def test_a_sound_run_is_correct(workload):
    res = _run(workload)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"train_tokens_per_s", "train_peak_gib",
                                   "setup_s"}


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_fault_under_the_step_is_not_correct(fault):
    res = _run("tiny.moe", fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", list(testing.CELLS))
def test_the_control_is_not_correct(workload):
    """The reference in fp8 in the program's place, its expert choices
    taken as the program's are, held to the cell's limits."""
    from port_bench.reference.moe import Routes

    model, real_traffic = testing.CELLS[workload]
    traffic = testing.traffic(real_traffic)
    lora0 = {p: x for p, x in weights.draw_all(model, SEED, "cpu").items()
             if weights.is_lora(p)}
    routes = Routes() if model.get("moe") else None
    control = train_check.reference_trajectory(
        model, traffic, SEED, lora0, lora_train.SETUP_STEPS, "cpu", "fp8",
        routes)
    if routes is not None:
        control["routes"] = routes.steps()
    ref = train_check.reference_for(model, traffic, SEED, lora0, control,
                                    "cpu")
    _, checks, correct = train_check.judge(
        control, ref, 0, testing.LIMITS[workload])
    assert not correct, checks


def test_the_reference_takes_the_programs_expert_choices():
    """The port's router's choices in set-up's steps, recorded under the
    step, taken by the reference. In f32 at a small size both choose
    alike: the reference's trajectory is its own, and no chosen gate lies
    below the reference's choice."""
    from types import SimpleNamespace

    model, traffic = testing.MOE, testing.traffic("lora.b8s1k")
    ctx = SimpleNamespace(model=model, traffic=traffic, device="cpu",
                          seed=SEED)
    st = lora_train.setup(ctx)
    steps = lora_train.SETUP_STEPS
    assert len(st["prog"]["routes"]) == steps
    own = train_check.reference_trajectory(model, traffic, SEED,
                                           st["lora0"], steps, "cpu")
    taken = train_check.reference_for(model, traffic, SEED, st["lora0"],
                                      st["prog"], "cpu")
    assert taken.pop("route_gap") == 0.0
    assert taken == own
