"""How ``correct`` is decided for a training cell.

The program's first steps (set-up runs them through the window's own step
and feed) are held against the plain reference following the same steps
from the same weights and batches. Four numbers are compared, each with a
limit of its own (``cells/<workload>.json``, where the readings that set
each limit are given):

- ``loss``: the largest gap between a step's loss and the reference's, as
  a share of the reference's;
- ``grad_norm``: the same for the global gradient norm before the clip,
  as the step reports it;
- ``first_grad``: the first step's gradient as the optimizer got it (its
  first moment after one step over 1 - b1), leaf by leaf: the largest gap
  between a leaf's norm and the reference's, as a share of the
  reference's norm of that leaf or of the median leaf, whichever is
  larger;
- ``change``: the same for each leaf's change over the steps, leaving out
  the leaves whose first reference gradient is under a thousandth of the
  median leaf's (they move by round-off alone under Adam);
- ``route_gap`` (MoE configurations): the reference takes the experts the
  program chose in each step, since bf16 and f32 choose differently near
  ties, and this is the widest by which a chosen gate lies below the
  reference's own choice of that rank (``reference.moe.Routes``).

A trajectory is {"losses", "grad_norms", "first_grad": {leaf: norm},
"change": {leaf: norm}}: the program's comes from ``drivers/``, the
reference's from :func:`reference_trajectory`, which can also compute in
the control's precision.
"""
from __future__ import annotations

import math
import statistics

import torch

from port_bench import catalog, weights
from port_bench.reference import common

NUMBERS = ("loss", "grad_norm", "first_grad", "change", "route_gap")
SMALL_LEAF = 1e-3


def feed(model: dict, traffic: dict, seed: int, step: int, device) -> tuple:
    """The batch of step ``step`` (from 0): token ids drawn uniformly over
    the vocabulary into full packed rows, each target the next id."""
    gen = torch.Generator(device=device)
    gen.manual_seed(weights.seed_for(seed, "batch", step))
    b, s = traffic["batch"], traffic["seq_len"]
    ids = torch.randint(0, model["vocab_size"], (b, s + 1), generator=gen,
                        device=device)
    return ids[:, :s], ids[:, 1:]


def norms(tree: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tree.items()}


def reference_trajectory(model: dict, traffic: dict, seed: int, lora0: dict,
                         steps: int, device, precision: str = "f32",
                         routes=None) -> dict:
    """The reference's trajectory over ``steps`` steps from the LoRA leaves
    ``lora0`` (f32), in ``precision`` ("f32", or "fp8": the control).
    ``routes`` (a ``reference.moe.Routes``, MoE configurations) gives the
    expert choices to take, or keeps the reference's own."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch = catalog.reference(model["arch_type"])
    prec = common.Precision(precision)
    at = [0]

    def draw(group):
        w = {k: v.float() for k, v in
             weights.draw_group(model, seed, group, device).items()}
        if routes is not None and group.startswith("layers/"):
            w[f"{group}/moe/routes"] = (routes, at[0],
                                        int(group.split("/")[1]))
        return w

    lora = {k: v.float().clone() for k, v in lora0.items()}
    opt = common.AdamW(lora, traffic["optimizer"])
    out = {"losses": [], "grad_norms": []}
    for k in range(steps):
        at[0] = k
        loss, grads = common.train_step(
            arch, model, draw, lora, feed(model, traffic, seed, k, device),
            prec)
        lora, gnorm, clipped = opt.update(lora, grads)
        out["losses"].append(float(loss))
        out["grad_norms"].append(gnorm)
        if k == 0:
            out["first_grad"] = norms(clipped)
        del grads, clipped
    out["change"] = norms({k: lora[k] - lora0[k].float() for k in lora})
    if routes is not None and routes.given is not None:
        out["route_gap"] = routes.gap
    return out


def _fit(model: dict, traffic: dict, given) -> bool:
    shape = (traffic["batch"], traffic["seq_len"], model["moe"]["top_k"])
    return given is not None and all(
        len(step) == model["num_layers"]
        and all(tuple(c.shape) == shape for c in step) for step in given)


def reference_for(model: dict, traffic: dict, seed: int, lora0: dict,
                  traj: dict, device) -> dict | None:
    """The reference's trajectory that ``traj`` (the program's, or what
    stands in its place) is judged by: the same steps, on ``traj``'s own
    expert choices (its "routes") in an MoE configuration. None where
    those do not cover every layer and token of each step's batch."""
    routes = None
    if model.get("moe"):
        if not _fit(model, traffic, traj.get("routes")):
            return None
        from port_bench.reference.moe import Routes
        routes = Routes(traj["routes"])
    return reference_trajectory(model, traffic, seed, lora0,
                                len(traj["losses"]), device, routes=routes)


def _worst(gaps) -> float:
    """The largest gap; infinite where one is not a number."""
    gaps = list(gaps)
    return max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf


def leaf_gaps(got: dict, want: dict, keep=None) -> dict:
    """Each leaf's gap between its norms, as a share of the reference's
    norm of that leaf or of the median leaf, whichever is larger."""
    keys = [k for k in want if keep is None or keep(k)]
    med = statistics.median(want[k] for k in keys)
    return {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30)
            for k in keys}


def moved(ref: dict):
    """The leaves ``change`` holds: those whose first reference gradient
    is a thousandth of the median leaf's or more."""
    med = statistics.median(ref["first_grad"].values())
    return lambda k: ref["first_grad"][k] >= SMALL_LEAF * med


def readings(prog: dict, ref: dict) -> dict:
    """The numbers of a trajectory against the reference's (``route_gap``
    where the reference took the trajectory's expert choices)."""
    if set(prog["first_grad"]) != set(ref["first_grad"]):
        raise ValueError("the trajectories name different LoRA leaves")
    out = {
        "loss": _worst(abs(a - b) / abs(b) for a, b in
                       zip(prog["losses"], ref["losses"], strict=True)),
        "grad_norm": _worst(abs(a - b) / b for a, b in
                            zip(prog["grad_norms"], ref["grad_norms"],
                                strict=True)),
        "first_grad": _worst(leaf_gaps(prog["first_grad"],
                                       ref["first_grad"]).values()),
        "change": _worst(leaf_gaps(prog["change"], ref["change"],
                                   moved(ref)).values()),
    }
    if "route_gap" in ref:
        out["route_gap"] = ref["route_gap"]
    return out


def judge(traj: dict, ref: dict, failed: int, limits: dict) -> tuple:
    """What decides ``correct``: a trajectory (the program's, or what
    stands in its place) against the reference's (``reference_for``; None
    where there is none, which reads every number as infinite), under a
    cell's limits. -> (readings, checks: {number: {"value", "limit"}} of
    the numbers with a limit, correct)."""
    got = (dict.fromkeys(NUMBERS, math.inf) if ref is None
           else readings(traj, ref))
    checks = {name: {"value": got[name], "limit": limits[name]}
              for name in NUMBERS if name in limits}
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    return got, checks, correct
