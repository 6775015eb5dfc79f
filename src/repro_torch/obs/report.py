"""Textual dashboard over a ledger dict (obs.ledger functions). Port of the
JAX package's ``obs/report.py`` (copied whole).

``render(ledger)`` returns a plain-text block; dispatch is on
``ledger["kind"]``. This is deliberately dependency-free formatting so CI
logs and quick REPL inspection get the same output."""
from __future__ import annotations

from typing import List


def _hdr(title: str) -> List[str]:
    return [title, "=" * len(title)]


def _recon_lines(recon: dict) -> List[str]:
    return [
        f"cost   spot {recon['spot_cost']:.2f} + od {recon['od_cost']:.2f}"
        f" + term {recon['termination_cost']:.2f}"
        f" = {recon['total_cost']:.2f}"
        f"  (spot share {recon['spot_share']:.1%})",
        f"recon  |cost resid| <= {recon['max_abs_cost_residual']:.3g}"
        f"  |utility resid| <= {recon['max_abs_utility_residual']:.3g}",
    ]


def _bar(frac: float, width: int = 20) -> str:
    n = int(round(max(0.0, min(1.0, frac)) * width))
    return "#" * n + "." * (width - n)


def _render_pool(ledger: dict) -> List[str]:
    sh = ledger["shape"]
    lines = _hdr(f"pool flight record  ({sh['n_jobs']} jobs x "
                 f"{sh['n_lanes']} lanes x {sh['n_slots']} slots)")
    lines += _recon_lines(ledger["cost_reconciliation"])
    pl = ledger["per_lane"]
    util = pl["mean_utility"]
    order = sorted(range(len(util)), key=lambda i: -util[i])[:5]
    names = pl.get("name")
    lines.append("top lanes by mean utility:")
    for i in order:
        tag = names[i] if names else f"lane {i}"
        lines.append(
            f"  {tag:<28} u={util[i]:8.2f}  cost={pl['mean_cost'][i]:7.2f}"
            f"  spot={pl['mean_spot_cost'][i]:7.2f}"
            f"  preempt={pl['preemptions_mean'][i]:.2f}"
            f"  done={pl['completion_rate'][i]:.0%}"
        )
    if "migration" in ledger:
        mg = ledger["migration"]
        occ = " ".join(f"r{r}={f:.0%}" for r, f in
                       enumerate(mg["region_occupancy"]))
        lines.append(
            f"migration  {mg['total_migrations']} switches"
            f" (mean {mg['migrations_mean']:.2f}/lane)"
            f"  occupancy {occ}"
            f"  reconciled={'yes' if mg['events_reconciled'] and mg['series_matches_leaf'] else 'NO'}"
        )
    return lines


def _render_fleet(ledger: dict) -> List[str]:
    sh = ledger["shape"]
    wf = ledger["waterfall"]
    lines = _hdr(f"fleet flight record  ({sh['n_jobs']} jobs x "
                 f"{sh['n_slots']} slots)")
    lines += _recon_lines(ledger["cost_reconciliation"])
    lines.append(
        f"waterfall  granted {wf['total_granted']}/{wf['total_demand']}"
        f" ({wf['grant_ratio']:.1%})"
        f"  starvation incidence {wf['starvation_incidence']:.1%}"
        f" ({wf['starved_slots_total']} starved slots)"
    )
    if "max_oversubscription" in wf:
        lines.append(f"           max oversubscription "
                     f"{wf['max_oversubscription']} (<= 0 is conserving)")
    return lines


def _render_selection(ledger: dict) -> List[str]:
    sh = ledger["shape"]
    lines = _hdr(f"selection flight record  ({sh['n_jobs']} jobs x "
                 f"{sh['n_policies']} policies)")
    lines.append(
        f"best policy {ledger['best_policy']}"
        f"  iters-to-half {ledger['iters_to_half']}"
        f"  regret/bound {ledger['regret_ratio']:.3f}"
    )
    if "entropy_final" in ledger:
        frac = ledger["entropy_final"] / max(ledger["entropy_uniform"], 1e-12)
        lines.append(
            f"weight entropy {ledger['entropy_final']:.3f}"
            f" / uniform {ledger['entropy_uniform']:.3f}  [{_bar(frac)}]"
        )
    if "top_policy" in ledger:
        tp = ledger["top_policy"]
        trace = " -> ".join(
            f"{p}@{s}" for p, s in zip(tp["policy"], tp["since_job"])
        )
        lines.append(f"leader trace ({tp['n_switches']} switches): {trace}")
    return lines


def _render_grid(ledger: dict) -> List[str]:
    sh = ledger["shape"]
    lines = _hdr(f"scenario-grid flight record  ({sh['n_regimes']} regimes x"
                 f" {sh['jobs_per_regime']} jobs x {sh['n_lanes']} lanes)")
    lines.append(
        f"recon  |cost resid| <= {ledger['max_abs_cost_residual']:.3g}"
        f"  |utility resid| <= {ledger['max_abs_utility_residual']:.3g}"
    )
    for e in ledger["per_regime"]:
        wl = e["winner_lane"]
        tag = e.get("winner", f"lane {e['winner_idx']}")
        lines.append(
            f"  {e.get('key', '?'):<26} winner {tag:<24}"
            f" u={e['winner_mean_utility']:8.2f}"
            f" spot%={e['pool']['spot_share']:.0%}"
            f" preempt={wl['preemptions_mean']:.2f}"
            f" done={wl['completion_rate']:.0%}"
        )
    return lines


_RENDERERS = {
    "pool": _render_pool,
    "fleet": _render_fleet,
    "selection": _render_selection,
    "scenario_grid": _render_grid,
}


def render(ledger: dict) -> str:
    """Render any obs.ledger dict as a textual dashboard."""
    kind = ledger.get("kind")
    if kind not in _RENDERERS:
        raise ValueError(f"unknown ledger kind: {kind!r}")
    return "\n".join(_RENDERERS[kind](ledger))
