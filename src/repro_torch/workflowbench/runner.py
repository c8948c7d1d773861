"""Manifest runner: executes every scheduler on every workflow instance
under the same runtime and exports one CSV per experiment
(paper Appendix C.4 — "Evaluation pipeline and result provenance").

These entry points are BACK-COMPAT WRAPPERS over the event-driven
scheduler core: every call lowers its per-call knobs
(``score_params`` / ``cost_params`` / ``calibration`` / ``slo`` /
``policy_kwargs``) into a typed
:class:`~repro_torch.core.scheduler.SchedulerConfig` and runs through the
executor adapters.  New code should build a ``SchedulerConfig`` and
drive :class:`~repro_torch.core.scheduler.Scheduler` directly (see
``docs/API.md``); the ``policy_kwargs`` escape hatch emits a
``DeprecationWarning``.
"""
from __future__ import annotations

import csv
import dataclasses
import warnings
from pathlib import Path
from typing import Optional, Sequence

from repro_torch.core.admission import SLOConfig
from repro_torch.core.calibration import CalibrationProfile
from repro_torch.core.costs import CostParams
from repro_torch.core.devices import Cluster, homogeneous_cluster
from repro_torch.core.executor import (ServingExecutor, ServingResult,
                                 WorkflowExecutor, fresh_state)
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.core.scoring import ScoreParams
from repro_torch.core.workflow import Workflow

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "workflow"


@dataclasses.dataclass
class RunRow:
    """One (workflow, policy) batch-run record — a CSV row of the
    Table 1 analogue, including solver statistics when available."""
    wid: str
    family: str
    policy: str
    num_queries: int
    makespan: float
    p95: float
    cross_device_edges: int
    prefix_hits_est: float
    same_model_continuations: float
    total_tasks: int
    model_switches: int
    solver_ms_mean: float = 0.0
    solver_ms_max: float = 0.0
    solver_solves: int = 0
    solver_all_optimal: bool = True

    def as_dict(self) -> dict:
        """Flat dict of every field (CSV export order)."""
        return dataclasses.asdict(self)


def _load_calibration(calibration: Optional[CalibrationProfile],
                      cost_params: Optional[CostParams]
                      ) -> tuple[Optional[dict], Optional[CostParams]]:
    """Lower a calibration profile onto runner inputs: the per-model
    profiles dict for ``fresh_state`` and the calibrated
    :class:`CostParams` (the explicit ``cost_params`` argument is the
    base the profile's scales are applied over)."""
    if calibration is None:
        return None, cost_params
    return (calibration.model_profiles(),
            calibration.cost_params(cost_params))


def _warn_policy_kwargs(policy_kwargs: Optional[dict]) -> dict:
    """Deprecation shim for the untyped ``policy_kwargs`` escape hatch
    (superseded by typed :class:`SchedulerConfig` fields)."""
    if policy_kwargs:
        warnings.warn(
            "policy_kwargs is deprecated; express planner knobs as "
            "SchedulerConfig fields (use_matrix/use_delta/warm_start/"
            "time_limit/max_waves/score/cost) and drive "
            "repro_torch.core.scheduler.Scheduler directly",
            DeprecationWarning, stacklevel=3)
    return dict(policy_kwargs or {})


def _legacy_config(policy_name: str, *,
                   score_params: Optional[ScoreParams] = None,
                   lowered_cost: Optional[CostParams] = None,
                   calibration: Optional[CalibrationProfile] = None,
                   slo: Optional[SLOConfig] = None,
                   policy_kwargs: Optional[dict] = None
                   ) -> SchedulerConfig:
    """Lower one legacy (kwarg-threaded) run description onto a typed
    :class:`SchedulerConfig`.

    Preserves the historical quirks exactly so wrapper runs stay
    bit-identical to the pre-redesign executors: the FATE planner sees
    ``cost_params`` only when a calibration profile was loaded (the
    executor always prices with them), and ``score_params`` falls back
    to defaults.  ``calibration`` itself is pre-lowered by the caller
    (``lowered_cost``), so the config embeds no profile.
    """
    return SchedulerConfig(
        policy=policy_name,
        policy_kwargs=dict(policy_kwargs or {}),
        score=score_params if score_params is not None else ScoreParams(),
        cost=lowered_cost if calibration is not None else None,
        slo=slo)


def run_one(wf: Workflow, policy_name: str, cluster: Cluster, *,
            score_params: Optional[ScoreParams] = None,
            cost_params: Optional[CostParams] = None,
            calibration: Optional[CalibrationProfile] = None,
            policy_kwargs: Optional[dict] = None) -> RunRow:
    """Run one workflow under one policy on a fresh state.

    Honors the workflow's ``meta["preload_model"]`` (cache-dominant
    suites start with the model resident fleet-wide).  With a
    ``calibration`` profile, the execution state's model profiles, the
    executor's cost params, and the FATE planner's cost params all load
    the profile's fitted constants (single source of truth).  Returns
    the :class:`RunRow` with mechanism proxies and solver stats filled
    in.
    """
    kwargs = _warn_policy_kwargs(policy_kwargs)
    profiles, cost_params = _load_calibration(calibration, cost_params)
    state = fresh_state(cluster, profiles=profiles)
    preload = wf.meta.get("preload_model")
    if preload:
        for d in cluster.ids():
            state.residency[d] = preload
    config = _legacy_config(policy_name, score_params=score_params,
                            lowered_cost=cost_params,
                            calibration=calibration,
                            policy_kwargs=kwargs)
    policy = config.build_policy()
    ex = WorkflowExecutor(state, cost_params)
    res = ex.run(wf, policy)
    row = RunRow(
        wid=wf.wid, family=wf.family, policy=policy_name,
        num_queries=wf.num_queries, makespan=res.makespan, p95=res.p95,
        cross_device_edges=res.cross_device_edges,
        prefix_hits_est=res.prefix_hits_est,
        same_model_continuations=res.same_model_continuations,
        total_tasks=res.total_tasks, model_switches=res.model_switches)
    log = getattr(policy, "solve_log", None)
    if log:
        times = [r.wall_time * 1e3 for r in log]
        row.solver_ms_mean = sum(times) / len(times)
        row.solver_ms_max = max(times)
        row.solver_solves = len(times)
        row.solver_all_optimal = all(r.status == "OPTIMAL" for r in log)
    return row


def run_suite(workflows: Sequence[Workflow], policies: Sequence[str],
              cluster: Optional[Cluster] = None, *,
              score_params: Optional[ScoreParams] = None,
              cost_params: Optional[CostParams] = None,
              calibration: Optional[CalibrationProfile] = None,
              csv_name: Optional[str] = None) -> list[RunRow]:
    """Run every (workflow × policy) pair on fresh per-run states and
    optionally export one CSV (``results/workflow/<csv_name>``)."""
    cluster = cluster or homogeneous_cluster(8)
    rows: list[RunRow] = []
    for wf in workflows:
        for pol in policies:
            rows.append(run_one(wf, pol, cluster,
                                score_params=score_params,
                                cost_params=cost_params,
                                calibration=calibration))
    if csv_name:
        export_csv(rows, csv_name)
    return rows


def export_csv(rows: Sequence[RunRow], name: str) -> Path:
    """Write batch-run rows to ``results/workflow/<name>``; returns
    the path."""
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    path = RESULTS_DIR / name
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].as_dict()))
        w.writeheader()
        for r in rows:
            w.writerow(r.as_dict())
    return path


def run_serving(trace: Sequence[tuple[float, Workflow]],
                policies: Sequence[str],
                cluster: Optional[Cluster] = None, *,
                score_params: Optional[ScoreParams] = None,
                cost_params: Optional[CostParams] = None,
                calibration: Optional[CalibrationProfile] = None,
                slo: Optional["SLOConfig"] = None,
                policy_kwargs: Optional[dict] = None,
                csv_name: Optional[str] = None
                ) -> dict[str, ServingResult]:
    """Run one Poisson serving trace under every policy.

    Each policy gets a fresh execution state over the same cluster and
    the same arrival trace (same workflow instances — the generators
    are deterministic, so cross-policy per-workflow ratios are
    meaningful).  With ``slo`` the SLO-aware control plane (admission /
    deferral / preemption) is active; pass
    ``SLOConfig(admission=False, preemption=False)`` to track deadlines
    under unconditional admission (the control-plane baseline), and
    ``SLOConfig(online_margin=True)`` to learn the probe margin online
    from observed completions instead of the hand-set constant.  With
    ``calibration``, every state/executor/planner constant loads the
    profile's fit (see :mod:`repro_torch.core.calibration`).
    ``policy_kwargs`` configure the FATE planner (e.g.
    ``{"use_delta": False, "warm_start": False}`` for parity
    references); like ``score_params`` they are applied to FATE only,
    so mixed-policy comparisons stay valid.  The kwarg path is
    DEPRECATED: new code should express these as
    :class:`~repro_torch.core.scheduler.SchedulerConfig` fields and drive
    the scheduler directly (``docs/API.md`` has the migration table).
    Returns
    ``{policy: ServingResult}``; aggregate with
    :func:`repro_torch.workflowbench.metrics.serving_summary` or
    :func:`repro_torch.workflowbench.metrics.slo_summary`.
    """
    cluster = cluster or homogeneous_cluster(8)
    pk = _warn_policy_kwargs(policy_kwargs)
    profiles, cost_params = _load_calibration(calibration, cost_params)
    results: dict[str, ServingResult] = {}
    for pol_name in policies:
        # policy_kwargs/score_params configure FATE only, so
        # mixed-policy comparisons stay valid (historical contract)
        fate = pol_name == "FATE"
        config = _legacy_config(
            pol_name,
            score_params=score_params if fate else None,
            lowered_cost=cost_params,
            calibration=calibration if fate else None,
            slo=slo, policy_kwargs=pk if fate else None)
        policy = config.build_policy()
        state = fresh_state(cluster, profiles=profiles)
        ex = ServingExecutor(state, cost_params, slo=slo)
        results[pol_name] = ex.run(list(trace), policy)
    if csv_name:
        export_serving_csv(results, csv_name)
    return results


def export_serving_csv(results: dict[str, ServingResult],
                       name: str) -> Path:
    """Write per-workflow serving stats (one row per completed
    workflow per policy) to ``results/workflow/<name>``."""
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    path = RESULTS_DIR / name
    fields = ["policy", "wid", "arrival", "finish", "makespan", "p95",
              "n_stages", "n_queries"]
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        for pol, res in results.items():
            for wid, s in sorted(res.stats.items()):
                w.writerow({
                    "policy": pol, "wid": wid, "arrival": s.arrival,
                    "finish": s.finish, "makespan": s.makespan,
                    "p95": s.p95, "n_stages": s.n_stages,
                    "n_queries": len(s.query_completion)})
    return path


def rows_to_tables(rows: Sequence[RunRow], baseline: str = "RoundRobin"):
    """Aggregate rows into the Table 1 style summary."""
    from repro_torch.workflowbench.metrics import geomean, mechanism_rates
    by_policy: dict[str, dict[str, RunRow]] = {}
    for r in rows:
        by_policy.setdefault(r.policy, {})[r.wid] = r
    base = by_policy.get(baseline, {})
    out: dict[str, dict] = {}
    for pol, per_wid in by_policy.items():
        ms_ratios, p95_ratios = [], []
        for wid, r in per_wid.items():
            b = base.get(wid)
            if b and b.makespan > 0:
                ms_ratios.append(r.makespan / b.makespan)
                p95_ratios.append(r.p95 / b.p95)
        mech = mechanism_rates([r.as_dict() for r in per_wid.values()])
        out[pol] = {
            "norm_ms": geomean(ms_ratios),
            "norm_p95": geomean(p95_ratios),
            **mech,
            "n": len(per_wid),
        }
    return out
