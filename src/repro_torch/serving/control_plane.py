"""The control plane on measured stage costs.

Closes the measure -> fit -> schedule loop of the port: once the serving
engine's stage observations (:meth:`ServingEngine.observations
<repro_torch.serving.engine.ServingEngine.observations>`, measured on the
card) are fitted into a
:class:`~repro_torch.core.calibration.CalibrationProfile`
(``fit_profile``), the workflow suites are scheduled on that profile
beside the hand-set one, and a gateway replica is held to a direct
:class:`~repro_torch.core.scheduler.Scheduler` run of the same trace.
All of it is host code: it runs the same on the CPU, from a fixed list of
observations, as on the card's host after a measured serve.

    from repro_torch.core.calibration import fit_profile
    from repro_torch.serving import control_plane as cp
    profile = fit_profile(engine.observations(), time_scale=1.0)
    print(cp.fit_summary(profile))
    hand, fitted = cp.schedule(None), cp.schedule(profile)
    print(fitted["summary"])

``schedule`` runs one instance of each workflow family under FATE and
the five baselines on eight devices, each run as ``runner.run_one`` runs
it, keeping its ``RunResult`` for the executor's invariants (every stage
runs once, dependencies hold, busy intervals on a device do not
overlap) beside its ``runner.RunRow``; and the Poisson serving trace
through ``runner.run_serving`` for the baselines and through the
``Scheduler`` surface (``SchedulerConfig(calibration=...)``) for FATE.
FATE's planners' ``solve_log`` gives its solve times.
"""
from __future__ import annotations

import http.client
import json
import math
from typing import Optional

from repro_torch.core.calibration import CalibrationProfile
from repro_torch.core.devices import Cluster, homogeneous_cluster
from repro_torch.core.executor import WorkflowExecutor, fresh_state
from repro_torch.core.policies import POLICY_REGISTRY
from repro_torch.core.scheduler import (RunResult, Scheduler,
                                        SchedulerConfig)
from repro_torch.core.workflow import Workflow
from repro_torch.serving.gateway import (Gateway, GatewayServer,
                                         scheduler_fingerprint)
from repro_torch.workflowbench import lift, metrics, runner, suites
from repro_torch.workflowbench.families import FAMILIES

BASELINE = "RoundRobin"
#: FATE first, then the five baselines of the registry
POLICIES = ("FATE",) + tuple(sorted(set(POLICY_REGISTRY) - {"FATE"}))
#: the queries of each family's instance, and the devices of the cluster
NUM_QUERIES, N_DEVICES = 16, 8

__all__ = ["BASELINE", "POLICIES", "batch_run", "executor_violations",
           "family_instances", "fit_summary", "gateway_parity", "schedule",
           "solve_stats"]


def fit_summary(profile: CalibrationProfile) -> dict:
    """Each measured family's coefficients beside its fit statistics
    (``n_obs``, ``rmse``, ``defaulted``, ``collinear``) and whether every
    coefficient is finite.  A family the trace did not measure is not in
    the profile, and its models keep their hand-set profiles."""
    out = {}
    for fam, c in sorted(profile.families.items()):
        coef = c.as_dict()
        out[fam] = {**coef, **dict(profile.fit_stats.get(fam, {})),
                    "finite": all(math.isfinite(v) for v in coef.values())}
    return out


def family_instances() -> list[Workflow]:
    """Instance 0 of each of the ten workflow families, NUM_QUERIES
    queries each."""
    return [lift.build_instance(fam, 0, NUM_QUERIES) for fam in FAMILIES]


def batch_run(wf: Workflow, policy: str, cluster: Cluster,
              calibration: Optional[CalibrationProfile]):
    """``wf`` under ``policy`` on a fresh state, as ``runner.run_one``
    runs it (the profile's model profiles and cost params, the
    workflow's preloaded model).  Returns its ``runner.RunRow`` (the
    solver statistics of FATE's ``solve_log``), its ``RunResult`` and the
    planner's solve log (empty for a baseline)."""
    profiles = calibration.model_profiles() if calibration else None
    cost = calibration.cost_params() if calibration else None
    state = fresh_state(cluster, profiles=profiles)
    preload = wf.meta.get("preload_model")
    if preload:
        for d in cluster.ids():
            state.residency[d] = preload
    planner = SchedulerConfig(policy=policy, cost=cost).build_policy()
    res = WorkflowExecutor(state, cost).run(wf, planner)
    row = runner.RunRow(
        wid=wf.wid, family=wf.family, policy=policy,
        num_queries=wf.num_queries, makespan=res.makespan, p95=res.p95,
        cross_device_edges=res.cross_device_edges,
        prefix_hits_est=res.prefix_hits_est,
        same_model_continuations=res.same_model_continuations,
        total_tasks=res.total_tasks, model_switches=res.model_switches)
    log = list(getattr(planner, "solve_log", None) or [])
    if log:
        st = solve_stats(log)
        row.solver_ms_mean, row.solver_ms_max = st["mean_ms"], st["max_ms"]
        row.solver_solves = st["solves"]
        row.solver_all_optimal = st["all_optimal"]
    return row, res, log


def executor_violations(wf: Workflow, res: RunResult) -> list[str]:
    """What breaks the executor's invariants in one batch run: a stage
    that did not run exactly once, a stage started before a parent
    finished, shards that do not cover the queries, busy intervals that
    overlap on a device, a query that completes after the makespan."""
    bad = []
    if set(res.stage_runs) != set(wf.stages):
        bad.append(f"stages run {sorted(res.stage_runs)}, "
                   f"workflow has {sorted(wf.stages)}")
    per_dev: dict[int, list] = {}
    for sid, run in sorted(res.stage_runs.items()):
        for p in wf.stages[sid].parents:
            parent = res.stage_runs.get(p)
            if parent is None or parent.finish > run.start + 1e-9:
                bad.append(f"{sid} starts at {run.start} before its "
                           f"parent {p} finishes")
        if sum(run.placement.shard_sizes) != wf.num_queries:
            bad.append(f"{sid}: shards {run.placement.shard_sizes} for "
                       f"{wf.num_queries} queries")
        for d, fin, nq in zip(run.placement.devices, run.shard_finish,
                              run.placement.shard_sizes):
            if nq:
                per_dev.setdefault(d, []).append((run.start, fin, sid))
    for d, ivs in sorted(per_dev.items()):
        ivs.sort()
        for (_, f1, a), (s2, _, b) in zip(ivs, ivs[1:]):
            if f1 > s2 + 1e-6:
                bad.append(f"device {d}: {a} and {b} overlap")
    if (len(res.query_completion) != wf.num_queries
            or max(res.query_completion, default=0.0)
            > res.makespan + 1e-9):
        bad.append("query completions do not fit the makespan")
    return bad


def solve_stats(log) -> dict:
    """Count, mean and largest milliseconds of a planner's solves, and
    whether every one was proven optimal."""
    ms = [r.wall_time * 1e3 for r in log]
    return {"solves": len(ms),
            "mean_ms": sum(ms) / len(ms) if ms else None,
            "max_ms": max(ms) if ms else None,
            "all_optimal": all(r.status == "OPTIMAL" for r in log),
            "not_optimal": sorted({r.status for r in log} - {"OPTIMAL"})}


def _serving_problems(trace, results: dict) -> list[str]:
    offered = {wf.wid for _, wf in trace}
    bad = []
    for pol, res in results.items():
        if set(res.stats) != offered or res.failed or res.rejected:
            bad.append(f"serving {pol}: {len(res.stats)} of {len(offered)} "
                       f"workflows finished (failed {list(res.failed)}, "
                       f"rejected {list(res.rejected)})")
    return bad


def schedule(calibration: Optional[CalibrationProfile] = None, *,
             trace=None) -> dict:
    """Schedule each family's instance (``family_instances``) and a
    serving ``trace`` (default ``suites.poisson_serving_trace()``) under
    every policy of POLICIES on N_DEVICES devices, priced by
    ``calibration`` (None: the hand-set profile).

    Returns ``rows`` (``runner.RunRow`` per batch run, as
    ``runner.run_suite`` gives them), ``runs`` (``(wid, policy)`` ->
    ``RunResult``), ``served`` (policy -> ``ServingResult``) and a
    JSON-able ``summary``: FATE's makespan and P95 against RoundRobin per
    family and as geomeans (``runner.rows_to_tables``,
    ``metrics.serving_summary``), FATE's solves, and ``problems``, every
    broken invariant and unfinished workflow."""
    cluster = homogeneous_cluster(N_DEVICES)
    trace = suites.poisson_serving_trace() if trace is None else trace
    rows, runs, problems, batch_log = [], {}, [], []
    for wf in family_instances():
        for pol in POLICIES:
            row, res, log = batch_run(wf, pol, cluster, calibration)
            rows.append(row)
            runs[(wf.wid, pol)] = res
            batch_log += log
            problems += [f"{wf.wid}/{pol}: {x}"
                         for x in executor_violations(wf, res)]
    served = runner.run_serving(trace, POLICIES[1:], cluster,
                                calibration=calibration)
    sched = Scheduler(cluster, SchedulerConfig(policy="FATE",
                                               calibration=calibration))
    for t, wf in trace:
        sched.submit(wf, at=t)
    served = {"FATE": sched.drain(), **served}
    problems += _serving_problems(trace, served)

    tables = runner.rows_to_tables(rows, baseline=BASELINE)
    base = {r.wid: r for r in rows if r.policy == BASELINE}
    per_family = {
        r.family: {"norm_ms": r.makespan / base[r.wid].makespan,
                   "norm_p95": r.p95 / base[r.wid].p95,
                   "makespan": r.makespan, "rr_makespan":
                   base[r.wid].makespan}
        for r in rows if r.policy == "FATE" and r.wid in base}
    serving = metrics.serving_summary(served, baseline=BASELINE)
    solves = {"batch": solve_stats(batch_log),
              "serving": solve_stats(sched.policy.solve_log)}
    for kind, s in solves.items():
        if not (s["solves"] and s["all_optimal"]):
            problems.append(f"FATE's {kind} solves: {s['solves']}, not "
                            f"optimal: {s['not_optimal']}")
    summary = {
        "profile": calibration.source if calibration else "hand-set",
        "batch": {p: {k: tables[p][k] for k in ("norm_ms", "norm_p95", "n")}
                  for p in POLICIES},
        "fate_by_family": per_family,
        "serving": {p: {k: serving[p][k] for k in (
            "norm_ms", "norm_p95", "goodput_wps", "model_switches", "n")}
            for p in POLICIES},
        "fate_solves": solves,
        "problems": problems,
    }
    return {"rows": rows, "runs": runs, "served": served,
            "summary": summary}


def _post(port: int, target: str, body: Optional[dict] = None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", target,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def gateway_parity(trace, cluster: Cluster, config: SchedulerConfig) -> dict:
    """Serve ``trace`` through a one-replica gateway on an ephemeral
    loopback port (each workflow POSTed with its explicit arrival, then
    ``POST /v1/drain``) and directly through a ``Scheduler``; the
    replica's fingerprint must equal the direct run's.  Returns both
    fingerprints, the HTTP statuses and ``match``."""
    direct = Scheduler(cluster, config)
    for t, wf in trace:
        direct.submit(wf, at=t)
    direct.drain()
    gw = Gateway(lambda: Scheduler(cluster, config), replicas=1)
    with GatewayServer(gw, host="127.0.0.1", port=0) as srv:
        statuses = [_post(srv.port, "/v1/workflows",
                          {"workflow": wf.to_dict(), "at": t})[0]
                    for t, wf in trace]
        drain_status, body = _post(srv.port, "/v1/drain")
    want = scheduler_fingerprint(direct)
    got = json.loads(body)["replicas"][0]["fingerprint"]
    return {"workflows": len(trace), "submit_statuses": sorted(set(statuses)),
            "drain_status": drain_status, "fingerprint": want,
            "http_fingerprint": got,
            "match": (got == want and drain_status == 200
                      and set(statuses) == {202})}

