"""The port's control plane (``repro_torch.core``: the event-driven
``Scheduler``, admission, the journal, the CP-SAT-style solver and the
executor adapters; ``repro_torch.workflowbench``; ``serving/gateway.py``)
held to the JAX package's, in one process.

* The copies equal their originals once ``repro_torch`` is read as
  ``repro``, docstrings aside.
* ``WorkflowExecutor`` places every family's workflow as the reference
  does, under every registered policy.
* ``ServingExecutor`` gives the same event stream and ``ServingResult`` on
  the Poisson, overloaded and multi-class traces under the SLO control
  plane, and under the chaos fault plan.
* A snapshot and journal written by either package restore in the other to
  the same drain.
* ``SchedulerConfig`` serialises alike and loads across packages; the
  port's exact 0-1 solver finds the frontier solver's optimum.
"""
import ast
import dataclasses
import json
import random
import types
from pathlib import Path

import numpy as np
import pytest

import repro.core.admission as ref_admission
import repro.core.calibration as ref_calibration
import repro.core.cpsat as ref_cpsat
import repro.core.devices as ref_devices
import repro.core.executor as ref_executor
import repro.core.frontier_solver as ref_frontier
import repro.core.journal as ref_journal
import repro.core.policies as ref_policies
import repro.core.routing as ref_routing
import repro.core.scheduler as ref_scheduler
import repro.workflowbench.families as ref_families
import repro.workflowbench.lift as ref_lift
import repro.workflowbench.suites as ref_suites
import repro_torch.core.admission as port_admission
import repro_torch.core.calibration as port_calibration
import repro_torch.core.cpsat as port_cpsat
import repro_torch.core.devices as port_devices
import repro_torch.core.executor as port_executor
import repro_torch.core.frontier_solver as port_frontier
import repro_torch.core.journal as port_journal
import repro_torch.core.policies as port_policies
import repro_torch.core.routing as port_routing
import repro_torch.core.scheduler as port_scheduler
import repro_torch.workflowbench.families as port_families
import repro_torch.workflowbench.lift as port_lift
import repro_torch.workflowbench.suites as port_suites

ROOT = Path(__file__).resolve().parents[1]
REF_SRC, PORT_SRC = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"

SIDES = {
    side: types.SimpleNamespace(
        admission=adm, calibration=cal, devices=dev, executor=ex,
        journal=jr, policies=pol, routing=rt, scheduler=sch, lift=lf,
        suites=su)
    for side, (adm, cal, dev, ex, jr, pol, rt, sch, lf, su) in {
        "ref": (ref_admission, ref_calibration, ref_devices, ref_executor,
                ref_journal, ref_policies, ref_routing, ref_scheduler,
                ref_lift, ref_suites),
        "port": (port_admission, port_calibration, port_devices,
                 port_executor, port_journal, port_policies, port_routing,
                 port_scheduler, port_lift, port_suites),
    }.items()}
POLICIES = sorted(ref_policies.POLICY_REGISTRY)
FAMILIES = list(ref_families.FAMILIES)
#: the weighted two-tier classes of ``tests/test_multiclass.py``
MC_SLO = dict(aging_rate=0.5, preempt_running=True, preempt_running_max=6,
              preempt_kill_cap=3)


# ---------------------------------------------------------------------------
# the copies
# ---------------------------------------------------------------------------

#: guarded: every file of these directories of the port, and these files
GUARDED_DIRS = ("core", "configs", "workflowbench")
GUARDED_FILES = ("serving/gateway.py",)
#: files of the guarded directories that have no original (none: each
#: is a copy; the port's own control-plane code is serving/control_plane.py)
PORT_ONLY = frozenset()


def _guarded(src: Path) -> set[str]:
    files = {str(p.relative_to(src)) for d in GUARDED_DIRS
             for p in (src / d).rglob("*.py")}
    return files | {f for f in GUARDED_FILES if (src / f).exists()}


COPIED = sorted(_guarded(PORT_SRC) - PORT_ONLY)


def _without_docstrings(source: str) -> str:
    tree = ast.parse(source)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef))
                and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:]
    return ast.dump(tree, include_attributes=False)


def test_the_copies_cover_the_reference():
    assert _guarded(PORT_SRC) - _guarded(REF_SRC) == PORT_ONLY
    assert _guarded(REF_SRC) <= _guarded(PORT_SRC)
    assert {"core/scheduler.py", "core/admission.py", "core/journal.py",
            "core/cpsat.py", "core/executor.py", "workflowbench/runner.py",
            "serving/gateway.py"} <= set(COPIED)


@pytest.mark.parametrize("rel", COPIED)
def test_copy_equals_its_original(rel):
    port = (PORT_SRC / rel).read_text().replace("repro_torch", "repro")
    assert _without_docstrings(port) == \
        _without_docstrings((REF_SRC / rel).read_text()), rel


# ---------------------------------------------------------------------------
# batch runs: every family under every policy
# ---------------------------------------------------------------------------

def _placements(stage_runs) -> dict:
    return {sid: (r.placement.devices, r.placement.shard_sizes,
                  r.placement.model, r.start, r.finish, r.shard_finish,
                  r.switched)
            for sid, r in sorted(stage_runs.items())}


def _batch(side: str, family: str, policy: str):
    s = SIDES[side]
    wf = s.lift.build_instance(family, 0, 16)
    state = s.executor.fresh_state(s.devices.homogeneous_cluster(8))
    preload = wf.meta.get("preload_model")
    if preload:
        for d in state.cluster.ids():
            state.residency[d] = preload
    res = s.executor.WorkflowExecutor(state).run(
        wf, s.policies.make_policy(policy))
    return (_placements(res.stage_runs), res.makespan, res.p95,
            res.model_switches, res.total_tasks, res.cross_device_edges)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("family", FAMILIES)
def test_batch_run_as_reference(family, policy):
    got, want = _batch("port", family, policy), _batch("ref", family, policy)
    assert got == want
    assert len(got[0]) > 1


# ---------------------------------------------------------------------------
# serving runs under the SLO control plane, and under faults
# ---------------------------------------------------------------------------

def _events(sched) -> list:
    return [json.dumps(e.to_dict(), sort_keys=True) for e in sched.events]


def _result(res) -> tuple:
    return (sorted((w, dataclasses.astuple(s))
                   for w, s in res.stats.items()),
            res.rejected, res.failed, res.horizon, res.max_in_flight,
            res.replans, res.model_switches, res.deferrals,
            res.preemptions, res.device_downs, res.shard_failures,
            res.retries, res.stragglers, res.speculations,
            res.shard_preemptions, sorted(res.classes.items()))


def _serve(side: str, trace_name: str, policy: str):
    s = SIDES[side]
    cluster = s.devices.homogeneous_cluster(6)
    if trace_name == "multiclass":
        spec = s.admission.ClassSpec
        slo = s.admission.SLOConfig(classes={
            "platinum": spec(weight=4.0, latency_scale=8.0),
            "batch": spec(weight=1.0, latency_scale=40.0,
                          backlog_limit=18)}, **MC_SLO)
        sched = s.scheduler.Scheduler(cluster, s.scheduler.SchedulerConfig(
            policy=policy, slo=slo))
        for t, wf, klass in s.suites.multiclass_overloaded_trace(
                n_workflows=10, num_queries=4):
            sched.submit(wf, at=t, klass=klass)
        res = sched.drain()
    else:
        trace = {"poisson": s.suites.poisson_serving_trace,
                 "overloaded": s.suites.overloaded_serving_trace,
                 }[trace_name]()
        ex = s.executor.ServingExecutor(
            s.executor.fresh_state(cluster), slo=s.admission.SLOConfig())
        res = ex.run(trace, s.policies.make_policy(policy))
        sched = ex.scheduler
    return _events(sched), _result(res)


@pytest.mark.parametrize("policy", ["FATE", "RoundRobin"])
@pytest.mark.parametrize("trace", ["poisson", "overloaded", "multiclass"])
def test_serving_run_as_reference(trace, policy):
    (ev_port, res_port), (ev_ref, res_ref) = (_serve("port", trace, policy),
                                              _serve("ref", trace, policy))
    assert ev_port == ev_ref
    assert res_port == res_ref
    assert res_port[0], "no workflow finished"


def _chaos(side: str, policy: str):
    s = SIDES[side]
    sched = s.scheduler.Scheduler(
        s.devices.homogeneous_cluster(6), s.scheduler.SchedulerConfig(
            policy=policy, slo=s.admission.SLOConfig(),
            faults=s.suites.chaos_fault_plan(0)))
    for t, wf in s.suites.overloaded_serving_trace():
        sched.submit(wf, at=t)
    res = sched.drain()
    return _events(sched), _result(res), s.scheduler.audit_invariants(sched)


@pytest.mark.parametrize("policy", ["FATE", "RoundRobin"])
def test_chaos_fault_plan_as_reference(policy):
    got, want = _chaos("port", policy), _chaos("ref", policy)
    assert got == want
    assert got[2] == []
    assert got[1][9] >= 1 and got[1][11] >= 1      # a device went down, a retry


# ---------------------------------------------------------------------------
# recovery across packages
# ---------------------------------------------------------------------------

def _recovery_config(side: str):
    s = SIDES[side]
    return s.scheduler.SchedulerConfig(
        policy="FATE", slo=s.admission.SLOConfig(),
        faults=s.suites.chaos_fault_plan(0))


def _recovery_trace(side: str):
    return SIDES[side].suites.overloaded_serving_trace(
        n_workflows=8, rate=14.0, seed=0, num_queries=4)


def _drained(side: str, sched) -> tuple:
    res = sched.drain()
    return _result(res), sched.events.n_total, \
        SIDES[side].scheduler.audit_invariants(sched)


@pytest.fixture(scope="module")
def uninterrupted():
    s = SIDES["ref"]
    sched = s.scheduler.Scheduler(s.devices.homogeneous_cluster(4),
                                  _recovery_config("ref"))
    for t, wf in _recovery_trace("ref"):
        sched.submit(wf, at=t)
    return _drained("ref", sched)


@pytest.mark.parametrize("journaled", [True, False],
                         ids=["journal", "snapshot"])
@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_restore_across_packages(writer, reader, journaled, tmp_path,
                                 uninterrupted):
    """The writer runs 40 % of the events, snapshotting every 15 steps
    into its journal, and is abandoned; the reader restores the latest
    snapshot (replaying the journal's tail) and drains to the
    uninterrupted run's result."""
    w, r = SIDES[writer], SIDES[reader]
    journal = w.journal.EventJournal(tmp_path, rotate_bytes=16 * 1024) \
        if journaled else None
    sched = w.scheduler.Scheduler(w.devices.homogeneous_cluster(4),
                                  _recovery_config(writer), journal=journal)
    for t, wf in _recovery_trace(writer):
        sched.submit(wf, at=t)
    snap = sched.snapshot()
    if journaled:
        journal.write_snapshot(snap)
    steps = 0
    while sched.events.n_total < int(uninterrupted[1] * 0.4) and \
            sched.step():
        steps += 1
        if journaled and steps % 15 == 0:
            journal.write_snapshot(sched.snapshot())
    killed_at = sched.events.n_total
    if not journaled:
        snap = json.loads(json.dumps(sched.snapshot()))
    del sched, journal
    if journaled:
        reopened = r.journal.EventJournal(tmp_path)
        snap = reopened.latest_snapshot()
        assert snap["events"]["n_total"] < killed_at
        restored = r.scheduler.Scheduler.restore(snap, reopened)
    else:
        restored = r.scheduler.Scheduler.restore(snap)
    assert type(restored).__module__.startswith(
        "repro_torch" if reader == "port" else "repro.")
    assert restored.events.n_total == killed_at
    assert r.scheduler.audit_invariants(restored) == []
    assert _drained(reader, restored) == uninterrupted


# ---------------------------------------------------------------------------
# configuration and solvers
# ---------------------------------------------------------------------------

def _config(side: str):
    s = SIDES[side]
    obs = [s.calibration.StageObservation(
        "qwen-7b", "qwen", q, p, o, sw, f, 0.0, w)
        for q, p, o, sw, f, w in ((8, 128, 8, 2, 0.0, 0.06),
                                  (8, 512, 32, 0, 1.0, 0.26),
                                  (4, 1024, 16, 1, 0.0, 0.21),
                                  (8, 1024, 16, 0, 1.0, 0.24))]
    return s.scheduler.SchedulerConfig(
        policy="FATE", policy_kwargs={"use_delta": False},
        slo=s.admission.SLOConfig(latency_scale=3.0),
        calibration=s.calibration.fit_profile(obs, time_scale=0.5),
        time_limit=2.0, max_waves=4, faults=s.suites.chaos_fault_plan(1),
        event_buffer=512, pools="auto", batch_probes=True,
        routing=s.routing.RoutingConfig(quality_floor=0.85),
        gateway={"replicas": 2, "port": 0})


def test_scheduler_config_json_across_packages():
    ref_json, port_json = _config("ref").to_json(), _config("port").to_json()
    assert port_json == ref_json
    assert port_scheduler.SchedulerConfig.from_json(ref_json).to_json() \
        == ref_json
    assert ref_scheduler.SchedulerConfig.from_json(port_json).to_json() \
        == port_json
    loaded = port_scheduler.SchedulerConfig.from_json(ref_json)
    assert loaded.model_profiles() == _config("port").model_profiles()
    assert type(loaded.build_policy()).__module__.startswith("repro_torch")


def _random_model(mod, seed: int):
    rng = random.Random(seed)
    m = mod.CpModel()
    n = rng.randint(2, 12)
    vs = [m.new_bool_var() for _ in range(n)]
    m.maximize([(v, rng.uniform(-3, 6)) for v in vs])
    for _ in range(rng.randint(0, 4)):
        m.add_at_most_one([vs[i] for i in rng.sample(
            range(n), rng.randint(1, min(4, n)))])
    for _ in range(rng.randint(0, 4)):
        a, b = rng.randint(0, n - 1), rng.randint(0, n - 1)
        if a != b:
            m.add_implication(vs[a], vs[b])
    return m


@pytest.mark.parametrize("seed", range(8))
def test_cpsat_as_reference(seed):
    got = port_cpsat.CpSolver().solve(_random_model(port_cpsat, seed))
    want = ref_cpsat.CpSolver().solve(_random_model(ref_cpsat, seed))
    assert got.status == want.status == "OPTIMAL"
    assert (got.objective, got.values) == (want.objective, want.values)


@pytest.mark.parametrize("seed", range(8))
def test_cpsat_finds_the_frontier_solvers_optimum(seed):
    """One slot a stage: the frontier problem is an assignment, which the
    0-1 model states exactly (at most one device a stage, one stage a
    device)."""
    rng = np.random.default_rng(seed)
    n_stages, n_dev = int(rng.integers(2, 7)), int(rng.integers(2, 5))
    weights = rng.uniform(-2, 5, (n_stages, n_dev))
    weights[rng.random((n_stages, n_dev)) < 0.2] = port_frontier.NEG
    rows = [(f"s{i}", 0) for i in range(n_stages)]
    want = port_frontier.solve_frontier_exact(port_frontier.FrontierProblem(
        rows, list(range(n_dev)), weights.copy()))
    ref = ref_frontier.solve_frontier_exact(ref_frontier.FrontierProblem(
        rows, list(range(n_dev)), weights.copy()))
    m = port_cpsat.CpModel()
    x = {(i, d): m.new_bool_var(f"x{i}_{d}") for i in range(n_stages)
         for d in range(n_dev) if weights[i, d] > port_frontier.NEG / 2}
    for i in range(n_stages):
        m.add_at_most_one([v for (r, _), v in x.items() if r == i])
    for d in range(n_dev):
        m.add_at_most_one([v for (_, c), v in x.items() if c == d])
    m.maximize([(v, float(weights[k])) for k, v in x.items()])
    got = port_cpsat.solve_frontier(m)
    assert got.status == want.status == "OPTIMAL"
    assert got.objective == pytest.approx(want.objective, abs=1e-9)
    assert (want.objective, want.assignment) == (ref.objective,
                                                 ref.assignment)
