"""The port's workflow suites, HTTP gateway and measured control plane
(``repro_torch.workflowbench``, ``serving/gateway.py``,
``serving/control_plane.py``) held to the JAX package's, in one process.

* Every family's instances lift to the same workflow documents.
* A one-replica gateway fed a trace over loopback HTTP gives the same
  fingerprint as the reference's direct ``Scheduler`` run; two replicas
  route and drain alike; the gateway's smoke check passes.
* ``chip_smoke.py``'s fit-and-schedule step, on a fixed list of stage
  observations shaped like the card's: the same fitted profile, and the
  same suite rows, placements and serving results as the reference's
  runner and ``Scheduler`` give on the same inputs, under the hand-set
  and the fitted profile, with no broken invariant and every solve
  optimal.
"""
import dataclasses
import json

import pytest

import repro.core.calibration as ref_calibration
import repro.core.devices as ref_devices
import repro.core.executor as ref_executor
import repro.core.scheduler as ref_scheduler
import repro.serving.gateway as ref_gateway
import repro.workflowbench.families as ref_families
import repro.workflowbench.lift as ref_lift
import repro.workflowbench.metrics as ref_metrics
import repro.workflowbench.runner as ref_runner
import repro.workflowbench.suites as ref_suites
import repro_torch.core.calibration as port_calibration
import repro_torch.core.devices as port_devices
import repro_torch.core.scheduler as port_scheduler
import repro_torch.serving.gateway as port_gateway
import repro_torch.workflowbench.lift as port_lift
import repro_torch.workflowbench.suites as port_suites
from repro_torch.serving import control_plane as cp

FAMILIES = list(ref_families.FAMILIES)


@pytest.mark.parametrize("num_queries", [4, 16])
@pytest.mark.parametrize("family", FAMILIES)
def test_instances_as_reference(family, num_queries):
    for index in range(2):
        got = port_lift.build_instance(family, index, num_queries)
        want = ref_lift.build_instance(family, index, num_queries)
        assert json.dumps(got.to_dict(), sort_keys=True) == \
            json.dumps(want.to_dict(), sort_keys=True)


# ---------------------------------------------------------------------------
# gateway
# ---------------------------------------------------------------------------

def _trace(suites, n=6):
    return suites.poisson_serving_trace(n_workflows=n, rate=6.0, seed=0,
                                        num_queries=4)


def test_gateway_fingerprint_as_reference():
    got = cp.gateway_parity(_trace(port_suites), port_devices
                            .homogeneous_cluster(4),
                            port_scheduler.SchedulerConfig(policy="FATE"))
    direct = ref_scheduler.Scheduler(ref_devices.homogeneous_cluster(4),
                                     ref_scheduler.SchedulerConfig(
                                         policy="FATE"))
    for t, wf in _trace(ref_suites):
        direct.submit(wf, at=t)
    direct.drain()
    assert got["match"], got
    assert got["submit_statuses"] == [202] and got["drain_status"] == 200
    assert got["http_fingerprint"] == got["fingerprint"] == \
        ref_gateway.scheduler_fingerprint(direct)


def _two_replicas(side):
    sched, dev, gateway, suites = {
        "ref": (ref_scheduler, ref_devices, ref_gateway, ref_suites),
        "port": (port_scheduler, port_devices, port_gateway, port_suites),
    }[side]
    cluster = dev.homogeneous_cluster(4)
    cfg = sched.SchedulerConfig(policy="FATE", gateway={"replicas": 2})
    gw = gateway.Gateway.from_config(cluster, cfg)
    routed = [gw.submit({"workflow": wf.to_dict(), "at": t})
              for t, wf in _trace(suites, 8)]
    res = gw.drain()
    return routed, json.dumps(res, sort_keys=True, default=str)


def test_two_replica_routing_as_reference():
    got, want = _two_replicas("port"), _two_replicas("ref")
    assert got == want
    assert {r["replica"] for r in got[0]} == {0, 1}


def test_gateway_smoke(capsys):
    assert port_gateway.main(["--smoke"]) == 0
    assert "gateway-smoke: OK" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# measure -> fit -> schedule
# ---------------------------------------------------------------------------

#: stage observations shaped like the card's: the example workflow's four
#: stages (three qwen, one llama) at (prompt, generated, queries) of
#: (128, 8, 8), (512, 32, 8) and (1024, 16, 4), under FATE and RoundRobin,
#: as (model, queries, prompt, generated, switches, prefix hit, wall s)
OBSERVATIONS = [
    ("qwen-7b", 8, 128, 8, 2, 0.0, 0.0612), ("llama-8b", 8, 128, 8, 1, 0.0,
                                             0.0987),
    ("qwen-7b", 8, 128, 8, 0, 0.0, 0.0334), ("qwen-7b", 8, 128, 8, 0, 1.0,
                                             0.0329),
    ("qwen-7b", 8, 128, 8, 1, 0.0, 0.0318), ("llama-8b", 8, 128, 8, 1, 0.0,
                                             0.0702),
    ("qwen-7b", 8, 128, 8, 0, 1.0, 0.0601), ("qwen-7b", 8, 128, 8, 1, 0.0,
                                             0.0322),
    ("qwen-7b", 8, 512, 32, 2, 0.0, 0.4811), ("llama-8b", 8, 512, 32, 1, 0.0,
                                              0.5480),
    ("qwen-7b", 8, 512, 32, 0, 0.0, 0.2571), ("qwen-7b", 8, 512, 32, 0, 1.0,
                                              0.2580),
    ("qwen-7b", 8, 512, 32, 1, 0.0, 0.2590), ("llama-8b", 8, 512, 32, 1, 0.0,
                                              0.5502),
    ("qwen-7b", 8, 512, 32, 0, 1.0, 0.4790), ("qwen-7b", 8, 512, 32, 1, 0.0,
                                              0.2562),
    ("qwen-7b", 4, 1024, 16, 2, 0.0, 0.2604), ("llama-8b", 4, 1024, 16, 1,
                                               0.0, 0.3011),
    ("qwen-7b", 4, 1024, 16, 0, 0.0, 0.1401), ("qwen-7b", 4, 1024, 16, 0, 1.0,
                                               0.1398),
    ("qwen-7b", 4, 1024, 16, 1, 0.0, 0.1405), ("llama-8b", 4, 1024, 16, 1,
                                               0.0, 0.3020),
    ("qwen-7b", 4, 1024, 16, 0, 1.0, 0.2611), ("qwen-7b", 4, 1024, 16, 1, 0.0,
                                               0.1399),
]
TIME_SCALE = 1.0


def _observations(cal):
    return [cal.StageObservation(model, model.split("-")[0], q, float(p),
                                 float(o), sw, f, 0.0, w)
            for model, q, p, o, sw, f, w in OBSERVATIONS]


def _serving_trace(suites):
    return suites.poisson_serving_trace(n_workflows=6, num_queries=4)


@pytest.fixture(scope="module")
def fitted():
    return tuple(cal.fit_profile(_observations(cal), time_scale=TIME_SCALE)
                 for cal in (port_calibration, ref_calibration))


def _ref_schedule(cal):
    """What ``control_plane.schedule`` does, through the reference."""
    cluster = ref_devices.homogeneous_cluster(8)
    wfs = [ref_lift.build_instance(f, 0, 16) for f in FAMILIES]
    rows = ref_runner.run_suite(wfs, cp.POLICIES, cluster, calibration=cal)
    cost = cal.cost_params() if cal else None
    runs = {}
    for wf in wfs:
        for pol in cp.POLICIES:
            state = ref_executor.fresh_state(
                cluster, profiles=cal.model_profiles() if cal else None)
            if wf.meta.get("preload_model"):
                for d in cluster.ids():
                    state.residency[d] = wf.meta["preload_model"]
            policy = ref_scheduler.SchedulerConfig(
                policy=pol, cost=cost).build_policy()
            runs[(wf.wid, pol)] = ref_executor.WorkflowExecutor(
                state, cost).run(wf, policy)
    trace = _serving_trace(ref_suites)
    served = ref_runner.run_serving(trace, cp.POLICIES[1:], cluster,
                                    calibration=cal)
    sched = ref_scheduler.Scheduler(cluster, ref_scheduler.SchedulerConfig(
        policy="FATE", calibration=cal))
    for t, wf in trace:
        sched.submit(wf, at=t)
    served["FATE"] = sched.drain()
    # the Scheduler surface and the runner serve FATE alike
    via_runner = ref_runner.run_serving(trace, ["FATE"], cluster,
                                        calibration=cal)["FATE"]
    assert _served(via_runner) == _served(served["FATE"])
    return rows, runs, served


def _served(res):
    return (sorted((w, dataclasses.astuple(s))
                   for w, s in res.stats.items()),
            res.rejected, res.failed, res.horizon, res.replans,
            res.model_switches, res.max_in_flight)


def _row(r):
    doc = r.as_dict()
    for k in ("solver_ms_mean", "solver_ms_max"):   # wall-clock
        doc.pop(k)
    return doc


@pytest.fixture(scope="module", params=["hand-set", "fitted"])
def scheduled(request, fitted):
    port_cal, ref_cal = fitted if request.param == "fitted" else (None, None)
    got = cp.schedule(port_cal, trace=_serving_trace(port_suites))
    return got, _ref_schedule(ref_cal)


def test_fit_as_reference(fitted):
    port, ref = fitted
    assert port.to_json() == ref.to_json()
    summary = cp.fit_summary(port)
    assert {f: summary[f]["n_obs"] for f in ("qwen", "llama")} == \
        {"qwen": 18, "llama": 6}
    assert all(s["finite"] for s in summary.values())
    # prompt and output lengths vary, so prefill and decode are fitted
    for fam in ("qwen", "llama"):
        assert not {"prefill", "decode"} & set(summary[fam]["defaulted"])
    assert summary["qwen"]["defaulted"] == ["transfer"]
    # deepseek was not measured: its models keep their hand-set profiles
    assert "deepseek" not in summary
    assert port.model_profiles()["deepseek-7b"] == \
        port_calibration.DEFAULT_PROFILES["deepseek-7b"]


def test_schedule_rows_as_reference(scheduled):
    got, (rows, _, _) = scheduled
    assert [_row(r) for r in got["rows"]] == [_row(r) for r in rows]
    assert len(rows) == len(FAMILIES) * len(cp.POLICIES)


def test_schedule_placements_as_reference(scheduled):
    got, (_, runs, _) = scheduled
    assert sorted(got["runs"]) == sorted(runs)
    for key, res in runs.items():
        mine = got["runs"][key]
        assert {s: (r.placement.devices, r.placement.shard_sizes, r.start,
                    r.finish) for s, r in mine.stage_runs.items()} == \
            {s: (r.placement.devices, r.placement.shard_sizes, r.start,
                 r.finish) for s, r in res.stage_runs.items()}, key


def test_schedule_serving_as_reference(scheduled):
    got, (_, _, served) = scheduled
    assert list(got["served"]) == list(cp.POLICIES)
    for pol in cp.POLICIES:
        assert _served(got["served"][pol]) == _served(served[pol]), pol
    summary = got["summary"]
    assert summary["serving"]["FATE"]["norm_ms"] == pytest.approx(
        ref_metrics.serving_summary(served)["FATE"]["norm_ms"], rel=0)


def test_schedule_summary(scheduled):
    got, (rows, _, _) = scheduled
    summary = got["summary"]
    assert summary["problems"] == []
    assert summary["batch"]["FATE"]["norm_ms"] == \
        ref_runner.rows_to_tables(rows)["FATE"]["norm_ms"]
    assert summary["batch"]["RoundRobin"]["norm_ms"] == 1.0
    assert set(summary["fate_by_family"]) == set(FAMILIES)
    for kind in ("batch", "serving"):
        solves = summary["fate_solves"][kind]
        assert solves["solves"] > 0 and solves["all_optimal"], kind
    json.dumps(summary)                      # printable as one line


def test_executor_violations_catch_a_broken_run(scheduled):
    got, _ = scheduled
    (wid, pol), res = next(iter(got["runs"].items()))
    wf = next(w for w in cp.family_instances() if w.wid == wid)
    assert cp.executor_violations(wf, res) == []
    child = next(s for s in wf.topo_order if wf.stages[s].parents)
    early = dataclasses.replace(res.stage_runs[child], start=-1.0)
    broken = dataclasses.replace(res, stage_runs={**res.stage_runs,
                                                  child: early})
    assert any("before its parent" in v
               for v in cp.executor_violations(wf, broken))
    dropped = dataclasses.replace(res, stage_runs={
        s: r for s, r in res.stage_runs.items() if s != child})
    assert cp.executor_violations(wf, dropped)
