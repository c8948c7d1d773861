"""Metric definitions (paper Appendix C.2).

NormMS(m)  = exp( mean_i log(T_{m,i} / T_{RR,i}) )
NormP95(m) = exp( mean_i log(L95_{m,i} / L95_{RR,i}) )
XDevEdge   = Σ cross_device_parent_edges / Σ workflow_tasks
CacheScore = Σ prefix_cache_hits_est / Σ workflow_tasks
ModelCont  = Σ same_model_continuations / Σ workflow_tasks

Serving metrics (shared-frontier suite): per-workflow makespan is
finish − arrival, P95 is the 95th-percentile per-query latency relative
to arrival, both normalized per instance against the baseline policy
and geomeaned; goodput is completed workflows (and queries) per second
of busy horizon.

SLO control-plane metrics (``slo_summary``): attainment is SLO-met
workflows over OFFERED workflows (rejected arrivals count against it);
SLO goodput is SLO-met workflows per second of busy horizon — shedding
load only pays off if the admitted set actually meets its deadlines.
"""
from __future__ import annotations

import math
from typing import Iterable, Sequence


def geomean(xs: Sequence[float]) -> float:
    xs = [x for x in xs if x > 0]
    if not xs:
        return float("nan")
    return math.exp(sum(math.log(x) for x in xs) / len(xs))


def normalized(values: dict[str, float], baseline: dict[str, float]
               ) -> list[float]:
    """Per-instance ratios value/baseline over the strict intersection."""
    out = []
    for k, v in values.items():
        b = baseline.get(k)
        if b is not None and b > 0 and v > 0:
            out.append(v / b)
    return out


def serving_summary(results: dict, baseline: str = "RoundRobin"
                    ) -> dict[str, dict]:
    """Aggregate ``{policy: ServingResult}`` into normalized serving
    metrics: geomean per-workflow makespan/P95 ratios vs ``baseline``
    (strict instance intersection), goodput, and contention stats."""
    base = results.get(baseline)
    out: dict[str, dict] = {}
    for pol, res in results.items():
        ms_ratios, p95_ratios = [], []
        if base is not None:
            for wid, s in res.stats.items():
                b = base.stats.get(wid)
                if b is None:
                    continue
                if b.makespan > 0 and s.makespan > 0:
                    ms_ratios.append(s.makespan / b.makespan)
                if b.p95 > 0 and s.p95 > 0:
                    p95_ratios.append(s.p95 / b.p95)
        out[pol] = {
            "norm_ms": geomean(ms_ratios),
            "norm_p95": geomean(p95_ratios),
            "goodput_wps": res.goodput_wps,
            "goodput_qps": res.goodput_qps,
            "mean_makespan": (sum(s.makespan for s in res.stats.values())
                              / len(res.stats) if res.stats
                              else float("nan")),
            "max_in_flight": res.max_in_flight,
            "replans": res.replans,
            "model_switches": res.model_switches,
            "n": len(res.stats),
        }
    return out


def _pooled_p95(latencies: Sequence[float]) -> float:
    """Nearest-rank 95th percentile of a pooled latency sample."""
    from repro_torch.core.executor import nearest_rank_p95
    return nearest_rank_p95(latencies)


def slo_summary(results: dict) -> dict[str, dict]:
    """Aggregate ``{label: ServingResult}`` into SLO control-plane
    metrics.

    Per label: ``slo_attainment`` (SLO-met workflows / offered —
    rejected arrivals count against it), ``goodput_slo_wps`` (SLO-met
    workflows per second of busy horizon, the objective the control
    plane optimizes), ``rejection_rate``, pooled per-query
    ``p95_latency`` over completed workflows, and the deferral /
    preemption / replan counters.
    """
    out: dict[str, dict] = {}
    for label, res in results.items():
        lat = [v for s in res.stats.values() for v in s.latencies]
        offered = res.n_offered
        out[label] = {
            "n_offered": offered,
            "n_completed": len(res.stats),
            "n_rejected": len(res.rejected),
            "rejection_rate": (len(res.rejected) / offered
                               if offered else float("nan")),
            "slo_attainment": res.slo_attainment,
            "goodput_slo_wps": res.goodput_slo_wps,
            "goodput_wps": res.goodput_wps,
            "p95_latency": _pooled_p95(lat),
            "mean_latency": (sum(lat) / len(lat) if lat
                             else float("nan")),
            "deferrals": res.deferrals,
            "preemptions": res.preemptions,
            "replans": res.replans,
        }
    return out


def class_summary(res) -> dict[str, dict]:
    """Per-admission-class breakdown of one
    :class:`~repro_torch.core.scheduler.ServingResult`.

    Classes come from ``res.classes`` (every OFFERED workflow id, so
    rejected and failed arrivals are attributed to their class too);
    workflows a pre-multiclass run produced (empty ``classes``) fall
    back to the per-stat ``klass`` label.  Per class:

    * ``slo_attainment`` — SLO-met completions over offered in-class
      arrivals (rejections and fault-failures count against it);
    * ``completion_rate`` — completed over offered (the bottom-class
      starvation gate asserts this is 1.0);
    * ``mean_wait`` / ``max_wait`` — end-to-end makespan
      (finish − arrival, queueing included): the bounded-wait side of
      the anti-starvation guarantee;
    * ``p95_latency`` — pooled per-query p95 over in-class completions;
    * offered / completed / rejected / failed counts.
    """
    klass_of = dict(res.classes)
    for wid, s in res.stats.items():
        klass_of.setdefault(wid, s.klass)
    for wid in list(res.rejected) + list(res.failed):
        klass_of.setdefault(wid, "default")
    out: dict[str, dict] = {}
    for klass in sorted(set(klass_of.values())):
        wids = {w for w, k in klass_of.items() if k == klass}
        stats = [s for w, s in res.stats.items() if w in wids]
        n_rej = sum(1 for w in res.rejected if w in wids)
        n_fail = sum(1 for w in res.failed if w in wids)
        offered = len(stats) + n_rej + n_fail
        lat = [v for s in stats for v in s.latencies]
        waits = [s.makespan for s in stats]
        met = sum(1 for s in stats if s.slo_met)
        out[klass] = {
            "n_offered": offered,
            "n_completed": len(stats),
            "n_rejected": n_rej,
            "n_failed": n_fail,
            "slo_attainment": (met / offered if offered
                               else float("nan")),
            "completion_rate": (len(stats) / offered if offered
                                else float("nan")),
            "mean_wait": (sum(waits) / len(waits) if waits
                          else float("nan")),
            "max_wait": (max(waits) if waits else float("nan")),
            "p95_latency": _pooled_p95(lat),
        }
    return out


def rebase_result(res, t0: "float | None" = None):
    """Normalize a :class:`~repro_torch.core.scheduler.ServingResult` onto
    the scheduler clock: shift every absolute timestamp so the
    earliest arrival sits at zero (or at an explicit ``t0``).

    Gateway-injected runs timestamp arrivals from wall-clock
    submission, so their absolute times start at an arbitrary offset
    instead of the trace-time origin the summaries were written
    against.  Every summary metric is difference-based (makespan,
    latencies, P95, SLO slack), so the shift changes nothing for
    trace-driven runs — this helper exists so the wall-clock
    assumption is handled in ONE place rather than per-summary.
    Returns a new result (the input is not mutated); a result already
    at the origin (or with no completions) is returned as-is.
    """
    import dataclasses
    if not res.stats:
        return res
    if t0 is None:
        t0 = min(s.arrival for s in res.stats.values())
    if abs(t0) < 1e-12:
        return res
    stats = {}
    for wid, s in res.stats.items():
        stats[wid] = dataclasses.replace(
            s, arrival=s.arrival - t0, finish=s.finish - t0,
            query_completion=[t - t0 for t in s.query_completion],
            deadline=(s.deadline - t0
                      if s.deadline is not None else None))
    return dataclasses.replace(res, stats=stats)


def _median(xs: Sequence[float]) -> float:
    """``statistics.median`` with NaN (not ValueError) on empty input —
    the robust center the probe-error gate compares, insensitive to the
    one-off tail blowups an overloaded trace produces."""
    import statistics
    return statistics.median(xs) if xs else float("nan")


def probe_error_summary(records: Sequence) -> dict[str, float]:
    """Aggregate an admission controller's ``probe_log``
    (:class:`repro_torch.core.admission.ProbeRecord` list) into
    predicted-vs-observed probe accuracy metrics.

    ``median_abs_err`` / ``mean_abs_err`` are over
    ``|margin · predicted − observed|`` seconds — the quantity the
    online EWMA correction shrinks and the ``sched_bench --calibrate``
    gate compares against the hand-set-margin baseline.
    ``median_ratio`` is the raw ``observed / predicted`` ratio (what a
    perfectly-converged margin would equal); ``mean_margin`` the
    margins actually applied.
    """
    errs = [r.abs_error for r in records]
    ratios = [r.observed / r.predicted for r in records
              if r.predicted > 1e-9]
    return {
        "n": len(errs),
        "median_abs_err": _median(errs),
        "mean_abs_err": (sum(errs) / len(errs) if errs
                         else float("nan")),
        "median_ratio": _median(ratios),
        "mean_margin": (sum(r.margin for r in records) / len(records)
                        if records else float("nan")),
    }


def mechanism_rates(rows: Iterable[dict]) -> dict[str, float]:
    """Mechanism proxies per task (Appendix C.2): cross-device edge
    rate, estimated prefix-cache hit rate, same-model continuation
    rate, over a set of run-row dicts."""
    rows = list(rows)
    tot_tasks = sum(r["total_tasks"] for r in rows)
    if tot_tasks == 0:
        return {"xdev_edge": float("nan"), "cache_score": float("nan"),
                "model_cont": float("nan")}
    return {
        "xdev_edge": sum(r["cross_device_edges"] for r in rows) / tot_tasks,
        "cache_score": sum(r["prefix_hits_est"] for r in rows) / tot_tasks,
        "model_cont": sum(r["same_model_continuations"]
                          for r in rows) / tot_tasks,
    }


def chaos_summary(results: dict) -> dict[str, dict]:
    """Fault-tolerance summary per labelled serving run.

    ``results`` maps a run label (e.g. ``"fault-free"``, ``"chaos"``)
    to a :class:`~repro_torch.core.scheduler.ServingResult`.  Each row
    reports completion accounting (offered / completed / failed /
    completion rate over admitted work), the horizon, and the fault
    machinery counters — the quantities the chaos gate asserts on.
    """
    out: dict[str, dict] = {}
    for label, res in results.items():
        n_completed = len(res.stats)
        n_admitted = n_completed + len(res.failed)
        out[label] = {
            "n_offered": res.n_offered,
            "n_completed": n_completed,
            "n_rejected": len(res.rejected),
            "n_failed": len(res.failed),
            "completion_rate": (n_completed / n_admitted
                                if n_admitted else float("nan")),
            "horizon": res.horizon,
            "device_downs": res.device_downs,
            "shard_failures": res.shard_failures,
            "retries": res.retries,
            "stragglers": res.stragglers,
            "speculations": res.speculations,
        }
    return out
