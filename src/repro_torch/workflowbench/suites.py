"""Controlled behavioural suites (paper §4.3, Appendix C.1 & D.2),
plus the multi-workflow serving trace generator (§2's serving setting:
many agentic DAGs with stochastic arrivals contend for one cluster).

* Prefix-reuse suite — workflow-style DAG templates over long-context
  workloads with shared-prefix repeat ratios {0, 0.25, 0.5, 1.0}.
  Cache-dominant: single model family, shardable workers.  Isolates
  whether reuse alone explains the FATE gap (Table 2).

* Conflict stress suite — appendix-only diagnostic (Table 9): layers of
  parallel stages alternate model families while retaining
  cache-relevant state along chains, so myopic residency/locality
  following serializes onto the few warm devices, while a
  future-state-aware planner balances creating new residencies against
  queueing.  Four templates at repeat ratios {0, .25, .5, 1.0}
  (workflow_cache_conflict_{000,025,050,100}).
"""
from __future__ import annotations

from repro_torch.core.workflow import Stage, Workflow

RATIOS = (0.0, 0.25, 0.5, 1.0)


def prefix_suite_instance(ratio: float, index: int,
                          num_queries: int = 16) -> Workflow:
    """Decompose -> W parallel long-context workers -> 2 verifiers ->
    merge.  All stages one model (cache-dominant); workers shardable."""
    model = "qwen-7b"
    widths = [3, 4, 5, 6]
    w = widths[index % len(widths)]
    grp = f"pref-{ratio}-{index}:ctx"
    stages: dict[str, Stage] = {
        "decompose": Stage("decompose", model, base_cost={-1: 0.06},
                           prefix_group=grp, shared_fraction=ratio,
                           output_tokens=256.0, role="decomposition"),
    }
    for i in range(w):
        stages[f"worker{i}"] = Stage(
            f"worker{i}", model, max_shards=2, base_cost={-1: 0.14},
            prefill_fraction=0.85,
            prefix_group=grp, shared_fraction=ratio,
            output_tokens=512.0, parents=("decompose",), role="worker")
    for j in range(2):
        stages[f"verify{j}"] = Stage(
            f"verify{j}", model, max_shards=2, base_cost={-1: 0.08},
            prefill_fraction=0.85,
            prefix_group=grp, shared_fraction=ratio,
            output_tokens=192.0,
            parents=tuple(f"worker{i}" for i in range(w)
                          if i % 2 == j), role="validation")
    stages["merge"] = Stage(
        "merge", model, base_cost={-1: 0.1}, prefill_fraction=0.85,
        prefix_group=grp,
        shared_fraction=ratio, output_tokens=512.0,
        parents=("verify0", "verify1"), role="merge")
    wf = Workflow(wid=f"prefix-{int(ratio*100):03d}-{index:02d}",
                  stages=stages, num_queries=num_queries,
                  family="prefix-reuse")
    # cache-dominant same-model setting: the serving fleet is dedicated
    # to this model family, so it is resident before the batch arrives
    wf.meta["preload_model"] = model
    return wf


def prefix_suite(ratio: float, n_instances: int = 8,
                 num_queries: int = 16) -> list[Workflow]:
    """Batch of prefix-sharing workflow instances at one shared ratio."""
    return [prefix_suite_instance(ratio, i, num_queries)
            for i in range(n_instances)]


def conflict_suite_instance(ratio: float, index: int,
                            num_queries: int = 16) -> Workflow:
    """workflow_cache_conflict_<ratio>: depth D layers of P parallel
    stages; layer models alternate between two families; each chain
    retains a shared-prefix group, so reuse/residency following pulls
    every chain onto the same 1-2 warm devices."""
    models = ["qwen-7b", "llama-8b"]
    depth, par = 8, 6
    stages: dict[str, Stage] = {}
    prev: list[str] = []
    for lv in range(depth):
        model = models[lv % 2]
        cur = []
        for pch in range(par):
            sid = f"l{lv}c{pch}"
            parents = (f"l{lv-1}c{pch}",) if lv else ()
            stages[sid] = Stage(
                sid, model, base_cost={-1: 0.11},
                prefix_group=f"conf-{index}:chain{pch}",
                shared_fraction=max(ratio, 0.01),
                output_tokens=384.0, comm_weight=1.2,
                parents=parents, role="worker")
            cur.append(sid)
        prev = cur
    stages["final"] = Stage(
        "final", models[0], base_cost={-1: 0.12},
        output_tokens=512.0, parents=tuple(prev),
        role="final_synthesis")
    return Workflow(
        wid=f"workflow_cache_conflict_{int(ratio*100):03d}-{index:02d}",
        stages=stages, num_queries=num_queries, family="conflict")


def conflict_suite(ratio: float, n_instances: int = 4,
                   num_queries: int = 16) -> list[Workflow]:
    """Batch of cache-conflict workflow instances at one shared ratio."""
    return [conflict_suite_instance(ratio, i, num_queries)
            for i in range(n_instances)]


# ---------------------------------------------------------------------------
# multi-workflow serving traces
# ---------------------------------------------------------------------------


def poisson_serving_trace(n_workflows: int = 12, rate: float = 4.0,
                          seed: int = 0, num_queries: int = 8,
                          mix: str = "mixed"
                          ) -> list[tuple[float, "Workflow"]]:
    """Poisson arrival trace of heterogeneous workflow instances.

    Inter-arrival times are Exp(rate); instances cycle through the
    prefix-reuse and conflict-stress templates (``mix='mixed'``), or a
    single family (``mix='prefix'`` / ``mix='conflict'``), each with a
    unique workflow id so many copies can be in flight at once.
    Deterministic in ``seed``.  Returned sorted by arrival time —
    directly consumable by ``ServingExecutor.run``.
    """
    import random

    rng = random.Random(seed)
    trace: list[tuple[float, Workflow]] = []
    t = 0.0
    for i in range(n_workflows):
        t += rng.expovariate(rate)
        ratio = RATIOS[i % len(RATIOS)]
        if mix == "prefix" or (mix == "mixed" and i % 2 == 0):
            wf = prefix_suite_instance(ratio, i, num_queries)
            wf.wid = f"serve-prefix-{i:03d}"
        else:
            wf = conflict_suite_instance(ratio, i, num_queries)
            wf.wid = f"serve-conflict-{i:03d}"
        wf.meta.pop("preload_model", None)   # serving fleet is shared
        trace.append((t, wf))
    return trace


def drifting_serving_trace(n_workflows: int = 24, rate_start: float = 2.0,
                           rate_end: float = 16.0, seed: int = 0,
                           num_queries: int = 8
                           ) -> list[tuple[float, "Workflow"]]:
    """Poisson trace whose arrival rate ramps linearly from
    ``rate_start`` to ``rate_end`` over the trace.

    As load climbs, queueing delay — and with it the true
    observed/predicted probe ratio — drifts upward, so a static probe
    margin is wrong at one end of the trace no matter its value.  The
    regime the online EWMA probe correction is built for
    (``tests/test_calibration.py`` gates convergence on it).
    Deterministic in ``seed``; same mixed workload as
    :func:`poisson_serving_trace`.
    """
    import random

    rng = random.Random(seed)
    trace: list[tuple[float, Workflow]] = []
    t = 0.0
    for i in range(n_workflows):
        frac = i / max(n_workflows - 1, 1)
        rate = rate_start + (rate_end - rate_start) * frac
        t += rng.expovariate(rate)
        ratio = RATIOS[i % len(RATIOS)]
        if i % 2 == 0:
            wf = prefix_suite_instance(ratio, i, num_queries)
            wf.wid = f"drift-prefix-{i:03d}"
        else:
            wf = conflict_suite_instance(ratio, i, num_queries)
            wf.wid = f"drift-conflict-{i:03d}"
        wf.meta.pop("preload_model", None)
        trace.append((t, wf))
    return trace


def overloaded_serving_trace(n_workflows: int = 18, rate: float = 14.0,
                             seed: int = 0, num_queries: int = 8
                             ) -> list[tuple[float, "Workflow"]]:
    """Deliberately overloaded Poisson trace for the SLO control plane.

    Same mixed workload as :func:`poisson_serving_trace` but with an
    arrival rate far above the cluster's service rate, so unconditional
    admission drives queueing delay (and P95) unboundedly up while an
    admission controller can trade rejected arrivals for SLO-met
    goodput.  Used by ``benchmarks/sched_bench.py --serve-slo`` and
    ``tests/test_admission.py``.
    """
    return poisson_serving_trace(n_workflows=n_workflows, rate=rate,
                                 seed=seed, num_queries=num_queries,
                                 mix="mixed")


def routed_workflow_instance(index: int, num_queries: int = 8,
                             candidates: tuple = (("qwen-7b", 0.92),
                                                  ("llama-3b", 0.84))
                             ) -> Workflow:
    """Decompose -> W parallel workers -> merge, with the workers
    defaulting to the LARGE family (``qwen-14b``) while declaring
    cheaper alternates via ``Stage.candidates``.

    The default alternate list offers ``qwen-7b`` at quality 0.92
    (admissible at the default 0.9 quality floor, roughly half the
    cost) and ``llama-3b`` at 0.84 (below the floor — the router must
    exclude it even though it is far cheaper), so one instance
    exercises both sides of the floor.  Decompose/merge stay
    single-family with no alternates: routing must leave them
    untouched.
    """
    w = 3 + index % 3
    grp = f"routed-{index}:ctx"
    stages: dict[str, Stage] = {
        "decompose": Stage("decompose", "qwen-7b",
                           base_cost={-1: 0.06}, prefix_group=grp,
                           shared_fraction=0.5, output_tokens=256.0,
                           role="decomposition"),
    }
    for i in range(w):
        stages[f"worker{i}"] = Stage(
            f"worker{i}", "qwen-14b", max_shards=2,
            base_cost={-1: 0.2}, prefill_fraction=0.7,
            prefix_group=grp, shared_fraction=0.5,
            output_tokens=512.0, parents=("decompose",),
            role="worker", candidates=tuple(candidates))
    stages["merge"] = Stage(
        "merge", "qwen-7b", base_cost={-1: 0.08},
        prefix_group=grp, shared_fraction=0.5, output_tokens=384.0,
        parents=tuple(f"worker{i}" for i in range(w)), role="merge")
    return Workflow(wid=f"routed-{index:03d}", stages=stages,
                    num_queries=num_queries, family="routed")


def routed_serving_trace(n_workflows: int = 10, rate: float = 4.0,
                         seed: int = 0, num_queries: int = 8
                         ) -> list[tuple[float, "Workflow"]]:
    """Poisson trace of :func:`routed_workflow_instance` copies — the
    cost/quality routing benchmark input (``sched_bench --gateway``).

    Every worker stage prefers the large ``qwen-14b`` family but
    declares cheaper admissible alternates, so a routing-enabled
    planner can trade quality margin above the floor for cost, while
    a routing-disabled run must serve everything on the default
    family.  Deterministic in ``seed``; sorted by arrival time.
    """
    import random

    rng = random.Random(seed)
    trace: list[tuple[float, Workflow]] = []
    t = 0.0
    for i in range(n_workflows):
        t += rng.expovariate(rate)
        wf = routed_workflow_instance(i, num_queries)
        trace.append((t, wf))
    return trace


def multiclass_overloaded_trace(n_workflows: int = 18, rate: float = 14.0,
                                seed: int = 0, num_queries: int = 8,
                                class_cycle: tuple = ("platinum", "batch",
                                                      "batch")
                                ) -> list[tuple[float, "Workflow", str]]:
    """The overloaded trace annotated with admission classes.

    Exactly :func:`overloaded_serving_trace` — identical workflows,
    arrival times, and wids (so :func:`chaos_fault_plan`'s targeted
    ``serve-prefix-000``/``serve-conflict-001`` failures keep
    landing) — with each arrival assigned a class from ``class_cycle``
    by arrival index.  The default cycle makes every third arrival
    platinum, so both tiers stay busy through the overload.  Returns
    ``[(arrival, workflow, klass)]`` triples for
    ``Scheduler.submit(wf, at=t, klass=k)``.  Deterministic in
    ``seed``.
    """
    trace = overloaded_serving_trace(n_workflows=n_workflows, rate=rate,
                                     seed=seed, num_queries=num_queries)
    return [(t, wf, class_cycle[i % len(class_cycle)])
            for i, (t, wf) in enumerate(trace)]


def scale_instance(index: int, num_queries: int = 4) -> Workflow:
    """One small workflow for the 1k-workflow scale trace.

    Shapes cycle through four tiny templates (2–5 stages: pair, chain,
    diamond, shardable fan-out/merge) over the five bench model
    families, with prefix groups shared within a burst-sized cohort —
    small enough that a thousand instances drain in bench time, varied
    enough that scoring (transfer, residency, prefix, sharding) and the
    pooled partitioner all stay live.  Deterministic in ``index``.
    """
    models = ["qwen-7b", "deepseek-7b", "llama-8b", "llama-3b",
              "qwen-14b"]
    m = models[index % 5]
    m2 = models[(index + 2) % 5]
    grp = f"scale:g{index % 16}"
    shape = index % 4
    stages: dict[str, Stage] = {}
    if shape == 0:                                  # pair: a -> b
        stages["a"] = Stage("a", m, base_cost={-1: 0.06},
                            prefix_group=grp, shared_fraction=0.5,
                            output_tokens=192.0)
        stages["b"] = Stage("b", m2, base_cost={-1: 0.08},
                            output_tokens=256.0, parents=("a",))
    elif shape == 1:                                # chain: a -> b -> c
        stages["a"] = Stage("a", m, base_cost={-1: 0.05},
                            output_tokens=192.0)
        stages["b"] = Stage("b", m2, base_cost={-1: 0.09},
                            prefix_group=grp, shared_fraction=0.5,
                            output_tokens=256.0, parents=("a",))
        stages["c"] = Stage("c", m, base_cost={-1: 0.06},
                            output_tokens=192.0, parents=("b",))
    elif shape == 2:                                # diamond
        stages["src"] = Stage("src", m, base_cost={-1: 0.05},
                              output_tokens=192.0)
        for side in ("l", "r"):
            stages[side] = Stage(side, m2, base_cost={-1: 0.08},
                                 prefix_group=grp, shared_fraction=0.5,
                                 output_tokens=256.0, parents=("src",))
        stages["sink"] = Stage("sink", m, base_cost={-1: 0.06},
                               output_tokens=192.0,
                               parents=("l", "r"))
    else:                                           # fan-out / merge
        stages["src"] = Stage("src", m, base_cost={-1: 0.05},
                              output_tokens=192.0)
        for i in range(3):
            stages[f"w{i}"] = Stage(
                f"w{i}", m2, max_shards=2, base_cost={-1: 0.1},
                prefix_group=grp, shared_fraction=0.5,
                output_tokens=256.0, parents=("src",))
        stages["merge"] = Stage("merge", m, base_cost={-1: 0.07},
                                output_tokens=256.0,
                                parents=("w0", "w1", "w2"))
    return Workflow(wid=f"scale-{index:04d}", stages=stages,
                    num_queries=num_queries, family="scale")


def scale_serving_trace(n_workflows: int = 1000, burst: int = 8,
                        gap: float = 0.25, num_queries: int = 4
                        ) -> list[tuple[float, "Workflow"]]:
    """Bursty arrival trace for the 1k-workflow ``--scale`` gate.

    Arrivals land in bursts of ``burst`` workflows at the SAME
    timestamp (exercising batched admission probing: one shared
    lookahead overlay per burst), bursts spaced ``gap`` simulated
    seconds apart so in-flight depth stays bounded while consecutive
    bursts overlap.  Instances are the tiny mixed
    :func:`scale_instance` shapes.  Fully deterministic.
    """
    trace: list[tuple[float, Workflow]] = []
    for i in range(n_workflows):
        t = (i // burst) * gap
        trace.append((t, scale_instance(i, num_queries)))
    return trace


def chaos_fault_plan(seed: int = 0) -> "FaultPlan":
    """The chaos-gate fault script for the overloaded serving trace.

    A fixed, seeded :class:`~repro_torch.core.faults.FaultPlan` combining
    every fault class the scheduler handles, with timings tuned to the
    fault-free FATE horizon of ``overloaded_serving_trace(18)`` on a
    6-device homogeneous cluster (≈107 simulated seconds):

    * one device crash at ~30% of the fault-free horizon (device 2 at
      t=30s) with recovery 30 simulated seconds later;
    * a 3× slowdown episode on device 1 (t=10–45s) long enough to
      trip straggler probes (threshold 1.5× believed duration) and
      speculative re-issue;
    * two targeted transient shard failures early in two different
      workflow shapes (a prefix-suite worker and a conflict-suite
      level stage), exercising retry-with-backoff.

    Used by ``benchmarks/sched_bench.py --chaos`` and
    ``tests/test_faults.py``.
    """
    from repro_torch.core.faults import (DeviceCrash, FaultPlan, ShardFailure,
                                   Slowdown)
    return FaultPlan(
        seed=seed,
        crashes=(DeviceCrash(device=2, at=30.0, recover_at=60.0),),
        slowdowns=(Slowdown(device=1, at=10.0, until=45.0, factor=3.0),),
        failures=(ShardFailure(wid="serve-prefix-000", sid="worker0",
                               at_fraction=0.5),
                  ShardFailure(wid="serve-conflict-001", sid="l0c0",
                               at_fraction=0.3)),
        max_retries=3, retry_backoff=0.05, retry_backoff_mult=2.0,
        straggler_threshold=1.5, speculate=True,
        quarantine_after=3, quarantine_s=1.0)
