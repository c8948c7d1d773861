"""SLO-aware admission control for the serving runtime (control plane).

The paper's central claim is that scheduling decisions should be
conditioned on predicted *future* state, not the immediate queue alone
(§1, §3.2).  PR 2's :class:`~repro_torch.core.executor.ServingExecutor`
still admitted every Poisson arrival unconditionally — exactly the
"optimize immediate queue state only" failure mode under overload.
This module adds the missing serving-time decision layer:

* **Admission** — on each arrival, a cheap *future-state probe* (a
  delta-rescored one-wave ``plan_shared`` lookahead over the merged
  frontier, run on a throwaway planning overlay) predicts the
  workflow's completion latency under current contention.  If the
  prediction violates the per-workflow SLO (a configurable latency
  multiplier over the workflow's critical-path lower bound), the
  arrival is deferred into a bounded backlog — or rejected when the
  backlog is full or the deadline is already unreachable.
* **Deferral / re-admission** — on completion events the backlog is
  re-probed oldest-feasible-first; entries whose deadline became
  unreachable are shed (rejected) so they never consume capacity they
  cannot convert into SLO-met goodput.
* **Preemption trigger** — an admitted workflow whose predicted
  latency sits within ``preempt_slack`` of its budget is flagged
  ``preempt=True``; the executor then revokes committed-but-unissued
  placements so the urgent DAG competes in a fresh merged solve
  immediately instead of waiting for the next completion event.

The controller never mutates the real :class:`ExecutionState`: probes
run on copy-on-write overlays, so the dirty-set protocol that keeps
``Scorer.rescore_matrix`` bit-identical to full rebuilds is untouched
(see :mod:`repro_torch.core.state`).

Probe-margin correction (``SLOConfig.online_margin``): the raw probe
under-estimates latency under load, so its prediction is inflated by a
safety margin before the SLO comparison.  The margin is either the
hand-set ``probe_margin`` constant or — when ``online_margin`` is on —
a live per-model-family :class:`~repro_torch.core.calibration.ProbeCorrector`
estimate: the serving executor reports every workflow completion back
via :meth:`AdmissionController.record_completion`, the corrector folds
the observed/predicted latency ratio into its EWMA, and every later
admission probe and deferral re-probe uses the corrected margin.  All
predicted-vs-observed pairs are kept on ``probe_log`` for the
``sched_bench --calibrate`` gate
(:func:`repro_torch.workflowbench.metrics.probe_error_summary`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional, Sequence

from repro_torch.core.calibration import ProbeCorrector
from repro_torch.core.state import ExecutionState
from repro_torch.core.workflow import Workflow


@dataclasses.dataclass(frozen=True)
class ClassSpec:
    """One admission class's scheduling contract.

    ``weight`` orders classes for backlog re-probing, congestion-floor
    accounting, displacement protection, and running-shard preemption
    (strictly-lower-weight workflows are preemptible by a tight
    higher-weight admission).  ``latency_scale`` overrides the global
    :attr:`SLOConfig.latency_scale` for the class's deadlines (``None``
    inherits it); ``backlog_limit`` likewise bounds the class's OWN
    deferral-queue share instead of the shared global limit.
    """
    weight: float = 1.0
    latency_scale: Optional[float] = None
    backlog_limit: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Per-workflow latency SLO and control-plane knobs.

    The deadline of a workflow arriving at ``t`` is
    ``t + latency_scale * cp_lower_bound(wf)`` — a multiple of the
    fastest possible execution on an empty cluster, so heavy DAGs get
    proportionally more budget than small ones.

    Multi-class serving (``classes`` non-empty) layers weighted SLOs on
    top: each admission class carries a :class:`ClassSpec` (weight,
    deadline scale, backlog share), the backlog is re-probed
    class-major (effective weight, then age — where effective weight is
    ``weight + aging_rate * wait``, the anti-starvation promotion), the
    congestion floors of a high-class candidate exclude lower-class
    committed-but-unissued work, and ``preempt_running`` arms
    kill/replay preemption of issued-and-running lower-class shards
    (see :meth:`repro_torch.core.scheduler.Scheduler._preempt_running`).
    With ``classes`` EMPTY (the default) every class-aware branch is
    skipped and the controller is bit-identical to the single-class
    one — the compatibility contract ``tests/test_multiclass.py``
    asserts.
    """
    latency_scale: float = 2.5      # deadline = arrival + scale * cp_lb
    backlog_limit: int = 8          # bounded deferral queue length
    # safety factor on predicted latency: the probe's floors ignore
    # transfer costs and residual layer serialization, so raw
    # predictions under-estimate under load.  With online_margin this
    # constant is only the corrector's PRIOR: the effective margin is
    # learned per model family from observed completions.
    probe_margin: float = 1.5
    # preempt when predicted * slack > budget; must be > probe_margin
    # or the trigger window (budget/slack, budget/margin] is empty
    preempt_slack: float = 2.5
    admission: bool = True          # False: track SLOs, admit everything
    preemption: bool = True         # False: never revoke commitments
    # online predicted-vs-observed probe correction (EWMA residual
    # tracker per model family, see repro_torch.core.calibration); the
    # corrector starts at probe_margin so an un-warmed controller is
    # identical to the static one
    online_margin: bool = False
    margin_alpha: float = 0.4       # EWMA step of the ratio tracker
    # ring-buffer cap on the predicted-vs-observed probe log (None =
    # unbounded, the benchmark/test default; long-running serving
    # deployments set a cap so the log cannot grow without bound)
    probe_log_limit: Optional[int] = None
    # -- multi-class control plane (empty = single-class, bit-identical
    # to the pre-class controller) --------------------------------------
    classes: Mapping[str, ClassSpec] = \
        dataclasses.field(default_factory=dict)
    # anti-starvation aging: a backlog entry's effective weight grows
    # by aging_rate per second of wait, so a bottom-class entry
    # overtakes a fresh top-class one after
    # (w_top - w_bottom) / aging_rate seconds — the starvation bound
    # docs/PRIORITY.md derives (0.0 = strict class order forever)
    aging_rate: float = 0.0
    # kill/replay preemption of ISSUED-and-running strictly-lower-class
    # shards when a higher-class arrival would otherwise be deferred
    # (or admits SLO-tight); the scheduler revokes the run token,
    # credits partial state back, and re-enqueues the stage
    preempt_running: bool = False
    preempt_running_max: int = 2    # max victims per trigger
    # a stage killed this many times becomes immune (anti-livelock:
    # guarantees bottom-class progress under sustained platinum load)
    preempt_kill_cap: int = 2
    # seconds the freed devices are held for the trigger's replan
    # before the victim stage re-enters the merged solve
    preempt_holdoff: float = 0.05

    def __post_init__(self):
        if self.classes:
            coerced = {k: (v if isinstance(v, ClassSpec)
                           else ClassSpec(**v))
                       for k, v in self.classes.items()}
            object.__setattr__(self, "classes", coerced)

    def class_spec(self, klass: str) -> Optional[ClassSpec]:
        """The configured :class:`ClassSpec` for ``klass`` (``None``
        when unconfigured — callers fall back to the global knobs)."""
        return self.classes.get(klass) if self.classes else None

    def class_weight(self, klass: str) -> float:
        """Scheduling weight of ``klass`` (1.0 when unconfigured)."""
        spec = self.class_spec(klass)
        return spec.weight if spec is not None else 1.0

    def deadline(self, arrival: float, cp_lb: float,
                 klass: str = "default") -> float:
        """Absolute completion deadline for a workflow with critical-path
        lower bound ``cp_lb`` that arrived at ``arrival``.  With a
        class-configured ``latency_scale`` override, the class's scale
        replaces the global one (single-class configs ignore
        ``klass``)."""
        scale = self.latency_scale
        spec = self.class_spec(klass)
        if spec is not None and spec.latency_scale is not None:
            scale = spec.latency_scale
        return arrival + scale * cp_lb


@dataclasses.dataclass
class AdmissionDecision:
    """Outcome of one admission probe.

    ``action`` is ``"admit"``, ``"defer"``, or ``"reject"``;
    ``predicted_latency`` is the probe's completion-latency estimate
    (seconds from the decision instant, BEFORE the safety margin);
    ``margin`` is the multiplicative safety margin the SLO comparison
    used (hand-set or corrector-supplied); ``deadline`` is absolute sim
    time; ``preempt`` asks the executor to revoke unissued commitments
    so the admitted workflow is replanned against immediately.
    """
    action: str
    predicted_latency: float
    deadline: float
    cp_lb: float
    preempt: bool = False
    margin: float = 1.0


@dataclasses.dataclass(frozen=True)
class ProbeRecord:
    """One admitted workflow's probe prediction vs serving reality.

    ``predicted`` is the raw probe estimate at the (final) admit
    decision, ``margin`` the multiplicative safety factor applied to
    it, and ``observed`` the measured completion latency from that
    decision instant — the evidence stream behind the online probe
    correction and the ``--calibrate`` benchmark gate.
    """
    wid: str
    family: str
    predicted: float
    margin: float
    observed: float
    decided_at: float
    finished_at: float

    @property
    def abs_error(self) -> float:
        """``|margin · predicted − observed|`` seconds — the gap the
        online corrector shrinks."""
        return abs(self.margin * self.predicted - self.observed)


def stage_floor_costs(wf: Workflow, cluster,
                      live: Optional[Sequence[int]] = None
                      ) -> dict[str, float]:
    """Per-stage minimum base cost over eligible devices (seconds).

    State-free lower bound: ignores switches, transfers, queueing and
    every benefit term — the fastest any single device could run the
    stage's full query batch.  ``live`` (the reduced device set under
    partial outage) restricts the minimum to live eligible devices;
    stages whose every eligible device is down fall back to the full
    eligible set so the bound stays finite.
    """
    out: dict[str, float] = {}
    q = wf.num_queries
    for sid, st in wf.stages.items():
        devs = st.eligible if st.eligible else cluster.ids()
        if live is not None:
            up = [d for d in devs if d in live]
            devs = up or devs
        out[sid] = min(st.cost_on(d) * q / cluster.devices[d].speed
                       for d in devs)
    return out


def stage_effective_floors(wf: Workflow, cluster, profiles: dict,
                           floor: Optional[dict] = None
                           ) -> dict[str, float]:
    """Switch-aware per-stage work floor (congestion accounting).

    Base floor cost plus HALF the model's load (switch) cost whenever
    the stage's model differs from a parent's — cross-model edges are
    what churns residency under contention, and charging the full load
    per edge overcounts (chains re-use residencies across devices)
    while ignoring it lets model-alternating DAGs look 5× lighter than
    they run.  Used by the admission probes' congestion floors; the
    SLO deadline normalizer uses the path-based
    :func:`critical_path_lower_bound` instead.  Pass a precomputed
    ``floor`` (:func:`stage_floor_costs`) to avoid recomputation.
    """
    if floor is None:
        floor = stage_floor_costs(wf, cluster)
    out: dict[str, float] = {}
    for sid, st in wf.stages.items():
        c = floor[sid]
        if st.parents and any(wf.stages[p].model != st.model
                              for p in st.parents):
            prof = profiles.get(st.model)
            if prof is not None:
                c += 0.5 * prof.switch_cost
        out[sid] = c
    return out


def stage_tail_bounds(wf: Workflow, cluster,
                      floor: Optional[dict] = None) -> dict[str, float]:
    """Critical-path-to-sink lower bound per stage.

    ``tails[sid]`` = the stage's own floor cost plus the longest floor
    path through its descendants; the workflow cannot finish earlier
    than ``start(sid) + tails[sid]`` once ``sid`` is on the critical
    path.  State-free, so cacheable per workflow topology.  Pass a
    precomputed ``floor`` (:func:`stage_floor_costs`) to avoid
    recomputation.
    """
    if floor is None:
        floor = stage_floor_costs(wf, cluster)
    tails: dict[str, float] = {}
    for sid in reversed(wf.topo_order):
        ch = wf.stages[sid].children
        tails[sid] = floor[sid] + max((tails[c] for c in ch), default=0.0)
    return tails


def critical_path_lower_bound(wf: Workflow, cluster,
                              profiles: Optional[dict] = None,
                              tails: Optional[dict] = None) -> float:
    """Fastest plausible makespan of ``wf`` on an idle ``cluster``.

    Longest source-to-sink path of per-stage floor costs, plus — when
    model ``profiles`` are given — one weight-load (switch cost) per
    distinct model along that path: even an idle cluster must activate
    each model at least once before the chain can run on it.  Without
    the switch term the bound is wildly optimistic for
    model-alternating workflows (5× observed on the conflict suite),
    which would make every deadline normalized by it unreachable.
    This is the normalizer of every SLO deadline (:class:`SLOConfig`).
    Pass precomputed ``tails`` (:func:`stage_tail_bounds`) to avoid
    recomputation.
    """
    if tails is None:
        tails = stage_tail_bounds(wf, cluster)
    if not wf.stages:
        return 0.0
    cp = max(tails[s] for s in wf.sources())
    if not profiles:
        return cp
    # walk the arg-max path and charge each distinct model's load once
    sid = max(wf.sources(), key=lambda s: tails[s])
    models = {wf.stages[sid].model}
    while wf.stages[sid].children:
        sid = max(wf.stages[sid].children, key=lambda c: tails[c])
        models.add(wf.stages[sid].model)
    for m in models:
        prof = profiles.get(m)
        if prof is not None:
            cp += prof.switch_cost
    return cp


class AdmissionController:
    """Future-state-aware admission/deferral/preemption decisions.

    One controller instance serves one :meth:`ServingExecutor.run`
    call.  It owns the bounded backlog of deferred workflows and the
    list of rejected workflow ids; the executor owns the frontier and
    applies the decisions (admit into the shared frontier, clear the
    committed pool on ``preempt``).

    Probing: policies that expose a ``planner`` with ``plan_shared``
    (FATE) get the planned probe — a one-wave merged-frontier solve on
    a throwaway overlay, delta-rescored off the planner's cached wave
    snapshots, predicting both the candidate's completion latency and
    the busy-time displacement it inflicts on in-flight workflows.
    Other policies fall back to an analytic backlog/critical-path
    estimate, so admission control composes with every baseline.
    """

    def __init__(self, slo: SLOConfig,
                 corrector: Optional[ProbeCorrector] = None):
        self.slo = slo
        # online probe-margin correction: explicit corrector wins;
        # otherwise slo.online_margin builds one primed with the
        # hand-set margin (None = static probe_margin forever)
        if corrector is None and slo.online_margin:
            corrector = ProbeCorrector(prior=slo.probe_margin,
                                       alpha=slo.margin_alpha)
        self.corrector = corrector
        # (original arrival time, workflow), oldest first
        self.backlog: list[tuple[float, Workflow]] = []
        self.rejected: list[str] = []
        self.deadlines: dict[str, float] = {}
        # admission class per live workflow id (registered by the
        # scheduler before any decision touches the wid; absent =
        # "default").  Only consulted when slo.classes is non-empty.
        self.klass: dict[str, str] = {}
        # live view of the owning scheduler's ISSUED stage-key set
        # (bound via bind_issued) — the class-aware congestion floor
        # charges lower-class workflows only for their issued (sunk)
        # stages, and committed-but-unissued work is preemptible
        self._issued_view: Optional[Callable[[], set]] = None
        self.n_deferrals = 0
        self.n_probes = 0
        # admitted-but-unfinished probe predictions awaiting their
        # observed completion latency, and the completed-pair log
        self.pending: dict[str, tuple[float, float, str, float]] = {}
        self.probe_log: list[ProbeRecord] = []
        self._tails: dict[str, dict[str, float]] = {}
        self._floor: dict[str, dict[str, float]] = {}
        self._efloor: dict[str, dict[str, float]] = {}
        self._cp: dict[str, float] = {}
        self._family: dict[str, str] = {}
        # live-set generation the bound caches were computed under;
        # a fault-epoch bump (device down/up) invalidates them all
        self._fault_epoch = 0
        # O(in-flight)-scan memos, keyed on (frontier.version,
        # fault_epoch): the total outstanding floor work and the
        # in-flight (remaining-tail, deadline) slack pairs.  Both are
        # pure functions of the frontier contents + live set, so a
        # version/epoch match returns the cached value and probes stop
        # re-walking every in-flight DAG.  Derived caches — not part of
        # state_dict (a restored controller rebuilds them lazily).
        self._floor_work_memo: Optional[tuple] = None
        self._slack_memo: Optional[tuple] = None

    # -- cached critical-path bounds -------------------------------------
    def _sync_fault_epoch(self, state: ExecutionState) -> None:
        """Invalidate floor/tail/cp caches when the live set changed."""
        ep = getattr(state, "fault_epoch", 0)
        if ep != self._fault_epoch:
            self._fault_epoch = ep
            self._tails.clear()
            self._floor.clear()
            self._efloor.clear()
            self._cp.clear()

    def tail_bounds(self, wf: Workflow,
                    state: ExecutionState) -> dict[str, float]:
        """Memoized :func:`stage_tail_bounds` for ``wf`` (also fills
        the floor-cost and switch-aware critical-path caches).

        Bounds are conditioned on the LIVE device set: under partial
        outage the per-stage floors rise to the fastest surviving
        device, so admission tightens instead of over-committing
        against capacity that no longer exists.
        """
        self._sync_fault_epoch(state)
        t = self._tails.get(wf.wid)
        if t is None:
            live = set(state.live_ids()) if state.down else None
            floor = stage_floor_costs(wf, state.cluster, live=live)
            t = stage_tail_bounds(wf, state.cluster, floor=floor)
            self._tails[wf.wid] = t
            self._floor[wf.wid] = floor
            self._efloor[wf.wid] = stage_effective_floors(
                wf, state.cluster, state.profiles, floor=floor)
            self._cp[wf.wid] = critical_path_lower_bound(
                wf, state.cluster, state.profiles, tails=t)
        return t

    def cp_lower_bound(self, wf: Workflow,
                       state: ExecutionState) -> float:
        """Memoized :func:`critical_path_lower_bound` for ``wf``
        (switch-aware: includes one load per critical-path model)."""
        self.tail_bounds(wf, state)
        return self._cp[wf.wid]

    def forget(self, wid: str) -> None:
        """Release cached bounds for a finished workflow."""
        self._tails.pop(wid, None)
        self._floor.pop(wid, None)
        self._efloor.pop(wid, None)
        self._cp.pop(wid, None)
        self._family.pop(wid, None)
        self.deadlines.pop(wid, None)
        self.pending.pop(wid, None)
        self.klass.pop(wid, None)

    # -- admission classes -----------------------------------------------
    def bind_issued(self, view: Callable[[], set]) -> None:
        """Bind a zero-arg callable returning the owning scheduler's
        live issued stage-key set (class-aware floors read it; the
        single-class path never calls it)."""
        self._issued_view = view

    def note_class(self, wid: str, klass: str) -> None:
        """Register a workflow's admission class before its first
        decision (the scheduler calls this on every arrival)."""
        self.klass[wid] = klass

    def _klass_of(self, wid: str) -> str:
        return self.klass.get(wid, "default")

    def _eff_weight(self, klass: str, wait: float) -> float:
        """Aged class weight of a backlog entry: the configured weight
        plus ``aging_rate`` per second already waited — the
        anti-starvation promotion that bounds bottom-class wait at
        ``(w_max - w) / aging_rate`` seconds behind the heaviest
        class."""
        return (self.slo.class_weight(klass)
                + self.slo.aging_rate * max(wait, 0.0))

    # -- durability ------------------------------------------------------
    def state_dict(self) -> dict:
        """Plain-JSON capture of the controller's decision state: the
        backlog (by workflow id — the owning scheduler snapshot
        carries the workflow objects), rejections, SLO deadlines,
        counters, pending probe predictions, the probe log, and the
        online :class:`ProbeCorrector` EWMAs.  The derived bound
        caches (tails/floors/critical paths) are pure functions of
        workflow + live set and are NOT captured — a restored
        controller rebuilds them lazily, bit-identically."""
        return {
            "backlog": [[arr, wf.wid] for arr, wf in self.backlog],
            "rejected": list(self.rejected),
            "deadlines": dict(self.deadlines),
            "klass": dict(self.klass),
            "n_deferrals": self.n_deferrals,
            "n_probes": self.n_probes,
            "pending": {wid: list(v)
                        for wid, v in self.pending.items()},
            "probe_log": [dataclasses.asdict(r)
                          for r in self.probe_log],
            "corrector": (self.corrector.to_dict()
                          if self.corrector is not None else None),
        }

    def load_state(self, doc, workflows) -> None:
        """Restore the state captured by :meth:`state_dict`
        (``workflows`` maps backlog workflow ids back to their
        rehydrated objects)."""
        self.backlog = [(arr, workflows[wid])
                        for arr, wid in doc["backlog"]]
        self.rejected = list(doc["rejected"])
        self.deadlines = dict(doc["deadlines"])
        self.klass = dict(doc.get("klass") or {})
        self.n_deferrals = int(doc["n_deferrals"])
        self.n_probes = int(doc["n_probes"])
        self.pending = {wid: tuple(v)
                        for wid, v in doc["pending"].items()}
        self.probe_log = [ProbeRecord(**r)
                          for r in doc["probe_log"]]
        cor = doc.get("corrector")
        if cor is not None:
            self.corrector = ProbeCorrector.from_dict(cor)

    # -- probe-margin correction -----------------------------------------
    def probe_family(self, wf: Workflow,
                     state: ExecutionState) -> str:
        """Corrector key of a workflow: its model-family composition.

        The sorted set of model families its stages span (e.g.
        ``"qwen"`` for a single-family DAG, ``"llama+qwen"`` for an
        alternating one) — distinct compositions have systematically
        different probe residuals (a multi-family DAG churns residency,
        a single-family one queues behind warm devices), so folding
        them into one EWMA would let one workload's ratio poison the
        other's margin.  Memoized per workflow id.
        """
        fam = self._family.get(wf.wid)
        if fam is None:
            fams = set()
            for st in wf.stages.values():
                prof = state.profiles.get(st.model)
                fams.add(prof.family if prof is not None else "generic")
            fam = "+".join(sorted(fams)) or "generic"
            self._family[wf.wid] = fam
        return fam

    def probe_margin(self, wf: Workflow, state: ExecutionState) -> float:
        """Live multiplicative safety margin for one workflow's probe:
        the corrector's per-family EWMA estimate when online correction
        is active, else the hand-set ``SLOConfig.probe_margin``."""
        if self.corrector is None:
            return self.slo.probe_margin
        return self.corrector.margin(self.probe_family(wf, state))

    def _note_admit(self, wf: Workflow, state: ExecutionState,
                    dec: "AdmissionDecision") -> None:
        """Bookkeeping for a (re-)admission: deadline registration plus
        the pending predicted-latency record the completion observer
        will close out."""
        self.deadlines[wf.wid] = dec.deadline
        self.pending[wf.wid] = (state.now, dec.predicted_latency,
                                self.probe_family(wf, state), dec.margin)

    def record_completion(self, wid: str, finish_t: float) -> None:
        """Close the probe loop for one completed workflow: log the
        predicted-vs-observed pair and feed the corrector's EWMA (the
        serving executor calls this on every workflow completion)."""
        p = self.pending.pop(wid, None)
        if p is None:
            return
        decided_at, predicted, family, margin = p
        observed = max(0.0, finish_t - decided_at)
        self.probe_log.append(ProbeRecord(
            wid=wid, family=family, predicted=predicted, margin=margin,
            observed=observed, decided_at=decided_at,
            finished_at=finish_t))
        if self.corrector is not None:
            self.corrector.observe(family, predicted, observed)
        limit = self.slo.probe_log_limit
        if limit is not None and len(self.probe_log) > limit:
            del self.probe_log[: len(self.probe_log) - limit]

    def activation_work(self, wf: Workflow, state: ExecutionState,
                        done=frozenset()) -> float:
        """One-time model-activation work of a workflow's remaining
        stages: half a weight-load per DISTINCT model still to run.

        The per-stage effective floors charge switch cost only on
        cross-model edges, so a single-model DAG looks switch-free to
        the congestion accounting even though every admitted DAG must
        activate its models at least once somewhere — under a deep
        merged queue that blind spot made predicted latency FLAT in
        queue depth while observed latency climbed with it (the probe
        ratio drifted ~1.6→2.6 across one overloaded burst).  Half a
        load mirrors the effective-floor convention: chains reuse
        residencies across devices, so charging full loads overcounts.
        """
        models = {st.model for sid, st in wf.stages.items()
                  if sid not in done}
        out = 0.0
        for m in models:
            prof = state.profiles.get(m)
            if prof is not None:
                out += 0.5 * prof.switch_cost
        return out

    def remaining_floor_work(self, frontier,
                             state: ExecutionState) -> float:
        """Total effective-floor seconds of work still outstanding
        across every in-flight workflow (not-yet-completed stages,
        switch-aware per :func:`stage_effective_floors`, plus each
        DAG's one-time :meth:`activation_work`).

        Divided by the device count this is a work-conserving bound on
        how long the cluster needs to drain its current admissions —
        queued frontier work is invisible to per-device ``free_at``
        (stages occupy devices only once issued), so probes must
        account for it explicitly.

        Memoized on ``(frontier.version, fault_epoch)``: the sum only
        changes when a workflow is admitted/retired or a stage
        completes (all bump the frontier version) or the live set
        changes, so back-to-back probes between events reuse it
        instead of re-walking every in-flight DAG.
        """
        self._sync_fault_epoch(state)
        ver = getattr(frontier, "version", None)
        if ver is not None and self._floor_work_memo is not None:
            m_ver, m_ep, m_total = self._floor_work_memo
            if m_ver == ver and m_ep == self._fault_epoch:
                return m_total
        total = 0.0
        for wid, wf in frontier.workflows.items():
            self.tail_bounds(wf, state)
            floor = self._efloor[wid]
            done = frontier.completed[wid]
            total += sum(c for sid, c in floor.items()
                         if sid not in done)
            total += self.activation_work(wf, state, done)
        if ver is not None:
            self._floor_work_memo = (ver, self._fault_epoch, total)
        return total

    # -- probes ----------------------------------------------------------
    def probe(self, wf: Workflow, state: ExecutionState, frontier,
              policy, claimed: set) -> tuple[float, float]:
        """Predict ``(completion latency, displacement)`` of admitting
        ``wf`` now.

        Latency is seconds from ``state.now`` until the candidate's
        predicted completion; displacement is the mean extra busy time
        per device its first-wave placements would add (the marginal
        delay in-flight workflows absorb).  Dispatches to the planned
        probe when the policy exposes a shared-frontier planner.
        """
        self.n_probes += 1
        planner = getattr(policy, "planner", None)
        if planner is not None and hasattr(planner, "plan_shared"):
            return self._probe_planned(wf, state, frontier, planner,
                                       claimed)
        return self._probe_analytic(wf, state, frontier, claimed)

    def _probe_planned(self, wf: Workflow, state: ExecutionState,
                       frontier, planner,
                       claimed: set) -> tuple[float, float]:
        """One-wave lookahead through the real merged-frontier solver.

        Runs ``plan_shared`` with the candidate's sources appended to
        the current ready frontier, on a copy-on-write overlay
        (``max_waves=1``), so the probe reuses the planner's cached
        delta-rescoring state and costs one incremental wave — not a
        cold solve.  The candidate's predicted completion is the max
        over its sources of (estimated source finish on the overlay +
        that source's critical-path tail); sources the solver deferred
        start no earlier than the first device release.
        """
        from repro_torch.core.costs import CostModel
        from repro_torch.core.planner import _apply_estimate

        cluster = state.cluster
        sim = state.overlay()
        before = {d: sim.device_free(d) for d in cluster.ids()}
        workflows = dict(frontier.workflows)
        workflows[wf.wid] = wf
        ready = list(frontier.ready(claimed))
        ready += [(wf.wid, sid) for sid in wf.sources()]
        placements = planner.plan_shared(workflows, sim, ready,
                                         max_waves=1)
        # plan_shared simulates on its OWN internal overlay; replay the
        # wave's estimated effects onto this probe's overlay (same
        # estimator — including the planner's calibrated cost params —
        # same order) so the reads below see post-placement device
        # state rather than the pre-plan snapshot.
        cm = CostModel(sim, getattr(planner, "cost_params", None))
        for p in placements:
            _apply_estimate(workflows[p.wid], sim, p, cm)
        tails = self.tail_bounds(wf, state)
        floor = self._floor[wf.wid]
        placed: dict[str, float] = {}
        my_busy = 0.0
        # within one solver wave the assignment is injective per device
        # (at-most-one row per column), so a device in a candidate
        # placement carries ONLY that placement's delta — no other
        # workflow's busy time can be misattributed here.
        for p in placements:
            if p.wid != wf.wid:
                continue
            fin = max(sim.device_free(d) for d in p.devices)
            placed[p.sid] = fin
            my_busy += sum(max(0.0, sim.device_free(d) - before[d])
                           for d in p.devices)
        live = sim.live_ids() if sim.down else cluster.ids()
        release = min(sim.device_free(d) for d in live)
        completion = state.now
        for sid in wf.sources():
            if sid in placed:
                est = placed[sid] + (tails[sid] - floor[sid])
            else:           # solver deferred the source: it queues
                est = max(release, state.now) + tails[sid]
            completion = max(completion, est)
        n_dev = max(len(live), 1)
        predicted = max(completion - state.now,
                        self._congestion_floor(wf, state, frontier))
        displacement = my_busy / n_dev
        return predicted, displacement

    def _congestion_floor(self, wf: Workflow, state: ExecutionState,
                          frontier) -> float:
        """Queued-work completion floor for candidate ``wf``.

        Queued frontier work is not on any device's τ yet, so wave
        estimates and ``backlog_seconds`` are blind to it.  Two bounds
        bracket the truth under the merged exact solver, which is
        neither FIFO nor strictly fair: a fair-share bound (the
        candidate's own floor work served on its 1/k share of the
        cluster, k = in-flight DAGs + 1) and a work-conserving drain
        bound (everything outstanding plus the candidate, amortized
        over all devices, as if the candidate finished last).  Their
        mean keeps light workflows admissible under heavy mixed load
        while still charging heavy arrivals for the queue they join.
        Both bounds amortize over the LIVE device count, so admission
        tightens under partial outage.

        Multi-class runs dispatch to the class-aware variant: the
        fair-share bound weights the candidate's cluster share by its
        class weight, and the drain bound charges strictly-lower-class
        workflows only for their ISSUED (sunk) stages — their committed
        and queued future work is preemptible, so a platinum candidate
        does not wait behind it.
        """
        if self.slo.classes:
            return self._congestion_floor_classed(wf, state, frontier)
        n_dev = max(state.n_live, 1)
        self.tail_bounds(wf, state)
        own = (sum(self._efloor[wf.wid].values())
               + self.activation_work(wf, state))
        k = len(frontier.workflows) + 1
        fair = own * k / n_dev
        drain = (self.remaining_floor_work(frontier, state)
                 + own) / n_dev
        return 0.5 * (fair + drain)

    def _congestion_floor_classed(self, wf: Workflow,
                                  state: ExecutionState,
                                  frontier) -> float:
        """Class-aware congestion floor (``slo.classes`` non-empty).

        Weighted fair share: the candidate holds ``w_c / (W + w_c)`` of
        the cluster, ``W`` the total in-flight weight — with uniform
        weights this reduces exactly (same float operations) to the
        single-class ``own * k / n_dev``.  Drain bound: workflows of
        strictly lower weight contribute only the effective floors of
        their ISSUED stages (work already on devices is sunk; committed
        or queued work is preemptible by this candidate), while equal-
        or-higher classes contribute their full remaining work plus
        activation, exactly as the single-class accounting does.  Not
        memoized: the issued set changes without a frontier-version
        bump, so the ``(version, epoch)`` memo key cannot cover it.
        """
        n_dev = max(state.n_live, 1)
        self.tail_bounds(wf, state)
        own = (sum(self._efloor[wf.wid].values())
               + self.activation_work(wf, state))
        w_c = self.slo.class_weight(self._klass_of(wf.wid))
        issued = (self._issued_view()
                  if self._issued_view is not None else None)
        issued_by_wid: dict[str, list[str]] = {}
        if issued:
            for iw, sid in issued:
                issued_by_wid.setdefault(iw, []).append(sid)
        total = 0.0
        w_sum = 0.0
        for wid, wf2 in frontier.workflows.items():
            w2 = self.slo.class_weight(self._klass_of(wid))
            w_sum += w2
            self.tail_bounds(wf2, state)
            floor = self._efloor[wid]
            done = frontier.completed[wid]
            if w2 < w_c - 1e-12:
                # strictly lower class: only sunk (issued) work counts
                total += sum(floor[sid]
                             for sid in sorted(issued_by_wid.get(wid, ()))
                             if sid not in done)
                continue
            total += sum(c for sid, c in floor.items()
                         if sid not in done)
            total += self.activation_work(wf2, state, done)
        fair = own * (w_sum + w_c) / (w_c * n_dev)
        drain = (total + own) / n_dev
        return 0.5 * (fair + drain)

    def _probe_analytic(self, wf: Workflow, state: ExecutionState,
                        frontier, claimed: set) -> tuple[float, float]:
        """Planner-free fallback probe (baseline policies).

        Predicted latency = mean device backlog + critical-path lower
        bound inflated by frontier contention (ready stages per
        device); displacement = the candidate's total floor work
        amortized over the live cluster.
        """
        cluster = state.cluster
        n_dev = max(state.n_live, 1)
        avg_wait = state.backlog_seconds() / n_dev
        n_ready = len(frontier.ready(claimed)) + len(wf.sources())
        contention = max(1.0, n_ready / n_dev)
        cp = self.cp_lower_bound(wf, state)
        work = sum(self._floor[wf.wid].values())
        predicted = max(avg_wait + cp * contention,
                        self._congestion_floor(wf, state, frontier))
        return predicted, work / n_dev

    # -- batched probing -------------------------------------------------
    def probe_batch(self, wfs: Sequence[Workflow],
                    state: ExecutionState, frontier, policy,
                    claimed: set) -> dict[str, tuple[float, float]]:
        """Shared-overlay probe for one same-instant arrival batch.

        Simultaneous arrivals in one event batch see identical device
        state, so probing them one-by-one runs N one-wave lookahead
        solves that differ only in which candidate's sources joined the
        frontier.  This probes them through a SINGLE delta-rescored
        overlay wave with ALL candidates' sources appended, attributing
        per-candidate completion estimates and displacement from the
        one shared solution (within a wave each device carries at most
        one placement, so attribution is exact).

        Returns ``{wid: (raw_completion_latency, displacement)}`` —
        the completion estimate is NOT floored by the congestion floor;
        :meth:`decide` applies the floor at decision time, so a later
        candidate's floor sees earlier batch admissions exactly as
        sequential probing would.  Candidates the pre-probe
        short-circuits of :meth:`decide` would never probe (admission
        off, or critical path already past the deadline) are omitted.
        """
        out: dict[str, tuple[float, float]] = {}
        if not self.slo.admission:
            return out
        cands: list[Workflow] = []
        for wf in wfs:
            cp = self.cp_lower_bound(wf, state)
            deadline = self.slo.deadline(state.now, cp,
                                         self._klass_of(wf.wid))
            if cp > deadline - state.now + 1e-12:
                continue                      # decide() rejects unprobed
            cands.append(wf)
        if not cands:
            return out
        self.n_probes += len(cands)
        planner = getattr(policy, "planner", None)
        if planner is not None and hasattr(planner, "plan_shared"):
            return self._probe_planned_batch(cands, state, frontier,
                                             planner, claimed)
        for wf in cands:                      # analytic probe is cheap:
            cluster_est = self._probe_analytic_raw(wf, state, frontier,
                                                   claimed)
            out[wf.wid] = cluster_est
        return out

    def _probe_analytic_raw(self, wf: Workflow, state: ExecutionState,
                            frontier,
                            claimed: set) -> tuple[float, float]:
        """:meth:`_probe_analytic` without the congestion floor —
        the batched path applies the floor in :meth:`decide`."""
        n_dev = max(state.n_live, 1)
        avg_wait = state.backlog_seconds() / n_dev
        n_ready = len(frontier.ready(claimed)) + len(wf.sources())
        contention = max(1.0, n_ready / n_dev)
        cp = self.cp_lower_bound(wf, state)
        work = sum(self._floor[wf.wid].values())
        return avg_wait + cp * contention, work / n_dev

    def _probe_planned_batch(self, wfs: Sequence[Workflow],
                             state: ExecutionState, frontier, planner,
                             claimed: set
                             ) -> dict[str, tuple[float, float]]:
        """One shared one-wave lookahead covering every candidate.

        Mirrors :meth:`_probe_planned` (same overlay protocol, same
        estimator replay, same per-source completion formula) but with
        all candidates' sources in one merged ready set, so the batch
        costs one incremental wave instead of N.
        """
        from repro_torch.core.costs import CostModel
        from repro_torch.core.planner import _apply_estimate

        cluster = state.cluster
        sim = state.overlay()
        before = {d: sim.device_free(d) for d in cluster.ids()}
        workflows = dict(frontier.workflows)
        ready = list(frontier.ready(claimed))
        for wf in wfs:
            workflows[wf.wid] = wf
            ready += [(wf.wid, sid) for sid in wf.sources()]
        placements = planner.plan_shared(workflows, sim, ready,
                                         max_waves=1)
        cm = CostModel(sim, getattr(planner, "cost_params", None))
        for p in placements:
            _apply_estimate(workflows[p.wid], sim, p, cm)
        cand_ids = {wf.wid for wf in wfs}
        placed: dict[tuple[str, str], float] = {}
        busy: dict[str, float] = {}
        for p in placements:
            if p.wid not in cand_ids:
                continue
            fin = max(sim.device_free(d) for d in p.devices)
            placed[(p.wid, p.sid)] = fin
            busy[p.wid] = busy.get(p.wid, 0.0) + sum(
                max(0.0, sim.device_free(d) - before[d])
                for d in p.devices)
        live = sim.live_ids() if sim.down else cluster.ids()
        release = min(sim.device_free(d) for d in live)
        n_dev = max(len(live), 1)
        out: dict[str, tuple[float, float]] = {}
        for wf in wfs:
            tails = self.tail_bounds(wf, state)
            floor = self._floor[wf.wid]
            completion = state.now
            for sid in wf.sources():
                fin = placed.get((wf.wid, sid))
                if fin is not None:
                    est = fin + (tails[sid] - floor[sid])
                else:
                    est = max(release, state.now) + tails[sid]
                completion = max(completion, est)
            out[wf.wid] = (completion - state.now,
                           busy.get(wf.wid, 0.0) / n_dev)
        return out

    # -- decisions -------------------------------------------------------
    def decide(self, wf: Workflow, state: ExecutionState, frontier,
               policy, claimed: set, arrival: float,
               probe: Optional[tuple[float, float]] = None
               ) -> AdmissionDecision:
        """Pure decision (no backlog bookkeeping): admit / defer /
        reject ``wf`` given its original ``arrival`` time.

        The SLO comparison inflates the raw probe prediction by
        :meth:`probe_margin` — the hand-set constant, or the
        corrector's live per-family estimate when online correction is
        active — so deferral re-probes automatically track the
        corrected margin too.

        ``probe``, when given, is a precomputed RAW (unfloored)
        ``(completion_latency, displacement)`` pair from
        :meth:`probe_batch`; the congestion floor is applied here, at
        decision time, so batch-mates admitted earlier in the same
        event batch raise this candidate's floor exactly as sequential
        probing would.
        """
        klass = self._klass_of(wf.wid)
        cp = self.cp_lower_bound(wf, state)
        deadline = self.slo.deadline(arrival, cp, klass)
        if not self.slo.admission:
            return AdmissionDecision("admit", cp, deadline, cp)
        budget = deadline - state.now
        if cp > budget + 1e-12:
            # unreachable even alone on an idle cluster: shed the load
            return AdmissionDecision("reject", cp, deadline, cp)
        if probe is not None:
            est, displacement = probe
            predicted = max(est,
                            self._congestion_floor(wf, state, frontier))
        else:
            predicted, displacement = self.probe(wf, state, frontier,
                                                 policy, claimed)
        margin = self.probe_margin(wf, state)
        fits = margin * predicted <= budget + 1e-12
        if fits and not self._displaces_inflight(state, frontier,
                                                 displacement, klass):
            preempt = (self.slo.preemption
                       and predicted * self.slo.preempt_slack > budget)
            return AdmissionDecision("admit", predicted, deadline, cp,
                                     preempt=preempt, margin=margin)
        return AdmissionDecision("defer", predicted, deadline, cp,
                                 margin=margin)

    def _displaces_inflight(self, state: ExecutionState, frontier,
                            displacement: float,
                            klass: str = "default") -> bool:
        """True if the candidate's displacement would push an
        otherwise-on-track in-flight workflow past its deadline.

        Workflows already predicted to miss are NOT protected — under
        overload everything is late, and refusing all admissions for
        the sake of already-lost deadlines would idle the cluster.
        In multi-class runs, STRICTLY-LOWER-weight workflows are not
        protected either: a platinum candidate may displace batch
        deadlines (the batch tier's protection is its completion
        guarantee plus aging, not deadline isolation).
        """
        if displacement <= 0.0:
            return False
        w_c = (self.slo.class_weight(klass)
               if self.slo.classes else None)
        for rem, deadline, wid in self._inflight_slack(state, frontier):
            if (w_c is not None
                    and self.slo.class_weight(self._klass_of(wid))
                    < w_c - 1e-12):
                continue
            without = state.now + rem
            if without <= deadline + 1e-12 < without + displacement:
                return True
        return False

    def _inflight_slack(self, state: ExecutionState,
                        frontier) -> list[tuple[float, float, str]]:
        """Memoized ``(remaining-tail, deadline, wid)`` triples for
        every in-flight workflow with a registered deadline.

        Keyed on ``(frontier.version, fault_epoch)`` like
        :meth:`remaining_floor_work`: the remaining tails only change
        when stages complete (version bump) or the live set changes.
        Deadlines registered for workflows not yet admitted into the
        frontier are excluded by construction (matching the unmemoized
        scan, which skipped wids absent from ``frontier.workflows``),
        so mid-sweep ``_note_admit`` calls cannot stale the memo.
        """
        self._sync_fault_epoch(state)
        ver = getattr(frontier, "version", None)
        if ver is not None and self._slack_memo is not None:
            m_ver, m_ep, m_pairs = self._slack_memo
            if m_ver == ver and m_ep == self._fault_epoch:
                return m_pairs
        pairs: list[tuple[float, float, str]] = []
        for wid, deadline in self.deadlines.items():
            wf = frontier.workflows.get(wid)
            if wf is None:
                continue
            tails = self.tail_bounds(wf, state)
            done = frontier.completed[wid]
            rem = max((tails[sid] for sid in wf.topo_order
                       if sid not in done), default=0.0)
            pairs.append((rem, deadline, wid))
        if ver is not None:
            self._slack_memo = (ver, self._fault_epoch, pairs)
        return pairs

    def _shed(self, wid: str, policy) -> None:
        """Record a rejection and release every cache that references
        the shed workflow — including the policy's planner/scorer
        caches, which the admission probes populated (a rejected
        workflow never runs, so without this a long-lived serving
        executor leaks one score table + topology cache per shed
        arrival)."""
        self.rejected.append(wid)
        self.forget(wid)
        if hasattr(policy, "forget_workflow"):
            policy.forget_workflow(wid)

    def _backlog_full(self, klass: str) -> bool:
        """Whether a deferral of class ``klass`` would overflow its
        queue: the class's own ``backlog_limit`` counted against its
        own entries when one is configured, else the shared global
        limit against the whole backlog."""
        spec = self.slo.class_spec(klass)
        if spec is not None and spec.backlog_limit is not None:
            n = sum(1 for _arr, w in self.backlog
                    if self._klass_of(w.wid) == klass)
            return n >= spec.backlog_limit
        return len(self.backlog) >= self.slo.backlog_limit

    def on_arrival(self, wf: Workflow, state: ExecutionState, frontier,
                   policy, claimed: set,
                   probe: Optional[tuple[float, float]] = None,
                   dec: Optional[AdmissionDecision] = None
                   ) -> AdmissionDecision:
        """Arrival-time decision with backlog bookkeeping applied:
        deferrals land in the bounded backlog (or degrade to reject
        when it is full); rejects are recorded.  ``probe`` forwards a
        precomputed raw estimate from :meth:`probe_batch`; ``dec``
        forwards a decision the caller already computed (the
        scheduler's running-shard preemption path re-decides after
        reclaiming devices and hands the final decision in)."""
        if dec is None:
            dec = self.decide(wf, state, frontier, policy, claimed,
                              arrival=state.now, probe=probe)
        if dec.action == "defer":
            if self._backlog_full(self._klass_of(wf.wid)):
                dec.action = "reject"
            else:
                self.backlog.append((state.now, wf))
                self.n_deferrals += 1
        if dec.action == "reject":
            self._shed(wf.wid, policy)
        elif dec.action == "admit":
            self._note_admit(wf, state, dec)
        return dec

    def readmit(self, state: ExecutionState, frontier, policy,
                claimed: set, force: bool = False
                ) -> list[tuple[float, Workflow, AdmissionDecision]]:
        """Re-admission sweep over the backlog.

        Single-class: oldest-feasible-first, exactly the historical
        order.  Multi-class (``slo.classes`` non-empty): CLASS-MAJOR —
        entries are probed by descending effective weight
        (``weight + aging_rate * wait``), ties by age (the stable sort
        preserves the backlog's arrival order), so a deferred platinum
        entry is re-probed before older batch entries while aging
        still promotes long-waiting batch work past fresh platinum.

        Entries whose deadline became unreachable are shed (rejected);
        the first entry whose fresh probe admits is returned (at most
        one per call, so the caller's frontier update is visible to the
        next sweep).  With ``force=True`` the oldest reachable entry
        (in sweep order) is admitted regardless of its probe — the
        executor uses this to drain the backlog when no further
        completion events exist.
        Returns ``[(original_arrival, workflow, decision)]``.
        """
        entries = self.backlog
        if self.slo.classes:
            entries = sorted(
                entries,
                key=lambda e: -self._eff_weight(
                    self._klass_of(e[1].wid), state.now - e[0]))
        admitted: list[tuple[float, Workflow, AdmissionDecision]] = []
        keep: list[tuple[float, Workflow]] = []
        for arrival, wf in entries:
            if admitted:
                keep.append((arrival, wf))
                continue
            cp = self.cp_lower_bound(wf, state)
            deadline = self.slo.deadline(arrival, cp,
                                         self._klass_of(wf.wid))
            if state.now + cp > deadline + 1e-12:
                self._shed(wf.wid, policy)         # expired
                continue
            if not force and self.slo.admission:
                # the probe's prediction is floored at the congestion
                # floor, so when margin·floor already exceeds the
                # budget the decision is defer regardless of what the
                # solver lookahead would say — skip the probe (FP-safe:
                # predicted = max(est, floor) ≥ floor exactly, and
                # x ↦ fl(m·x) is monotone for m > 0, so
                # m·floor > budget + ε implies m·predicted > budget + ε
                # and decide() could only defer)
                floor = self._congestion_floor(wf, state, frontier)
                margin = self.probe_margin(wf, state)
                if margin * floor > (deadline - state.now) + 1e-12:
                    keep.append((arrival, wf))
                    continue
            dec = self.decide(wf, state, frontier, policy, claimed,
                              arrival=arrival)
            if dec.action == "admit" or force:
                dec.action = "admit"
                self._note_admit(wf, state, dec)
                admitted.append((arrival, wf, dec))
            else:
                keep.append((arrival, wf))
        self.backlog = keep
        return admitted
