"""Unified event-driven scheduler core: typed config, explicit
lifecycle, and a first-class event stream.

This module is the single runtime behind both execution settings:

* :class:`Scheduler` — the event core.  Workflows are ``submit()``-ed
  (immediately or at a future arrival time), the clock advances one
  event batch per ``step()`` (or ``run_until(t)`` / ``drain()``), and
  every control-plane and data-plane transition is emitted as a typed,
  replayable event (:class:`ArrivalEvent` → :class:`AdmittedEvent` /
  :class:`DeferredEvent` / :class:`RejectedEvent`,
  :class:`PlacementEvent` → :class:`IssueEvent` →
  :class:`CompletionEvent`, plus :class:`PreemptionEvent`) consumable
  via iteration (:meth:`Scheduler.stream`) or
  :meth:`Scheduler.on` subscriptions.
* :class:`SchedulerConfig` — one frozen, JSON-round-trippable object
  collapsing every knob that used to be threaded per-call through the
  executors and ``workflowbench.runner`` (score params, SLO config,
  cost params, an embedded calibration profile, planner switches).
  ``SchedulerConfig.from_json(cfg.to_json()) == cfg``, so any run is
  reproducible from a single artifact (CI archives the config used
  for the gated benchmark runs).

The commit-and-advance mechanics (paper Algorithm 2) are unchanged:
policies commit :class:`~repro_torch.core.planner.Placement`s into a pool,
the core issues dependency-ready actions as devices free, updates
(ρ, κ, ℓ, τ) on completion, and replans when the pool cannot cover
the ready frontier.  :class:`~repro_torch.core.executor.WorkflowExecutor`
and :class:`~repro_torch.core.executor.ServingExecutor` are now thin
adapters over this loop; the ``batch`` flag reproduces the
single-workflow batch runtime's exact semantics (per-workflow
``plan()`` dispatch, unconditional greedy fallback, persistent commit
pool, one completion per clock advance) so placements stay
bit-identical to the historical executors in both settings.

Per-query completion times are tracked through shard partitions so
P95 query latency is measurable (queries in different shards of the
sink stage finish at different times).
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
import json
from pathlib import Path
from typing import Callable, Iterator, Mapping, Optional, Sequence

from repro_torch.core.admission import AdmissionController, SLOConfig
from repro_torch.core.calibration import CalibrationProfile
from repro_torch.core.costs import CostModel, CostParams
from repro_torch.core.devices import Cluster, Device
from repro_torch.core.faults import DeviceHealth, FaultInjector, FaultPlan
from repro_torch.core.journal import EventJournal, JournalError
from repro_torch.core.planner import Placement
from repro_torch.core.routing import RoutingConfig, StageRouter
from repro_torch.core.scoring import ScoreParams
from repro_torch.core.state import ExecutionState
from repro_torch.core.workflow import Stage, StageKey, Workflow

#: Schema version of :meth:`SchedulerConfig.to_json` documents.
CONFIG_VERSION = 1

#: Schema version of :meth:`SchedulerEvent.to_dict` documents.
EVENT_SCHEMA_VERSION = 1

#: Schema version of :meth:`Scheduler.snapshot` documents.
SNAPSHOT_VERSION = 1

#: Keep queued workflow arrivals on their own heap (``submit`` pushes
#: there) so the in-flight event heap — which ``_kill_run`` and the
#: invariant audit scan linearly — stays proportional to running work
#: even with 100k future arrivals enqueued.  Entries share the
#: ``(t, prio, seq)`` prefix, so popping the smaller head of the two
#: heaps reproduces the exact single-heap order (bit-identical event
#: streams; ``tests/test_arrival_queue.py`` flips this off to assert
#: it).
_SPLIT_ARRIVALS = True


class RecoveryError(RuntimeError):
    """Deterministic replay diverged from the journal: the regenerated
    event stream does not match what the pre-crash scheduler logged
    (or the journal tail extends past the restored run's quiescence).
    Either the snapshot/journal pair is mismatched or determinism was
    broken — the restored state cannot be trusted."""


def nearest_rank_p95(xs: Sequence[float],
                     default: float = float("nan")) -> float:
    """Nearest-rank 95th percentile of ``xs`` (``default`` if empty).

    The single percentile convention shared by batch results, serving
    stats, and the benchmark metrics — keep them in sync by calling
    this, not by re-deriving the index.
    """
    s = sorted(xs)
    if not s:
        return default
    idx = max(0, min(len(s) - 1, int(round(0.95 * (len(s) - 1)))))
    return s[idx]


def fresh_state(cluster, profiles=None) -> ExecutionState:
    """Empty execution state over ``cluster`` (cold devices, t=0),
    with the paper's default model profiles unless overridden."""
    from repro_torch.core.workflow import DEFAULT_PROFILES
    return ExecutionState(cluster=cluster,
                          profiles=dict(profiles or DEFAULT_PROFILES))


# ---------------------------------------------------------------------------
# typed configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Complete, serializable configuration of one scheduler run.

    Collapses the knobs that used to be scattered across
    ``make_policy(**policy_kwargs)``, the two executor constructors,
    and the ``run_one``/``run_suite``/``run_serving`` signatures into
    one frozen object:

    * ``policy`` — registered policy name
      (:data:`repro_torch.core.policies.POLICY_REGISTRY`);
    * ``policy_kwargs`` — extra constructor overrides for the policy
      (kept for back-compat and for policy-specific knobs like Halo's
      ``beam_width``; entries override the typed fields below);
    * ``score`` — :class:`~repro_torch.core.scoring.ScoreParams` (λ weights,
      horizon, margin);
    * ``cost`` — :class:`~repro_torch.core.costs.CostParams` global scales
      (``None`` = hand-set defaults);
    * ``slo`` — :class:`~repro_torch.core.admission.SLOConfig`; ``None``
      disables the admission/deferral/preemption control plane;
    * ``calibration`` — an embedded
      :class:`~repro_torch.core.calibration.CalibrationProfile`; when set,
      the execution state's model profiles AND the effective cost
      params are lowered from it (single source of truth), exactly as
      the runner's ``calibration=`` argument did;
    * ``time_limit`` / ``use_matrix`` / ``use_delta`` / ``warm_start``
      / ``max_waves`` — planner switches (see
      :class:`~repro_torch.core.planner.FrontierPlanner`);
    * ``replan_on_completion`` — revoke unissued commitments on every
      completion batch (the serving replan trigger);
    * ``faults`` — a :class:`~repro_torch.core.faults.FaultPlan` driving
      deterministic fault injection (device crashes, transient shard
      failures, slowdown/straggler episodes) plus the retry /
      quarantine / speculation recovery knobs; ``None`` (default)
      disables the fault machinery entirely and an EMPTY plan arms it
      without injecting anything — both are bit-identical to the
      fault-free scheduler (serving mode only; ignored by ``batch``);
    * ``event_buffer`` — ring-buffer cap on the retained event stream
      (``None`` = unbounded); long-running serving deployments set a
      cap so :attr:`Scheduler.events` cannot grow without bound;
    * ``pools`` — hierarchical sharded frontier solve: partition the
      merged ready frontier into this many residency-aware device
      pools and solve each pool exactly, combining the disjoint
      per-pool solutions (``1`` = the monolithic solve; the string
      ``"auto"`` derives the count per wave from device count and
      frontier width — see
      :class:`~repro_torch.core.planner.FrontierPlanner`);
    * ``batch_probes`` — admission probes of simultaneous arrivals in
      one event batch share a single delta-rescored lookahead wave
      (see :meth:`~repro_torch.core.admission.AdmissionController
      .probe_batch`) instead of running one solve per arrival;
    * ``routing`` — a :class:`~repro_torch.core.routing.RoutingConfig`
      enabling cost/quality model-family routing: stages declaring
      ``candidates`` may be served by an alternate family that clears
      the quality floor (``None``, the default, is bit-identical to
      the unrouted planner);
    * ``gateway`` — plain-dict knobs for the HTTP serving gateway
      (``serving/gateway.py``: ``replicas``, ``host``, ``port``);
      inert to the scheduler core itself, carried here so one JSON
      artifact reproduces a served deployment.

    ``to_json``/``from_json`` round-trip the whole object — including
    the embedded calibration profile — so a benchmark gate can be
    reproduced from a single JSON artifact
    (``benchmarks/sched_bench.py --config``).
    """

    policy: str = "FATE"
    policy_kwargs: Mapping = dataclasses.field(default_factory=dict)
    score: ScoreParams = ScoreParams()
    cost: Optional[CostParams] = None
    slo: Optional[SLOConfig] = None
    calibration: Optional[CalibrationProfile] = None
    time_limit: float = 5.0
    use_matrix: bool = True
    use_delta: bool = True
    warm_start: bool = True
    max_waves: Optional[int] = None
    replan_on_completion: bool = True
    faults: Optional[FaultPlan] = None
    event_buffer: Optional[int] = None
    pools: "int | str" = 1
    batch_probes: bool = False
    routing: Optional[RoutingConfig] = None
    gateway: Optional[Mapping] = None

    # -- lowering --------------------------------------------------------
    def effective_cost_params(self) -> Optional[CostParams]:
        """The :class:`CostParams` every consumer should price with:
        ``cost`` with the calibration profile's fitted scales applied
        over it when a profile is embedded, else ``cost`` verbatim."""
        if self.calibration is None:
            return self.cost
        return self.calibration.cost_params(self.cost)

    def model_profiles(self) -> Optional[dict]:
        """Per-model profile dict for ``fresh_state`` (``None`` keeps
        the hand-set defaults) — the calibration profile's fitted
        constants when one is embedded."""
        if self.calibration is None:
            return None
        return self.calibration.model_profiles()

    def build_policy(self):
        """Instantiate the configured policy from the registry.

        Dispatches through the policy class's ``from_config`` hook
        (see :class:`~repro_torch.core.policies.BasePolicy`), passing the
        calibration-lowered cost params; unknown names raise the
        registry's listing ``KeyError``.
        """
        from repro_torch.core.policies import POLICY_REGISTRY, make_policy
        if self.policy not in POLICY_REGISTRY:
            make_policy(self.policy)        # raises the listing KeyError
        cls = POLICY_REGISTRY[self.policy]
        if hasattr(cls, "from_config"):
            return cls.from_config(self,
                                   cost_params=self.effective_cost_params())
        return cls(**dict(self.policy_kwargs))

    # -- serialization ---------------------------------------------------
    def to_json(self) -> str:
        """Serialize to a versioned JSON document (exact inverse of
        :meth:`from_json`, including the embedded calibration
        profile)."""
        doc = {
            "config_version": CONFIG_VERSION,
            "policy": self.policy,
            "policy_kwargs": dict(self.policy_kwargs),
            "score": dataclasses.asdict(self.score),
            "cost": (dataclasses.asdict(self.cost)
                     if self.cost is not None else None),
            "slo": (dataclasses.asdict(self.slo)
                    if self.slo is not None else None),
            "calibration": (json.loads(self.calibration.to_json())
                            if self.calibration is not None else None),
            "time_limit": self.time_limit,
            "use_matrix": self.use_matrix,
            "use_delta": self.use_delta,
            "warm_start": self.warm_start,
            "max_waves": self.max_waves,
            "replan_on_completion": self.replan_on_completion,
            "faults": (self.faults.to_dict()
                       if self.faults is not None else None),
            "event_buffer": self.event_buffer,
            "pools": self.pools,
            "batch_probes": self.batch_probes,
            "routing": (self.routing.to_dict()
                        if self.routing is not None else None),
            "gateway": (dict(self.gateway)
                        if self.gateway is not None else None),
        }
        return json.dumps(doc, indent=2, sort_keys=True) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "SchedulerConfig":
        """Rebuild a config from :meth:`to_json` output; rejects
        unknown schema versions."""
        doc = json.loads(text)
        version = int(doc.get("config_version", -1))
        if version != CONFIG_VERSION:
            raise ValueError(
                f"unsupported SchedulerConfig version {version} "
                f"(expected {CONFIG_VERSION})")
        cal = doc.get("calibration")
        pools = doc.get("pools", 1)
        if pools != "auto":
            pools = int(pools)
        return cls(
            policy=doc.get("policy", "FATE"),
            policy_kwargs=dict(doc.get("policy_kwargs") or {}),
            score=ScoreParams(**(doc.get("score") or {})),
            cost=(CostParams(**doc["cost"])
                  if doc.get("cost") is not None else None),
            slo=(SLOConfig(**doc["slo"])
                 if doc.get("slo") is not None else None),
            calibration=(CalibrationProfile.from_json(json.dumps(cal))
                         if cal is not None else None),
            time_limit=float(doc.get("time_limit", 5.0)),
            use_matrix=bool(doc.get("use_matrix", True)),
            use_delta=bool(doc.get("use_delta", True)),
            warm_start=bool(doc.get("warm_start", True)),
            max_waves=doc.get("max_waves"),
            replan_on_completion=bool(
                doc.get("replan_on_completion", True)),
            faults=(FaultPlan.from_dict(doc["faults"])
                    if doc.get("faults") is not None else None),
            event_buffer=doc.get("event_buffer"),
            pools=pools,
            batch_probes=bool(doc.get("batch_probes", False)),
            # pre-gateway documents have neither key: legacy configs
            # load with routing/gateway disabled, unchanged otherwise
            routing=(RoutingConfig.from_dict(doc["routing"])
                     if doc.get("routing") is not None else None),
            gateway=(dict(doc["gateway"])
                     if doc.get("gateway") is not None else None),
        )

    def save(self, path) -> Path:
        """Write :meth:`to_json` to ``path``; returns the path."""
        path = Path(path)
        path.write_text(self.to_json())
        return path

    @classmethod
    def load(cls, path) -> "SchedulerConfig":
        """Read a config previously written by :meth:`save`."""
        return cls.from_json(Path(path).read_text())


# ---------------------------------------------------------------------------
# event taxonomy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SchedulerEvent:
    """Base of every record on the scheduler's replayable event
    stream; ``t`` is the simulation time the event occurred at.

    Every concrete subclass is registered in :data:`EVENT_REGISTRY`
    and round-trips through :meth:`to_dict`/:meth:`from_dict` — the
    serialization contract the write-ahead
    :class:`~repro_torch.core.journal.EventJournal` depends on.
    """
    t: float

    def to_dict(self) -> dict:
        """Versioned plain-JSON document: the event's class name under
        ``"type"``, :data:`EVENT_SCHEMA_VERSION` under
        ``"event_version"``, and every dataclass field (tuples become
        lists).  Exact inverse of :meth:`from_dict`."""
        doc = {"event_version": EVENT_SCHEMA_VERSION,
               "type": type(self).__name__}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            doc[f.name] = list(v) if isinstance(v, tuple) else v
        return doc

    @staticmethod
    def from_dict(doc: Mapping) -> "SchedulerEvent":
        """Rebuild the concrete event from a :meth:`to_dict` document.

        Raises ``ValueError`` on an unknown ``"type"`` (not in
        :data:`EVENT_REGISTRY`) or a schema version other than
        :data:`EVENT_SCHEMA_VERSION` — a journal written by a future
        schema must be rejected, not half-parsed.  Unknown extra keys
        (e.g. the journal's ``"i"`` index tag) are ignored; list
        values are coerced back to the tuples the dataclasses carry.
        """
        version = int(doc.get("event_version", -1))
        if version != EVENT_SCHEMA_VERSION:
            raise ValueError(
                f"unsupported event schema version {version} "
                f"(expected {EVENT_SCHEMA_VERSION})")
        name = doc.get("type")
        cls = EVENT_REGISTRY.get(name)
        if cls is None:
            raise ValueError(
                f"unknown event type {name!r} "
                f"(registered: {sorted(EVENT_REGISTRY)})")
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name in doc:
                v = doc[f.name]
                kwargs[f.name] = tuple(v) if isinstance(v, list) else v
        return cls(**kwargs)


@dataclasses.dataclass(frozen=True)
class ArrivalEvent(SchedulerEvent):
    """A submitted workflow's arrival time was reached (emitted
    before any admission decision)."""
    wid: str


@dataclasses.dataclass(frozen=True)
class AdmittedEvent(SchedulerEvent):
    """A workflow entered the shared frontier.  ``arrival`` is the
    ORIGINAL submission arrival (earlier than ``t`` for workflows that
    waited in the admission backlog); ``deadline`` is absolute sim
    time or ``None`` without an SLO."""
    wid: str
    arrival: float
    deadline: Optional[float] = None
    klass: str = "default"


@dataclasses.dataclass(frozen=True)
class DeferredEvent(SchedulerEvent):
    """The admission probe predicted an SLO miss: the arrival was
    parked in the bounded backlog for later re-admission."""
    wid: str
    predicted_latency: float
    deadline: float


@dataclasses.dataclass(frozen=True)
class RejectedEvent(SchedulerEvent):
    """The workflow was shed and will never execute (``reason`` is
    ``"admission"`` for arrival-time rejections, ``"expired"`` for
    backlog entries whose deadline became unreachable)."""
    wid: str
    reason: str = "admission"


@dataclasses.dataclass(frozen=True)
class PlacementEvent(SchedulerEvent):
    """The policy committed a placement into the action pool (not yet
    running — a later replan or preemption may still revoke it)."""
    wid: str
    sid: str
    devices: tuple
    shard_sizes: tuple


@dataclasses.dataclass(frozen=True)
class IssueEvent(SchedulerEvent):
    """A committed placement started executing: device state (ρ, κ, τ)
    was mutated and the stage now finishes at ``finish``."""
    wid: str
    sid: str
    devices: tuple
    start: float
    finish: float


@dataclasses.dataclass(frozen=True)
class PreemptionEvent(SchedulerEvent):
    """An SLO-tight admission revoked the committed-but-unissued pool
    (``n_revoked`` placements return to the next merged solve)."""
    trigger_wid: str
    n_revoked: int


@dataclasses.dataclass(frozen=True)
class ShardPreemptionEvent(SchedulerEvent):
    """An ISSUED-and-running stage attempt was killed to reclaim its
    devices for a higher-class admission (kill/replay semantics).

    The attempt's run token was revoked — its pending finish/fail/
    timeout heap events (including speculative copies, which share the
    token) are now stale — its exclusively-held devices were freed at
    the preemption instant, its warm-prefix state was forfeited
    (partial τ/κ credit-back through the dirty-device protocol; the
    residency ρ it loaded is real and stays), and the stage returns to
    the ready frontier after a short holdoff so the trigger's replan
    claims the freed devices first.  ``devices`` is the killed
    attempt's primary placement; ``klass``/``trigger_klass`` are the
    victim's and the trigger's admission classes."""
    wid: str
    sid: str
    devices: tuple
    trigger_wid: str
    klass: str = "default"
    trigger_klass: str = "default"


@dataclasses.dataclass(frozen=True)
class CompletionEvent(SchedulerEvent):
    """A stage finished; ``workflow_done`` marks its workflow's last
    stage (the workflow retired from the frontier)."""
    wid: str
    sid: str
    workflow_done: bool = False


@dataclasses.dataclass(frozen=True)
class DeviceDownEvent(SchedulerEvent):
    """A device left the live set (``reason``: ``"crash"`` fail-stop —
    its residency/prefix/queue state was wiped — or ``"quarantine"``
    after repeated transient failures, state kept warm).
    ``recover_at`` is the scheduled rejoin time when known;
    ``n_revoked`` counts committed-but-unissued placements on the
    device that were revoked back into the merged solve."""
    device: int
    reason: str = "crash"
    recover_at: Optional[float] = None
    n_revoked: int = 0


@dataclasses.dataclass(frozen=True)
class DeviceRecoveredEvent(SchedulerEvent):
    """A downed device rejoined the live set (cold after a crash,
    warm after a quarantine)."""
    device: int


@dataclasses.dataclass(frozen=True)
class ShardFailedEvent(SchedulerEvent):
    """An issued stage execution failed before completing (``reason``:
    ``"transient"`` injected shard failure, or ``"device_down"`` when
    a device crashed mid-run).  ``attempt`` is the 0-based attempt
    index that failed; the stage re-enters the frontier after
    backoff."""
    wid: str
    sid: str
    devices: tuple
    reason: str = "transient"
    attempt: int = 0


@dataclasses.dataclass(frozen=True)
class RetryEvent(SchedulerEvent):
    """A failed stage's backoff expired: attempt ``attempt`` is now
    eligible for replanning (``backoff`` seconds after the failure)."""
    wid: str
    sid: str
    attempt: int
    backoff: float


@dataclasses.dataclass(frozen=True)
class DegradedEvent(SchedulerEvent):
    """Graceful-degradation marker.  ``kind="straggler"``: an issued
    stage blew past its timeout and (when enabled) a speculative copy
    was re-issued on the best alternate device; ``kind="gave_up"``: a
    stage exhausted its retry budget and its workflow was failed out
    of the frontier."""
    kind: str
    wid: Optional[str] = None
    sid: Optional[str] = None
    device: Optional[int] = None


#: Every concrete event type, in lifecycle order (docs/tests anchor).
EVENT_TYPES = (ArrivalEvent, AdmittedEvent, DeferredEvent,
               RejectedEvent, PlacementEvent, IssueEvent,
               PreemptionEvent, ShardPreemptionEvent, CompletionEvent,
               DeviceDownEvent, DeviceRecoveredEvent, ShardFailedEvent,
               RetryEvent, DegradedEvent)

#: Type registry ``SchedulerEvent.from_dict`` dispatches through —
#: class name -> class, one entry per :data:`EVENT_TYPES` member.
EVENT_REGISTRY: dict[str, type] = {cls.__name__: cls
                                   for cls in EVENT_TYPES}


class EventLog:
    """Append-only event buffer with an optional ring cap.

    List-like for reads: ``len`` / iteration / indexing cover the
    RETAINED window (everything, when ``maxlen`` is ``None``), and
    equality compares against any iterable of events.  With a cap, the
    oldest events are dropped as new ones arrive; ``n_total`` counts
    every event ever appended and ``n_dropped`` how many fell off the
    ring, so :meth:`Scheduler.stream` can keep yielding from absolute
    positions while the window slides.
    """

    def __init__(self, maxlen: Optional[int] = None):
        if maxlen is not None and maxlen < 1:
            raise ValueError(f"event_buffer must be >= 1, got {maxlen}")
        self.maxlen = maxlen
        self.n_total = 0
        self.n_dropped = 0
        self._items: list[SchedulerEvent] = []

    def append(self, ev: SchedulerEvent) -> None:
        """Append one event, evicting the oldest past the cap."""
        self._items.append(ev)
        self.n_total += 1
        if self.maxlen is not None and len(self._items) > self.maxlen:
            drop = len(self._items) - self.maxlen
            del self._items[:drop]
            self.n_dropped += drop

    def since(self, n: int) -> list:
        """Retained events with absolute index ``>= n``, oldest first.

        ``n`` is an ABSOLUTE stream position in ``[0, n_total]``:
        ``since(0)`` is the whole retained window, ``since(n_total)``
        is empty (the next event lands there).  Positions the ring has
        already evicted (``n < n_dropped``) are legal — the evicted
        prefix is silently absent, which is the wraparound contract
        :meth:`Scheduler.stream` relies on across window slides.
        Out-of-range positions raise ``ValueError``: a negative ``n``
        or one beyond ``n_total`` is a cursor-bookkeeping bug at the
        caller, not a readable position.
        """
        if n < 0:
            raise ValueError(
                f"absolute event index must be >= 0, got {n}")
        if n > self.n_total:
            raise ValueError(
                f"absolute event index {n} is past the end of the "
                f"stream (n_total={self.n_total})")
        return self._items[max(0, n - self.n_dropped):]

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def __getitem__(self, i):
        return self._items[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, EventLog):
            return self._items == other._items
        try:
            return self._items == list(other)
        except TypeError:
            return NotImplemented

    def __repr__(self) -> str:
        cap = "" if self.maxlen is None else f", maxlen={self.maxlen}"
        return (f"EventLog(n={len(self._items)}, "
                f"total={self.n_total}{cap})")


# ---------------------------------------------------------------------------
# snapshot serialization helpers (plain-JSON codecs for the run-state
# structures Scheduler.snapshot()/restore() round-trip)
# ---------------------------------------------------------------------------


def _placement_doc(p: Placement) -> dict:
    doc = {"wid": p.wid, "sid": p.sid, "devices": list(p.devices),
           "shard_sizes": list(p.shard_sizes), "score": p.score,
           "planned_at": p.planned_at}
    if p.model is not None:
        # only routed placements carry the key, so unrouted snapshots
        # stay byte-identical to pre-routing documents
        doc["model"] = p.model
    return doc


def _placement_from_doc(doc: Mapping) -> Placement:
    return Placement(doc["wid"], doc["sid"], tuple(doc["devices"]),
                     tuple(doc["shard_sizes"]),
                     score=doc.get("score", 0.0),
                     planned_at=doc.get("planned_at", 0.0),
                     model=doc.get("model"))


def _stagerun_doc(run: "StageRun") -> dict:
    return {"placement": _placement_doc(run.placement),
            "start": run.start, "finish": run.finish,
            "shard_finish": list(run.shard_finish),
            "switched": list(run.switched)}


def _stagerun_from_doc(doc: Mapping) -> "StageRun":
    return StageRun(_placement_from_doc(doc["placement"]),
                    doc["start"], doc["finish"],
                    tuple(doc["shard_finish"]),
                    tuple(bool(s) for s in doc["switched"]))


def _heap_entry_doc(entry: tuple) -> dict:
    """Serialize one pending heap entry ``(t, prio, seq, kind,
    payload)``; arrival payloads are stored by wid (the workflow
    itself lives in the snapshot's workflow registry)."""
    t, prio, seq, kind, payload = entry
    doc = {"t": t, "prio": prio, "seq": seq, "kind": kind}
    if kind == "arrive":
        doc["wid"] = payload.wid
    elif kind in ("finish", "fail"):
        key, token, run = payload
        doc.update(key=list(key), token=token,
                   run=_stagerun_doc(run))
    elif kind == "retry":
        key, attempt, backoff = payload
        doc.update(key=list(key), attempt=attempt, backoff=backoff)
    elif kind == "timeout":
        key, token = payload
        doc.update(key=list(key), token=token)
    elif kind == "release":
        doc["key"] = list(payload)
    elif kind == "crash":
        doc["crash"] = dataclasses.asdict(payload)
    elif kind == "recover":
        doc["device"] = payload
    else:                                # pragma: no cover
        raise ValueError(f"unknown heap event kind {kind!r}")
    return doc


def _heap_entry_from_doc(doc: Mapping,
                         workflows: Mapping[str, "Workflow"]) -> tuple:
    """Inverse of :func:`_heap_entry_doc` (arrival workflows resolved
    through the snapshot's registry)."""
    from repro_torch.core.faults import DeviceCrash
    kind = doc["kind"]
    if kind == "arrive":
        payload = workflows[doc["wid"]]
    elif kind in ("finish", "fail"):
        payload = (tuple(doc["key"]), doc["token"],
                   _stagerun_from_doc(doc["run"]))
    elif kind == "retry":
        payload = (tuple(doc["key"]), doc["attempt"], doc["backoff"])
    elif kind == "timeout":
        payload = (tuple(doc["key"]), doc["token"])
    elif kind == "release":
        payload = tuple(doc["key"])
    elif kind == "crash":
        payload = DeviceCrash(**doc["crash"])
    elif kind == "recover":
        payload = doc["device"]
    else:
        raise ValueError(f"unknown heap event kind {kind!r}")
    return (doc["t"], doc["prio"], doc["seq"], kind, payload)


def _keyed_dict_doc(d: Mapping) -> list:
    """``{(wid, sid): value}`` -> ``[[wid, sid, value], ...]`` in
    insertion order (JSON objects cannot key on tuples)."""
    return [[wid, sid, v] for (wid, sid), v in d.items()]


def _keyed_dict_from_doc(rows, value=lambda v: v) -> dict:
    return {(wid, sid): value(v) for wid, sid, v in rows}


# ---------------------------------------------------------------------------
# shared issue/completion machinery
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StageRun:
    """One issued stage execution: its placement and timing record."""
    placement: Placement
    start: float
    finish: float                       # max over shards
    shard_finish: tuple[float, ...]
    switched: tuple[bool, ...]


@dataclasses.dataclass
class RunResult:
    """Outcome of one single-workflow batch run (paper Table 1 row)."""
    wid: str
    makespan: float
    query_completion: list[float]       # per query
    stage_runs: dict[str, StageRun]
    # mechanism proxies (Appendix C.2), per workflow
    cross_device_edges: int
    prefix_hits_est: float
    same_model_continuations: float
    total_tasks: int
    model_switches: int

    @property
    def p95(self) -> float:
        """95th-percentile per-query completion time (nearest-rank)."""
        return nearest_rank_p95(self.query_completion,
                                default=self.makespan)


def _greedy_fallback(state: ExecutionState, cm: CostModel, wf: Workflow,
                     sid: str) -> Optional[Placement]:
    """Liveness fallback shared by both runtimes: place one ready stage
    on the LIVE device minimizing state-corrected cost plus queueing
    (``None`` when every eligible device is down — the caller waits on
    a pending recovery event instead)."""
    st = wf.stages[sid]
    devs = list(st.eligible) if st.eligible else state.cluster.ids()
    if state.down:
        devs = [d for d in devs if d not in state.down]
        if not devs:
            return None
    best = min(devs, key=lambda d: (
        cm.effective_cost(wf, st, d, wf.num_queries)
        + state.wait_time(d)))
    return Placement(wf.wid, sid, (best,), (wf.num_queries,))


def _issue_shards(state: ExecutionState, cm: CostModel, wf: Workflow,
                  st: Stage, p: Placement,
                  slow: Optional[dict] = None,
                  fail_frac: Optional[float] = None
                  ) -> tuple[list[float], list[bool], list[float]]:
    """Start one placement's shards: per-device state-corrected duration
    (base + switch + transfer − prefix − locality, plus coordination
    overhead when sharded), applied to (ρ, κ, τ) through the dirty-set
    mutators.  The single duration model shared by both runtimes.

    Fault hooks (both ``None`` on the fault-free path, which is then
    bit-identical to the historical behavior): ``slow`` maps devices to
    slowdown factors the ACTUAL execution suffers (the scheduler's
    belief — the third returned list — stays unslowed, which is what
    straggler detection keys off); ``fail_frac`` truncates the attempt
    at that fraction of its actual duration (the failure instant) and
    suppresses prefix warming — a failed attempt produces no reusable
    cache state.
    """
    shard_fin: list[float] = []
    switched: list[bool] = []
    believed: list[float] = []
    for d, nq in zip(p.devices, p.shard_sizes):
        was_resident = state.is_resident(st.model, d)
        t0 = max(state.now, state.device_free(d))
        dur = cm.base_cost(st, d, nq)
        dur += cm.switch_cost(st, d)
        dur += cm.transfer_cost(wf, st, d, nq)
        dur -= cm.prefix_benefit(st, d, nq)
        dur -= cm.locality_benefit(wf, st, d, nq)
        if len(p.devices) > 1:
            dur += (cm.base_cost(st, d, wf.num_queries)
                    * cm.p.shard_overhead)
        dur = max(dur, 1e-6)
        believed.append(t0 + dur)
        if slow is not None:
            dur *= slow.get(d, 1.0)
        if fail_frac is not None:
            dur = max(dur * fail_frac, 1e-6)
        fin = t0 + dur
        state.set_free_at(d, fin)
        state.set_resident(d, st.model)
        if st.keep_cache and fail_frac is None:
            state.warm_prefix(d, st.prefix_group, st.model, nq, fin)
        shard_fin.append(fin)
        switched.append(not was_resident)
    return shard_fin, switched, believed


# ---------------------------------------------------------------------------
# multi-workflow frontier + serving stats
# ---------------------------------------------------------------------------


class SharedFrontier:
    """Merged ready frontier across in-flight workflow DAGs.

    Tracks, per admitted workflow, which stages have completed and
    exposes one ``(wid, sid)``-keyed ready list spanning every active
    DAG — the planning unit of the serving setting.  Workflows are
    iterated in admission order and stages in topological order, so the
    merged list is deterministic; the planner (not this container)
    decides how cross-workflow contention is resolved.  A workflow is
    retired automatically once its last stage completes.

    The ready set is INDEXED: per workflow, a topo-sorted list of
    dependency-ready stages plus unmet-parent counters, maintained
    incrementally on admit/complete/retire, so :meth:`ready` costs
    O(ready + in-flight) instead of re-walking every DAG
    (O(total stages)) per call — the dominant scan at 1k-workflow
    scale.  ``version`` increments on every mutation; admission-probe
    memos key on it.  :meth:`ready_reference` keeps the brute-force
    walk for audits and tests.
    """

    def __init__(self) -> None:
        self.workflows: dict[str, Workflow] = {}
        self.completed: dict[str, set[str]] = {}
        #: mutation counter (admit/complete/retire); cache key for
        #: derived views (admission-probe memos, planner partitions)
        self.version = 0
        # per-wid ready index: sorted (topo_pos, sid) pairs of
        # dependency-ready not-yet-completed stages, the unmet-parent
        # counts behind them, the topo position map, and the workflow
        # generation the index was built against (topology mutation
        # via Workflow.invalidate_topology forces a rebuild)
        self._ready: dict[str, list[tuple[int, str]]] = {}
        self._unmet: dict[str, dict[str, int]] = {}
        self._topo_pos: dict[str, dict[str, int]] = {}
        self._gen: dict[str, int] = {}

    @property
    def _order(self) -> list[str]:
        """Admission-ordered workflow ids (the dict insertion order is
        the admission order — kept as a view so retiring a workflow is
        O(1) instead of a list scan)."""
        return list(self.workflows)

    def _index_workflow(self, wid: str) -> None:
        """(Re)build one workflow's ready index from scratch."""
        wf = self.workflows[wid]
        done = self.completed[wid]
        pos = {sid: i for i, sid in enumerate(wf.topo_order)}
        unmet: dict[str, int] = {}
        ready: list[tuple[int, str]] = []
        for sid in wf.topo_order:
            if sid in done:
                continue
            n = sum(1 for p in wf.stages[sid].parents if p not in done)
            unmet[sid] = n
            if n == 0:
                ready.append((pos[sid], sid))
        self._topo_pos[wid] = pos
        self._unmet[wid] = unmet
        self._ready[wid] = ready
        self._gen[wid] = wf.generation

    def reindex(self) -> None:
        """Rebuild every workflow's ready index (snapshot restore)."""
        for wid in self.workflows:
            self._index_workflow(wid)

    def admit(self, wf: Workflow) -> None:
        """Add an in-flight workflow; its sources become ready."""
        if wf.wid in self.workflows:
            raise ValueError(f"duplicate workflow id {wf.wid}")
        wf.validate()
        self.workflows[wf.wid] = wf
        self.completed[wf.wid] = set()
        self._index_workflow(wf.wid)
        self.version += 1

    def complete(self, wid: str, sid: str) -> bool:
        """Record a stage completion; True if the workflow finished."""
        done = self.completed[wid]
        done.add(sid)
        self.version += 1
        wf = self.workflows[wid]
        if len(done) == len(wf.stages):
            self.retire(wid)
            return True
        if self._gen.get(wid) != wf.generation:
            self._index_workflow(wid)       # topology mutated: rebuild
            return False
        pos = self._topo_pos[wid]
        ready = self._ready[wid]
        unmet = self._unmet[wid]
        if unmet.pop(sid, 1) == 0:          # drop the completed stage
            i = bisect.bisect_left(ready, (pos[sid], sid))
            if i < len(ready) and ready[i] == (pos[sid], sid):
                del ready[i]
        for c in wf.stages[sid].children:
            n = unmet.get(c)
            if n is None:
                continue                    # child already completed
            unmet[c] = n - 1
            if n == 1:                      # became dependency-ready
                bisect.insort(ready, (pos[c], c))
        return False

    def retire(self, wid: str) -> None:
        """Drop a workflow (finished or evicted) from the frontier."""
        self.workflows.pop(wid, None)
        self.completed.pop(wid, None)
        self._ready.pop(wid, None)
        self._unmet.pop(wid, None)
        self._topo_pos.pop(wid, None)
        self._gen.pop(wid, None)
        self.version += 1

    def ready(self, exclude: set[StageKey]) -> list[StageKey]:
        """Merged dependency-ready, not-yet-claimed stage keys.

        Indexed: reads the per-workflow ready lists (admission order,
        topo order within a workflow — identical output to
        :meth:`ready_reference`, which the invariant audit asserts).
        """
        out: list[StageKey] = []
        for wid, wf in self.workflows.items():
            if self._gen.get(wid) != wf.generation:
                self._index_workflow(wid)
            for _pos, sid in self._ready[wid]:
                if (wid, sid) not in exclude:
                    out.append((wid, sid))
        return out

    def ready_reference(self, exclude: set[StageKey]) -> list[StageKey]:
        """Brute-force ready walk (the pre-index implementation),
        kept as the ground truth the indexed :meth:`ready` is audited
        against."""
        out: list[StageKey] = []
        for wid in self.workflows:
            wf = self.workflows[wid]
            done = self.completed[wid]
            for sid in wf.topo_order:
                if sid in done or (wid, sid) in exclude:
                    continue
                if all(p in done for p in wf.stages[sid].parents):
                    out.append((wid, sid))
        return out

    def __len__(self) -> int:
        return len(self.workflows)


@dataclasses.dataclass
class WorkflowServeStats:
    """Per-workflow serving outcome (times are absolute sim seconds).

    ``arrival`` is the ORIGINAL trace arrival even for workflows that
    the control plane deferred, so latency (and SLO attainment)
    includes time spent in the admission backlog.  ``deadline`` is set
    only when the scheduler runs with an :class:`SLOConfig` (or the
    workflow was submitted with an explicit deadline); ``klass`` is
    the admission class named at submission.
    """
    wid: str
    arrival: float
    finish: float
    query_completion: list[float]      # absolute per-query finish times
    n_stages: int
    deadline: Optional[float] = None   # absolute SLO deadline, if any
    klass: str = "default"

    @property
    def makespan(self) -> float:
        """End-to-end latency: completion minus original arrival."""
        return self.finish - self.arrival

    @property
    def latencies(self) -> list[float]:
        """Per-query latencies relative to the original arrival."""
        return [t - self.arrival for t in self.query_completion]

    @property
    def p95(self) -> float:
        """95th-percentile per-query latency (nearest-rank)."""
        return nearest_rank_p95(self.latencies, default=self.makespan)

    @property
    def slo_met(self) -> bool:
        """True when the workflow finished within its deadline (always
        True when no SLO was configured)."""
        return self.deadline is None or self.finish <= self.deadline + 1e-9


@dataclasses.dataclass
class ServingResult:
    """Outcome of one serving trace under one policy.

    ``rejected`` lists workflows the admission controller shed (never
    executed); ``deferrals``/``preemptions`` count control-plane
    interventions.  All three stay empty/zero without an SLO config.
    ``failed`` lists admitted workflows that exhausted their retry
    budget under fault injection; the fault counters
    (``device_downs``/``shard_failures``/``retries``/``stragglers``/
    ``speculations``) stay zero without a
    :class:`~repro_torch.core.faults.FaultPlan`.  ``shard_preemptions``
    counts kill/replay preemptions of issued-and-running shards
    (multi-class runs with ``preempt_running`` only) and ``classes``
    maps every offered workflow id to its admission class, so
    per-class attainment is computable for rejected/failed workflows
    too (:func:`repro_torch.workflowbench.metrics.class_summary`).
    """
    stats: dict[str, WorkflowServeStats]
    horizon: float                     # first arrival -> last completion
    max_in_flight: int
    replans: int
    model_switches: int
    rejected: list[str] = dataclasses.field(default_factory=list)
    deferrals: int = 0
    preemptions: int = 0
    failed: list[str] = dataclasses.field(default_factory=list)
    device_downs: int = 0
    shard_failures: int = 0
    retries: int = 0
    stragglers: int = 0
    speculations: int = 0
    shard_preemptions: int = 0
    classes: dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def n_offered(self) -> int:
        """Workflows offered by the trace: completed + rejected +
        failed-under-faults (failures count against attainment)."""
        return len(self.stats) + len(self.rejected) + len(self.failed)

    @property
    def slo_attainment(self) -> float:
        """Fraction of OFFERED workflows that completed within their
        deadline (rejected arrivals count against attainment)."""
        if self.n_offered == 0:
            return float("nan")
        met = sum(1 for s in self.stats.values() if s.slo_met)
        return met / self.n_offered

    @property
    def goodput_wps(self) -> float:
        """Completed workflows per second over the busy horizon."""
        return len(self.stats) / self.horizon if self.horizon > 0 else 0.0

    @property
    def goodput_slo_wps(self) -> float:
        """SLO-met workflows per second over the busy horizon — the
        serving objective the control plane optimizes."""
        if self.horizon <= 0:
            return 0.0
        met = sum(1 for s in self.stats.values() if s.slo_met)
        return met / self.horizon

    @property
    def goodput_qps(self) -> float:
        """Completed queries per second over the busy horizon."""
        n_q = sum(len(s.query_completion) for s in self.stats.values())
        return n_q / self.horizon if self.horizon > 0 else 0.0


# ---------------------------------------------------------------------------
# the scheduler core
# ---------------------------------------------------------------------------


class Scheduler:
    """Event-driven scheduling runtime with an explicit lifecycle.

    Construction::

        sched = Scheduler(cluster, SchedulerConfig(policy="FATE"))
        sched.submit(wf_a)                 # arrives now
        sched.submit(wf_b, at=0.7)         # arrives at t=0.7
        for ev in sched.stream():          # lazily advances the clock
            ...
        result = sched.drain()             # ServingResult

    ``submit`` enqueues an arrival; ``step()`` advances the clock by
    exactly one event batch (performing any planning/issuing the batch
    unlocks); ``run_until(t)`` steps through every event at or before
    ``t``; ``drain()`` runs to quiescence and returns the
    :class:`ServingResult`.  With ``config.slo`` set, every arrival
    passes the :class:`~repro_torch.core.admission.AdmissionController`
    future-state probe and is admitted, deferred into the bounded
    backlog (re-probed oldest-feasible-first on completions), or
    rejected; SLO-tight admissions preempt the committed-but-unissued
    pool.  Revocation never touches execution state (only issuing
    mutates ρ/κ/τ), so delta rescoring stays bit-identical to full
    rebuilds across preemptions.

    Every transition is appended to :attr:`events` and dispatched to
    :meth:`on` subscribers — the replayable trace that feeds the
    calibration loop and any external observer.

    Advanced injection hooks (used by the back-compat executor
    adapters): pass a pre-built ``state`` and/or ``policy`` to bypass
    the config's construction of them, ``world_profiles`` to emulate
    hardware whose constants diverge from the scheduler's belief (the
    calibration mis-belief harness), ``probe_corrector`` to share a
    long-lived online probe-margin corrector across runs, and
    ``batch=True`` for the single-workflow batch semantics of
    :class:`~repro_torch.core.executor.WorkflowExecutor` (per-workflow
    ``plan()`` dispatch, unconditional greedy fallback, persistent
    commit pool, one completion per clock advance, no admission).
    """

    def __init__(self, cluster=None,
                 config: Optional[SchedulerConfig] = None, *,
                 state: Optional[ExecutionState] = None,
                 policy=None, world_profiles: Optional[dict] = None,
                 world_cost_params: Optional[CostParams] = None,
                 probe_corrector=None, batch: bool = False,
                 journal: Optional[EventJournal] = None,
                 audit_every: Optional[int] = None):
        self.config = config or SchedulerConfig()
        # snapshot() refuses schedulers built through the injection
        # hooks below: injected objects are not reconstructable from
        # the config, so a snapshot of them could not restore
        self._injected = (state is not None or policy is not None
                          or world_profiles is not None
                          or world_cost_params is not None
                          or probe_corrector is not None)
        if state is None:
            if cluster is None:
                raise ValueError("Scheduler needs a cluster or a "
                                 "pre-built ExecutionState")
            state = fresh_state(cluster,
                                profiles=self.config.model_profiles())
        self.state = state
        self.cost_params = self.config.effective_cost_params()
        # world_profiles / world_cost_params: ground-truth constants the
        # emulated hardware follows when they diverge from what the
        # scheduler believes (state.profiles / config cost params) —
        # the calibration benchmark's mis-belief harness; None means
        # world == belief
        self.cm = CostModel(state,
                            (world_cost_params
                             if world_cost_params is not None
                             else self.cost_params),
                            profiles=world_profiles)
        self.policy = policy if policy is not None \
            else self.config.build_policy()
        self.batch = batch
        self.slo = None if batch else self.config.slo
        self.replan_on_completion = (not batch
                                     and self.config.replan_on_completion)
        self.admission: Optional[AdmissionController] = (
            AdmissionController(self.slo, corrector=probe_corrector)
            if self.slo is not None else None)
        if self.admission is not None:
            # late-bound view: self.issued is REBOUND by _load_snapshot,
            # so the controller must read the attribute, not the set
            self.admission.bind_issued(lambda: self.issued)

        # event stream ---------------------------------------------------
        self.events = EventLog(self.config.event_buffer)
        self._handlers: list[tuple[type, Callable]] = []

        # durability ------------------------------------------------------
        # lifecycle: "open" accepts submissions; "drained" is a
        # finalized run; "restored" resumes pre-crash work only
        self._lifecycle = "open"
        self.journal: Optional[EventJournal] = None
        self._journaled = 0                 # next stream index to journal
        self.audit_every = audit_every
        self._n_steps = 0
        if journal is not None:
            self.attach_journal(journal)

        # run state ------------------------------------------------------
        self.frontier = SharedFrontier()
        # (t, prio, seq, kind, payload); prio is seq in serving mode,
        # the stage id in batch mode (historical tie-break contracts).
        # Future arrivals live on their own heap (_SPLIT_ARRIVALS) so
        # in-flight heap scans don't degrade under deep arrival queues;
        # _peek/_pop_next merge the two in exact single-heap order.
        self._heap: list[tuple] = []
        self._arrivals_q: list[tuple] = []
        self._seq = 0
        # routed stage resolution at issue time (Placement.model);
        # None whenever routing is off — every resolver then returns
        # the workflow's own stage object untouched
        self._router: Optional[StageRouter] = (
            StageRouter(self.config.routing)
            if getattr(self.config, "routing", None) is not None
            else None)
        self._n_total_stages = 0
        self.committed: list[Placement] = []
        self.issued: set[StageKey] = set()
        self.runs: dict[StageKey, StageRun] = {}
        # indexed views of the commit pool and issued set, kept in
        # lockstep by _commit/_drop_commit_index/_drop_issued (the
        # invariant audit cross-checks them against the authoritative
        # list/set).  They replace the per-tick O(committed × parents)
        # feasibility scan and the O(issued) by-device/by-workflow
        # scans in the crash/failure paths.
        self._committed_keys: set[StageKey] = set()
        self._commit_unmet: dict[StageKey, int] = {}
        self._commit_feasible: set[StageKey] = set()
        # parent stage key -> commit keys waiting on it, plus the
        # reverse map so drops clean up without a workflow lookup
        self._commit_waiting: dict[StageKey, set[StageKey]] = {}
        self._commit_parents: dict[StageKey, list[StageKey]] = {}
        self._committed_by_dev: dict[int, set[StageKey]] = {}
        self._issued_by_dev: dict[int, set[StageKey]] = {}
        self._issued_by_wid: dict[str, set[StageKey]] = {}
        # devices recorded at ISSUE time — runs[key] can be replaced
        # by a winning speculative copy on different devices before
        # the drop, so index removal must not read runs[key]
        self._issued_devices: dict[StageKey, tuple] = {}
        self._wf_finish: dict[str, float] = {}
        self._arrivals: dict[str, float] = {}
        self._deadlines: dict[str, float] = {}
        self._klass: dict[str, str] = {}
        self._workflows_all: dict[str, Workflow] = {}
        self.stats: dict[str, WorkflowServeStats] = {}
        self._query_done: dict[str, dict[int, float]] = {}
        self._first_arrival: Optional[float] = None
        self._last_finish: Optional[float] = None
        self.max_in_flight = 0
        self.replans = 0
        self.preemptions = 0
        self.shard_preemptions = 0
        self._switches_before = state.model_switches
        self._guard = 0
        self._n_rejected_seen = 0
        # mechanism proxies (Appendix C.2), accumulated per workflow
        self._edge_cross: dict[str, int] = {}
        self._prefix_hits: dict[str, float] = {}
        self._same_model: dict[str, float] = {}
        self.result: Optional[ServingResult] = None

        # fault machinery (serving mode only; None everywhere on the
        # fault-free path, whose behavior is bit-identical to pre-fault
        # schedulers) -----------------------------------------------------
        self.faults: Optional[FaultPlan] = (None if batch
                                            else self.config.faults)
        self.injector: Optional[FaultInjector] = None
        self.health: Optional[DeviceHealth] = None
        self.failed: list[str] = []
        self.device_downs = 0
        self.shard_failures = 0
        self.retries = 0
        self.stragglers = 0
        self.speculations = 0
        # per-stage execution generation: pending heap events carry the
        # token they were issued under, so a failure (token bump)
        # invalidates the stale finish/timeout events still in flight
        self._run_token: dict[StageKey, int] = {}
        self._attempts: dict[StageKey, int] = {}
        # kill/replay anti-livelock: stages preempted this many times
        # (slo.preempt_kill_cap) become immune to further preemption
        self._preempt_counts: dict[StageKey, int] = {}
        # retry backoff holds: stage key -> earliest replan time
        self._hold: dict[StageKey, float] = {}
        self._submitted: set[str] = set()
        if self.faults is not None:
            self.injector = FaultInjector(self.faults)
            self.health = DeviceHealth(self.faults)
            for crash in self.faults.crashes:
                heapq.heappush(self._heap, (crash.at, self._seq,
                                            self._seq, "crash", crash))
                self._seq += 1
                if crash.recover_at is not None:
                    heapq.heappush(self._heap,
                                   (crash.recover_at, self._seq,
                                    self._seq, "recover", crash.device))
                    self._seq += 1

    # -- clock -----------------------------------------------------------
    @property
    def now(self) -> float:
        """Current simulation time (monotone across steps)."""
        return self.state.now

    def next_event_time(self) -> Optional[float]:
        """Timestamp of the next pending event (``None`` when idle)."""
        head = self._peek()
        return head[0] if head is not None else None

    def _peek(self) -> Optional[tuple]:
        """Earliest pending entry across the event and arrival heaps
        (``None`` when both are empty).  Full-tuple comparison on the
        shared ``(t, prio, seq)`` prefix reproduces the single-heap
        order exactly."""
        a = self._heap[0] if self._heap else None
        b = self._arrivals_q[0] if self._arrivals_q else None
        if a is None:
            return b
        if b is None or a <= b:
            return a
        return b

    def _pop_next(self) -> tuple:
        """Pop the entry :meth:`_peek` points at."""
        a = self._heap[0] if self._heap else None
        b = self._arrivals_q[0] if self._arrivals_q else None
        if b is None or (a is not None and a <= b):
            return heapq.heappop(self._heap)
        return heapq.heappop(self._arrivals_q)

    # -- event stream ----------------------------------------------------
    def on(self, event_type: type, handler: Callable) -> None:
        """Subscribe ``handler(event)`` to every emitted event that is
        an instance of ``event_type`` (use :class:`SchedulerEvent` to
        observe the whole stream)."""
        self._handlers.append((event_type, handler))

    def _emit(self, ev: SchedulerEvent) -> None:
        self.events.append(ev)
        for etype, handler in self._handlers:
            if isinstance(ev, etype):
                handler(ev)

    def __iter__(self) -> Iterator[SchedulerEvent]:
        """Iterate over the events emitted so far (a snapshot; use
        :meth:`stream` to lazily drive the clock instead)."""
        return iter(list(self.events))

    def stream(self, strict: bool = False) -> Iterator[SchedulerEvent]:
        """Drive the scheduler to quiescence lazily, yielding each
        event as it is emitted (one :meth:`step` per batch).

        Positions are absolute (ring-buffer safe): with a configured
        ``event_buffer`` cap, events evicted between steps are skipped
        rather than re-yielded or crashed on — unless ``strict`` is
        set, in which case an eviction the consumer has not seen
        raises ``RuntimeError`` instead of silently gapping the
        stream (the contract the gateway's NDJSON endpoint rides:
        a dropped event must surface as an error, never as silence).
        """
        seen = self.events.n_total
        while True:
            progressed = self.step()
            if strict and seen < self.events.n_dropped:
                raise RuntimeError(
                    f"event stream gap: {self.events.n_dropped - seen}"
                    f" event(s) were evicted from the ring "
                    f"(event_buffer={self.events.maxlen}) before this "
                    f"consumer read them; raise event_buffer or "
                    f"consume faster")
            if self.events.n_total > seen:
                for ev in self.events.since(seen):
                    yield ev
                seen = self.events.n_total
            if not progressed:
                return

    # -- lifecycle -------------------------------------------------------
    def submit(self, wf: Workflow, *, at: Optional[float] = None,
               deadline: Optional[float] = None,
               klass: str = "default") -> str:
        """Enqueue a workflow arrival.

        ``at`` is the absolute arrival time (default: now); arrivals
        in the past fire at the next step.  ``deadline`` optionally
        pins an absolute completion deadline for stats/events even
        without an SLO config (with one, the SLO-derived deadline
        governs admission and this override only annotates the
        outcome).  ``klass`` names the admission class; with
        ``SLOConfig.classes`` configured it must be one of the
        registered class names (``ValueError`` otherwise, mirroring
        ``make_policy``'s unknown-name behavior) and selects the
        per-class weight/deadline scale.  Without class config any
        label is accepted and merely annotates stats.  Returns the
        workflow id.

        Raises ``ValueError`` on a duplicate ``wf.wid`` (stats and
        arrivals are keyed by wid for the whole run, so a reused id
        would silently clobber them) and on negative ``at`` or
        ``deadline`` (the simulated clock starts at zero).  Raises
        ``RuntimeError`` when the scheduler is no longer ``"open"``:
        a drained run is finalized (its :class:`ServingResult` is
        built) and a crash-restored scheduler only resumes pre-crash
        work — pushing fresh arrivals into either would corrupt the
        finalized stats / the deterministic replay contract, so build
        a fresh :class:`Scheduler` instead.
        """
        if self._lifecycle != "open":
            raise RuntimeError(
                f"cannot submit {wf.wid!r}: scheduler lifecycle state "
                f"is {self._lifecycle!r} (submissions are only "
                f"accepted while 'open' — drained runs are finalized "
                f"and restored runs only resume pre-crash work; "
                f"create a fresh Scheduler for new arrivals)")
        if wf.wid in self._submitted:
            raise ValueError(
                f"duplicate workflow id submitted: {wf.wid!r}")
        if at is not None and float(at) < 0.0:
            raise ValueError(
                f"negative arrival time at={at!r} for {wf.wid!r}; "
                f"the simulated clock starts at 0.0")
        if deadline is not None and float(deadline) < 0.0:
            raise ValueError(
                f"negative deadline {deadline!r} for {wf.wid!r}; "
                f"deadlines are absolute times on a clock that "
                f"starts at 0.0")
        if (self.slo is not None and self.slo.classes
                and klass not in self.slo.classes):
            raise ValueError(
                f"unknown admission class {klass!r} for {wf.wid!r}; "
                f"configured classes: {sorted(self.slo.classes)}")
        self._submitted.add(wf.wid)
        t = self.state.now if at is None else float(at)
        # batch mode replicates the historical batch executor's heap
        # ordering: ties between simultaneous completions break by
        # stage id, not issue order (arrivals sort first via "")
        prio = "" if self.batch else self._seq
        q = self._arrivals_q if _SPLIT_ARRIVALS else self._heap
        heapq.heappush(q, (t, prio, self._seq, "arrive", wf))
        self._seq += 1
        self._n_total_stages += len(wf.stages)
        self._first_arrival = (t if self._first_arrival is None
                               else min(self._first_arrival, t))
        if deadline is not None:
            self._deadlines[wf.wid] = deadline
        self._klass[wf.wid] = klass
        return wf.wid

    def step(self) -> bool:
        """Advance through exactly one event batch.

        Consumes the next batch of simultaneous events (arrivals and
        completions) with the re-admission sweep and replan trigger,
        then SETTLES the new instant: every planning/issuing action
        the batch unlocked runs before ``step`` returns, so the heap
        already holds the follow-on events (this is what lets
        :meth:`run_until` honor its contract).  Returns ``False`` when
        the scheduler is quiescent (no pending events, commitments, or
        in-flight workflows) — at which point :meth:`drain` finalizes
        the result.

        With an attached :class:`~repro_torch.core.journal.EventJournal`,
        the batch's events are appended (write-ahead) before ``step``
        returns — the step's commit point for crash recovery.  With
        ``audit_every=N``, every Nth step additionally runs
        :func:`audit_invariants` and raises :class:`RecoveryError` on
        any violation (the debug hook the recovery gate uses).
        """
        progressed = self._step_core()
        # flush even on a quiescent step: the final tick may still have
        # emitted events (e.g. expired-backlog rejections) that must
        # reach the journal before the run is considered settled
        self._flush_journal()
        if progressed:
            self._n_steps += 1
            if (self.audit_every is not None
                    and self._n_steps % self.audit_every == 0):
                violations = audit_invariants(self)
                if violations:
                    raise RecoveryError(
                        "invariant audit failed at step "
                        f"{self._n_steps} (t={self.now:.3f}): "
                        + "; ".join(violations))
        return progressed

    def _step_core(self) -> bool:
        while True:
            outcome = self._tick()
            if outcome == "advanced":
                # settle: run the work ticks the batch unlocked
                while self._tick(advance=False) == "work":
                    pass
                return True
            if outcome == "done":
                # quiescent: an idle, long-lived scheduler may be
                # polled indefinitely — liveness-guard counts must not
                # accumulate across idle polls
                self._guard = 0
                return False

    def run_until(self, t: float) -> None:
        """Process every pending event with timestamp ``<= t`` and
        advance the clock to at least ``t``.

        Each consumed batch is settled before the next is considered
        (see :meth:`step`), so follow-on events the planning creates
        at or before ``t`` are processed too, and work unlocked by the
        last batch is issued at its own timestamp — never back-dated
        to ``t``.
        """
        while True:
            head = self._peek()
            if head is None or head[0] > t + 1e-12:
                break
            self.step()
        self.state.now = max(self.state.now, t)

    def drain(self) -> ServingResult:
        """Run to quiescence and return the :class:`ServingResult`
        (also kept on :attr:`result`).  Finalizes the lifecycle:
        further :meth:`submit` calls raise ``RuntimeError``."""
        while self.step():
            pass
        self._lifecycle = "drained"
        self.result = self.peek_result()
        return self.result

    def peek_result(self) -> ServingResult:
        """Provisional :class:`ServingResult` over the work completed
        SO FAR, without advancing the clock or finalizing the
        lifecycle — the live-metrics view the serving gateway's
        ``/v1/metrics`` endpoint reads mid-run.  :meth:`drain` builds
        its final result through this same constructor, so a drained
        run's ``peek_result()`` equals its :attr:`result`."""
        adm = self.admission
        fa = self._first_arrival if self._first_arrival is not None \
            else 0.0
        lf = self._last_finish if self._last_finish is not None else fa
        return ServingResult(
            stats=self.stats, horizon=max(lf - fa, 0.0),
            max_in_flight=self.max_in_flight, replans=self.replans,
            model_switches=(self.state.model_switches
                            - self._switches_before),
            rejected=list(adm.rejected) if adm is not None else [],
            deferrals=adm.n_deferrals if adm is not None else 0,
            preemptions=self.preemptions,
            failed=list(self.failed),
            device_downs=self.device_downs,
            shard_failures=self.shard_failures,
            retries=self.retries, stragglers=self.stragglers,
            speculations=self.speculations,
            shard_preemptions=self.shard_preemptions,
            classes=dict(self._klass))

    def batch_result(self, wid: str) -> RunResult:
        """Single-workflow :class:`RunResult` view of a drained run
        (the batch adapter's output): per-stage runs, per-query
        completions, and the mechanism proxies of ``wid``."""
        runs = {sid: r for (w, sid), r in self.runs.items() if w == wid}
        makespan = max((r.finish for r in runs.values()), default=0.0)
        wf = self._workflows_all[wid]
        qd = self._query_done.get(wid, {})
        qdone = [qd.get(i, makespan) for i in range(wf.num_queries)]
        return RunResult(
            wid=wid, makespan=makespan, query_completion=qdone,
            stage_runs=runs,
            cross_device_edges=self._edge_cross.get(wid, 0),
            prefix_hits_est=self._prefix_hits.get(wid, 0.0),
            same_model_continuations=self._same_model.get(wid, 0.0),
            total_tasks=len(wf.stages),
            model_switches=(self.state.model_switches
                            - self._switches_before))

    # -- durability ------------------------------------------------------
    def attach_journal(self, journal: EventJournal) -> None:
        """Adopt ``journal`` as this run's write-ahead log: every
        subsequent :meth:`step` appends its event batch before
        returning.

        The journal's position must match the event stream — a fresh
        journal on a fresh scheduler, or the journal a restored
        scheduler was replayed against.  Anything else raises
        :class:`~repro_torch.core.journal.JournalError` (the journal would
        silently stop being a contiguous prefix of the stream).
        """
        if journal.next_index != self.events.n_total:
            raise JournalError(
                f"journal is at index {journal.next_index} but the "
                f"event stream is at {self.events.n_total}; attach "
                f"the journal this stream was logged to (or a fresh "
                f"one before the first step)")
        self.journal = journal
        self._journaled = journal.next_index

    def _flush_journal(self) -> None:
        """Write-ahead append of every event emitted since the last
        flush (the per-step commit point)."""
        if self.journal is None:
            return
        n = self.events.n_total
        if n <= self._journaled:
            return
        new = self.events.since(self._journaled)
        if len(new) != n - self._journaled:
            raise JournalError(
                f"{n - self._journaled - len(new)} un-journaled "
                f"event(s) were evicted from the event ring before "
                f"the journal flush — journaled runs need an "
                f"event_buffer at least one step-batch large")
        self.journal.append_batch(new, self._journaled)
        self._journaled = n

    def snapshot(self) -> dict:
        """Serialize the complete run state into one versioned
        plain-JSON document (the checkpoint half of the durable
        control plane).

        Captures the clock and execution state (ρ/κ/ℓ/τ, down set),
        every in-flight structure (pending event heap with run tokens,
        frontier, commitments, issued runs), the admission
        controller's backlog/deadline/probe state including the
        :class:`~repro_torch.core.calibration.ProbeCorrector` EWMAs, the
        fault machinery's RNG cursor / health counters / retry
        backoffs, the retained event window with its ring cursors, and
        the embedded :class:`SchedulerConfig` — everything
        :meth:`restore` needs to resume deterministically.

        Only config-driven serving schedulers snapshot: batch-mode
        adapters and schedulers built through the injection hooks
        (``state=``/``policy=``/``world_*``/``probe_corrector=``)
        raise ``ValueError``, since injected objects cannot be
        reconstructed from the document.
        """
        if self.batch:
            raise ValueError(
                "snapshot() supports serving mode only (batch-mode "
                "adapters are single-shot and need no durability)")
        if self._injected:
            raise ValueError(
                "snapshot() requires a config-driven Scheduler; "
                "injected state/policy/world/probe_corrector hooks "
                "cannot be reconstructed from a snapshot")
        wfs = dict(self._workflows_all)
        for entry in list(self._heap) + list(self._arrivals_q):
            if entry[3] == "arrive":
                wfs[entry[4].wid] = entry[4]
        if self.admission is not None:
            for _arr, wf in self.admission.backlog:
                wfs[wf.wid] = wf
        cluster = self.state.cluster
        return {
            "snapshot_version": SNAPSHOT_VERSION,
            "config": json.loads(self.config.to_json()),
            "cluster": {
                "transfer_coef": cluster.transfer_coef,
                "devices": [dataclasses.asdict(d)
                            for d in cluster.devices]},
            "lifecycle": self._lifecycle,
            "state": self.state.to_dict(),
            "workflows": {wid: wf.to_dict() for wid, wf in wfs.items()},
            "workflows_all": list(self._workflows_all),
            "frontier": {
                "order": list(self.frontier._order),
                "completed": {wid: sorted(done) for wid, done
                              in self.frontier.completed.items()}},
            # one wire key for both heaps (the arrival split is an
            # in-memory layout, not a snapshot format change)
            "heap": ([_heap_entry_doc(e) for e in self._heap]
                     + [_heap_entry_doc(e) for e in self._arrivals_q]),
            "committed": [_placement_doc(p) for p in self.committed],
            "issued": sorted(list(k) for k in self.issued),
            "runs": _keyed_dict_doc({k: _stagerun_doc(r)
                                     for k, r in self.runs.items()}),
            "wf_finish": dict(self._wf_finish),
            "arrivals": dict(self._arrivals),
            "deadlines": dict(self._deadlines),
            "klass": dict(self._klass),
            "stats": {wid: dataclasses.asdict(s)
                      for wid, s in self.stats.items()},
            "query_done": {wid: {str(q): t for q, t in qd.items()}
                           for wid, qd in self._query_done.items()},
            "submitted": sorted(self._submitted),
            "counters": {
                "seq": self._seq,
                "n_total_stages": self._n_total_stages,
                "first_arrival": self._first_arrival,
                "last_finish": self._last_finish,
                "max_in_flight": self.max_in_flight,
                "replans": self.replans,
                "preemptions": self.preemptions,
                "switches_before": self._switches_before,
                "guard": self._guard,
                "n_rejected_seen": self._n_rejected_seen,
                "n_steps": self._n_steps,
                "device_downs": self.device_downs,
                "shard_failures": self.shard_failures,
                "retries": self.retries,
                "stragglers": self.stragglers,
                "speculations": self.speculations,
                "shard_preemptions": self.shard_preemptions},
            "failed": list(self.failed),
            "run_token": _keyed_dict_doc(self._run_token),
            "attempts": _keyed_dict_doc(self._attempts),
            "hold": _keyed_dict_doc(self._hold),
            "preempt_counts": _keyed_dict_doc(self._preempt_counts),
            "faults": (None if self.injector is None else {
                "injector": self.injector.state_dict(),
                "health": self.health.state_dict()}),
            "admission": (self.admission.state_dict()
                          if self.admission is not None else None),
            "events": {
                "maxlen": self.events.maxlen,
                "n_total": self.events.n_total,
                "n_dropped": self.events.n_dropped,
                "retained": [ev.to_dict() for ev in self.events]},
        }

    def save_snapshot(self, path) -> Path:
        """Write :meth:`snapshot` as JSON to ``path``; returns it."""
        path = Path(path)
        path.write_text(json.dumps(self.snapshot(), sort_keys=True))
        return path

    @classmethod
    def restore(cls, snapshot, journal: Optional[EventJournal] = None
                ) -> "Scheduler":
        """Rebuild a scheduler from a :meth:`snapshot` document (or a
        path to one) and, when ``journal`` is given, deterministically
        replay the journal tail past the snapshot.

        Replay is *regeneration*: the scheduler is a deterministic
        state machine, so :meth:`restore` re-steps it from the
        snapshot and verifies every regenerated event against the
        journal's record, raising :class:`RecoveryError` on the first
        divergence.  Work that was in flight at the crash is re-armed
        through the snapshotted pending-event heap under its recorded
        run tokens, so stale completions from the pre-crash epoch are
        discarded by the same token machinery that handles speculative
        duplicates.  The journal is then re-attached (write-ahead
        logging resumes seamlessly), and the restored scheduler's
        lifecycle is ``"restored"``: it drains pre-crash work but
        refuses fresh :meth:`submit` calls.
        """
        doc = snapshot
        if not isinstance(doc, Mapping):
            doc = json.loads(Path(doc).read_text())
        version = int(doc.get("snapshot_version", -1))
        if version != SNAPSHOT_VERSION:
            raise ValueError(
                f"unsupported snapshot version {version} "
                f"(expected {SNAPSHOT_VERSION})")
        config = SchedulerConfig.from_json(json.dumps(doc["config"]))
        cl = doc["cluster"]
        cluster = Cluster(tuple(Device(**d) for d in cl["devices"]),
                          transfer_coef=cl["transfer_coef"])
        sched = cls(cluster, config)
        sched._load_snapshot(doc)
        if journal is not None:
            sched._replay_journal(journal)
        return sched

    def _load_snapshot(self, doc: Mapping) -> None:
        """Overwrite this (freshly constructed) scheduler's run state
        with a snapshot document's contents."""
        from repro_torch.core.workflow import DEFAULT_PROFILES
        wfs = {wid: Workflow.from_dict(w)
               for wid, w in doc["workflows"].items()}
        profiles = self.config.model_profiles() or DEFAULT_PROFILES
        self.state = ExecutionState.from_dict(
            doc["state"], self.state.cluster, profiles)
        # the cost model prices off the state object — rebind it (the
        # config-driven path never injects world profiles/params)
        self.cm = CostModel(self.state, self.cost_params)
        fr = SharedFrontier()
        for wid in doc["frontier"]["order"]:
            fr.workflows[wid] = wfs[wid]
            fr.completed[wid] = set(doc["frontier"]["completed"][wid])
        fr.reindex()
        self.frontier = fr
        # replaces the scripted crash/recover events the constructor
        # pre-pushed — the snapshot heap carries the pending ones
        entries = [_heap_entry_from_doc(h, wfs) for h in doc["heap"]]
        if _SPLIT_ARRIVALS:
            self._heap = [e for e in entries if e[3] != "arrive"]
            self._arrivals_q = [e for e in entries if e[3] == "arrive"]
        else:
            self._heap = entries
            self._arrivals_q = []
        heapq.heapify(self._heap)
        heapq.heapify(self._arrivals_q)
        self.committed = [_placement_from_doc(p)
                          for p in doc["committed"]]
        self.issued = {tuple(k) for k in doc["issued"]}
        self.runs = _keyed_dict_from_doc(doc["runs"],
                                         _stagerun_from_doc)
        self._rebuild_indexes()
        self._wf_finish = dict(doc["wf_finish"])
        self._arrivals = dict(doc["arrivals"])
        self._deadlines = dict(doc["deadlines"])
        self._klass = dict(doc["klass"])
        self._workflows_all = {wid: wfs[wid]
                               for wid in doc["workflows_all"]}
        self.stats = {wid: WorkflowServeStats(**s)
                      for wid, s in doc["stats"].items()}
        self._query_done = {wid: {int(q): t for q, t in qd.items()}
                            for wid, qd in doc["query_done"].items()}
        self._submitted = set(doc["submitted"])
        c = doc["counters"]
        self._seq = c["seq"]
        self._n_total_stages = c["n_total_stages"]
        self._first_arrival = c["first_arrival"]
        self._last_finish = c["last_finish"]
        self.max_in_flight = c["max_in_flight"]
        self.replans = c["replans"]
        self.preemptions = c["preemptions"]
        self._switches_before = c["switches_before"]
        self._guard = c["guard"]
        self._n_rejected_seen = c["n_rejected_seen"]
        self._n_steps = c["n_steps"]
        self.device_downs = c["device_downs"]
        self.shard_failures = c["shard_failures"]
        self.retries = c["retries"]
        self.stragglers = c["stragglers"]
        self.speculations = c["speculations"]
        self.shard_preemptions = c.get("shard_preemptions", 0)
        self.failed = list(doc["failed"])
        self._run_token = _keyed_dict_from_doc(doc["run_token"])
        self._attempts = _keyed_dict_from_doc(doc["attempts"])
        self._hold = _keyed_dict_from_doc(doc["hold"])
        self._preempt_counts = _keyed_dict_from_doc(
            doc.get("preempt_counts") or {})
        f = doc.get("faults")
        if f is not None:
            self.injector.load_state(f["injector"])
            self.health.load_state(f["health"])
        adm_doc = doc.get("admission")
        if adm_doc is not None and self.admission is not None:
            self.admission.load_state(adm_doc, wfs)
        ev_doc = doc["events"]
        log = EventLog(ev_doc["maxlen"])
        log._items = [SchedulerEvent.from_dict(e)
                      for e in ev_doc["retained"]]
        log.n_total = ev_doc["n_total"]
        log.n_dropped = ev_doc["n_dropped"]
        self.events = log
        self._journaled = log.n_total
        self._lifecycle = "restored"

    def _replay_journal(self, journal: EventJournal) -> None:
        """Re-step from the snapshot through the journal tail,
        verifying each regenerated event against the journal's record
        (see :meth:`restore`); then adopt the journal for continued
        write-ahead logging."""
        cursor = self.events.n_total
        tail = [ev for _i, ev in journal.read(cursor)]
        if journal.next_index < cursor:
            raise JournalError(
                f"journal ends at event {journal.next_index} but the "
                f"snapshot is already at {cursor} — this journal does "
                f"not extend this snapshot")
        consumed = 0
        while consumed < len(tail):
            before = self.events.n_total
            if not self._step_core():
                raise RecoveryError(
                    f"journal holds {len(tail) - consumed} more "
                    f"event(s) past the restored run's quiescence")
            new = self.events.since(before)
            if len(new) != self.events.n_total - before:
                raise RecoveryError(
                    "event ring evicted events mid-replay — "
                    "journaled runs need an event_buffer at least "
                    "one step-batch large")
            for ev in new:
                if consumed >= len(tail):
                    break       # regenerated past the logged tail
                if ev != tail[consumed]:
                    raise RecoveryError(
                        f"replay divergence at event "
                        f"{cursor + consumed}: regenerated {ev!r}, "
                        f"journal holds {tail[consumed]!r}")
                consumed += 1
        # resume write-ahead logging: adopt the journal and flush any
        # events the final replayed batch generated past its record
        self.journal = journal
        self._journaled = journal.next_index
        self._flush_journal()

    # -- internals -------------------------------------------------------
    def _guard_limit(self) -> int:
        factor = 40 if self.batch else 60
        limit = factor * max(self._n_total_stages, 1) + 1000
        if self.injector is not None:
            # retries, speculation, and crash replans legitimately
            # multiply the per-stage tick count under fault injection
            limit += 20 * max(self._n_total_stages, 1) + 2000
        return limit

    def _claimed_keys(self) -> set[StageKey]:
        return self.issued | self._committed_keys

    # -- commit-pool / issued-set indexes ---------------------------------
    def _commit(self, p: Placement) -> None:
        """Append one placement to the commit pool, indexing it: key
        set, unmet-parent count (feeding the O(1) pool-feasibility
        check), waiting-on maps, and the by-device view."""
        key = (p.wid, p.sid)
        self.committed.append(p)
        self._committed_keys.add(key)
        wf = self.frontier.workflows.get(p.wid)
        done = self.frontier.completed.get(p.wid, ())
        unmet = ([par for par in wf.stages[p.sid].parents
                  if par not in done] if wf is not None else [])
        self._commit_unmet[key] = len(unmet)
        parents = [(p.wid, par) for par in unmet]
        self._commit_parents[key] = parents
        for pk in parents:
            self._commit_waiting.setdefault(pk, set()).add(key)
        if wf is not None and not unmet:
            self._commit_feasible.add(key)
        for d in p.devices:
            self._committed_by_dev.setdefault(d, set()).add(key)

    def _commit_all(self, ps: Sequence[Placement]) -> None:
        for p in ps:
            self._commit(p)

    def _drop_commit_index(self, p: Placement) -> None:
        """Remove one placement's index entries (the caller removes it
        from the ``committed`` list itself)."""
        key = (p.wid, p.sid)
        self._committed_keys.discard(key)
        self._commit_feasible.discard(key)
        self._commit_unmet.pop(key, None)
        for pk in self._commit_parents.pop(key, ()):
            s = self._commit_waiting.get(pk)
            if s is not None:
                s.discard(key)
                if not s:
                    del self._commit_waiting[pk]
        for d in p.devices:
            s = self._committed_by_dev.get(d)
            if s is not None:
                s.discard(key)
                if not s:
                    del self._committed_by_dev[d]

    def _clear_committed(self) -> None:
        """Empty the commit pool and every index over it (preemption /
        crash / completion-replan revocation)."""
        self.committed.clear()
        self._committed_keys.clear()
        self._commit_unmet.clear()
        self._commit_feasible.clear()
        self._commit_waiting.clear()
        self._commit_parents.clear()
        self._committed_by_dev.clear()

    def _drop_issued(self, key: StageKey) -> None:
        """Remove ``key`` from the issued set and its indexes, using
        the devices recorded at issue time (``runs[key]`` may already
        hold a winning speculative copy on other devices)."""
        self.issued.discard(key)
        for d in self._issued_devices.pop(key, ()):
            s = self._issued_by_dev.get(d)
            if s is not None:
                s.discard(key)
                if not s:
                    del self._issued_by_dev[d]
        s = self._issued_by_wid.get(key[0])
        if s is not None:
            s.discard(key)
            if not s:
                del self._issued_by_wid[key[0]]

    def _rebuild_indexes(self) -> None:
        """Recompute every derived committed/issued index from the
        authoritative structures (snapshot-restore path).  Unmet
        counts come from the restored completion sets, so the rebuilt
        indexes are exactly what incremental maintenance would have
        produced."""
        pool = self.committed
        self.committed = []
        self._clear_committed()
        for p in pool:
            self._commit(p)
        self._issued_by_dev = {}
        self._issued_by_wid = {}
        self._issued_devices = {}
        for key in self.issued:
            devs = self.runs[key].placement.devices
            self._issued_devices[key] = devs
            self._issued_by_wid.setdefault(key[0], set()).add(key)
            for d in devs:
                self._issued_by_dev.setdefault(d, set()).add(key)

    def _stall_name(self) -> str:
        if self.batch:
            wid = next(iter(self._workflows_all), "batch")
            return f"{wid}: executor stalled ({self.policy.name})"
        return f"serving executor stalled ({self.policy.name})"

    def _issuable(self, p: Placement) -> bool:
        done = self.frontier.completed.get(p.wid)
        if done is None:
            return False
        st = self.frontier.workflows[p.wid].stages[p.sid]
        if any(par not in done for par in st.parents):
            return False
        if self.state.down and any(d in self.state.down
                                   for d in p.devices):
            return False
        return all(self.state.device_free(d) <= self.state.now + 1e-12
                   for d in p.devices)

    def _effective_stage(self, wf: Workflow, sid: str,
                         model: Optional[str]) -> Stage:
        """The stage object an attempt actually runs as: the routed
        twin when the placement carries an alternate family
        (``Placement.model``, set by the routing-enabled planner),
        the workflow's own stage otherwise — so issue durations,
        residency, prefix warmth, and kill/replay credit-back all
        price the family that really executed."""
        st = wf.stages[sid]
        if (model is None or model == st.model
                or self._router is None):
            return st
        var = self._router.variant(wf.wid, st, model,
                                   self.state.profiles)
        return var if var is not None else st

    def _issue(self, p: Placement) -> None:
        state = self.state
        wf = self.frontier.workflows[p.wid]
        st = self._effective_stage(wf, p.sid, p.model)
        if self.batch:
            # mechanism proxies (Appendix C.2), measured at issue
            # before the state update — batch-only: ServingResult
            # never reports them, so the serving hot path (replanned
            # on every completion) skips the per-issue scans
            primary = p.devices[0]
            for par in st.parents:
                locs = state.output_loc.get((p.wid, par), ())
                if locs and primary not in locs:
                    self._edge_cross[p.wid] = \
                        self._edge_cross.get(p.wid, 0) + 1
            ov = state.prefix_overlap(st, primary, wf.num_queries)
            self._prefix_hits[p.wid] = \
                self._prefix_hits.get(p.wid, 0.0) + ov
            res_frac = sum(
                1 for d in p.devices if state.is_resident(st.model, d)
            ) / len(p.devices)
            self._same_model[p.wid] = \
                self._same_model.get(p.wid, 0.0) + res_frac

        key = (p.wid, p.sid)
        slow = fail_frac = None
        attempt = 0
        if self.injector is not None:
            attempt = self._attempts.get(key, 0)
            slow = self.injector.slow_map(p.devices, state.now)
            fail_frac = self.injector.failure_fraction(
                p.wid, p.sid, p.devices, attempt)
        shard_fin, switched, believed = _issue_shards(
            state, self.cm, wf, st, p, slow=slow, fail_frac=fail_frac)
        fin_all = max(shard_fin)
        token = self._run_token.get(key, 0)
        run = StageRun(p, state.now, fin_all,
                       tuple(shard_fin), tuple(switched))
        self.runs[key] = run
        self.issued.add(key)
        self._issued_devices[key] = p.devices
        self._issued_by_wid.setdefault(p.wid, set()).add(key)
        for d in p.devices:
            self._issued_by_dev.setdefault(d, set()).add(key)
        prio = p.sid if self.batch else self._seq
        kind = "finish" if fail_frac is None else "fail"
        heapq.heappush(self._heap, (fin_all, prio, self._seq, kind,
                                    (key, token, run)))
        self._seq += 1
        if (self.injector is not None and not self.batch
                and self.faults.straggler_threshold > 0.0):
            # schedule a straggler probe at threshold x the believed
            # (fault-free) duration; elide it when the actual finish
            # provably beats it (healthy stage — no timeout can fire)
            horizon = max(believed) - state.now
            if horizon > 1e-9:
                t_out = (state.now
                         + self.faults.straggler_threshold * horizon)
                if t_out < fin_all - 1e-9:
                    heapq.heappush(
                        self._heap,
                        (t_out, self._seq, self._seq, "timeout",
                         (key, token)))
                    self._seq += 1
        self._emit(IssueEvent(t=state.now, wid=p.wid, sid=p.sid,
                              devices=p.devices, start=state.now,
                              finish=fin_all))

    def _issue_all(self) -> None:
        """Issue every committed placement that is dependency-ready on
        free live devices, purging stale commitments (already issued,
        retired workflow, completed stage).

        Single pass: issuing a placement never makes another committed
        placement MORE issuable at the same instant — parents only
        complete in event handlers, and issuing only raises device
        free times — so one in-order sweep reaches the same fixpoint
        the historical issue-until-no-progress loop did, without
        re-scanning the pool once per issued placement.
        """
        if not self.committed:
            return
        keep: list[Placement] = []
        for p in self.committed:
            key = (p.wid, p.sid)
            if key in self.issued \
                    or p.wid not in self.frontier.workflows \
                    or p.sid in self.frontier.completed[p.wid]:
                self._drop_commit_index(p)
                continue
            if self._issuable(p):
                self._drop_commit_index(p)
                self._issue(p)
            else:
                keep.append(p)
        self.committed = keep

    def _admit(self, wf: Workflow, arrival: float,
               deadline: Optional[float] = None) -> None:
        self.frontier.admit(wf)
        self._workflows_all[wf.wid] = wf
        self._arrivals[wf.wid] = arrival
        if deadline is not None:
            # an explicit submit() deadline annotation wins over the
            # SLO-derived one for reporting (admission already decided)
            self._deadlines.setdefault(wf.wid, deadline)
        self.max_in_flight = max(self.max_in_flight, len(self.frontier))
        hook = getattr(self.policy, "on_arrival", None)
        if hook is not None:
            hook(wf, self.state)
        self._emit(AdmittedEvent(
            t=self.state.now, wid=wf.wid, arrival=arrival,
            deadline=self._deadlines.get(wf.wid),
            klass=self._klass.get(wf.wid, "default")))

    def _preempt_commitments(self, trigger_wid: str) -> None:
        """Revoke committed-but-unissued placements for an SLO-tight
        admission.  No execution state was mutated for them (only
        issuing writes ρ/κ/τ), so the planner's delta-rescoring caches
        need no repair — the revoked rows simply reappear in the next
        merged solve, warm-started on their previous devices via the
        solution hint."""
        if self.committed:
            revoked = list(self.committed)
            self._clear_committed()
            self.preemptions += 1
            hook = getattr(self.policy, "on_preempt", None)
            if hook is not None:
                hook(revoked, self.state)
            self._emit(PreemptionEvent(t=self.state.now,
                                       trigger_wid=trigger_wid,
                                       n_revoked=len(revoked)))

    def _preempt_running(self, trigger_wid: str) -> int:
        """Kill/replay preemption of ISSUED-and-running shards on
        behalf of a higher-class arrival (multi-class configs with
        ``preempt_running`` only; a no-op — returning 0 — otherwise,
        keeping single-class runs bit-identical).

        Victims are issued stages of strictly lower class weight than
        the trigger, excluding stages already killed
        ``preempt_kill_cap`` times (anti-livelock immunity) and stages
        about to finish at the current instant (killing them gains no
        capacity and loses finished work).  Up to
        ``preempt_running_max`` victims are killed per trigger,
        furthest-from-finishing first.  Returns the kill count.
        """
        slo = self.slo
        if (slo is None or not slo.classes or not slo.preempt_running
                or not self.issued):
            return 0
        w_t = slo.class_weight(self._klass.get(trigger_wid, "default"))
        now = self.state.now
        victims = []
        for key in self.issued:
            wid = key[0]
            if wid == trigger_wid:
                continue
            w_v = slo.class_weight(self._klass.get(wid, "default"))
            if not (w_v < w_t - 1e-12):
                continue
            if (self._preempt_counts.get(key, 0)
                    >= slo.preempt_kill_cap):
                continue
            run = self.runs[key]
            if run.finish <= now + 1e-9:
                continue
            victims.append((-run.finish, key))
        victims.sort()
        n = 0
        for _neg_fin, key in victims[:max(slo.preempt_running_max, 0)]:
            self._kill_run(key, trigger_wid)
            n += 1
        return n

    def _kill_run(self, key: StageKey, trigger_wid: str) -> None:
        """Kill one issued run and credit its partial state back.

        The run token is bumped so the in-flight finish/fail heap
        events go stale (the same machinery that retires speculative
        losers), the stage leaves the issued set (it re-enters the
        ready frontier, so the next settle loop replans it), and the
        devices the run held are credited back through the dirty-device
        mutators: τ is released to now and the κ prefix warm this
        attempt wrote is revoked (a killed attempt produces no reusable
        cache — mirroring ``fail_frac``'s no-warm rule).  Residency ρ
        is NOT rolled back: the model weights really were loaded.

        A device is only freed when no OTHER issued stage has a
        token-valid heap event running on it — speculative copies queue
        on busy devices, so blindly freeing would corrupt their τ.

        A short ``preempt_holdoff`` is recorded against the stage (with
        a "release" heap event guaranteeing the clock reaches its
        expiry) so the very next solve cannot re-place the victim ahead
        of the trigger it was killed for.
        """
        state = self.state
        wid, sid = key
        run = self.runs[key]
        token = self._run_token.get(key, 0)
        mine: set[int] = set()
        busy_others: set[int] = set()
        for (_t, _prio, _seq, kind, payload) in self._heap:
            if kind not in ("finish", "fail"):
                continue
            k2, tok2, run2 = payload
            if tok2 != self._run_token.get(k2, 0):
                continue
            if k2 == key:
                mine.update(run2.placement.devices)
            elif k2 in self.issued:
                busy_others.update(run2.placement.devices)
        st = self._effective_stage(self.frontier.workflows[wid], sid,
                                   run.placement.model)
        for d in sorted(mine - busy_others):
            if d in state.down:
                continue
            state.set_free_at(d, state.now)
            if st.keep_cache:
                state.revoke_prefix(d, st.prefix_group, st.model)
        self._run_token[key] = token + 1
        self._drop_issued(key)
        self.shard_preemptions += 1
        self._preempt_counts[key] = \
            self._preempt_counts.get(key, 0) + 1
        holdoff = max(self.slo.preempt_holdoff, 0.0)
        if holdoff > 0.0:
            t_r = state.now + holdoff
            self._hold[key] = t_r
            heapq.heappush(self._heap, (t_r, self._seq, self._seq,
                                        "release", key))
            self._seq += 1
        self._emit(ShardPreemptionEvent(
            t=state.now, wid=wid, sid=sid,
            devices=run.placement.devices, trigger_wid=trigger_wid,
            klass=self._klass.get(wid, "default"),
            trigger_klass=self._klass.get(trigger_wid, "default")))

    def _emit_new_rejections(self, reason: str) -> None:
        adm = self.admission
        if adm is None:
            return
        for wid in adm.rejected[self._n_rejected_seen:]:
            self._emit(RejectedEvent(t=self.state.now, wid=wid,
                                     reason=reason))
        self._n_rejected_seen = len(adm.rejected)

    def _finish(self, key: StageKey) -> None:
        state = self.state
        wid, sid = key
        wf = self.frontier.workflows[wid]
        st = wf.stages[sid]
        run = self.runs[key]
        # workflow finish tracks only SUCCESSFUL attempts (a failed
        # attempt's projected finish never materialises)
        self._wf_finish[wid] = max(self._wf_finish.get(wid, 0.0),
                                   run.finish)
        if self.health is not None:
            for d in run.placement.devices:
                self.health.record_success(d)
        self._attempts.pop(key, None)
        state.output_loc[(wid, sid)] = run.placement.devices
        state.completed.add((wid, sid))
        if not st.children:          # sink: per-query completion
            qd = self._query_done.setdefault(wid, {})
            qid = 0
            for dfin, nq in zip(run.shard_finish,
                                run.placement.shard_sizes):
                for _ in range(nq):
                    qd[qid] = max(qd.get(qid, 0.0), dfin)
                    qid += 1
        self._drop_issued(key)
        done = self.frontier.complete(wid, sid)
        # committed placements waiting on this stage move one parent
        # closer to issuable; zero unmet parents = pool-feasible
        for ck in self._commit_waiting.pop(key, ()):
            n = self._commit_unmet.get(ck)
            if n is not None:
                self._commit_unmet[ck] = n - 1
                if n == 1:
                    self._commit_feasible.add(ck)
        hook = getattr(self.policy, "on_completion", None)
        if hook is not None:
            hook(wid, sid, state)
        if done:
            wf_all = self._workflows_all[wid]
            qd = self._query_done.get(wid, {})
            fin_t = self._wf_finish.get(wid, state.now)
            qdone = [qd.get(i, fin_t)
                     for i in range(wf_all.num_queries)]
            self.stats[wid] = WorkflowServeStats(
                wid=wid, arrival=self._arrivals[wid], finish=fin_t,
                query_completion=qdone, n_stages=len(wf_all.stages),
                deadline=self._deadlines.get(wid),
                klass=self._klass.get(wid, "default"))
            self._last_finish = (fin_t if self._last_finish is None
                                 else max(self._last_finish, fin_t))
            if not self.batch and hasattr(self.policy,
                                          "forget_workflow"):
                self.policy.forget_workflow(wid)
            if self.admission is not None:
                # close the probe loop (predicted vs observed latency
                # -> EWMA margin corrector) before the controller
                # drops its per-workflow records
                self.admission.record_completion(wid, fin_t)
                self.admission.forget(wid)
        self._emit(CompletionEvent(t=state.now, wid=wid, sid=sid,
                                   workflow_done=done))

    def _plan(self, ready: list[StageKey]) -> list[Placement]:
        policy = self.policy
        if not self.batch and hasattr(policy, "plan_shared"):
            if (self.slo is not None and self.slo.classes
                    and getattr(policy, "supports_priorities", False)):
                # class weights bias the shared solve toward
                # higher-class rows (uniform weights are skipped in
                # the planner, keeping single-class solves identical)
                prios = {wid: self.slo.class_weight(
                             self._klass.get(wid, "default"))
                         for wid in self.frontier.workflows}
                return policy.plan_shared(self.frontier.workflows,
                                          self.state, ready,
                                          priorities=prios)
            return policy.plan_shared(self.frontier.workflows,
                                      self.state, ready)
        out: list[Placement] = []
        by_wid: dict[str, list[str]] = {}
        for wid, sid in ready:
            by_wid.setdefault(wid, []).append(sid)
        for wid, sids in by_wid.items():
            out.extend(policy.plan(self.frontier.workflows[wid],
                                   self.state, sids))
        return out

    def _process_arrivals(self, wfs: list[Workflow]) -> None:
        """Process one same-instant run of arrival events (pop order).

        With ``config.batch_probes`` and 2+ simultaneous arrivals, the
        admission probes are batched: one shared delta-rescored
        lookahead wave covers every candidate
        (:meth:`~repro_torch.core.admission.AdmissionController.probe_batch`)
        and the per-arrival decisions are applied in pop order with
        the congestion floor evaluated at decision time — each
        decision still sees its predecessors' admissions.  Otherwise
        the arrivals are processed sequentially, byte-identically to
        the unbatched scheduler.
        """
        adm = self.admission
        if len(wfs) < 2 or adm is None or not self.config.batch_probes:
            for wf in wfs:
                self._process_arrival(wf)
            return
        if self.slo is not None and self.slo.classes:
            # the shared probe's deadline shortcut reads the class map
            for wf in wfs:
                adm.note_class(wf.wid,
                               self._klass.get(wf.wid, "default"))
        probes = adm.probe_batch(wfs, self.state, self.frontier,
                                 self.policy, self._claimed_keys())
        for wf in wfs:
            self._process_arrival(wf, probe=probes.get(wf.wid))

    def _process_arrival(self, wf: Workflow,
                         probe: Optional[tuple] = None) -> None:
        state = self.state
        if wf.wid in self._workflows_all:
            # stats/arrivals are keyed by wid for the whole run, so a
            # reused wid (even after the first instance retired) would
            # silently clobber them
            raise ValueError(
                f"duplicate workflow id in trace: {wf.wid}")
        self._emit(ArrivalEvent(t=state.now, wid=wf.wid))
        adm = self.admission
        if adm is None:
            self._admit(wf, state.now)
            return
        if self.slo is not None and self.slo.classes:
            # class-aware path: register the class before the first
            # decision; a deferral may first reclaim devices from
            # running lower-class shards (kill/replay) and re-decide
            # against the reclaimed state before backlog bookkeeping
            adm.note_class(wf.wid, self._klass.get(wf.wid, "default"))
            dec = adm.decide(wf, state, self.frontier, self.policy,
                             self._claimed_keys(), arrival=state.now,
                             probe=probe)
            if (dec.action == "defer"
                    and self._preempt_running(wf.wid) > 0):
                dec = adm.decide(wf, state, self.frontier,
                                 self.policy, self._claimed_keys(),
                                 arrival=state.now)
            dec = adm.on_arrival(wf, state, self.frontier,
                                 self.policy, self._claimed_keys(),
                                 dec=dec)
        else:
            dec = adm.on_arrival(wf, state, self.frontier, self.policy,
                                 self._claimed_keys(), probe=probe)
        if dec.action == "admit":
            self._admit(wf, state.now, dec.deadline)
            if dec.preempt:
                # SLO-tight arrival: revoke unissued commitments so it
                # competes immediately
                self._preempt_commitments(wf.wid)
                self._preempt_running(wf.wid)
        elif dec.action == "defer":
            self._emit(DeferredEvent(t=state.now, wid=wf.wid,
                                     predicted_latency=dec.predicted_latency,
                                     deadline=dec.deadline))
        self._emit_new_rejections("admission")

    # -- fault handling ---------------------------------------------------
    def _held(self, key: StageKey, now: float) -> bool:
        """True while ``key`` sits in retry backoff (lazily clears
        expired holds)."""
        t = self._hold.get(key)
        if t is None:
            return False
        if t <= now + 1e-12:
            del self._hold[key]
            return False
        return True

    def _on_shard_failed(self, key: StageKey, token: int, run: StageRun,
                         reason: str) -> None:
        """A stage attempt failed (transient shard fault or device
        crash): invalidate the in-flight run, count the attempt, trip
        quarantine, and schedule a backed-off retry or give up."""
        if key not in self.issued or token != self._run_token.get(key, 0):
            return                      # stale event (already handled)
        wid, sid = key
        self._drop_issued(key)
        self._run_token[key] = token + 1
        attempt = self._attempts.get(key, 0) + 1
        self._attempts[key] = attempt
        self.shard_failures += 1
        self._emit(ShardFailedEvent(t=self.state.now, wid=wid, sid=sid,
                                    devices=run.placement.devices,
                                    reason=reason, attempt=attempt - 1))
        if reason == "transient" and self.health is not None:
            for d in run.placement.devices:
                if self.health.record_failure(d):
                    self._quarantine(d)
        if attempt > self.faults.max_retries:
            self._fail_workflow(wid, sid)
            return
        backoff = self.faults.backoff(attempt)
        t_r = self.state.now + backoff
        self._hold[key] = t_r
        heapq.heappush(self._heap, (t_r, self._seq, self._seq, "retry",
                                    (key, attempt, backoff)))
        self._seq += 1

    def _on_retry(self, key: StageKey, attempt: int,
                  backoff: float) -> None:
        """Backoff expired: release the hold so the stage re-enters
        the ready frontier (the settle loop replans it)."""
        self._hold.pop(key, None)
        wid, sid = key
        if wid not in self.frontier.workflows:
            return                      # workflow failed/retired since
        self.retries += 1
        self._emit(RetryEvent(t=self.state.now, wid=wid, sid=sid,
                              attempt=attempt, backoff=backoff))

    def _on_timeout(self, key: StageKey, token: int) -> None:
        """Straggler probe fired before the stage finished: emit a
        degraded-mode event and (optionally) speculatively re-issue a
        single-device copy on the best live alternate.  First valid
        finish wins — both copies share the run token, and
        :meth:`_finish` discards ``key`` from ``issued``, making the
        loser's event stale."""
        if key not in self.issued or token != self._run_token.get(key, 0):
            return                      # finished or failed already
        state = self.state
        run = self.runs[key]
        wid, sid = key
        self.stragglers += 1
        self._emit(DegradedEvent(t=state.now, kind="straggler",
                                 wid=wid, sid=sid,
                                 device=run.placement.devices[0]))
        if not self.faults.speculate:
            return
        wf = self.frontier.workflows.get(wid)
        if wf is None:
            return
        # a speculative copy re-runs the SAME family the straggling
        # attempt was routed to (the quality decision is the planner's)
        st = self._effective_stage(wf, sid, run.placement.model)
        cand = [d for d in (st.eligible or state.cluster.ids())
                if d not in state.down
                and d not in run.placement.devices]
        if not cand:
            return
        best = min(cand, key=lambda d: (
            self.cm.effective_cost(wf, st, d, wf.num_queries)
            + state.wait_time(d), d))
        p2 = Placement(wid=wid, sid=sid, devices=(best,),
                       shard_sizes=(wf.num_queries,),
                       model=run.placement.model)
        slow = self.injector.slow_map((best,), state.now)
        shard_fin, switched, _ = _issue_shards(state, self.cm, wf, st,
                                               p2, slow=slow)
        fin2 = max(shard_fin)
        run2 = StageRun(p2, state.now, fin2, tuple(shard_fin),
                        tuple(switched))
        heapq.heappush(self._heap, (fin2, self._seq, self._seq,
                                    "finish", (key, token, run2)))
        self._seq += 1
        self.speculations += 1
        self._emit(IssueEvent(t=state.now, wid=wid, sid=sid,
                              devices=p2.devices, start=state.now,
                              finish=fin2))

    def _on_device_crash(self, crash) -> None:
        """Planned device crash fired: fail every in-flight stage
        touching the device (freeing surviving shard devices), evict
        the device from the live set (wiping its residency/prefix
        state), revoke committed placements on it, and force a full
        replan of the merged frontier."""
        state = self.state
        d = crash.device
        if d in state.down:
            return
        for key in sorted(self._issued_by_dev.get(d, ())):
            run = self.runs[key]
            for sd in run.placement.devices:
                if sd != d:
                    state.set_free_at(sd, state.now)
            self._on_shard_failed(key, self._run_token.get(key, 0),
                                  run, "device_down")
        state.mark_down(d, wipe=True)
        self.device_downs += 1
        n = self._revoke_on_device(d)
        hook = getattr(self.policy, "on_device_down", None)
        if hook is not None:
            hook(d, state)
        self._emit(DeviceDownEvent(t=state.now, device=d,
                                   reason="crash",
                                   recover_at=crash.recover_at,
                                   n_revoked=n))
        self._clear_committed()         # failure-aware replan

    def _on_device_recover(self, d: int) -> None:
        """Device rejoined (crash recovery or quarantine expiry):
        restore it to the live set and replan to use it."""
        state = self.state
        if d not in state.down:
            return
        state.mark_up(d)
        if self.health is not None:
            self.health.reset(d)
        hook = getattr(self.policy, "on_device_up", None)
        if hook is not None:
            hook(d, state)
        self._emit(DeviceRecoveredEvent(t=state.now, device=d))
        self._clear_committed()         # replan onto the wider set

    def _quarantine(self, d: int) -> None:
        """Health tracker tripped on ``d``: temporarily evict it
        (keeping its caches — the device is sick, not gone) and
        schedule its automatic recovery."""
        state = self.state
        if d in state.down:
            return
        state.mark_down(d, wipe=False)
        self.device_downs += 1
        recover_at = state.now + self.faults.quarantine_s
        heapq.heappush(self._heap, (recover_at, self._seq, self._seq,
                                    "recover", d))
        self._seq += 1
        n = self._revoke_on_device(d)
        hook = getattr(self.policy, "on_device_down", None)
        if hook is not None:
            hook(d, state)
        self._emit(DeviceDownEvent(t=state.now, device=d,
                                   reason="quarantine",
                                   recover_at=recover_at, n_revoked=n))

    def _revoke_on_device(self, d: int) -> int:
        """Withdraw committed-but-unissued placements touching ``d``
        (no execution state was mutated for them) and notify the
        policy's preemption hook.  Returns the revoked count."""
        keys = self._committed_by_dev.get(d)
        if not keys:
            return 0
        keys = set(keys)
        revoked = [p for p in self.committed if (p.wid, p.sid) in keys]
        self.committed = [p for p in self.committed
                          if (p.wid, p.sid) not in keys]
        for p in revoked:
            self._drop_commit_index(p)
        hook = getattr(self.policy, "on_preempt", None)
        if hook is not None:
            hook(revoked, self.state)
        return len(revoked)

    def _fail_workflow(self, wid: str, sid: str) -> None:
        """Retry budget exhausted on ``(wid, sid)``: give the whole
        workflow up.  Invalidates its in-flight runs, scrubs its
        commitments/holds, retires it from the frontier, and records
        it on :attr:`failed` (reported by :meth:`drain`)."""
        for key in sorted(self._issued_by_wid.get(wid, ())):
            self._drop_issued(key)
            self._run_token[key] = self._run_token.get(key, 0) + 1
        dropped = [p for p in self.committed if p.wid == wid]
        if dropped:
            self.committed = [p for p in self.committed
                              if p.wid != wid]
            for p in dropped:
                self._drop_commit_index(p)
        for key in [k for k in self._hold if k[0] == wid]:
            del self._hold[key]
        for key in [k for k in self._attempts if k[0] == wid]:
            del self._attempts[key]
        if wid in self.frontier.workflows:
            self.frontier.retire(wid)
        self.failed.append(wid)
        if hasattr(self.policy, "forget_workflow"):
            self.policy.forget_workflow(wid)
        if self.admission is not None:
            self.admission.forget(wid)
        self._emit(DegradedEvent(t=self.state.now, kind="gave_up",
                                 wid=wid, sid=sid))

    def _tick(self, advance: bool = True) -> str:
        """One pass of the commit-and-advance loop.

        Returns ``"work"`` (made planning/issuing progress without
        touching the clock), ``"advanced"`` (consumed one event
        batch), ``"done"`` (quiescent), or — with ``advance=False``,
        the settle mode :meth:`step` uses to flush planning at the
        current instant — ``"idle"`` (no work possible now; the clock
        was deliberately left alone).
        """
        state = self.state
        adm = self.admission
        self._guard += 1
        if self._guard > self._guard_limit():
            raise RuntimeError(self._stall_name())
        # 1. issue everything issuable at the current time
        self._issue_all()
        # 2. plan when claimed actions cannot cover the frontier
        ready = self.frontier.ready(self._claimed_keys())
        if self._hold:
            # stages in retry backoff stay out of the plan; a "retry"
            # heap event guarantees the clock reaches their release
            ready = [k for k in ready
                     if not self._held(k, state.now)]
        # O(1) via the unmet-parent index: _issue_all just purged every
        # commitment whose workflow left the frontier, so a key with
        # zero unmet parents is exactly what the historical
        # all-parents-completed scan over the pool found
        pool_feasible = bool(self._commit_feasible)
        if ready and not pool_feasible:
            new = self._plan(ready)
            self.replans += 1
            if not new and (self.batch or not self.issued):
                # liveness fallback: greedily place the single best
                # ready stage by state-corrected cost
                wid, sid = ready[0]
                fb = _greedy_fallback(
                    state, self.cm, self.frontier.workflows[wid], sid)
                new = [fb] if fb is not None else []
            if new:
                for p in new:
                    self._emit(PlacementEvent(
                        t=state.now, wid=p.wid, sid=p.sid,
                        devices=p.devices, shard_sizes=p.shard_sizes))
                self._commit_all(new)
                self._issue_all()  # start the fresh plan NOW, before
                return "work"      # the clock advances to next event
        if not advance:
            return "idle"
        # 3. advance the clock to the next event batch
        if not self._heap and not self._arrivals_q:
            if adm is not None and adm.backlog:
                # no further events will trigger re-admission: drain
                # the backlog (shed expired entries, force the oldest
                # reachable one in) and keep planning
                for arr, wfp, dec in adm.readmit(
                        state, self.frontier, self.policy,
                        self._claimed_keys(), force=True):
                    self._admit(wfp, arr, dec.deadline)
                    if dec.preempt:
                        self._preempt_commitments(wfp.wid)
                        self._preempt_running(wfp.wid)
                self._emit_new_rejections("expired")
                return "work"
            if self.batch:
                if self.committed:
                    return "work"      # unfeasible pool: guard trips
                if len(self.frontier):
                    wid = next(iter(self.frontier.workflows))
                    raise RuntimeError(
                        f"{wid}: deadlock ({self.policy.name})")
                return "done"
            if self.committed or len(self.frontier):
                raise RuntimeError(
                    f"serving executor deadlock ({self.policy.name})")
            return "done"
        t = self._peek()[0]
        state.now = max(state.now, t)
        completed_any = False
        if self.batch:
            # batch semantics: one completion per clock advance (plan
            # between same-instant completions, as Algorithm 2 does);
            # fault injection is serving-only, so the only kinds are
            # "arrive" and always-valid "finish"
            _, _, _, kind, payload = self._pop_next()
            if kind == "arrive":
                self._process_arrival(payload)
            else:
                key, _token, run = payload
                self.runs[key] = run
                self._finish(key)
                completed_any = True
        else:
            # consecutive same-instant arrivals are collected into one
            # batch so their admission probes can share a lookahead
            # wave; the flush before any other event kind (and at loop
            # end) preserves the exact pop-order semantics
            arrivals: list[Workflow] = []
            while True:
                head = self._peek()
                if head is None or head[0] > t + 1e-12:
                    break
                _, _, _, kind, payload = self._pop_next()
                if kind == "arrive":
                    arrivals.append(payload)
                    continue
                if arrivals:
                    self._process_arrivals(arrivals)
                    arrivals = []
                if kind == "finish":
                    key, token, run = payload
                    if key in self.issued \
                            and token == self._run_token.get(key, 0):
                        # first valid finish wins (speculative copies
                        # share the token; the discard below makes
                        # the loser's event stale)
                        self.runs[key] = run
                        self._finish(key)
                        completed_any = True
                elif kind == "fail":
                    key, token, run = payload
                    self._on_shard_failed(key, token, run, "transient")
                elif kind == "retry":
                    key, attempt, backoff = payload
                    self._on_retry(key, attempt, backoff)
                elif kind == "timeout":
                    key, token = payload
                    self._on_timeout(key, token)
                elif kind == "release":
                    # preemption holdoff expired: the victim stage may
                    # re-enter the plan (no event is emitted — the
                    # hold's lazy clear makes this a pure clock driver)
                    self._hold.pop(payload, None)
                elif kind == "crash":
                    self._on_device_crash(payload)
                else:               # "recover"
                    self._on_device_recover(payload)
            if arrivals:
                self._process_arrivals(arrivals)
        if completed_any and adm is not None:
            # re-admission sweep: freed capacity may now fit the
            # oldest deferred arrivals (one per sweep so each
            # admission's frontier update feeds the next probe)
            while True:
                batch = adm.readmit(state, self.frontier, self.policy,
                                    self._claimed_keys())
                self._emit_new_rejections("expired")
                if not batch:
                    break
                for arr, wfp, dec in batch:
                    self._admit(wfp, arr, dec.deadline)
                    if dec.preempt:
                        self._preempt_commitments(wfp.wid)
                        self._preempt_running(wfp.wid)
        if completed_any and self.replan_on_completion and self.committed:
            # revoke unissued commitments: the completed stage changed
            # ρ/κ/ℓ/τ, so the merged frontier is re-solved
            self._clear_committed()
        return "advanced"


# ---------------------------------------------------------------------------
# cross-structure invariant auditor
# ---------------------------------------------------------------------------


def audit_invariants(sched: Scheduler) -> list[str]:
    """Check the scheduler's cross-structure invariants; returns a
    list of human-readable violation strings (empty = consistent).

    Runs against any live, snapshotted-and-restored, or replayed
    scheduler — ``tools/invariant_audit.py`` wraps it as a CLI over
    archived snapshots, the ``--recovery`` bench gate asserts it on
    every restored state, and ``Scheduler(audit_every=N)`` runs it as
    an in-``step()`` debug hook.  Invariants:

    * no stage is simultaneously issued and completed, committed and
      issued, or committed twice;
    * every issued stage has a :class:`StageRun` record AND a pending
      token-valid finish/fail heap event (no lost work);
    * committed placements reference live frontier workflows with
      satisfied completions only, and never target a downed
      (crashed/quarantined) device;
    * stages in retry backoff are not concurrently issued, and every
      live hold (retry backoff or preemption holdoff) has a pending
      retry/release heap event that lifts it;
    * frontier bookkeeping is closed: order list <-> workflow map <->
      completion sets <-> registry/arrival tables, completed sids
      exist in their DAG, and no in-flight workflow already has final
      stats;
    * the indexed structures match their brute-force references: the
      frontier's incremental ready index reproduces the full DAG walk,
      the commit-pool key/unmet/feasibility indexes match the pool,
      and the issued by-device/by-workflow indexes match the issued
      set;
    * event ring accounting: ``n_total == n_dropped + retained``, the
      cap is respected, and nothing is dropped while uncapped.
    """
    v: list[str] = []
    state = sched.state
    fr = sched.frontier
    # issued set ----------------------------------------------------------
    pending: set[StageKey] = set()
    for (_t, _prio, _seq, kind, payload) in sched._heap:
        if kind in ("finish", "fail"):
            key, token, _run = payload
            if token == sched._run_token.get(key, 0):
                pending.add(key)
    for key in sorted(sched.issued):
        wid, sid = key
        if sid in fr.completed.get(wid, ()):
            v.append(f"stage {key} is both issued and completed")
        if key not in sched.runs:
            v.append(f"issued stage {key} has no StageRun record")
        if key not in pending:
            v.append(f"issued stage {key} has no pending token-valid "
                     f"completion event (lost work)")
        if key in sched._hold:
            v.append(f"stage {key} is in retry backoff but issued")
    # holds ---------------------------------------------------------------
    # every live hold needs a heap event that reaches its release time
    # (a "retry" from the failure path or a "release" from running-shard
    # preemption) — otherwise the stage could sit held forever
    releasable: set[StageKey] = set()
    for (_t, _prio, _seq, kind, payload) in sched._heap:
        if kind == "retry":
            releasable.add(payload[0])
        elif kind == "release":
            releasable.add(payload)
    for key, t_r in sorted(sched._hold.items()):
        if t_r > sched.state.now + 1e-9 and key not in releasable:
            v.append(f"held stage {key} (until {t_r:.6f}) has no "
                     f"pending retry/release event to lift the hold")
    # committed pool ------------------------------------------------------
    seen: set[StageKey] = set()
    for p in sched.committed:
        key = (p.wid, p.sid)
        if key in seen:
            v.append(f"duplicate commitment for {key}")
        seen.add(key)
        if key in sched.issued:
            v.append(f"stage {key} is both committed and issued")
        if p.wid in fr.completed and p.sid in fr.completed[p.wid]:
            v.append(f"committed stage {key} is already completed")
        for d in p.devices:
            if d in state.down:
                v.append(f"committed placement {key} targets downed "
                         f"device {d}")
    # frontier bookkeeping ------------------------------------------------
    if sorted(fr.completed) != sorted(fr.workflows):
        v.append("frontier completion sets out of sync with "
                 "workflow map")
    for name, idx in (("ready", fr._ready), ("unmet", fr._unmet),
                      ("topo-pos", fr._topo_pos)):
        if sorted(idx) != sorted(fr.workflows):
            v.append(f"frontier {name} index keys out of sync with "
                     f"workflow map")
    for wid, wf in fr.workflows.items():
        if wid not in sched._workflows_all:
            v.append(f"frontier workflow {wid} missing from the "
                     f"workflow registry")
        if wid not in sched._arrivals:
            v.append(f"frontier workflow {wid} has no recorded "
                     f"arrival")
        unknown = fr.completed.get(wid, set()) - set(wf.stages)
        if unknown:
            v.append(f"workflow {wid} completed unknown stage(s) "
                     f"{sorted(unknown)}")
        if wid in sched.stats:
            v.append(f"workflow {wid} is both in flight and "
                     f"finalized in stats")
    # indexed structures vs brute-force references ------------------------
    if fr.ready(set()) != fr.ready_reference(set()):
        v.append("frontier ready index diverges from the brute-force "
                 "DAG walk")
    c_keys = {(p.wid, p.sid) for p in sched.committed}
    if c_keys != sched._committed_keys:
        v.append("committed key index out of sync with the pool")
    feas: set[StageKey] = set()
    for p in sched.committed:
        key = (p.wid, p.sid)
        wf = fr.workflows.get(p.wid)
        if wf is None:
            continue
        done = fr.completed[p.wid]
        brute = sum(1 for par in wf.stages[p.sid].parents
                    if par not in done)
        if sched._commit_unmet.get(key) != brute:
            v.append(f"commit unmet-parent count for {key} is "
                     f"{sched._commit_unmet.get(key)}, expected "
                     f"{brute}")
        if brute == 0:
            feas.add(key)
    if feas != {k for k in sched._commit_feasible
                if k in c_keys and k[0] in fr.workflows}:
        v.append("commit feasibility index out of sync with the pool")
    by_dev: dict[int, set[StageKey]] = {}
    for p in sched.committed:
        for d in p.devices:
            by_dev.setdefault(d, set()).add((p.wid, p.sid))
    if by_dev != sched._committed_by_dev:
        v.append("committed by-device index out of sync with the pool")
    if set(sched._issued_devices) != sched.issued:
        v.append("issued device record out of sync with the issued "
                 "set")
    i_dev: dict[int, set[StageKey]] = {}
    i_wid: dict[str, set[StageKey]] = {}
    for key, devs in sched._issued_devices.items():
        i_wid.setdefault(key[0], set()).add(key)
        for d in devs:
            i_dev.setdefault(d, set()).add(key)
    if i_dev != sched._issued_by_dev:
        v.append("issued by-device index out of sync")
    if i_wid != sched._issued_by_wid:
        v.append("issued by-workflow index out of sync")
    # event ring accounting ----------------------------------------------
    ev = sched.events
    if ev.n_total != ev.n_dropped + len(ev):
        v.append(f"event ring accounting broken: n_total="
                 f"{ev.n_total} != n_dropped={ev.n_dropped} + "
                 f"retained={len(ev)}")
    if ev.maxlen is None and ev.n_dropped:
        v.append(f"uncapped event log dropped {ev.n_dropped} "
                 f"event(s)")
    if ev.maxlen is not None and len(ev) > ev.maxlen:
        v.append(f"event ring holds {len(ev)} > maxlen={ev.maxlen}")
    return v
