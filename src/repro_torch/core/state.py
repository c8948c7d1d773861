"""Execution state s_t = (ρ_t, κ_t, ℓ_t, τ_t) — the object FATE preserves.

  ρ_t : model residency per device (which model is live in HBM)
  κ_t : reusable prefix-related metadata per device (prefix groups with
        warm cache state, plus the model they were built under)
  ℓ_t : device location(s) of completed stage outputs
  τ_t : next-available time per device

The state also carries bookkeeping used by the runtime (completed set,
running set, committed-but-not-finished set — Appendix A.1 notes these
implementation-level sets are suppressed in the main-text formulation).

Dirty-set protocol
------------------
Incremental wave rescoring (``Scorer.rescore_matrix``) reuses the
previous wave's frontier score tables and recomputes only the entries
whose state inputs changed.  Every mutation of per-device state must
go through the mutator methods (``set_free_at``, ``set_resident``,
``warm_prefix``), which record the touched device in a dirty-device
set.  A single-consumer caller (the planner, between its own
commit-and-advance waves on one overlay) calls
:meth:`ExecutionState.drain_dirty` to claim-and-clear the set and
passes it to the rescorer, which then patches only those devices'
warm-prefix columns.  When no claimed set is available — the first
wave of a session, or any caller that cannot guarantee it is the sole
consumer — the rescorer verifies warm state against fully re-gathered
per-signature snapshots instead, so a lost or stolen mark can never
produce stale scores.  Residency, wait times, and sibling counts are
always snapshot-diffed (clock advancement shrinks every busy device's
wait without touching the device, so marks alone could not cover
them).  ``PlanningOverlay`` starts each planning session with an
empty dirty set: its drains see exactly the devices its own estimated
placements touched.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional

from repro_torch.core.devices import Cluster
from repro_torch.core.workflow import ModelProfile, Stage, Workflow


@dataclasses.dataclass
class PrefixEntry:
    """One warm shared-prefix slot on a device: group, model, warmth."""

    group: str
    model: str
    warm_queries: int = 0          # number of queries whose prefix is warm
    last_used: float = 0.0


@dataclasses.dataclass
class ExecutionState:
    """Mutable cluster-wide execution state ``s_t``: residency (ρ),
    prefix caches (κ), output locations (ℓ), device free times (τ),
    the fault domain, and mechanism counters."""

    cluster: Cluster
    profiles: dict[str, ModelProfile]
    # ρ_t: device -> resident model alias (None = empty)
    residency: dict[int, Optional[str]] = dataclasses.field(
        default_factory=dict)
    # κ_t: device -> {group: PrefixEntry}
    prefix: dict[int, dict[str, PrefixEntry]] = dataclasses.field(
        default_factory=dict)
    # ℓ_t: (wid, sid) -> tuple of device ids holding the completed output
    # (shard execution can leave outputs on several devices)
    output_loc: dict[tuple[str, str], tuple[int, ...]] = dataclasses.field(
        default_factory=dict)
    # τ_t: device -> next free time
    free_at: dict[int, float] = dataclasses.field(default_factory=dict)
    now: float = 0.0
    # bookkeeping
    completed: set = dataclasses.field(default_factory=set)
    running: set = dataclasses.field(default_factory=set)
    committed: set = dataclasses.field(default_factory=set)
    # mechanism counters (Appendix C.2 proxies)
    cross_device_edges: int = 0
    prefix_hits_est: float = 0.0
    same_model_continuations: int = 0
    total_tasks: int = 0
    model_switches: int = 0
    # fault domain: devices currently out of the live set (crashed or
    # quarantined), and a monotone epoch bumped on every membership
    # change so per-cluster caches (admission floors, deadlines) know
    # to invalidate.  Empty set / epoch 0 on every fault-free run.
    down: set = dataclasses.field(default_factory=set)
    fault_epoch: int = 0

    def __post_init__(self) -> None:
        for d in self.cluster.ids():
            self.residency.setdefault(d, None)
            self.prefix.setdefault(d, {})
            self.free_at.setdefault(d, 0.0)
        self._dirty_devices: set[int] = set()

    # -- dirty-set protocol (see module docstring) -----------------------
    def touch_device(self, device: int) -> None:
        """Mark ``device`` dirty for the delta-rescoring consumer."""
        self._dirty_devices.add(device)

    def drain_dirty(self) -> set[int]:
        """Claim-and-clear the set of devices mutated since last drain."""
        out = self._dirty_devices
        self._dirty_devices = set()
        return out

    # -- ρ --------------------------------------------------------------
    def resident_model(self, device: int) -> Optional[str]:
        """Model alias currently resident on ``device`` (None = empty)."""
        return self.residency.get(device)

    def is_resident(self, model: str, device: int) -> bool:
        """Whether ``model`` is the resident model on ``device``."""
        return self.residency.get(device) == model

    def set_resident(self, device: int, model: str) -> None:
        """Load ``model`` onto ``device``, counting the switch and
        dropping prefix entries invalidated by the swap."""
        if self.residency.get(device) != model:
            self.model_switches += 1
            # switching a model invalidates that device's prefix cache
            self.prefix[device] = {
                g: e for g, e in self.prefix[device].items()
                if e.model == model}
        self.residency[device] = model
        self.touch_device(device)

    # -- κ --------------------------------------------------------------
    def prefix_overlap(self, stage: Stage, device: int,
                       num_queries: int) -> float:
        """Overlap(grp(v), d, s_t): fraction of the stage's queries whose
        shared prefix is warm on the device (0..1)."""
        if not stage.cache_reuse or stage.prefix_group is None:
            return 0.0
        e = self.prefix.get(device, {}).get(stage.prefix_group)
        if e is None or e.model != stage.model:
            return 0.0
        return (min(1.0, e.warm_queries / max(num_queries, 1))
                * stage.shared_fraction)

    def warm_prefix(self, device: int, group: Optional[str], model: str,
                    queries: int, now: float) -> None:
        """Record that ``queries`` of prefix ``group`` are warm on
        ``device`` under ``model`` (monotone in query count)."""
        if group is None:
            return
        slot = self.prefix[device].setdefault(
            group, PrefixEntry(group, model))
        if slot.model != model:
            slot.model = model
            slot.warm_queries = 0
        slot.warm_queries = max(slot.warm_queries, queries)
        slot.last_used = now
        self.touch_device(device)

    def revoke_prefix(self, device: int, group: Optional[str],
                      model: str) -> None:
        """Forfeit the warm-prefix entry for ``group`` on ``device``
        (only if it is held under ``model``): the κ credit-back of a
        killed stage attempt, whose :meth:`warm_prefix` recorded cache
        state that never materialized.  Conservative — a prior
        attempt's genuinely-warm entry for the same group is forfeited
        with it, which only under-estimates future benefit.  Marks the
        device dirty like every other state mutator."""
        if group is None:
            return
        e = self.prefix.get(device, {}).get(group)
        if e is not None and e.model == model:
            del self.prefix[device][group]
            self.touch_device(device)

    # -- ℓ --------------------------------------------------------------
    def parent_locations(self, wid: str, stage: Stage) -> dict[str, tuple]:
        """Map each parent stage id to the devices holding its output."""
        return {p: self.output_loc.get((wid, p), ()) for p in stage.parents}

    def parent_on_device(self, wid: str, stage: Stage, device: int) -> int:
        """Number of parents whose output is local to ``device``."""
        k = 0
        for p in stage.parents:
            if device in self.output_loc.get((wid, p), ()):
                k += 1
        return k

    # -- τ --------------------------------------------------------------
    def set_free_at(self, device: int, t: float) -> None:
        """Set device ``d``'s next-free time τ_d and mark it dirty."""
        self.free_at[device] = t
        self.touch_device(device)

    def device_free(self, device: int) -> float:
        """Next-free time τ_d for ``device`` (0.0 if never used)."""
        return self.free_at.get(device, 0.0)

    def wait_time(self, device: int, t: Optional[float] = None) -> float:
        """Queueing delay on ``device`` at time ``t`` (default: now)."""
        t = self.now if t is None else t
        return max(0.0, self.device_free(device) - t)

    def backlog_seconds(self) -> float:
        """Total committed busy time still queued across the cluster:
        ``Σ_d max(0, τ_d − now)``.  The admission controller's analytic
        probe divides this by the device count to estimate how long a
        new arrival waits before its first stage can start."""
        return sum(self.wait_time(d) for d in self.cluster.ids())

    def residency_groups(self) -> dict[Optional[str], list[int]]:
        """Device ids grouped by currently-resident model.

        Devices with no resident model (cold, or wiped by a fail-stop
        crash) land under the ``None`` key.  Group membership follows
        the cluster's canonical id order, so for a fixed residency map
        the grouping is deterministic.  The hierarchical frontier
        partitioner uses this to build affinity-aware device pools:
        keeping same-model devices in one pool preserves the colocation
        and prefix-cache bonuses that the planner score rewards.
        """
        out: dict[Optional[str], list[int]] = {}
        for d in self.cluster.ids():
            out.setdefault(self.residency.get(d), []).append(d)
        return out

    # -- fault domain -----------------------------------------------------
    def live_ids(self) -> list[int]:
        """Device ids currently in the live set (cluster minus down)."""
        if not self.down:
            return self.cluster.ids()
        return [d for d in self.cluster.ids() if d not in self.down]

    @property
    def n_live(self) -> int:
        """Number of live devices (``cluster.n`` minus downed)."""
        return self.cluster.n - len(self.down)

    def mark_down(self, device: int, *, wipe: bool = True) -> None:
        """Evict ``device`` from the live set (crash or quarantine).

        ``wipe=True`` (fail-stop crash) destroys the device's residency
        ρ, warm-prefix table κ, and queued busy time τ — HBM contents do
        not survive a crash.  ``wipe=False`` (quarantine) keeps state
        warm; the device merely stops receiving new work.  Either way
        the device is marked dirty so delta rescoring repairs its
        columns, and the fault epoch is bumped so dependent caches
        invalidate.
        """
        self.down.add(device)
        self.fault_epoch += 1
        if wipe:
            self.residency[device] = None
            self.prefix[device] = {}
            self.free_at[device] = self.now
        self.touch_device(device)

    def mark_up(self, device: int) -> None:
        """Return ``device`` to the live set (recovery)."""
        self.down.discard(device)
        self.fault_epoch += 1
        self.touch_device(device)

    # -- planning views --------------------------------------------------
    def overlay(self) -> "PlanningOverlay":
        """Copy-on-write view for commit-and-advance planning."""
        return PlanningOverlay(self)

    # -- serialization ---------------------------------------------------
    def to_dict(self) -> dict:
        """Plain-JSON document of the full state (ρ/κ/ℓ/τ, clock,
        bookkeeping sets, counters, fault domain, dirty set).

        Dict iteration orders are preserved verbatim — the restored
        state must replay bit-identically, so insertion order (which
        downstream float accumulation can observe) is part of the
        contract.  The cluster and profiles are NOT embedded; the
        owning snapshot carries them (:meth:`from_dict` takes both).
        """
        def _key(k):
            return list(k) if isinstance(k, tuple) else k
        return {
            "now": self.now,
            "residency": {str(d): m for d, m in self.residency.items()},
            "prefix": {str(d): {g: dataclasses.asdict(e)
                                for g, e in tbl.items()}
                       for d, tbl in self.prefix.items()},
            "output_loc": [[wid, sid, list(devs)]
                           for (wid, sid), devs
                           in self.output_loc.items()],
            "free_at": {str(d): t for d, t in self.free_at.items()},
            "completed": [_key(k) for k in sorted(self.completed)],
            "running": [_key(k) for k in sorted(self.running)],
            "committed": [_key(k) for k in sorted(self.committed)],
            "cross_device_edges": self.cross_device_edges,
            "prefix_hits_est": self.prefix_hits_est,
            "same_model_continuations": self.same_model_continuations,
            "total_tasks": self.total_tasks,
            "model_switches": self.model_switches,
            "down": sorted(self.down),
            "fault_epoch": self.fault_epoch,
            "dirty": sorted(self._dirty_devices),
        }

    @classmethod
    def from_dict(cls, doc, cluster: Cluster,
                  profiles: dict) -> "ExecutionState":
        """Rebuild a state from :meth:`to_dict` output over the given
        cluster and model-profile table."""
        def _key(k):
            return tuple(k) if isinstance(k, list) else k
        st = cls(cluster=cluster, profiles=dict(profiles))
        st.now = doc["now"]
        st.residency = {int(d): m
                        for d, m in doc["residency"].items()}
        st.prefix = {int(d): {g: PrefixEntry(**e)
                              for g, e in tbl.items()}
                     for d, tbl in doc["prefix"].items()}
        st.output_loc = {(wid, sid): tuple(devs)
                         for wid, sid, devs in doc["output_loc"]}
        st.free_at = {int(d): t for d, t in doc["free_at"].items()}
        st.completed = {_key(k) for k in doc["completed"]}
        st.running = {_key(k) for k in doc["running"]}
        st.committed = {_key(k) for k in doc["committed"]}
        st.cross_device_edges = doc["cross_device_edges"]
        st.prefix_hits_est = doc["prefix_hits_est"]
        st.same_model_continuations = doc["same_model_continuations"]
        st.total_tasks = doc["total_tasks"]
        st.model_switches = doc["model_switches"]
        st.down = set(doc["down"])
        st.fault_epoch = doc["fault_epoch"]
        st._dirty_devices = set(doc.get("dirty", ()))
        return st


class _LayeredSet:
    """Set overlay: additions land in a private layer, lookups fall
    through to the (unmodified) base set."""
    __slots__ = ("_base", "_added")

    def __init__(self, base: set):
        self._base = base
        self._added: set = set()

    def add(self, x) -> None:
        if x not in self._base:
            self._added.add(x)

    def __contains__(self, x) -> bool:
        return x in self._added or x in self._base

    def __len__(self) -> int:
        return len(self._base) + len(self._added)

    def __iter__(self):
        yield from self._base
        yield from self._added


class PlanningOverlay(ExecutionState):
    """Copy-on-write overlay over an :class:`ExecutionState`.

    The frontier planner simulates placement effects between waves
    (Algorithm 2's commit-and-advance) on a scratch state.  The seed
    implementation deep-copied the nested per-device prefix tables on
    every ``plan()`` call; the overlay copies only the flat top-level
    dicts (C-speed, device-count sized) and shares the inner prefix
    dicts with the base until a device is first written, at which point
    that device's table (and its entries, mutated in place by
    ``warm_prefix``) is copied.
    """

    def __init__(self, base: ExecutionState):
        # deliberately NOT calling the dataclass __init__: every field
        # is re-bound to an overlay view of the base state.
        self.cluster = base.cluster
        self.profiles = base.profiles
        self.residency = dict(base.residency)
        self.prefix = dict(base.prefix)        # inner dicts shared (COW)
        self.output_loc = dict(base.output_loc)
        self.free_at = dict(base.free_at)
        self.now = base.now
        self.completed = _LayeredSet(base.completed)
        self.running = _LayeredSet(base.running)
        self.committed = _LayeredSet(base.committed)
        self.cross_device_edges = base.cross_device_edges
        self.prefix_hits_est = base.prefix_hits_est
        self.same_model_continuations = base.same_model_continuations
        self.total_tasks = base.total_tasks
        self.model_switches = base.model_switches
        self.down = set(base.down)
        self.fault_epoch = base.fault_epoch
        self._base = base
        self._prefix_own: set[int] = set()
        # fresh, overlay-local dirty set: it records ONLY this planning
        # session's estimated placements, so the planner can trust it
        # for intra-session wave patching (single consumer by
        # construction).  Base-state mutations are NOT claimed — the
        # session's first rescore verifies warm state against full
        # re-gathered snapshots instead (see Scorer.rescore_matrix), so
        # constructing an overlay never perturbs other consumers.
        self._dirty_devices: set[int] = set()

    def _own_prefix(self, device: int) -> None:
        if device not in self._prefix_own:
            src = self._base.prefix.get(device, {})
            self.prefix[device] = {g: copy.copy(e) for g, e in src.items()}
            self._prefix_own.add(device)

    def warm_prefix(self, device: int, group: Optional[str], model: str,
                    queries: int, now: float) -> None:
        """Copy-on-write wrapper: own the device's prefix map, then
        apply the base-class warm-prefix update to the overlay only."""
        if group is None:
            return
        self._own_prefix(device)
        super().warm_prefix(device, group, model, queries, now)

    def set_resident(self, device: int, model: str) -> None:
        """Copy-on-write wrapper around residency switching, so the
        prefix-invalidation side effect stays overlay-local."""
        self._own_prefix(device)
        super().set_resident(device, model)

    def revoke_prefix(self, device: int, group: Optional[str],
                      model: str) -> None:
        """Copy-on-write wrapper: the forfeit stays overlay-local."""
        if group is None:
            return
        self._own_prefix(device)
        super().revoke_prefix(device, group, model)
