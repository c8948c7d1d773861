"""Deterministic, seeded fault injection for the scheduling runtime.

The serving loop in :mod:`repro_torch.core.scheduler` historically assumed
every issued shard completes on a healthy device.  This module supplies
the declarative fault model that breaks that assumption on purpose —
reproducibly:

* :class:`FaultPlan` — a frozen, JSON-serializable description of a
  fault trace: scripted :class:`DeviceCrash` / recovery episodes,
  :class:`Slowdown` (straggler) windows, targeted transient
  :class:`ShardFailure` injections plus an optional seeded random
  failure rate, and the retry / quarantine / speculation knobs the
  scheduler obeys while recovering.  A plan rides inside
  ``SchedulerConfig`` (``faults=...``) so a chaos run is reproducible
  from its config JSON alone.
* :class:`FaultInjector` — the runtime oracle the scheduler consults at
  issue time.  All randomness flows through one ``random.Random(seed)``
  stream and scripted faults are pure functions of ``(wid, sid, t)``,
  so two runs of the same plan over the same trace produce bit-identical
  event streams (the ``sched_bench --chaos`` replay gate).
* :class:`DeviceHealth` — consecutive-transient-failure counter that
  trips a device into quarantine after ``quarantine_after`` strikes.
* :class:`TransientStageFailure` — the exception
  :meth:`repro_torch.serving.engine.ServingEngine.run_stage` raises when an
  injected failure fires, so the live engine exercises the same retry
  contract as the simulator.

An EMPTY ``FaultPlan()`` arms the machinery but injects nothing: the
scheduler's fault paths are strictly additive, and the chaos gate
asserts that an empty plan reproduces the fault-free run bit-for-bit.

See ``docs/FAULTS.md`` for the fault taxonomy and recovery semantics.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Mapping, Optional, Sequence


class TransientStageFailure(RuntimeError):
    """Raised by the live engine when an injected shard failure fires.

    Carries no state beyond the message; callers retry the stage (up to
    ``FaultPlan.max_retries``) or surface the failure.
    """


@dataclasses.dataclass(frozen=True)
class DeviceCrash:
    """Scripted fail-stop crash of one device at time ``at``.

    The device loses residency, warm prefixes, and all in-flight shards
    the moment it crashes; committed-but-unissued placements on it are
    revoked.  If ``recover_at`` is set the device rejoins the live set
    (cold) at that time; otherwise it stays down for the whole run.
    """

    device: int
    at: float
    recover_at: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class Slowdown:
    """Straggler episode: device runs ``factor``× slower in a window.

    Any shard ISSUED on ``device`` with ``at <= t < until`` takes
    ``factor`` times its modeled duration.  The scheduler's cost model
    does not see the slowdown — that gap is what timeout-based straggler
    detection (``FaultPlan.straggler_threshold``) exists to catch.
    """

    device: int
    at: float
    until: float
    factor: float = 3.0


@dataclasses.dataclass(frozen=True)
class ShardFailure:
    """Targeted transient failure of one stage's first issue attempt.

    The attempt runs for ``at_fraction`` of its (actual) duration, then
    fails; the scheduler retries with exponential backoff.  Fires at
    most once per ``(wid, sid)``; retries of the same stage succeed.
    """

    wid: str
    sid: str
    at_fraction: float = 0.5


def _tuple_of(cls, docs) -> tuple:
    """Rehydrate a tuple of frozen fault dataclasses from dict rows."""
    return tuple(cls(**dict(d)) for d in (docs or ()))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Declarative, seeded fault trace plus recovery policy knobs.

    Scripted faults (``crashes`` / ``slowdowns`` / ``failures``) are
    deterministic; ``failure_rate`` adds seeded random transient
    failures (at most ``max_random_failures``, each failing at
    ``failure_point`` of the shard's duration).  Recovery knobs:
    ``max_retries`` bounded replays with ``retry_backoff *
    retry_backoff_mult**attempt`` backoff; ``straggler_threshold``
    (× believed duration, 0 disables) arms timeout-based straggler
    detection with optional speculative re-issue (``speculate``);
    ``quarantine_after`` consecutive transient failures on one device
    quarantine it for ``quarantine_s`` seconds.  The default
    ``FaultPlan()`` injects nothing.
    """

    seed: int = 0
    crashes: tuple = ()
    slowdowns: tuple = ()
    failures: tuple = ()
    failure_rate: float = 0.0
    max_random_failures: int = 0
    failure_point: float = 0.5
    max_retries: int = 3
    retry_backoff: float = 0.05
    retry_backoff_mult: float = 2.0
    straggler_threshold: float = 0.0
    speculate: bool = True
    quarantine_after: int = 3
    quarantine_s: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "crashes", tuple(self.crashes))
        object.__setattr__(self, "slowdowns", tuple(self.slowdowns))
        object.__setattr__(self, "failures", tuple(self.failures))

    @property
    def empty(self) -> bool:
        """True when the plan injects nothing and arms no detection."""
        return (not self.crashes and not self.slowdowns
                and not self.failures and self.failure_rate <= 0.0
                and self.straggler_threshold <= 0.0)

    def backoff(self, attempt: int) -> float:
        """Exponential backoff before re-issuing retry ``attempt``."""
        return self.retry_backoff * self.retry_backoff_mult ** max(
            attempt - 1, 0)

    def to_dict(self) -> dict:
        """Plain-JSON dict; inverse of :meth:`from_dict`."""
        doc = dataclasses.asdict(self)
        doc["crashes"] = [dataclasses.asdict(c) for c in self.crashes]
        doc["slowdowns"] = [dataclasses.asdict(s) for s in self.slowdowns]
        doc["failures"] = [dataclasses.asdict(f) for f in self.failures]
        return doc

    @classmethod
    def from_dict(cls, doc: Mapping) -> "FaultPlan":
        """Rehydrate a plan from :meth:`to_dict` output."""
        doc = dict(doc)
        doc["crashes"] = _tuple_of(DeviceCrash, doc.get("crashes"))
        doc["slowdowns"] = _tuple_of(Slowdown, doc.get("slowdowns"))
        doc["failures"] = _tuple_of(ShardFailure, doc.get("failures"))
        return cls(**doc)


class FaultInjector:
    """Runtime oracle for a :class:`FaultPlan`.

    The scheduler (or live engine) asks it, at each issue, whether the
    attempt fails and how much each device is slowed.  Scripted faults
    are pure lookups; random failures draw from one seeded stream in
    issue order, so identical runs consume identical draws.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._rng = random.Random(plan.seed)
        self._targeted = {(f.wid, f.sid): f.at_fraction
                          for f in plan.failures}
        self._fired: set = set()
        self.n_random = 0

    def failure_fraction(self, wid: str, sid: str,
                         devices: Sequence[int],
                         attempt: int) -> Optional[float]:
        """Fraction of the attempt's duration to run before failing.

        ``None`` means the attempt succeeds.  Targeted failures fire
        once on the stage's first attempt; random failures (if
        ``failure_rate > 0``) also only strike first attempts so
        bounded retry always converges.
        """
        if attempt > 0:
            return None
        key = (wid, sid)
        if key in self._targeted and key not in self._fired:
            self._fired.add(key)
            return self._targeted[key]
        if (self.plan.failure_rate > 0.0
                and self.n_random < self.plan.max_random_failures
                and self._rng.random() < self.plan.failure_rate):
            self.n_random += 1
            return self.plan.failure_point
        return None

    def slow_factor(self, device: int, t: float) -> float:
        """Slowdown multiplier for a shard issued on ``device`` at ``t``."""
        f = 1.0
        for ep in self.plan.slowdowns:
            if ep.device == device and ep.at <= t < ep.until:
                f = max(f, ep.factor)
        return f

    def slow_map(self, devices: Sequence[int], t: float
                 ) -> Optional[dict]:
        """Per-device slowdown factors, or ``None`` when all are 1.0."""
        if not self.plan.slowdowns:
            return None
        m = {d: self.slow_factor(d, t) for d in devices}
        return m if any(v != 1.0 for v in m.values()) else None

    # -- durability ------------------------------------------------------
    def state_dict(self) -> dict:
        """Plain-JSON capture of the injector's mutable cursor: the
        seeded RNG state, fired targeted failures, and the random-
        failure count.  With :meth:`load_state` this lets a restored
        scheduler consume the exact same fault draws the pre-crash
        run would have — the determinism the recovery gate asserts."""
        version, internal, gauss = self._rng.getstate()
        return {"rng": [version, list(internal), gauss],
                "fired": sorted(list(k) for k in self._fired),
                "n_random": self.n_random}

    def load_state(self, doc: Mapping) -> None:
        """Restore the cursor captured by :meth:`state_dict` (the
        plan itself rides in the owning ``SchedulerConfig``)."""
        version, internal, gauss = doc["rng"]
        self._rng.setstate((int(version),
                            tuple(int(x) for x in internal), gauss))
        self._fired = {tuple(k) for k in doc["fired"]}
        self.n_random = int(doc["n_random"])


class DeviceHealth:
    """Consecutive-transient-failure tracker driving quarantine.

    ``record_failure`` returns True when a device crosses
    ``quarantine_after`` consecutive strikes (and resets its counter);
    any successful completion on the device resets it.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.consecutive: dict[int, int] = {}

    def record_failure(self, device: int) -> bool:
        """Register a transient failure; True when quarantine trips."""
        n = self.consecutive.get(device, 0) + 1
        self.consecutive[device] = n
        if 0 < self.plan.quarantine_after <= n:
            self.consecutive[device] = 0
            return True
        return False

    def record_success(self, device: int) -> None:
        """A healthy completion clears the device's strike counter."""
        self.consecutive.pop(device, None)

    def reset(self, device: int) -> None:
        """Forget a device's strikes (e.g. on crash recovery)."""
        self.consecutive.pop(device, None)

    # -- durability ------------------------------------------------------
    def state_dict(self) -> dict:
        """Plain-JSON capture of the per-device strike counters."""
        return {"consecutive": {str(d): n
                                for d, n in self.consecutive.items()}}

    def load_state(self, doc: Mapping) -> None:
        """Restore the counters captured by :meth:`state_dict`."""
        self.consecutive = {int(d): int(n)
                            for d, n in doc["consecutive"].items()}
