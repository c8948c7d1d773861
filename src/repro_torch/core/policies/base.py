"""Policy protocol, lifecycle mixin, and the pluggable policy registry.

The scheduler core (:mod:`repro_torch.core.scheduler`) talks to policies
through one interface with an explicit lifecycle:

* :meth:`Policy.plan` — map a ready frontier to committed placements
  (the only REQUIRED method; everything else has no-op defaults);
* ``plan_shared(workflows, state, ready)`` — OPTIONAL merged
  multi-workflow planning; the serving runtime dispatches on its
  presence (``hasattr``), so policies without it are planned one DAG
  at a time.  It is deliberately absent from :class:`BasePolicy`: a
  no-op default would silently shadow the per-workflow fallback;
* :meth:`BasePolicy.on_arrival` / :meth:`BasePolicy.on_completion` /
  :meth:`BasePolicy.on_preempt` — event hooks the scheduler core
  invokes as workflows are admitted, stages complete, and committed
  placements are revoked, so stateful policies can maintain their own
  bookkeeping without subscribing to the event stream;
* :meth:`BasePolicy.forget_workflow` — cache release on retirement;
* :meth:`BasePolicy.from_config` — construct the policy from a
  :class:`~repro_torch.core.scheduler.SchedulerConfig` (policies that expose
  tunables override it to thread the config's knobs into their
  constructor).

Registration: decorate a class with ``@register_policy("Name")`` and
it becomes constructible via :func:`make_policy` and usable as
``SchedulerConfig(policy="Name")``.  The registry replaces the old
hand-maintained ``ALL_POLICIES`` dict literal (which is now an alias
of the registry, kept for back-compat).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Protocol, runtime_checkable

from repro_torch.core.planner import Placement
from repro_torch.core.state import ExecutionState
from repro_torch.core.workflow import Workflow

if TYPE_CHECKING:                                   # pragma: no cover
    from repro_torch.core.scheduler import SchedulerConfig


@runtime_checkable
class Policy(Protocol):
    """Scheduling policy interface: map a ready frontier to placements.

    Policies may additionally implement ``plan_shared(workflows,
    state, ready)`` (merged multi-workflow planning) and
    ``forget_workflow(wid)`` (cache release on retirement); the serving
    runtime dispatches on their presence.  Lifecycle hooks
    (``on_arrival`` / ``on_completion`` / ``on_preempt``) are invoked
    by the scheduler core when present — inherit :class:`BasePolicy`
    for no-op defaults.
    """

    name: str

    def plan(self, wf: Workflow, state: ExecutionState,
             ready: list[str]) -> list[Placement]:
        """Return committed placements for (a subset of) ``ready``."""
        ...


#: name -> policy class; populated by :func:`register_policy`.
POLICY_REGISTRY: dict[str, type] = {}


def register_policy(name: str):
    """Class decorator registering a policy under ``name``.

    The registered class must satisfy the :class:`Policy` protocol
    (a ``plan`` method and a ``name`` attribute).  Registration makes
    the class reachable through :func:`make_policy` and through
    ``SchedulerConfig(policy=name)``.  Re-registering a name replaces
    the previous entry (deliberate: downstream experiments may swap a
    variant in under the canonical name).
    """
    def deco(cls):
        if not hasattr(cls, "plan"):
            raise TypeError(
                f"@register_policy({name!r}): {cls.__name__} has no "
                f"plan() method and cannot satisfy the Policy protocol")
        cls.name = name
        POLICY_REGISTRY[name] = cls
        return cls
    return deco


def registered_policies() -> list[str]:
    """Sorted names of every registered policy."""
    return sorted(POLICY_REGISTRY)


def make_policy(name: str, **kwargs):
    """Construct a registered policy by name.

    Unknown names raise a ``KeyError`` that lists the registered
    alternatives (the old failure mode was an opaque dict
    ``KeyError``).  Keyword arguments go to the policy constructor
    unchanged.
    """
    try:
        cls = POLICY_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown policy {name!r}; registered policies: "
            f"{', '.join(registered_policies())}") from None
    return cls(**kwargs)


class BasePolicy:
    """No-op lifecycle defaults every in-repo policy mixes in.

    Subclasses implement :meth:`plan`; the hook defaults keep
    simple policies one-method classes while the scheduler core can
    unconditionally drive the full lifecycle on any of them.
    ``plan_shared`` is intentionally NOT defined here — the serving
    runtime treats its presence as "this policy can solve a merged
    multi-workflow frontier", and a no-op default would disable the
    per-workflow fallback.
    """

    name = "base"

    def plan(self, wf: Workflow, state: ExecutionState,
             ready: list[str]) -> list[Placement]:
        """Return committed placements for (a subset of) ``ready``."""
        raise NotImplementedError(
            f"{type(self).__name__} must implement plan()")

    # -- lifecycle hooks (no-op defaults) --------------------------------
    def on_arrival(self, wf: Workflow, state: ExecutionState) -> None:
        """Hook: ``wf`` was admitted into the (shared) frontier."""

    def on_completion(self, wid: str, sid: str,
                      state: ExecutionState) -> None:
        """Hook: stage ``(wid, sid)`` completed on the runtime."""

    def on_preempt(self, revoked: list[Placement],
                   state: ExecutionState) -> None:
        """Hook: committed-but-unissued ``revoked`` placements were
        withdrawn (SLO-tight admission preempted the pool)."""

    def forget_workflow(self, wid: str) -> None:
        """Hook: release per-workflow caches (workflow retired)."""

    def on_device_down(self, device: int, state: ExecutionState) -> None:
        """Hook: ``device`` left the live set (crash or quarantine)."""

    def on_device_up(self, device: int, state: ExecutionState) -> None:
        """Hook: ``device`` rejoined the live set (recovery)."""

    # -- config-driven construction --------------------------------------
    @classmethod
    def from_config(cls, config: "SchedulerConfig",
                    cost_params=None) -> "BasePolicy":
        """Build the policy from a ``SchedulerConfig``.

        The default forwards ``config.policy_kwargs`` to the
        constructor; policies with richer tunables (FATE) override
        this to thread typed config fields (score params, planner
        switches, calibrated cost params) into their constructor.
        ``cost_params`` carries the calibration-lowered
        :class:`~repro_torch.core.costs.CostParams` for policies that price
        placements themselves; the default ignores it.
        """
        return cls(**dict(config.policy_kwargs))
