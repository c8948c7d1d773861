"""Back-compat executor adapters over the event-driven scheduler core.

The commit-and-advance runtime (paper Algorithm 2) lives in
:mod:`repro_torch.core.scheduler` — one event loop, one issue/completion
machinery, one typed event stream.  This module keeps the historical
entry points as thin adapters over it:

* :class:`WorkflowExecutor` — the paper's single-workflow batch
  setting: one DAG owns the cluster until it drains (the scheduler
  core's ``batch=True`` semantics: per-workflow ``plan()`` dispatch,
  unconditional greedy fallback, persistent commit pool, one
  completion per clock advance);
* :class:`ServingExecutor` — the serving setting: workflows arrive
  over time (e.g. from a Poisson trace), a
  :class:`~repro_torch.core.scheduler.SharedFrontier` merges the ready sets
  of every in-flight DAG, and the policy replans the merged frontier
  on every completion.

Both adapters produce bit-identical placements to the pre-refactor
monolithic loops (``tests/test_scheduler_api.py``).  The former
residents of this module (:class:`Policy`, :class:`SharedFrontier`,
:class:`StageRun`, :class:`RunResult`, :class:`WorkflowServeStats`,
:class:`ServingResult`, ``nearest_rank_p95``, ``fresh_state``) are
re-exported from their new homes so existing imports keep working.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core.admission import SLOConfig
from repro_torch.core.costs import CostModel, CostParams
from repro_torch.core.planner import Placement                        # noqa: F401
from repro_torch.core.policies.base import Policy                     # noqa: F401
from repro_torch.core.scheduler import (RunResult, Scheduler,         # noqa: F401
                                  SchedulerConfig, ServingResult,
                                  SharedFrontier, StageRun,
                                  WorkflowServeStats,
                                  _greedy_fallback, _issue_shards,
                                  fresh_state, nearest_rank_p95)
from repro_torch.core.state import ExecutionState
from repro_torch.core.workflow import StageKey, Workflow

__all__ = [
    "Policy", "RunResult", "ServingExecutor", "ServingResult",
    "SharedFrontier", "StageRun", "WorkflowExecutor",
    "WorkflowServeStats", "fresh_state", "nearest_rank_p95",
]


class WorkflowExecutor:
    """Single-workflow batch runtime: one DAG owns the cluster.

    A thin adapter: each :meth:`run` builds a batch-mode
    :class:`~repro_torch.core.scheduler.Scheduler` around this executor's
    execution state, submits the workflow, drains it, and returns the
    single-workflow :class:`RunResult` view.  The last scheduler (with
    its event stream) is kept on :attr:`scheduler`.
    """

    def __init__(self, state: ExecutionState,
                 cost_params: Optional[CostParams] = None,
                 world_profiles: Optional[dict] = None):
        self.state = state
        self.cost_params = cost_params
        # world_profiles: ground-truth per-model constants the emulated
        # hardware follows when they diverge from what the scheduler
        # believes (state.profiles) — the calibration benchmark's
        # mis-belief harness; None means world == belief
        self.world_profiles = world_profiles
        self.cm = CostModel(state, cost_params, profiles=world_profiles)
        self.scheduler: Optional[Scheduler] = None

    def run(self, wf: Workflow, policy: Policy) -> RunResult:
        """Execute ``wf`` to completion under ``policy``.

        Invariants (property-tested in ``tests/test_executor.py``):
        every stage runs exactly once, dependencies are respected, and
        per-device busy intervals never overlap.  Raises
        ``RuntimeError`` on a stalled policy (liveness guard).
        """
        wf.validate()
        sched = Scheduler(
            config=SchedulerConfig(cost=self.cost_params),
            state=self.state, policy=policy,
            world_profiles=self.world_profiles, batch=True)
        self.scheduler = sched
        self.cm = sched.cm      # the model actually pricing this run
        sched.submit(wf, at=self.state.now)
        sched.drain()
        return sched.batch_result(wf.wid)


class ServingExecutor:
    """Event-driven multi-workflow runtime over the proxy cost model.

    A thin adapter: each :meth:`run` builds a
    :class:`~repro_torch.core.scheduler.Scheduler` around this executor's
    execution state, submits the whole arrival trace, and drains it.
    With an :class:`SLOConfig`, the SLO-aware control plane
    (admission / deferral / preemption, see
    :mod:`repro_torch.core.admission`) is active inside the core.  The
    long-lived ``probe_corrector`` is shared across :meth:`run` calls
    so learned per-family probe margins survive trace boundaries (a
    calibration run warm-starts production traffic) while still
    updating online on every completion.
    """

    def __init__(self, state: ExecutionState,
                 cost_params: Optional[CostParams] = None,
                 replan_on_completion: bool = True,
                 slo: Optional[SLOConfig] = None,
                 world_profiles: Optional[dict] = None,
                 probe_corrector=None):
        self.state = state
        # world != belief harness; see WorkflowExecutor.__init__
        self.cm = CostModel(state, cost_params, profiles=world_profiles)
        self.cost_params = cost_params
        self.replan_on_completion = replan_on_completion
        self.slo = slo
        self.world_profiles = world_profiles
        self.probe_corrector = probe_corrector
        # the last run()'s controller/scheduler, for tests/introspection
        self.admission = None
        self.scheduler: Optional[Scheduler] = None
        # per-(wid, sid) StageRun records of the most recent run()
        self.last_runs: dict[StageKey, StageRun] = {}

    def run(self, trace: Sequence[tuple[float, Workflow]],
            policy) -> ServingResult:
        """Serve one arrival trace to completion under ``policy``.

        ``trace`` is a list of ``(arrival_time, workflow)`` sorted by
        time with unique workflow ids.  Returns the per-workflow stats
        plus control-plane counters; per-stage :class:`StageRun`
        records of this run are left on :attr:`last_runs`.
        """
        sched = Scheduler(
            config=SchedulerConfig(
                cost=self.cost_params, slo=self.slo,
                replan_on_completion=self.replan_on_completion),
            state=self.state, policy=policy,
            world_profiles=self.world_profiles,
            probe_corrector=self.probe_corrector)
        self.scheduler = sched
        self.cm = sched.cm      # the model actually pricing this run
        for t, wf in trace:
            sched.submit(wf, at=t)
        res = sched.drain()
        self.admission = sched.admission
        self.last_runs = sched.runs
        return res
