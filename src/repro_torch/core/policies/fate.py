"""FATE scheduling policy: CP-SAT-backed frontier planning with
horizon-aware state-conditional scoring (the paper's method)."""
from __future__ import annotations

from typing import TYPE_CHECKING, Mapping, Optional, Sequence

from repro_torch.core.costs import CostParams
from repro_torch.core.planner import FrontierPlanner, Placement
from repro_torch.core.policies.base import BasePolicy, register_policy
from repro_torch.core.scoring import ScoreParams
from repro_torch.core.state import ExecutionState
from repro_torch.core.workflow import StageKey, Workflow

if TYPE_CHECKING:                                   # pragma: no cover
    from repro_torch.core.scheduler import SchedulerConfig


@register_policy("FATE")
class FATEPolicy(BasePolicy):
    """The paper's future-state-aware policy: a thin lifecycle shell
    around :class:`~repro_torch.core.planner.FrontierPlanner` (scoring
    engine + exact frontier solver)."""

    name = "FATE"
    # the scheduler may bias the shared solve with per-workflow class
    # weights (multi-class SLO configs); policies without this flag
    # are planned unweighted
    supports_priorities = True

    def __init__(self, params: Optional[ScoreParams] = None,
                 time_limit: float = 5.0, use_matrix: bool = True,
                 use_delta: bool = True, warm_start: bool = True,
                 cost_params: Optional[CostParams] = None,
                 max_waves: Optional[int] = None, pools=1,
                 routing=None):
        self.planner = FrontierPlanner(params, time_limit,
                                       use_matrix=use_matrix,
                                       use_delta=use_delta,
                                       warm_start=warm_start,
                                       cost_params=cost_params,
                                       max_waves=max_waves,
                                       pools=pools,
                                       routing=routing)
        self.params = self.planner.params

    @classmethod
    def from_config(cls, config: "SchedulerConfig",
                    cost_params: Optional[CostParams] = None
                    ) -> "FATEPolicy":
        """Thread the typed ``SchedulerConfig`` knobs (score params,
        planner switches, calibration-lowered cost params) into the
        planner; ``policy_kwargs`` entries override config fields so
        the deprecated kwarg path keeps its old meaning."""
        kwargs = dict(
            params=config.score, time_limit=config.time_limit,
            use_matrix=config.use_matrix, use_delta=config.use_delta,
            warm_start=config.warm_start, max_waves=config.max_waves,
            cost_params=cost_params,
            pools=getattr(config, "pools", 1),
            routing=getattr(config, "routing", None))
        kwargs.update(config.policy_kwargs)
        return cls(**kwargs)

    def plan(self, wf: Workflow, state: ExecutionState,
             ready: list[str]) -> list[Placement]:
        """Plan one workflow's ready frontier (batch setting)."""
        return self.planner.plan(wf, state, ready)

    def plan_shared(self, workflows: dict[str, Workflow],
                    state: ExecutionState,
                    ready: Sequence[StageKey],
                    priorities: Optional[Mapping[str, float]] = None
                    ) -> list[Placement]:
        """Serving mode: one merged frontier problem across DAGs
        (``priorities`` weights per-workflow objective rows)."""
        return self.planner.plan_shared(workflows, state, ready,
                                        priorities=priorities)

    def forget_workflow(self, wid: str) -> None:
        """Release per-workflow planner caches (workflow retired)."""
        self.planner.forget_workflow(wid)

    def on_device_down(self, device: int, state: ExecutionState) -> None:
        """Scrub warm-start hints targeting the downed device."""
        self.planner.drop_device_hints(device)

    @property
    def phase_ms(self):
        """Planner per-phase wall-time accumulators (benchmarks)."""
        return self.planner.phase_ms

    @property
    def solve_log(self):
        """Per-solve :class:`~repro_torch.core.planner.SolveRecord` list."""
        return self.planner.solve_log
