"""State-conditional cost estimation (paper §3.5, Appendix A.4).

    ĉ(v,d,s) = c_base(v,d) + Δ_switch + Δ_transfer
               − Δ_prefix − Δ_locality − Δ_parallel

This estimator is the single measurement layer feeding both the planner
score Ψ and the runtime scheduling score S — it is not a third
objective (paper §3.5).

Constants come from two places, both replaceable by a fitted
:class:`~repro_torch.core.calibration.CalibrationProfile` (see
``docs/COSTMODEL.md``): per-model switch/prefill/decode coefficients
live on ``ExecutionState.profiles`` (:class:`ModelProfile`), and the
global correction-term scales live on :class:`CostParams` — a loaded
profile supplies both via ``model_profiles()`` / ``cost_params()``
instead of the hand-set defaults.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.devices import Cluster
from repro_torch.core.state import ExecutionState
from repro_torch.core.workflow import Stage, Workflow


@functools.lru_cache(maxsize=64)
def cluster_arrays(cluster: Cluster) -> tuple[np.ndarray, np.ndarray]:
    """Per-cluster (speed, transfer_scale) vectors indexed by device id.

    ``Cluster`` is a frozen dataclass, so the arrays are immutable facts
    of the topology; they are computed once and shared by every wave of
    the vectorized scoring engine.
    """
    speeds = np.array([d.speed for d in cluster.devices], dtype=float)
    tscale = np.array([d.transfer_scale for d in cluster.devices],
                      dtype=float)
    speeds.flags.writeable = False
    tscale.flags.writeable = False
    return speeds, tscale


@dataclasses.dataclass(frozen=True)
class CostParams:
    """Global scales of the correction terms (perturbed in Table 11).

    Hand-set defaults; a fitted
    :class:`~repro_torch.core.calibration.CalibrationProfile` lowers its
    observation-weighted transfer and prefix-saving fits onto this
    object via ``cost_params()``.  Pass the result everywhere a
    ``CostParams`` is accepted (executors, :class:`CostModel`,
    ``FrontierPlanner``) so planner and runtime price with one set of
    constants.
    """
    switch_scale: float = 1.0
    transfer_scale: float = 1.0
    prefix_scale: float = 1.0
    prefix_saving: float = 0.9       # fraction of the prefill part saved
    locality_saving: float = 0.05    # activation-locality side benefit
    shard_overhead: float = 0.08     # per-extra-shard coordination overhead


@dataclasses.dataclass
class CostBreakdown:
    """Additive decomposition of one ĉ(v,d,s) estimate — the paper's
    §3.5 terms, kept separate so Ψ/EFT assembly can weight them
    individually."""
    base: float
    switch: float
    transfer: float
    prefix_benefit: float
    locality_benefit: float
    parallel_benefit: float

    @property
    def total(self) -> float:
        """ĉ(v,d,s): base + penalties − benefits."""
        return (self.base + self.switch + self.transfer
                - self.prefix_benefit - self.locality_benefit
                - self.parallel_benefit)


class CostModel:
    """State-conditional cost estimator ĉ(v,d,s) over one
    :class:`ExecutionState` view.

    Reads per-model constants from ``state.profiles`` and the global
    correction scales from ``params`` — so loading a calibration
    profile into both (see :mod:`repro_torch.core.calibration`) recalibrates
    every consumer (scorer, planner waves, executor durations,
    admission floors) at once.  Stateless apart from those references:
    rebinding ``state`` repoints all component methods.

    ``profiles`` overrides the per-model constants WITHOUT touching the
    shared state — the calibration benchmark uses this to emulate
    ground-truth hardware whose real coefficients diverge from what the
    scheduler believes (executor durations priced from the override,
    planner/probes from ``state.profiles``).
    """

    def __init__(self, state: ExecutionState,
                 params: Optional[CostParams] = None,
                 profiles: Optional[dict] = None):
        self.state = state
        self.p = params or CostParams()
        self.profiles_override = profiles

    def model_profile(self, model: str):
        """Per-model constants this estimator prices with: the
        explicit override when set, else the shared state's profiles."""
        if self.profiles_override is not None:
            return self.profiles_override[model]
        return self.state.profiles[model]

    # -- components ------------------------------------------------------
    def base_cost(self, stage: Stage, device: int, queries: int) -> float:
        """c_base(v,d): the stage's device-profile cost × queries,
        scaled by the device's speed multiplier."""
        dev = self.state.cluster.devices[device]
        return stage.cost_on(device) * queries / dev.speed

    def switch_cost(self, stage: Stage, device: int) -> float:
        """κ_switch(m(v), d) if m(v) not resident on d, else 0."""
        if self.state.is_resident(stage.model, device):
            return 0.0
        prof = self.model_profile(stage.model)
        return prof.switch_cost * self.p.switch_scale

    def transfer_cost(self, wf: Workflow, stage: Stage, device: int,
                      queries: int) -> float:
        """Σ_parents 1[ℓ(u) != d] · β_{ℓ(u),d} · σ(u,v).

        σ(u,v) = parent-output token proxy × queries × comm weight; β is
        seconds per 1k tokens between distinct devices (Appendix C.1:
        "a constant edge-transfer coefficient").
        """
        total = 0.0
        for p in stage.parents:
            locs = self.state.output_loc.get((wf.wid, p), ())
            if not locs or device in locs:
                continue
            src = locs[0]
            beta = self.state.cluster.beta(src, device)
            parent = wf.stages[p]
            sigma_k_tokens = (parent.output_tokens * queries
                              * stage.comm_weight / 1000.0)
            total += beta * sigma_k_tokens
        return total * self.p.transfer_scale

    def prefix_benefit(self, stage: Stage, device: int,
                       queries: int) -> float:
        """Δ_prefix: prefill time saved by warm shared-prefix state on
        the device (0 when the stage's group/model has no overlap)."""
        ov = self.state.prefix_overlap(stage, device, queries)
        if ov <= 0.0:
            return 0.0
        base = self.base_cost(stage, device, queries)
        # a warm shared prefix saves (most of) the prefill part of the
        # stage; prefill_fraction comes from the runtime proxy profile
        return (base * stage.prefill_fraction * self.p.prefix_saving
                * ov * self.p.prefix_scale)

    def locality_benefit(self, wf: Workflow, stage: Stage, device: int,
                         queries: int) -> float:
        """B_colo: activation-locality side benefit, proportional to
        the fraction of parents whose output already sits on the
        device."""
        if not stage.parents:
            return 0.0
        frac = (self.state.parent_on_device(wf.wid, stage, device)
                / len(stage.parents))
        return (self.base_cost(stage, device, queries)
                * self.p.locality_saving * frac)

    def parallel_benefit(self, stage: Stage, devices: Sequence[int],
                         queries: int) -> float:
        """Completion-time reduction from sharding the query batch over
        k devices vs running on the single best of them."""
        if len(devices) <= 1:
            return 0.0
        solo = min(self.base_cost(stage, d, queries) for d in devices)
        shard = self.shard_completion_time(stage, devices, queries)
        return max(0.0, solo - shard)

    def shard_completion_time(self, stage: Stage, devices: Sequence[int],
                              queries: int) -> float:
        """Balanced query partition: completion = slowest shard, plus a
        per-extra-shard coordination overhead."""
        speeds = [self.state.cluster.devices[d].speed for d in devices]
        tot = sum(speeds)
        per_dev = [self.base_cost(stage, d, 1)
                   * _shard_size(queries, speeds, i, tot)
                   for i, d in enumerate(devices)]
        k = len(devices)
        base = min(self.base_cost(stage, d, queries) for d in devices)
        return max(per_dev) + base * self.p.shard_overhead * (k - 1)

    # -- composite ĉ ------------------------------------------------------
    def breakdown(self, wf: Workflow, stage: Stage, device: int,
                  queries: int) -> CostBreakdown:
        """Full per-term :class:`CostBreakdown` of placing the stage's
        query batch on one device (parallel benefit is a multi-device
        property and stays 0 here)."""
        return CostBreakdown(
            base=self.base_cost(stage, device, queries),
            switch=self.switch_cost(stage, device),
            transfer=self.transfer_cost(wf, stage, device, queries),
            prefix_benefit=self.prefix_benefit(stage, device, queries),
            locality_benefit=self.locality_benefit(wf, stage, device,
                                                   queries),
            parallel_benefit=0.0,
        )

    def effective_cost(self, wf: Workflow, stage: Stage, device: int,
                       queries: int) -> float:
        """Scalar ĉ(v,d,s) — :meth:`breakdown` collapsed to its total."""
        return self.breakdown(wf, stage, device, queries).total


def _shard_size(queries: int, speeds: list[float], i: int,
                tot: float) -> int:
    """Deterministic speed-proportional integer partition of queries."""
    lo = round(queries * sum(speeds[:i]) / tot)
    hi = round(queries * sum(speeds[: i + 1]) / tot)
    return max(0, hi - lo)


def shard_partition(queries: int, speeds: list[float]) -> list[int]:
    """Speed-proportional shard sizes for a query batch (sums to
    ``queries``; deterministic, so placements are reproducible)."""
    tot = sum(speeds)
    return [_shard_size(queries, speeds, i, tot)
            for i in range(len(speeds))]
