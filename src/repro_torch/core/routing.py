"""Cost/quality model routing: planner-chosen model families per stage.

FATE's frontier solve assigns (stage-slot × device); routing widens the
assignment axis to (stage, **family**, device) — ECCOS-style: a stage
may declare alternate model families (``Stage.candidates`` as
``(alias, quality)`` pairs, quality relative to the default
``Stage.model``'s implicit 1.0), and the planner may serve it with any
candidate whose quality clears :attr:`RoutingConfig.quality_floor`,
priced through the calibrated per-family cost coefficients
(``ModelProfile.prefill_coef`` / ``decode_coef``).  Cheap-but-good
families win rows on score exactly like devices do, making serving
cost a scheduling objective alongside latency.

Mechanics
---------
* :func:`admissible_candidates` filters a stage's declared alternates
  against the floor (and the profile table) — deterministic order.
* :func:`variant_stage` builds the routed twin of a stage: same sid /
  topology / features, ``model`` swapped, ``base_cost`` scaled by
  :func:`family_cost_ratio` (prefill/decode coefficient ratios blended
  by the stage's ``prefill_fraction``).  Switch costs, residency, and
  the future tail all re-price automatically because every consumer
  reads them off ``stage.model`` via ``state.profiles``.
* The planner emits extra solver rows keyed ``(wid, sid, alias)`` next
  to the default ``(wid, sid)`` rows, under a solver-side mutual-
  exclusion constraint (``FrontierProblem.exclusive``): at most one
  family per stage may hold devices in a wave.

Routing **disabled** (``SchedulerConfig.routing is None`` or a stage
with no ``candidates``) adds no rows, no constraint groups, and no
branching — the solve is bit-identical to the unrouted planner by
construction (``tests/test_routing.py`` asserts it).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

from repro_torch.core.workflow import ModelProfile, Stage


@dataclasses.dataclass(frozen=True)
class RoutingConfig:
    """Cost/quality routing knobs (``SchedulerConfig.routing``).

    ``quality_floor`` is the hard per-stage constraint: a candidate
    family with declared quality below the floor is never offered to
    the solver (the default ``Stage.model`` has quality 1.0 and is
    always admissible).  ``max_candidates`` bounds the per-stage row
    blow-up on wide frontiers.
    """

    quality_floor: float = 0.9
    max_candidates: int = 4

    def to_dict(self) -> dict:
        """Plain-JSON document; inverse of :meth:`from_dict`."""
        return {"quality_floor": self.quality_floor,
                "max_candidates": self.max_candidates}

    @classmethod
    def from_dict(cls, doc: dict) -> "RoutingConfig":
        """Rebuild from :meth:`to_dict` output (tolerates missing
        keys: absent fields keep their defaults)."""
        return cls(
            quality_floor=float(doc.get("quality_floor", 0.9)),
            max_candidates=int(doc.get("max_candidates", 4)))


def family_cost_ratio(profiles: Mapping[str, ModelProfile],
                      base_model: str, alt_model: str,
                      prefill_fraction: float) -> float:
    """Per-query runtime ratio of ``alt_model`` vs ``base_model``.

    Blends the calibrated prefill/decode coefficient ratios by the
    stage's prefill share — the same decomposition the cost model's
    breakdown uses — so a routed stage's ``base_cost`` row scales to
    what the candidate family would actually cost on every device.
    """
    b = profiles[base_model]
    a = profiles[alt_model]
    pf = min(max(prefill_fraction, 0.0), 1.0)
    pre = a.prefill_coef / max(b.prefill_coef, 1e-12)
    dec = a.decode_coef / max(b.decode_coef, 1e-12)
    return pf * pre + (1.0 - pf) * dec


def admissible_candidates(stage: Stage, config: RoutingConfig,
                          profiles: Mapping[str, ModelProfile]
                          ) -> list[tuple[str, float]]:
    """Candidate families of ``stage`` that clear the quality floor.

    Preserves the stage's declaration order (deterministic solves),
    drops aliases without a profile entry or equal to the default
    model, and caps the list at ``config.max_candidates``.  Empty when
    the stage declares no alternates — routing never touches it.
    """
    if not stage.candidates:
        return []
    out: list[tuple[str, float]] = []
    for alias, quality in stage.candidates:
        if alias == stage.model or alias not in profiles:
            continue
        if quality + 1e-12 < config.quality_floor:
            continue
        out.append((alias, quality))
        if len(out) >= config.max_candidates:
            break
    return out


def variant_stage(stage: Stage, alias: str,
                  profiles: Mapping[str, ModelProfile]) -> Stage:
    """Routed twin of ``stage`` served by family ``alias``.

    Same sid / parents / children / features (so topology lookups and
    the scorer's descendant walks keyed by sid stay valid), with
    ``model`` swapped and the ``base_cost`` profile scaled by
    :func:`family_cost_ratio`.  ``candidates`` is cleared — a variant
    is a leaf, never re-routed.
    """
    ratio = family_cost_ratio(profiles, stage.model, alias,
                              stage.prefill_fraction)
    base_cost = {d: c * ratio for d, c in stage.base_cost.items()}
    return dataclasses.replace(stage, model=alias, base_cost=base_cost,
                               candidates=())


class StageRouter:
    """Per-planner cache of routed stage variants.

    Variants are pure functions of (stage object identity, alias,
    profile table), so they are memoized per ``(wid, sid, alias)`` and
    invalidated when the stage object changes (topology mutation builds
    new ``Stage`` objects via ``Workflow.invalidate_topology``'s
    rewiring, and a replaced stage object never matches ``is``).
    """

    def __init__(self, config: RoutingConfig):
        self.config = config
        self._cache: dict[tuple, tuple] = {}

    def candidates(self, wid: str, stage: Stage,
                   profiles: Mapping[str, ModelProfile]
                   ) -> list[tuple[str, float, Stage]]:
        """``(alias, quality, variant)`` triples for one stage."""
        key = (wid, stage.sid)
        hit = self._cache.get(key)
        if hit is not None and hit[0] is stage:
            return hit[1]
        out = [(alias, quality, variant_stage(stage, alias, profiles))
               for alias, quality in admissible_candidates(
                   stage, self.config, profiles)]
        self._cache[key] = (stage, out)
        return out

    def variant(self, wid: str, stage: Stage, alias: str,
                profiles: Mapping[str, ModelProfile]
                ) -> Optional[Stage]:
        """The cached routed twin for ``alias`` (None if not
        admissible) — the issue path resolves ``Placement.model``
        through this so planning and execution price one stage."""
        for a, _q, var in self.candidates(wid, stage, profiles):
            if a == alias:
                return var
        return None

    def forget_workflow(self, wid: str) -> None:
        """Drop a retired workflow's cached variants."""
        for key in [k for k in self._cache if k[0] == wid]:
            del self._cache[key]
