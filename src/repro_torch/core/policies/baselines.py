"""Baseline scheduling policies in the common runtime (Appendix B).

Signal access follows Table 7:

| policy       | residency | transfer | prefix | lookahead              |
|--------------|-----------|----------|--------|------------------------|
| RoundRobin   | no        | no       | no     | none                   |
| HEFT         | yes       | yes      | no     | upward-rank priority   |
| Helix-style  | yes       | yes      | no     | heterogeneity-aware EFT|
| KVFlow-style | yes       | partial  | yes    | cache/reuse priority   |
| Halo-style   | coarse    | no       | no     | beam search over DAG   |
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

from repro_torch.core.costs import CostModel
from repro_torch.core.planner import Placement
from repro_torch.core.policies.base import BasePolicy, register_policy
from repro_torch.core.state import ExecutionState
from repro_torch.core.workflow import Stage, Workflow


# ---------------------------------------------------------------------------
# RoundRobin
# ---------------------------------------------------------------------------


@register_policy("RoundRobin")
class RoundRobinPolicy(BasePolicy):
    """State-blind round-robin placement over eligible devices."""

    name = "RoundRobin"

    def __init__(self) -> None:
        self._next = 0

    def plan(self, wf: Workflow, state: ExecutionState,
             ready: list[str]) -> list[Placement]:
        """Place each ready stage on the next eligible device."""
        out = []
        devices = state.cluster.ids()
        for sid in ready:
            st = wf.stages[sid]
            eligible = list(st.eligible) if st.eligible else devices
            d = eligible[self._next % len(eligible)]
            self._next += 1
            out.append(Placement(wf.wid, sid, (d,), (wf.num_queries,)))
        return out


# ---------------------------------------------------------------------------
# HEFT: upward rank + earliest finish time (with residency/transfer costs)
# ---------------------------------------------------------------------------


@register_policy("HEFT")
class HEFTPolicy(BasePolicy):
    """Upward-rank list scheduling with residency/transfer-aware
    earliest-finish placement (classic HEFT in the common runtime)."""

    name = "HEFT"

    def __init__(self) -> None:
        self._ranks: dict[str, dict[str, float]] = {}

    def _upward_ranks(self, wf: Workflow,
                      state: ExecutionState) -> dict[str, float]:
        if wf.wid in self._ranks:
            return self._ranks[wf.wid]
        devices = state.cluster.ids()
        q = wf.num_queries
        mean_cost = {
            sid: sum(wf.stages[sid].cost_on(d) for d in devices)
            / len(devices) * q
            for sid in wf.stages}
        # mean communication cost proxy
        beta = state.cluster.transfer_coef
        rank: dict[str, float] = {}
        for sid in reversed(wf.topo_order):
            st = wf.stages[sid]
            best_child = 0.0
            for ch in st.children:
                comm = beta * st.output_tokens * q / 1000.0
                best_child = max(best_child, comm + rank[ch])
            rank[sid] = mean_cost[sid] + best_child
        self._ranks[wf.wid] = rank
        return rank

    def plan(self, wf: Workflow, state: ExecutionState,
             ready: list[str]) -> list[Placement]:
        """Place ready stages in decreasing upward rank at EFT."""
        cm = CostModel(state)
        rank = self._upward_ranks(wf, state)
        q = wf.num_queries
        out = []
        free = dict(state.free_at)
        resident = dict(state.residency)
        for sid in sorted(ready, key=lambda s: -rank[s]):
            st = wf.stages[sid]
            devices = list(st.eligible) if st.eligible else \
                state.cluster.ids()

            def eft(d: int) -> float:
                dur = cm.base_cost(st, d, q)
                if resident.get(d) != st.model:
                    dur += state.profiles[st.model].switch_cost
                dur += cm.transfer_cost(wf, st, d, q)
                return max(free.get(d, 0.0), state.now) + dur

            best = min(devices, key=eft)
            free[best] = eft(best)
            resident[best] = st.model
            out.append(Placement(wf.wid, sid, (best,), (q,)))
        return out


# ---------------------------------------------------------------------------
# Helix-style: heterogeneity-aware earliest-finish placement
# ---------------------------------------------------------------------------


@register_policy("Helix")
class HelixPolicy(BasePolicy):
    """Heterogeneity-aware earliest-finish placement, heaviest
    stages first (Helix-style baseline)."""

    name = "Helix"

    def plan(self, wf: Workflow, state: ExecutionState,
             ready: list[str]) -> list[Placement]:
        """Place ready stages heaviest-first at earliest finish."""
        cm = CostModel(state)
        q = wf.num_queries
        out = []
        free = dict(state.free_at)
        resident = dict(state.residency)
        # heaviest stages first so slow devices don't capture them
        order = sorted(ready,
                       key=lambda s: -wf.stages[s].cost_on(-1))
        for sid in order:
            st = wf.stages[sid]
            devices = list(st.eligible) if st.eligible else \
                state.cluster.ids()

            def finish(d: int) -> float:
                dur = cm.base_cost(st, d, q)     # heterogeneity: /speed
                if resident.get(d) != st.model:
                    dur += state.profiles[st.model].switch_cost
                dur += cm.transfer_cost(wf, st, d, q)
                return max(free.get(d, 0.0), state.now) + dur

            best = min(devices, key=finish)
            free[best] = finish(best)
            resident[best] = st.model
            out.append(Placement(wf.wid, sid, (best,), (q,)))
        return out


# ---------------------------------------------------------------------------
# KVFlow-style: future-reuse-aware cache priority + greedy scheduling
# ---------------------------------------------------------------------------


@register_policy("KVFlow")
class KVFlowPolicy(BasePolicy):
    """Future-reuse-aware cache priority + greedy device scoring
    (KVFlow-style baseline)."""

    name = "KVFlow"

    def plan(self, wf: Workflow, state: ExecutionState,
             ready: list[str]) -> list[Placement]:
        """Place ready stages by cache-reuse priority and score."""
        cm = CostModel(state)
        q = wf.num_queries
        out = []
        free = dict(state.free_at)
        resident = dict(state.residency)

        def reuse_priority(sid: str) -> float:
            st = wf.stages[sid]
            pr = 0.0
            if st.prefix_group is not None and st.cache_reuse:
                pr += max(state.prefix_overlap(st, d, q)
                          for d in state.cluster.ids())
            # near-future steps of the same group raise retention value
            for ch in st.children:
                if wf.stages[ch].prefix_group == st.prefix_group \
                        and st.prefix_group is not None:
                    pr += 0.5
            return pr

        for sid in sorted(ready, key=lambda s: -reuse_priority(s)):
            st = wf.stages[sid]
            devices = list(st.eligible) if st.eligible else \
                state.cluster.ids()

            def kv_score(d: int) -> float:
                s = 0.0
                s += 2.0 * state.prefix_overlap(st, d, q) \
                    * cm.base_cost(st, d, q)
                if resident.get(d) == st.model:
                    s += state.profiles[st.model].switch_cost
                # partial transfer signal: parent colocation preference
                # only (no β-weighted cost)
                if st.parents:
                    s += 0.3 * state.parent_on_device(wf.wid, st, d)
                s -= max(free.get(d, 0.0), state.now) - state.now
                s -= cm.base_cost(st, d, q) * 0.1
                return s

            best = max(devices, key=kv_score)
            dur = cm.base_cost(st, best, q)
            if resident.get(best) != st.model:
                dur += state.profiles[st.model].switch_cost
            free[best] = max(free.get(best, 0.0), state.now) + dur
            resident[best] = st.model
            out.append(Placement(wf.wid, sid, (best,), (q,)))
        return out


# ---------------------------------------------------------------------------
# Halo-style: beam search over DAG assignments (coarse residency)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _BeamState:
    free: tuple[float, ...]
    resident: tuple[Optional[str], ...]
    assign: tuple[tuple[str, int], ...]
    fins: tuple[float, ...]          # finish time per assigned stage
    cost: float


@register_policy("Halo")
class HaloPolicy(BasePolicy):
    """Beam search over stage→device assignments in topological order.

    Residency is "coarse": a single average switch penalty, applied when
    the device's last model differs (Table 7 / Appendix B.1).  No
    transfer or prefix signals.
    """
    name = "Halo"

    def __init__(self, beam_width: int = 8):
        self.beam_width = beam_width
        self._plan_cache: dict[str, dict[str, int]] = {}

    def _search(self, wf: Workflow, state: ExecutionState) -> dict[str, int]:
        if wf.wid in self._plan_cache:
            return self._plan_cache[wf.wid]
        devices = state.cluster.ids()
        q = wf.num_queries
        avg_switch = (sum(p.switch_cost
                          for p in state.profiles.values())
                      / len(state.profiles))
        beam = [_BeamState(tuple(state.free_at[d] for d in devices),
                           tuple(state.residency[d] for d in devices),
                           (), (), 0.0)]
        stage_index = {sid: i for i, sid in enumerate(wf.topo_order)}
        for sid in wf.topo_order:
            st = wf.stages[sid]
            eligible = [devices.index(d) for d in
                        (st.eligible if st.eligible else devices)]
            nxt: list[_BeamState] = []
            for bs in beam:
                for j in eligible:
                    dur = st.cost_on(devices[j]) * q \
                        / state.cluster.devices[devices[j]].speed
                    if bs.resident[j] != st.model:
                        dur += avg_switch
                    # start after the device frees AND parents finish
                    start = bs.free[j]
                    for par in st.parents:
                        start = max(start, bs.fins[stage_index[par]])
                    fin = start + dur
                    free = list(bs.free)
                    free[j] = fin
                    res = list(bs.resident)
                    res[j] = st.model
                    nxt.append(_BeamState(
                        tuple(free), tuple(res),
                        bs.assign + ((sid, j),), bs.fins + (fin,),
                        max(bs.cost, fin)))
            nxt.sort(key=lambda b: (b.cost, sum(b.free)))
            beam = nxt[: self.beam_width]
        best = beam[0]
        plan = {sid: devices[j] for sid, j in best.assign}
        self._plan_cache[wf.wid] = plan
        return plan

    def plan(self, wf: Workflow, state: ExecutionState,
             ready: list[str]) -> list[Placement]:
        """Place ready stages per the cached beam-search plan."""
        plan = self._search(wf, state)
        return [Placement(wf.wid, sid, (plan[sid],), (wf.num_queries,))
                for sid in ready]
