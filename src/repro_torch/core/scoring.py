"""State-aware scoring: runtime score S(v,d|s) and horizon-aware
planner score Ψ(v,k,d|s,H)  (paper §3.3–3.4, Appendix A.3).

    S(v,d|s) = −λ_q C_wait − λ_s C_switch − λ_tr C_transfer
               + λ_c B_colo + λ_p B_prefix + λ_r B_parallel
               (+ λ_m B_same_model — the "same-model bonus", ablated
                separately from switch cost per Appendix C.3)

    Ψ(v,k,d|s,H) = quality_base + S-terms (+ marginal shard gain for
                   k>0) + Σ_{u ∈ Desc_H(v)} γ^{dist(u)} · tail(u, v, d)

The tail folds downstream demand into current-frontier candidates
without expanding future stages into solver variables (paper §3.3):
  * same-model continuation — placing v on d keeps m(v) resident where
    descendant u (same model) could continue, weighted by how scarce
    m(v)-residency currently is;
  * prefix affinity — placing v on d warms grp(v) state that matching
    descendants can reuse;
  * child transfer pressure — direct children inherit v's output.

Batched engine layout
---------------------
``Scorer.score_matrix`` no longer loops numpy expressions per ready
stage: it fills per-component matrices (base / switch / transfer /
prefix / locality / tail / bonuses, each [R, D]) and assembles Ψ and
EFT with one 2-D pass in ``planner_score``'s exact accumulation order,
so entries stay bit-identical to the scalar path.  Rows are grouped by
model (residency mask, scarcity, switch vector, bonuses shared) and by
(prefix-group, model) signature (warm-query gathers and overlap math
shared), and the discounted future tail is materialized from a cached
per-stage *term plan* — the static [K, D] payload of every descendant
term in scalar DFS order plus a flag marking scarcity-scaled terms —
then folded with K sequential 2-D adds.

``Scorer.rescore_matrix`` is the incremental twin: given the previous
wave's :class:`FrontierScores` it recomputes only what state changes
invalidated — rows of models whose residency footprint or frontier
sibling count changed, newly-ready rows, prefix columns whose warm
state moved — and reuses every other cached component bit-identically.
See the dirty-set protocol in :mod:`repro_torch.core.state`.

Every model-level constant the scorer folds (switch costs in the
switch/tail/bonus terms) is read from ``state.profiles``, and every
global scale from the cost model's ``CostParams`` — so a loaded
:class:`~repro_torch.core.calibration.CalibrationProfile` recalibrates both
score paths identically, and parity (matrix vs scalar, delta vs full)
holds under ANY fixed profile (``tests/test_calibration.py``).
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.costs import CostModel, cluster_arrays
from repro_torch.core.frontier_solver import NEG
from repro_torch.core.state import ExecutionState
from repro_torch.core.workflow import Stage, Workflow


@dataclasses.dataclass(frozen=True)
class ScoreParams:
    """Score-term weights λ and horizon knobs (paper Table 10 rows).

    ``sibling_factor`` scales the frontier-sibling demand term; note
    the sibling COUNT it multiplies is capped at cluster size inside
    the scorer (see :meth:`Scorer.future_tail`) — merged serving
    frontiers can queue dozens of same-model stages, and an unbounded
    linear term would drown every other signal and thrash residency.
    """

    lam_wait: float = 1.0          # λ_q
    lam_switch: float = 1.0        # λ_s
    lam_transfer: float = 1.0      # λ_tr
    lam_colo: float = 0.6          # λ_c
    lam_prefix: float = 1.5       # λ_p
    lam_parallel: float = 0.9      # λ_r
    lam_same_model: float = 0.5    # λ_m (same-model bonus)
    horizon: int = 4               # H (levels; 1 = frontier only)
    gamma: float = 0.6             # level discount
    sibling_factor: float = 0.4    # frontier-sibling demand folding
    bonus_factor: float = 0.4      # same-model bonus scale (of switch)
    margin_factor: float = 0.1     # wave regret margin (of mean base)
    specialize_factor: float = 0.15  # model-specialized device preference
    # ablation switches (Appendix C.3)
    enable_future: bool = True
    enable_locality: bool = True
    enable_same_model: bool = True
    enable_prefix: bool = True
    enable_shard: bool = True

    def scaled(self, *, state_mul: float = 1.0, locality_mul: float = 1.0,
               prefix_mul: float = 1.0) -> "ScoreParams":
        """Table 10 sensitivity: scale term groups."""
        return dataclasses.replace(
            self,
            lam_switch=self.lam_switch * state_mul,
            lam_same_model=self.lam_same_model * state_mul,
            lam_colo=self.lam_colo * locality_mul,
            lam_transfer=self.lam_transfer * locality_mul,
            lam_prefix=self.lam_prefix * prefix_mul,
        )


_AFFINITY_GENERATION = 0


def invalidate_affinity_cache() -> None:
    """Bump the generation key of the per-model device-affinity cache.

    ``_preferred_devices`` memoizes on ``(model, n_devices)`` — immutable
    facts for frozen clusters.  Code that redefines what those inputs
    mean (swapping the profile table, re-numbering devices in place)
    must call this so stale affinity tuples are never reused.
    """
    global _AFFINITY_GENERATION
    _AFFINITY_GENERATION += 1


@functools.lru_cache(maxsize=4096)
def _preferred_devices_keyed(model: str, n_devices: int, k: int,
                             generation: int) -> tuple[int, ...]:
    h = int(hashlib.sha256(model.encode()).hexdigest()[:8], 16)
    return tuple((h + i * 3) % n_devices for i in range(k))


def _preferred_devices(model: str, n_devices: int,
                       k: int = 2) -> tuple[int, ...]:
    """Stable per-model device affinity (hash-spread over the cluster).

    Memoized (the seed re-imported hashlib and re-hashed the model name
    for every candidate of every wave) and keyed on a generation counter
    so :func:`invalidate_affinity_cache` can force recomputation.
    """
    return _preferred_devices_keyed(model, n_devices, k,
                                    _AFFINITY_GENERATION)


@dataclasses.dataclass
class WaveComponents:
    """Per-wave component cache behind one :class:`FrontierScores`.

    Holds every additive term of Ψ/EFT as its own [R, D] matrix (in
    ``planner_score``'s accumulation order), the materialized tail term
    vectors [R, K, D] for cheap refolds, and the state snapshots
    (residency row, frontier model counts, topology generation) that
    the delta engine diffs to prove which rows/columns are still valid.
    """
    sids: list
    models: list
    sigs: list                      # (prefix_group, model) or None
    row_of: dict
    base: np.ndarray                # [R, D]
    switch: np.ndarray
    transfer: np.ndarray
    prefix: np.ndarray
    locality: np.ndarray
    tail: np.ndarray
    res_bonus: np.ndarray
    spec_bonus: np.ndarray
    elig: np.ndarray                # [R, D] bool
    tail_terms: np.ndarray          # [R, K, D] scar-folded term vectors
    shared_frac: np.ndarray         # [R]
    prefill_frac: np.ndarray        # [R]
    constrained: list
    max_slots: list
    n_terms: list
    # snapshots (validity certificates for the next delta wave)
    res_model: list
    counts: dict
    generation: int
    model_vecs: dict
    warm: dict = dataclasses.field(default_factory=dict)
    sig_groups: dict = dataclasses.field(default_factory=dict)
    # identity of the Workflow these tables were built from: a NEW
    # Workflow object reusing the same wid must never match (fresh
    # objects restart at generation 0, so the counter alone cannot
    # distinguish them)
    wf: object = None


@dataclasses.dataclass
class FrontierScores:
    """Full frontier × device score tables for one planning wave.

    ``raw[i, j]`` is the slot-0 planner score Ψ of ready stage i on
    device j (NEG where ineligible); ``eft`` the state-corrected stage
    durations (inf where ineligible); ``base`` the unmasked base costs
    (the wave margin is an all-pairs mean in the scalar path).  Shard
    slot weights are derived on demand from the cached EFT rows.
    ``comp`` carries the component cache that lets the next wave be
    delta-rescored instead of rebuilt.
    """
    ready: list[str]
    devices: list[int]
    raw: np.ndarray                # [R, D]
    eft: np.ndarray                # [R, D]
    base: np.ndarray               # [R, D]
    eligible: np.ndarray           # [R, D] bool
    max_slots: list[int]
    constrained: list[bool]        # row has an eligibility restriction
    wait: np.ndarray               # [D]
    pressure: float
    shard_overhead: float
    lam_parallel: float
    lam_wait: float
    comp: Optional[WaveComponents] = None
    built_full: bool = False           # full build vs delta rescore

    def shard_weights(self, i: int, slot: int,
                      solo_best: float) -> np.ndarray:
        """Ψ for shard slot ``slot`` ≥ 1 of ready stage ``i`` — the
        vectorized twin of the scalar ``planner_score`` shard branch."""
        eft = self.eft[i]
        completion_new = np.maximum(solo_best, eft) / (slot + 1)
        overhead = solo_best * self.shard_overhead
        gain = (solo_best / slot - completion_new - overhead) \
            * self.lam_parallel
        gain = gain - self.lam_wait * self.wait
        gain = gain - self.pressure
        if not self.constrained[i]:
            return gain
        return np.where(self.eligible[i], gain, NEG)

    def restrict(self, cols: Sequence[int]) -> "FrontierScores":
        """Column-sliced copy for a device-pool subproblem.

        ``cols`` are column *positions* into :attr:`devices` (not device
        ids).  Every per-device table is sliced to the pool's columns so
        downstream row building, shard-weight derivation (``solo_best``
        becomes pool-local, by design) and solving see only the pool's
        devices; rows, scalars and the eligibility flags carry over
        unchanged.  Fancy indexing copies, so the slice never aliases
        the cached full-axis tables, and slicing the full column set in
        order reproduces the originals bit-for-bit.  The component
        cache is deliberately dropped (``comp=None``) — it is keyed to
        the full device axis and must never seed a delta rescore from a
        pool-shaped table.
        """
        idx = np.asarray(list(cols), dtype=int)
        return dataclasses.replace(
            self,
            devices=[self.devices[j] for j in idx],
            raw=self.raw[:, idx],
            eft=self.eft[:, idx],
            base=self.base[:, idx],
            eligible=self.eligible[:, idx],
            wait=self.wait[idx],
            comp=None,
        )


class _WaveCtx:
    """Per-wave scratch: cluster vectors, state gathers, lazy caches."""
    __slots__ = ("ids", "pos", "n_dev", "speeds", "tscale", "wait",
                 "res_model", "counts", "zeros", "model_vecs",
                 "warm_cache")

    def __init__(self, state: ExecutionState, counts: dict):
        cluster = state.cluster
        self.ids = cluster.ids()
        self.pos = {d: j for j, d in enumerate(self.ids)}
        self.n_dev = len(self.ids)
        self.speeds, self.tscale = cluster_arrays(cluster)
        free = np.array([state.free_at.get(d, 0.0) for d in self.ids])
        self.wait = np.maximum(0.0, free - state.now)
        self.res_model = [state.residency.get(d) for d in self.ids]
        self.counts = counts
        self.zeros = np.zeros(self.n_dev)
        self.model_vecs: dict = {}
        self.warm_cache: dict = {}


class Scorer:
    """State-aware scoring engine: S, Ψ/EFT, and their batched twins.

    One scorer serves many planning sessions: per-workflow topology
    caches (base-cost rows, tail term plans) persist across calls,
    keyed by workflow identity + generation, and are dropped via
    :meth:`forget_workflow` when a served workflow retires.  The
    scalar entry points (:meth:`runtime_score`, :meth:`planner_score`,
    :meth:`corrected_eft`) are the bit-parity reference for the
    batched ones (:meth:`score_matrix`, :meth:`rescore_matrix`).
    Call :meth:`set_frontier` (or :meth:`set_frontier_shared`) before
    scoring a wave — sibling demand and device pressure are
    frontier-wide inputs.
    """

    def __init__(self, state: ExecutionState, cost_model: CostModel,
                 params: Optional[ScoreParams] = None):
        self.state = state
        self.cm = cost_model
        self.p = params or ScoreParams()
        self._frontier_models: dict[str, int] = {}
        self._device_pressure_cost = 0.0
        # per-wid cache shards: O(1) eviction on workflow retirement
        self._cost_vecs: dict[str, dict] = {}
        self._tail_plans: dict[str, dict] = {}
        # (workflow object, generation) the caches were derived from
        self._wf_seen: dict[str, tuple] = {}
        self._cluster = state.cluster

    def rebind(self, state: ExecutionState) -> None:
        """Point this scorer (and its cost model) at another state view
        — e.g. a fresh :class:`PlanningOverlay` — while keeping the
        per-workflow topology caches warm across planning sessions."""
        self.state = state
        self.cm.state = state

    def forget_workflow(self, wid: str) -> None:
        """Drop per-workflow caches (serving: workflow retired)."""
        self._cost_vecs.pop(wid, None)
        self._tail_plans.pop(wid, None)
        self._wf_seen.pop(wid, None)

    def _check_generation(self, wf: Workflow) -> None:
        """Drop caches whose provenance is gone: a different cluster
        (base-cost rows fold in device speeds, which the wid keys
        cannot see), a NEW workflow object reusing a wid, or a bumped
        topology generation."""
        if self.state.cluster is not self._cluster:
            self._cost_vecs.clear()
            self._tail_plans.clear()
            self._wf_seen.clear()
            self._cluster = self.state.cluster
        seen = self._wf_seen.get(wf.wid)
        if seen is not None and (seen[0] is not wf
                                 or seen[1] != wf.generation):
            self.forget_workflow(wf.wid)
        self._wf_seen[wf.wid] = (wf, wf.generation)

    def set_frontier(self, wf: Workflow, ready: Sequence[str]) -> None:
        """Record frontier model demand + device pressure."""
        self._check_generation(wf)
        counts: dict[str, int] = {}
        for sid in ready:
            m = wf.stages[sid].model
            counts[m] = counts.get(m, 0) + 1
        self._frontier_models = counts
        self._device_pressure_cost = self._pressure(
            [(wf, sid) for sid in ready])

    def set_frontier_shared(self, wf: Workflow, ready: Sequence[str],
                            counts: dict[str, int],
                            pressure: float) -> None:
        """Shared-frontier variant: model demand and device pressure are
        merged across every in-flight workflow by the caller (the
        multi-workflow planner), so cross-DAG siblings raise residency
        demand exactly like same-DAG siblings do."""
        self._check_generation(wf)
        self._frontier_models = dict(counts)
        self._device_pressure_cost = pressure

    def _pressure(self, entries: Sequence[tuple]) -> float:
        """Displacement pressure for a (possibly merged) frontier."""
        n_dev = self.state.cluster.n
        ids = self.state.cluster.ids()
        speeds, _ = cluster_arrays(self.state.cluster)
        total = 0.0
        for wf, sid in entries:
            total += self._base_row_sum(wf, wf.stages[sid], ids, speeds,
                                        wf.num_queries)
        mean_base = total / max(len(entries) * n_dev, 1)
        # displacement only bites once primaries saturate the devices
        pressure = min(1.0, max(0.0, (len(entries) - 0.75 * n_dev)
                                / (0.5 * n_dev)))
        return mean_base * pressure

    # ------------------------------------------------------------------
    def runtime_score(self, wf: Workflow, stage: Stage,
                      device: int) -> float:
        """S(v, d | s_t)."""
        p = self.p
        q = wf.num_queries
        s = 0.0
        s -= p.lam_wait * self.state.wait_time(device)
        s -= p.lam_switch * self.cm.switch_cost(stage, device)
        if p.enable_locality:
            s -= p.lam_transfer * self.cm.transfer_cost(wf, stage, device, q)
            if stage.parents:
                colo = (self.state.parent_on_device(wf.wid, stage, device)
                        / len(stage.parents))
                s += p.lam_colo * colo * self.cm.base_cost(stage, device, q) \
                    * 0.25
        if p.enable_prefix:
            s += p.lam_prefix * self.cm.prefix_benefit(stage, device, q)
        if p.enable_same_model and self.state.is_resident(stage.model,
                                                          device):
            # small tie-breaker only: residency's real value is carried
            # by C_switch (immediate) and the horizon tail (future)
            prof = self.state.profiles[stage.model]
            s += p.lam_same_model * prof.switch_cost * p.bonus_factor
        return s

    # ------------------------------------------------------------------
    def _descendants_within(self, wf: Workflow, sid: str,
                            depth: int) -> list[tuple[str, int]]:
        out: list[tuple[str, int]] = []
        frontier = [(sid, 0)]
        seen = {sid}
        while frontier:
            cur, d = frontier.pop()
            if d >= depth:
                continue
            for ch in wf.stages[cur].children:
                if ch in seen:
                    continue
                seen.add(ch)
                out.append((ch, d + 1))
                frontier.append((ch, d + 1))
        return out

    def future_tail(self, wf: Workflow, stage: Stage, device: int) -> float:
        """Discounted downstream (and frontier-sibling) state-preservation
        value of placing v on d."""
        p = self.p
        if not p.enable_future or p.horizon <= 1:
            return 0.0
        q = wf.num_queries
        tail = 0.0
        resident_count = sum(
            1 for d2 in self.state.cluster.ids()
            if d2 != device and self.state.is_resident(stage.model, d2))
        scarcity = 1.0 / (1.0 + resident_count)
        # frontier-sibling demand: creating a NEW m(v) residency is worth
        # a share of the switch cost the queued same-model siblings would
        # otherwise pay (or wait out), with diminishing returns as more
        # devices already host the model.
        if not self.state.is_resident(stage.model, device):
            siblings = self._frontier_models.get(stage.model, 1) - 1
            # bounded by cluster size: queued siblings beyond the device
            # count add no marginal residency value within one wave (the
            # merged serving frontier can queue dozens of same-model
            # stages; an unbounded linear term would drown every other
            # signal and thrash residency)
            siblings = min(siblings, self.state.cluster.n)
            if siblings > 0:
                prof = self.state.profiles[stage.model]
                tail += (p.sibling_factor * siblings
                         * prof.switch_cost * scarcity)
        for uid, dist in self._descendants_within(wf, stage.sid,
                                                  p.horizon - 1):
            u = wf.stages[uid]
            g = p.gamma ** dist
            if u.model == stage.model:
                prof = self.state.profiles[u.model]
                tail += (g * 0.5 * p.lam_switch * prof.switch_cost
                         * scarcity)
            if (p.enable_prefix and stage.prefix_group is not None
                    and u.prefix_group == stage.prefix_group
                    and u.cache_reuse and u.model == stage.model):
                base_u = self.cm.base_cost(u, device, q)
                tail += (g * p.lam_prefix * base_u * u.prefill_fraction
                         * self.cm.p.prefix_saving)
            if p.enable_locality and dist == 1:
                # direct child inherits v's output: colocating later saves
                # β·σ(v,u); reward keeping that option cheap on d
                sigma_k = stage.output_tokens * q * u.comm_weight / 1000.0
                tail += g * p.lam_transfer * \
                    self.state.cluster.transfer_coef * sigma_k * 0.5
        return tail

    def corrected_eft(self, wf: Workflow, stage: Stage,
                      device: int) -> float:
        """State-corrected stage duration on d (no wait): ĉ(v,d,s)."""
        bd = self.cm.breakdown(wf, stage, device, wf.num_queries)
        return max(1e-6, bd.total)

    # ------------------------------------------------------------------
    def planner_score(self, wf: Workflow, stage: Stage, slot: int,
                      device: int, quality_base: float,
                      solo_best: float = 0.0) -> float:
        """Ψ(v, k, d | s_t, H).

        Slot 0 scores are an estimated-finish-time value in seconds:
        −(wait + state-corrected cost) plus the discounted future tail,
        so immediate efficiency and future-state quality share one unit
        and the planner's wave competition approximates completion-time
        impact (§3.2's  −C_imm + γ·V_future  decomposition).
        """
        p = self.p
        q = wf.num_queries
        if slot == 0:
            bd = self.cm.breakdown(wf, stage, device, q)
            eft = p.lam_wait * self.state.wait_time(device)
            eft += bd.base
            eft += p.lam_switch * bd.switch
            if p.enable_locality:
                eft += p.lam_transfer * bd.transfer
                eft -= p.lam_colo * bd.locality_benefit
            if p.enable_prefix:
                eft -= p.lam_prefix * bd.prefix_benefit
            psi = quality_base - eft
            psi += self.future_tail(wf, stage, device)
            if p.enable_same_model and self.state.is_resident(
                    stage.model, device):
                prof = self.state.profiles[stage.model]
                psi += p.lam_same_model * prof.switch_cost \
                    * p.bonus_factor
            # model-specialized placement preference (deep heterogeneous
            # workflows, §4.1 implementation summary): a stable per-model
            # device affinity that damps residency churn across waves.
            if p.specialize_factor and p.enable_same_model:
                prof = self.state.profiles[stage.model]
                if device in _preferred_devices(
                        stage.model, self.state.cluster.n):
                    psi += p.specialize_factor * prof.switch_cost
            return psi
        # extra shard slot: marginal completion-time gain minus occupancy.
        # Under device pressure (more ready stages than devices) taking a
        # device for a shard defers another stage's primary — charge that
        # opportunity cost so bounded shard execution activates only when
        # devices would otherwise idle (paper: "enables bounded
        # multi-device shard execution when beneficial").
        if not p.enable_shard or slot >= stage.max_shards:
            return float("-inf")
        # completion with this extra shard = the slowest partition; the
        # candidate device contributes its own STATE-CORRECTED per-query
        # cost (a cold/unswitched device can make sharding a net loss
        # even when the primary runs warm).
        corrected_d = self.corrected_eft(wf, stage, device)
        solo = solo_best if solo_best > 0 else corrected_d
        completion_new = max(solo, corrected_d) / (slot + 1)
        overhead = solo * self.cm.p.shard_overhead
        gain = (solo / slot - completion_new - overhead) * p.lam_parallel
        gain -= p.lam_wait * self.state.wait_time(device)
        gain -= self._device_pressure_cost
        return gain

    # ------------------------------------------------------------------
    # vectorized frontier engine
    # ------------------------------------------------------------------
    def _stage_cost_vec(self, wf: Workflow, stage: Stage,
                        ids: list[int]) -> np.ndarray:
        shard = self._cost_vecs.setdefault(wf.wid, {})
        v = shard.get(stage.sid)
        if v is None:
            v = np.array([stage.cost_on(d) for d in ids], dtype=float)
            shard[stage.sid] = v
        return v

    def _base_row(self, wf: Workflow, stage: Stage, ids: list[int],
                  speeds: np.ndarray, q: int) -> np.ndarray:
        """Cached per-device base-cost row (state-independent)."""
        shard = self._cost_vecs.setdefault(wf.wid, {})
        key = (stage.sid, "b")
        v = shard.get(key)
        if v is None:
            v = self._stage_cost_vec(wf, stage, ids) * q / speeds
            shard[key] = v
        return v

    def _base_row_sum(self, wf: Workflow, stage: Stage, ids: list[int],
                      speeds: np.ndarray, q: int) -> float:
        shard = self._cost_vecs.setdefault(wf.wid, {})
        key = (stage.sid, "bs")
        v = shard.get(key)
        if v is None:
            v = float(self._base_row(wf, stage, ids, speeds, q).sum())
            shard[key] = v
        return v

    def _model_vec(self, ctx: _WaveCtx, m: str) -> dict:
        """Per-model shared vectors (residency mask, scarcity, switch
        cost row, bonuses) for the current residency snapshot."""
        mv = ctx.model_vecs.get(m)
        if mv is not None:
            return mv
        p = self.p
        mask = np.array([rm == m for rm in ctx.res_model])
        mask_i = mask.astype(np.int64)
        scar = 1.0 / (1.0 + (int(mask_i.sum()) - mask_i))
        prof = self.state.profiles[m]
        mv = {
            "mask": mask,
            "scar": scar,
            "prof": prof,
            "switch": np.where(mask, 0.0,
                               prof.switch_cost * self.cm.p.switch_scale),
        }
        if p.enable_same_model:
            mv["res_bonus"] = np.where(
                mask, p.lam_same_model * prof.switch_cost * p.bonus_factor,
                0.0)
            if p.specialize_factor:
                pref = set(_preferred_devices(m, ctx.n_dev))
                mv["spec_bonus"] = np.where(
                    np.array([d in pref for d in ctx.ids]),
                    p.specialize_factor * prof.switch_cost, 0.0)
        ctx.model_vecs[m] = mv
        return mv

    def _gather_warm(self, ctx: _WaveCtx, sig: tuple) -> np.ndarray:
        """Warm-query vector for one (prefix-group, model) signature."""
        wq = ctx.warm_cache.get(sig)
        if wq is None:
            group, model = sig
            vals = []
            for d in ctx.ids:
                e = self.state.prefix.get(d, {}).get(group)
                vals.append(e.warm_queries
                            if e is not None and e.model == model else 0)
            wq = np.array(vals, dtype=np.int64)
            ctx.warm_cache[sig] = wq
        return wq

    def _tail_plan(self, wf: Workflow, sid: str,
                   ctx: _WaveCtx) -> tuple[np.ndarray, np.ndarray]:
        """Static tail term plan for one stage: ([K, D] payload rows in
        scalar DFS order, [K] bool flags marking scarcity-scaled terms).
        State-independent given topology + params, so cached per stage
        until the workflow's generation changes."""
        shard = self._tail_plans.setdefault(wf.wid, {})
        plan = shard.get(sid)
        if plan is not None and plan[0].shape[1] == ctx.n_dev:
            return plan
        p = self.p
        cm = self.cm
        s = wf.stages[sid]
        m = s.model
        prof = self.state.profiles[m]
        cluster = self.state.cluster
        q = wf.num_queries
        rows: list[np.ndarray] = []
        flags: list[bool] = []
        for uid, dist in wf.descendants_within(sid, p.horizon - 1):
            u = wf.stages[uid]
            g = p.gamma ** dist
            if u.model == m:
                rows.append(np.full(
                    ctx.n_dev, g * 0.5 * p.lam_switch * prof.switch_cost))
                flags.append(True)
            if (p.enable_prefix and s.prefix_group is not None
                    and u.prefix_group == s.prefix_group
                    and u.cache_reuse and u.model == m):
                base_u = self._base_row(wf, u, ctx.ids, ctx.speeds, q)
                rows.append(g * p.lam_prefix * base_u
                            * u.prefill_fraction * cm.p.prefix_saving)
                flags.append(False)
            if p.enable_locality and dist == 1:
                sigma_k = (s.output_tokens * q * u.comm_weight / 1000.0)
                rows.append(np.full(
                    ctx.n_dev, g * p.lam_transfer
                    * cluster.transfer_coef * sigma_k * 0.5))
                flags.append(False)
        plan = (np.array(rows) if rows else np.zeros((0, ctx.n_dev)),
                np.array(flags, dtype=bool))
        shard[sid] = plan
        return plan

    def _alloc(self, R: int, K: int, ctx: _WaveCtx) -> WaveComponents:
        n = ctx.n_dev
        return WaveComponents(
            sids=[None] * R, models=[None] * R, sigs=[None] * R,
            row_of={},
            base=np.empty((R, n)), switch=np.empty((R, n)),
            transfer=np.zeros((R, n)), prefix=np.zeros((R, n)),
            locality=np.zeros((R, n)), tail=np.zeros((R, n)),
            res_bonus=np.zeros((R, n)), spec_bonus=np.zeros((R, n)),
            elig=np.ones((R, n), dtype=bool),
            tail_terms=np.zeros((R, K, n)),
            shared_frac=np.zeros(R), prefill_frac=np.zeros(R),
            constrained=[False] * R, max_slots=[1] * R, n_terms=[0] * R,
            res_model=[], counts={}, generation=-1, model_vecs={})

    def _sib_row(self, ctx: _WaveCtx, mv: dict, m: str) -> np.ndarray:
        """Frontier-sibling tail seed for one row's model (sibling
        count bounded by cluster size, as in ``future_tail``)."""
        p = self.p
        siblings = min(ctx.counts.get(m, 1) - 1, ctx.n_dev)
        if siblings > 0:
            coef = p.sibling_factor * siblings * mv["prof"].switch_cost
            return np.where(~mv["mask"], coef * mv["scar"], 0.0)
        return ctx.zeros

    def _materialize_terms(self, wf: Workflow, sid: str, ctx: _WaveCtx,
                           mv: dict, comp: WaveComponents,
                           i: int) -> None:
        static, flags = self._tail_plan(wf, sid, ctx)
        k_i = static.shape[0]
        comp.n_terms[i] = k_i
        if k_i:
            fac = np.where(flags[:, None], mv["scar"][None, :], 1.0)
            comp.tail_terms[i, :k_i] = static * fac

    def _fold_tails(self, comp: WaveComponents, idxs: list[int],
                    sib_rows: list[np.ndarray]) -> None:
        """Sequential left fold (scalar accumulation order) of the
        cached term vectors on top of each row's sibling seed."""
        if not idxs:
            return
        ia = np.array(idxs)
        block = np.stack(sib_rows)
        terms = comp.tail_terms[ia]
        for k in range(terms.shape[1]):
            block = block + terms[:, k, :]
        comp.tail[ia] = block

    def _prefix_rows(self, wf: Workflow, comp: WaveComponents,
                     ctx: _WaveCtx, groups: dict) -> None:
        """Signature-batched prefix benefit: one 2-D pass per
        (prefix-group, model) signature."""
        cm = self.cm
        q = wf.num_queries
        for sig, grp in groups.items():
            wq = self._gather_warm(ctx, sig)
            ovb = np.minimum(1.0, wq / max(q, 1))
            gi = np.array(grp)
            ov = ovb[None, :] * comp.shared_frac[gi][:, None]
            base_g = comp.base[gi]
            comp.prefix[gi] = np.where(
                ov > 0.0,
                base_g * comp.prefill_frac[gi][:, None]
                * cm.p.prefix_saving * ov * cm.p.prefix_scale,
                0.0)

    def _fill_rows(self, wf: Workflow, rows: list[tuple[int, str]],
                   comp: WaveComponents, ctx: _WaveCtx) -> None:
        """Compute every component for the given (row index, sid) pairs
        over all devices — the full-build path, also used for
        newly-ready rows during delta rescoring."""
        p = self.p
        cm = self.cm
        state = self.state
        cluster = state.cluster
        q = wf.num_queries
        n_dev = ctx.n_dev
        pos = ctx.pos
        tscale = ctx.tscale
        future_on = p.enable_future and p.horizon > 1
        sig_groups: dict[tuple, list[int]] = {}
        tail_idx: list[int] = []
        sib_rows: list[np.ndarray] = []
        for i, sid in rows:
            s = wf.stages[sid]
            m = s.model
            mv = self._model_vec(ctx, m)
            comp.sids[i] = sid
            comp.models[i] = m
            comp.shared_frac[i] = s.shared_fraction
            comp.prefill_frac[i] = s.prefill_fraction
            comp.base[i] = self._base_row(wf, s, ctx.ids, ctx.speeds, q)
            comp.switch[i] = mv["switch"]
            if p.enable_same_model:
                comp.res_bonus[i] = mv["res_bonus"]
                if p.specialize_factor:
                    comp.spec_bonus[i] = mv["spec_bonus"]
            if s.parents:
                transfer = np.zeros(n_dev)
                for par in s.parents:
                    locs = state.output_loc.get((wf.wid, par), ())
                    if not locs:
                        continue
                    src = locs[0]
                    parent = wf.stages[par]
                    sigma_k = (parent.output_tokens * q
                               * s.comm_weight / 1000.0)
                    contrib = (cluster.transfer_coef
                               * tscale[pos[src]] * tscale) * sigma_k
                    local = np.zeros(n_dev, dtype=bool)
                    for d in locs:
                        if d in pos:
                            local[pos[d]] = True
                    transfer = transfer + np.where(local, 0.0, contrib)
                comp.transfer[i] = transfer * cm.p.transfer_scale
                cnt = np.zeros(n_dev)
                for par in s.parents:
                    for d in state.output_loc.get((wf.wid, par), ()):
                        if d in pos:
                            cnt[pos[d]] += 1
                frac = cnt / len(s.parents)
                comp.locality[i] = comp.base[i] * cm.p.locality_saving \
                    * frac
            else:
                comp.transfer[i] = 0.0
                comp.locality[i] = 0.0
            if s.cache_reuse and s.prefix_group is not None:
                sig = (s.prefix_group, s.model)
                comp.sigs[i] = sig
                sig_groups.setdefault(sig, []).append(i)
            else:
                comp.sigs[i] = None
                comp.prefix[i] = 0.0
            if s.eligible:
                comp.elig[i] = np.array(
                    [d in set(s.eligible) for d in ctx.ids])
                comp.constrained[i] = True
            else:
                comp.elig[i] = True
                comp.constrained[i] = False
            comp.max_slots[i] = s.max_shards if p.enable_shard else 1
            if future_on:
                self._materialize_terms(wf, sid, ctx, mv, comp, i)
                tail_idx.append(i)
                sib_rows.append(self._sib_row(ctx, mv, m))
            else:
                comp.tail[i] = 0.0
        self._prefix_rows(wf, comp, ctx, sig_groups)
        self._fold_tails(comp, tail_idx, sib_rows)

    def _assemble(self, comp: WaveComponents,
                  wait: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """One 2-D pass reproducing ``planner_score``'s exact term
        order, so every entry is bit-identical to the scalar path."""
        p = self.p
        wait_term = p.lam_wait * wait
        eft = wait_term[None, :] + comp.base
        eft = eft + p.lam_switch * comp.switch
        if p.enable_locality:
            eft = eft + p.lam_transfer * comp.transfer
            eft = eft - p.lam_colo * comp.locality
        if p.enable_prefix:
            eft = eft - p.lam_prefix * comp.prefix
        psi = 0.0 - eft
        psi = psi + comp.tail
        if p.enable_same_model:
            psi = psi + comp.res_bonus
            if p.specialize_factor:
                psi = psi + comp.spec_bonus
        total = comp.base + comp.switch + comp.transfer - comp.prefix \
            - comp.locality - 0.0
        eft_total = np.maximum(1e-6, total)
        raw = np.where(comp.elig, psi, NEG)
        eftm = np.where(comp.elig, eft_total, np.inf)
        return raw, eftm

    def _finalize(self, comp: WaveComponents, ctx: _WaveCtx,
                  built_full: bool = False) -> FrontierScores:
        if len(comp.row_of) != len(comp.sids):
            comp.row_of = {sid: i for i, sid in enumerate(comp.sids)}
            groups: dict = {}
            for i, sig in enumerate(comp.sigs):
                if sig is not None:
                    groups.setdefault(sig, []).append(i)
            comp.sig_groups = groups
        comp.res_model = list(ctx.res_model)
        comp.counts = dict(ctx.counts)
        comp.model_vecs = ctx.model_vecs
        comp.warm = dict(ctx.warm_cache)
        raw, eftm = self._assemble(comp, ctx.wait)
        return FrontierScores(
            ready=list(comp.sids), devices=ctx.ids, raw=raw, eft=eftm,
            base=comp.base, eligible=comp.elig,
            max_slots=list(comp.max_slots),
            constrained=list(comp.constrained), wait=ctx.wait,
            pressure=self._device_pressure_cost,
            shard_overhead=self.cm.p.shard_overhead,
            lam_parallel=self.p.lam_parallel, lam_wait=self.p.lam_wait,
            comp=comp, built_full=built_full)

    def _plan_k(self, wf: Workflow, ready: Sequence[str],
                ctx: _WaveCtx) -> int:
        if not (self.p.enable_future and self.p.horizon > 1):
            return 0
        k = 0
        for sid in ready:
            k = max(k, self._tail_plan(wf, sid, ctx)[0].shape[0])
        return k

    def score_matrix(self, wf: Workflow,
                     ready: Sequence[str]) -> FrontierScores:
        """Batched Ψ/EFT tables for the whole ready frontier.

        Computes, with signature-grouped 2-D numpy passes, exactly what
        ``planner_score(slot=0)`` + ``corrected_eft`` compute per
        (stage, device) pair — same term order, so results are
        bit-identical to the scalar path.  Call ``set_frontier`` first
        (as the planner does).
        """
        self._check_generation(wf)
        ctx = _WaveCtx(self.state, dict(self._frontier_models))
        comp = self._alloc(len(ready), self._plan_k(wf, ready, ctx), ctx)
        comp.generation = wf.generation
        comp.wf = wf
        self._fill_rows(wf, list(enumerate(ready)), comp, ctx)
        return self._finalize(comp, ctx, built_full=True)

    def _warm_entry(self, sig: tuple, device: int) -> int:
        group, model = sig
        e = self.state.prefix.get(device, {}).get(group)
        return e.warm_queries if e is not None and e.model == model else 0

    def _patch_warm(self, comp_p: WaveComponents, sigs: set,
                    dirty_pos: Optional[list[int]],
                    ctx: _WaveCtx) -> set:
        """Seed ``ctx.warm_cache`` for every carried signature and
        return the signatures whose warm vector moved.

        With a claimed dirty-device list, only those columns are
        re-read (the dirty-set protocol guarantees warm-prefix state is
        unchanged elsewhere).  With ``dirty_pos=None`` — no
        single-consumer claim available — each signature's vector is
        re-gathered in full and diffed against the snapshot, so
        correctness never depends on who drained the marks."""
        changed: set = set()
        for sig in sigs:
            wq = comp_p.warm.get(sig)
            if wq is None:                 # never gathered before
                changed.add(sig)
                self._gather_warm(ctx, sig)
                continue
            if dirty_pos is None:
                fresh = self._gather_warm(ctx, sig)
                if not np.array_equal(fresh, wq):
                    changed.add(sig)
                continue
            patched = None
            for j in dirty_pos:
                val = self._warm_entry(sig, ctx.ids[j])
                if val != wq[j]:
                    if patched is None:
                        patched = wq.copy()
                    patched[j] = val
            if patched is not None:
                changed.add(sig)
                wq = patched
            ctx.warm_cache[sig] = wq
        return changed

    def _refresh_dirty_rows(self, wf: Workflow, comp: WaveComponents,
                            ctx: _WaveCtx, rows: Sequence[int],
                            res_dirty: set, sib_dirty: set) -> None:
        """Re-derive per-model components for rows whose model's
        residency footprint or frontier sibling count changed."""
        p = self.p
        future_on = p.enable_future and p.horizon > 1
        refold_idx: list[int] = []
        sib_rows: list[np.ndarray] = []
        for i in rows:
            m = comp.models[i]
            if m in res_dirty:
                mv = self._model_vec(ctx, m)
                comp.switch[i] = mv["switch"]
                if p.enable_same_model:
                    comp.res_bonus[i] = mv["res_bonus"]
                    if p.specialize_factor:
                        comp.spec_bonus[i] = mv["spec_bonus"]
                if future_on:
                    self._materialize_terms(wf, comp.sids[i], ctx, mv,
                                            comp, i)
            if future_on and (m in res_dirty or m in sib_dirty):
                refold_idx.append(i)
                sib_rows.append(self._sib_row(
                    ctx, self._model_vec(ctx, m), m))
        self._fold_tails(comp, refold_idx, sib_rows)

    def rescore_matrix(self, wf: Workflow, ready: Sequence[str],
                       prev: Optional[FrontierScores] = None,
                       consume: bool = True,
                       dirty: Optional[set] = None) -> FrontierScores:
        """Incremental twin of :meth:`score_matrix`.

        Reuses the previous wave's component cache and recomputes only
        invalidated entries: rows of models whose residency footprint
        changed (mask/scarcity/switch vectors stale), rows of models
        whose frontier sibling count changed (tail seed stale — refolded
        from cached term vectors), newly-ready rows (full build), and
        prefix signatures whose warm state moved on a dirty device.
        Wait times enter only at assembly, so clock advancement never
        invalidates cached components.  Falls back to the full build
        when there is no usable previous wave.

        With ``consume=True`` (default) ``prev`` is CONSUMED: when the
        ready frontier is unchanged its component cache is recycled in
        place into the returned object, so never rescore twice from the
        same ``prev``.  Pass ``consume=False`` to keep ``prev`` intact
        (the planner does this when chaining intra-session waves off the
        preserved cross-session snapshot).  ``dirty`` is a claimed
        dirty-device set from a single-consumer ``drain_dirty()`` —
        when the caller can guarantee every state mutation since
        ``prev`` is marked in it (the planner's own intra-session
        waves), warm-prefix columns are patched only at those devices;
        a caller rescoring SEVERAL workflows for one wave must drain
        once and pass the same set to every call.  Without it
        (``dirty=None``), warm vectors are re-gathered in full and
        snapshot-diffed, so correctness never rests on mark ownership.
        Bit-identical to a fresh ``score_matrix`` call by construction;
        enforced by ``tests/test_delta_rescoring.py``.
        """
        self._check_generation(wf)
        comp_p = prev.comp if prev is not None else None
        if (comp_p is None or comp_p.wf is not wf
                or comp_p.generation != wf.generation
                or prev.devices != self.state.cluster.ids()):
            return self.score_matrix(wf, ready)
        p = self.p
        ctx = _WaveCtx(self.state, dict(self._frontier_models))
        dirty_pos = (None if dirty is None
                     else [ctx.pos[d] for d in dirty if d in ctx.pos])
        res_dirty: set[str] = set()
        for rm_old, rm_new in zip(comp_p.res_model, ctx.res_model):
            if rm_old != rm_new:
                if rm_old is not None:
                    res_dirty.add(rm_old)
                if rm_new is not None:
                    res_dirty.add(rm_new)
        for m, mv in comp_p.model_vecs.items():
            if m not in res_dirty:
                ctx.model_vecs[m] = mv

        if consume and list(ready) == comp_p.sids:
            # steady-state fast path: same frontier, recycle in place
            comp = comp_p
            sib_dirty = {m for m in set(comp.models)
                         if ctx.counts.get(m, 0)
                         != comp_p.counts.get(m, 0)}
            self._refresh_dirty_rows(wf, comp, ctx, range(len(ready)),
                                     res_dirty, sib_dirty)
            changed = self._patch_warm(comp_p, set(comp.sig_groups),
                                       dirty_pos, ctx)
            if changed:
                self._prefix_rows(wf, comp, ctx, {
                    sig: comp.sig_groups[sig] for sig in changed})
            return self._finalize(comp, ctx)

        new_rows: list[int] = []
        carried: list[tuple[int, int]] = []
        for i, sid in enumerate(ready):
            j = comp_p.row_of.get(sid)
            if j is None:
                new_rows.append(i)
            else:
                carried.append((i, j))
        comp = self._alloc(len(ready), self._plan_k(wf, ready, ctx), ctx)
        comp.generation = wf.generation
        comp.wf = wf
        if carried:
            inew = np.array([i for i, _ in carried])
            iold = np.array([j for _, j in carried])
            for name in ("base", "switch", "transfer", "prefix",
                         "locality", "tail", "res_bonus", "spec_bonus",
                         "elig", "shared_frac", "prefill_frac"):
                getattr(comp, name)[inew] = getattr(comp_p, name)[iold]
            kcopy = min(comp.tail_terms.shape[1],
                        comp_p.tail_terms.shape[1])
            if kcopy:
                comp.tail_terms[inew, :kcopy] = \
                    comp_p.tail_terms[iold, :kcopy]
            for i, j in carried:
                comp.sids[i] = comp_p.sids[j]
                comp.models[i] = comp_p.models[j]
                comp.sigs[i] = comp_p.sigs[j]
                comp.constrained[i] = comp_p.constrained[j]
                comp.max_slots[i] = comp_p.max_slots[j]
                comp.n_terms[i] = comp_p.n_terms[j]
        # warm state first, so new-row fills see patched gathers
        carried_sigs = {comp.sigs[i] for i, _ in carried
                        if comp.sigs[i] is not None}
        changed = self._patch_warm(comp_p, carried_sigs, dirty_pos, ctx)
        if new_rows:
            self._fill_rows(wf, [(i, ready[i]) for i in new_rows],
                            comp, ctx)
        sib_dirty = {m for m in {comp.models[i] for i, _ in carried}
                     if ctx.counts.get(m, 0) != comp_p.counts.get(m, 0)}
        self._refresh_dirty_rows(wf, comp, ctx,
                                 [i for i, _ in carried],
                                 res_dirty, sib_dirty)
        if changed:
            groups: dict[tuple, list[int]] = {}
            for i, _ in carried:
                if comp.sigs[i] in changed:
                    groups.setdefault(comp.sigs[i], []).append(i)
            self._prefix_rows(wf, comp, ctx, groups)
        return self._finalize(comp, ctx)
