"""FATE frontier planner: builds the frontier ILP from horizon-aware
scores, solves it exactly, and materializes shard-slot placements
(paper §3.3, Appendix A.2).

Two score-generation paths feed the same exact solver:

* the incremental vectorized engine (default) — the first wave of a
  planning session calls ``Scorer.score_matrix`` (signature-batched
  2-D build); every later wave — and every later ``plan()`` call for
  the same workflow — calls ``Scorer.rescore_matrix``, which reuses the
  previous wave's component cache and recomputes only entries that the
  commit-and-advance state changes invalidated.  Runs on a
  copy-on-write planning overlay;
* the scalar path (``use_matrix=False``) — the seed's per-(stage,
  slot, device) ``planner_score`` loop, kept as the reference baseline
  for parity tests and ``benchmarks/sched_bench.py``.

Both produce bit-identical weights, hence identical placements.

``plan_shared`` extends the same machinery to a merged multi-workflow
frontier: per-workflow score matrices (each delta-rescored against its
own previous wave) are stacked into one assignment problem whose rows
are ``(wid, sid)``-tagged, so many in-flight DAGs contend for devices
inside a single exact solve.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Mapping, Optional, Sequence

import numpy as np

from repro_torch.core.costs import CostModel, CostParams, shard_partition
from repro_torch.core.frontier_solver import (NEG, FrontierProblem,
                                        FrontierSolution,
                                        combine_solutions, merge_problems,
                                        solve_frontier_exact)
from repro_torch.core.routing import RoutingConfig, StageRouter, variant_stage
from repro_torch.core.scoring import FrontierScores, ScoreParams, Scorer
from repro_torch.core.state import ExecutionState
from repro_torch.core.workflow import Stage, StageKey, Workflow


@dataclasses.dataclass
class Placement:
    """A committed stage placement: devices[0] is the primary (slot 0).

    ``model`` is the routed model family serving the stage (cost/
    quality routing, :mod:`repro_torch.core.routing`) — ``None`` means the
    stage's default ``Stage.model``, which is also what every
    pre-routing placement deserializes to.
    """
    wid: str
    sid: str
    devices: tuple[int, ...]
    shard_sizes: tuple[int, ...]
    score: float = 0.0
    planned_at: float = 0.0
    model: Optional[str] = None


@dataclasses.dataclass
class SolveRecord:
    """Per-solve stats for the Table 12 analogue."""
    wall_time: float
    nodes: int
    status: str
    n_rows: int
    n_devices: int
    objective: float


class FrontierPlanner:
    """Commit-and-advance frontier planner (the FATE policy's core).

    Wraps the scoring engine and the exact frontier solver into
    Algorithm 2's wave loop; see the module docstring for the score
    path taxonomy.  Switches:

    * ``use_matrix`` — vectorized engine (default) vs the seed's
      scalar reference loop;
    * ``use_delta`` — incremental delta rescoring (default) vs a full
      matrix rebuild every wave (the parity/benchmark reference);
    * ``warm_start`` — carry each merged-frontier solve's assignment
      into the next solve as a solution hint
      (:class:`FrontierProblem.hint`).  Hints only seed
      branch-and-bound pruning, so placements are bit-identical with
      warm starts on or off.

    Invariant: all four configurations produce identical placements on
    identical inputs (``tests/test_score_matrix_parity.py``,
    ``tests/test_delta_rescoring.py``, ``tests/test_preemption.py``).
    """

    def __init__(self, params: Optional[ScoreParams] = None,
                 time_limit: float = 5.0, use_matrix: bool = True,
                 use_delta: bool = True, warm_start: bool = True,
                 cost_params: Optional[CostParams] = None,
                 max_waves: Optional[int] = None, pools=1,
                 routing: Optional[RoutingConfig] = None):
        self.params = params or ScoreParams()
        # hierarchical sharded solve: > 1 splits every merged-frontier
        # wave into that many disjoint device pools (affinity-aware) and
        # solves each pool exactly; 1 keeps the monolithic merged solve;
        # "auto" derives the count per wave from device count and
        # frontier width (see _effective_pools).
        # See docs/SCALE.md for the partition scheme and its invariants.
        self.pools = pools if pools == "auto" else max(1, int(pools))
        # cost/quality model routing (docs/GATEWAY.md): when set, stages
        # declaring candidate families get extra (wid, sid, alias) rows
        # in the frontier solve under a mutual-exclusion constraint.
        # None (default) adds no rows — bit-identical to the unrouted
        # planner by construction.
        self.routing = routing
        self._router = (StageRouter(routing) if routing is not None
                        else None)
        # test/bench hook: explicit device-id pools (list of id lists)
        # that override the residency-aware partitioner when set.
        self._forced_partition: Optional[list[list[int]]] = None
        # default wave cap of plan_shared (None = plan until the merged
        # frontier is exhausted); per-call max_waves overrides it — the
        # admission probe always passes 1 regardless of this default
        self.max_waves = max_waves
        # cost-model calibration of every CostModel this planner builds
        # (both score paths and the commit-and-advance estimator) —
        # None keeps the hand-set defaults; a CalibrationProfile's
        # cost_params() goes here when a profile is loaded
        self.cost_params = cost_params
        self.time_limit = time_limit
        self.use_matrix = use_matrix
        # use_delta=False forces a full matrix rebuild every wave — the
        # reference for incremental-vs-full parity tests and benchmarks
        self.use_delta = use_delta
        self.warm_start = warm_start
        # rolling ((wid, sid), slot) -> device hint fed to the next
        # merged solve; revoked (preempted) commitments re-enter later
        # waves with their previous devices as the warm start.
        self._shared_hint: dict = {}
        self.solve_log: list[SolveRecord] = []
        self._scorer: Optional[Scorer] = None
        # last wave's score tables per workflow: the seed of the next
        # delta rescore (within a plan() session and across sessions).
        # Bounded: long-lived planners seeing a stream of unique wids
        # (serving without retirement calls) evict oldest-first.
        self._wave_scores: dict[str, FrontierScores] = {}
        self._max_cached_workflows = 64
        # per-phase timing accumulators (benchmarks --profile)
        self.phase_ms = {"full_build": 0.0, "delta_rescore": 0.0,
                         "solve": 0.0}

    def _get_scorer(self, sim: ExecutionState) -> Scorer:
        if self._scorer is None:
            self._scorer = Scorer(sim, CostModel(sim, self.cost_params),
                                  self.params)
        else:
            self._scorer.rebind(sim)
        return self._scorer

    def _store_snapshot(self, wid: str, fs: FrontierScores) -> None:
        if wid not in self._wave_scores and \
                len(self._wave_scores) >= self._max_cached_workflows:
            self.forget_workflow(next(iter(self._wave_scores)))
        self._wave_scores[wid] = fs

    def forget_workflow(self, wid: str) -> None:
        """Release cached scores/topology/hints for a retired workflow."""
        self._wave_scores.pop(wid, None)
        if self._scorer is not None:
            self._scorer.forget_workflow(wid)
        if self._router is not None:
            self._router.forget_workflow(wid)
        if self._shared_hint:
            self._shared_hint = {k: d for k, d in
                                 self._shared_hint.items()
                                 if k[0][0] != wid}

    def drop_device_hints(self, device: int) -> None:
        """Scrub warm-start hints pointing at a downed device.

        The exact solver skips infeasible hints anyway; dropping them
        here keeps the hint dictionary from steering branch-and-bound
        toward a device that no longer exists.
        """
        if self._shared_hint:
            self._shared_hint = {k: d for k, d in
                                 self._shared_hint.items()
                                 if d != device}

    def plan(self, wf: Workflow, state: ExecutionState,
             ready: list[str]) -> list[Placement]:
        """Commit-and-advance planning (Algorithm 2): repeatedly solve
        frontier waves, advancing a simulated execution-state view
        between waves (each device takes at most one assignment per
        wave; estimated completion effects — residency, prefix warmth,
        availability — feed the next wave's scores)."""
        out: list[Placement] = []
        if self.use_matrix:
            sim = state.overlay()          # copy-on-write planning view
            scorer = self._get_scorer(sim)
            cm = scorer.cm                 # hoisted out of the wave loop
        else:
            sim = _simulate_copy(state)    # seed behavior: full dict copy
            cm = scorer = None
        remaining = list(ready)
        # cross-session snapshot: only the FIRST wave's tables (free of
        # this session's estimated placements) seed the next plan() call
        prev = (self._wave_scores.get(wf.wid)
                if self.use_matrix and self.use_delta else None)
        n_wave = 0
        while remaining:
            if self.use_matrix:
                # wave 0 rescoring verifies against full snapshots (no
                # claim on the base state's marks); later waves patch
                # from the overlay's own single-consumer dirty set
                wave, fs = self._plan_wave_fast(
                    wf, sim, remaining, cm, scorer,
                    prev if self.use_delta else None,
                    consume=(n_wave != 1),
                    dirty=(sim.drain_dirty() if n_wave else None))
                if n_wave == 0 and fs is not None:
                    self._store_snapshot(wf.wid, fs)
                prev = fs
                n_wave += 1
            else:
                wave = self._plan_wave(wf, sim, remaining)
            if not wave:
                break
            apply_cm = cm if cm is not None \
                else CostModel(sim, self.cost_params)
            for p in wave:
                _apply_estimate(wf, sim, p, apply_cm)
            placed = {p.sid for p in wave}
            remaining = [s for s in remaining if s not in placed]
            out.extend(wave)
        return out

    # ------------------------------------------------------------------
    # multi-workflow shared frontier
    # ------------------------------------------------------------------
    def plan_shared(self, workflows: dict[str, Workflow],
                    state: ExecutionState,
                    ready: Sequence[StageKey],
                    max_waves: Optional[int] = None,
                    priorities: Optional[Mapping[str, float]] = None
                    ) -> list[Placement]:
        """Commit-and-advance over the merged frontier of many DAGs.

        Each in-flight workflow's ready rows are scored by the same
        incremental engine (model demand and device pressure merged
        across workflows), stacked into one ``(wid, sid)``-keyed
        assignment problem, and solved exactly — so workflows compete
        for devices inside a single wave instead of being placed
        greedily one DAG at a time.

        ``max_waves`` bounds the number of solver waves — the
        admission controller's future-state probe runs a single wave
        (``max_waves=1``) to predict an arrival's marginal impact
        without paying for a full plan.  ``None`` (default) falls back
        to the planner-level ``max_waves`` (itself ``None`` = plan
        until the frontier is exhausted).

        ``priorities`` optionally maps ``wid`` to a class weight that
        multiplies the workflow's objective rows, biasing the shared
        solve toward higher-class work without changing feasibility.
        A weight of exactly 1.0 is skipped entirely, so uniform
        priorities solve the bit-identical unweighted problem.
        """
        if max_waves is None:
            max_waves = self.max_waves
        if not ready:
            return []
        sim = state.overlay()
        scorer = self._get_scorer(sim)
        cm = scorer.cm
        out: list[Placement] = []
        remaining: list[StageKey] = [k for k in ready
                                     if k[0] in workflows]
        # per-workflow intra-session wave chains; index 0 of each chain
        # is the preserved cross-session snapshot (estimate-free)
        session: dict[str, tuple[FrontierScores, int]] = {}
        n_waves = 0
        while remaining:
            wave = self._plan_wave_shared(workflows, sim, remaining,
                                          scorer, session,
                                          priorities=priorities)
            if not wave:
                break
            for p in wave:
                _apply_estimate(workflows[p.wid], sim, p, cm)
            placed = {(p.wid, p.sid) for p in wave}
            remaining = [k for k in remaining if k not in placed]
            out.extend(wave)
            n_waves += 1
            if max_waves is not None and n_waves >= max_waves:
                break
        return out

    def _plan_wave_shared(self, workflows: dict[str, Workflow],
                          sim: ExecutionState,
                          remaining: Sequence[StageKey],
                          scorer: Scorer,
                          session: dict,
                          priorities: Optional[Mapping[str, float]] = None
                          ) -> list[Placement]:
        by_wid: dict[str, list[str]] = {}
        for wid, sid in remaining:
            by_wid.setdefault(wid, []).append(sid)
        # merged frontier demand: cross-DAG same-model stages are
        # siblings too, and pressure reflects total contention
        counts: dict[str, int] = {}
        entries = []
        for wid, sids in by_wid.items():
            wf = workflows[wid]
            for sid in sids:
                counts[wf.stages[sid].model] = \
                    counts.get(wf.stages[sid].model, 0) + 1
                entries.append((wf, sid))
        pressure = scorer._pressure(entries)
        problems: list[FrontierProblem] = []
        base_sum, base_n = 0.0, 0
        per_wf: list[tuple[str, FrontierScores, list[str]]] = []
        # one drain per wave: every workflow's rescore must see the same
        # dirty-device set (a per-call drain would feed only the first).
        # The session's first wave makes no claim at all — it verifies
        # against full warm snapshots instead.
        dirty = sim.drain_dirty() if session else None
        for wid, sids in by_wid.items():
            wf = workflows[wid]
            scorer.set_frontier_shared(wf, sids, counts, pressure)
            t0 = time.perf_counter()
            entry = session.get(wid)
            if entry is None:             # first wave for this workflow
                prev, n_scored = self._wave_scores.get(wid), 0
            else:
                prev, n_scored = entry
            if not self.use_delta:
                prev = None
            fs = scorer.rescore_matrix(wf, sids, prev,
                                       consume=(n_scored != 1),
                                       dirty=dirty)
            key = "full_build" if fs.built_full else "delta_rescore"
            self.phase_ms[key] += (time.perf_counter() - t0) * 1e3
            if n_scored == 0:
                self._store_snapshot(wid, fs)  # cross-session snapshot
            session[wid] = (fs, n_scored + 1)
            per_wf.append((wid, fs, sids))
            flat = fs.base.reshape(-1).tolist()
            base_sum += sum(flat)
            base_n += len(flat)
        margin = (self.params.margin_factor * (base_sum / base_n)
                  if base_n else 1.0)
        partition = None
        n_pools = self._effective_pools(len(sim.cluster.ids()),
                                        len(remaining))
        if n_pools > 1 or self._forced_partition is not None:
            partition = self._partition_frontier(sim, workflows, by_wid,
                                                 counts, n_pools)
        if partition is not None:
            return self._solve_pooled(workflows, sim, per_wf, margin,
                                      partition, priorities=priorities)
        for wid, fs, sids in per_wf:
            fsm = self._mask_down(fs, sim)
            rows, weights = self._rows_from_scores(
                fsm, sids, margin, key_of=lambda s, w=wid: (w, s))
            weights = _scale_weights(weights, priorities, wid)
            exclusive = None
            if self._router is not None:
                wf = workflows[wid]
                # re-arm the merged frontier context: the scoring loop
                # above left the scorer on the LAST workflow's caches
                scorer.set_frontier_shared(wf, sids, counts, pressure)
                vrows, vweights, groups = self._variant_rows(
                    wf, sim, scorer, fsm, sids, margin,
                    key_of=lambda s, w=wid: (w, s))
                if vrows:
                    rows = rows + vrows
                    weights = weights + _scale_weights(
                        vweights, priorities, wid)
                    exclusive = groups
            if rows:
                hint = None
                if self.warm_start and self._shared_hint:
                    hint = {r: self._shared_hint[r] for r in rows
                            if r in self._shared_hint} or None
                problems.append(FrontierProblem(
                    rows, fs.devices, np.array(weights), hint=hint,
                    exclusive=exclusive))
        if not problems:
            return []
        problem = merge_problems(problems)
        t0 = time.perf_counter()
        sol = solve_frontier_exact(problem, self.time_limit)
        self.phase_ms["solve"] += (time.perf_counter() - t0) * 1e3
        if self.warm_start:
            # next wave's (and next replan's) warm start; revoked
            # commitments reappear as rows and pick their old device
            # hints back up.  Rebuild rather than grow without bound.
            if len(self._shared_hint) > 8192:
                self._shared_hint = dict(sol.assignment)
            else:
                self._shared_hint.update(sol.assignment)
        self.solve_log.append(SolveRecord(
            wall_time=sol.wall_time, nodes=sol.nodes, status=sol.status,
            n_rows=len(problem.rows), n_devices=len(problem.devices),
            objective=sol.objective))
        return self._materialize_shared(workflows, sim, sol)

    # ------------------------------------------------------------------
    # hierarchical sharded solve (device-pool partitioning)
    # ------------------------------------------------------------------
    def _effective_pools(self, n_devices: int, n_rows: int) -> int:
        """Resolve the pool count for one wave.

        A fixed integer ``pools`` passes through unchanged.  With
        ``pools="auto"`` the count is derived per wave: one pool per
        16 devices, further capped so each pool keeps a useful share of
        the frontier (at least ~4 ready rows per pool) — small clusters
        and narrow frontiers resolve to 1, which IS the monolithic
        merged solve (``tests/test_pools_auto.py`` asserts parity).
        Deterministic in its two inputs.
        """
        if self.pools != "auto":
            return self.pools
        return max(1, min(n_devices // 16, n_rows // 4))

    def _partition_frontier(self, sim: ExecutionState,
                            workflows: dict[str, Workflow],
                            by_wid: dict[str, list[str]],
                            counts: dict[str, int],
                            n_pools: int = 0
                            ) -> Optional[tuple[list[list[int]],
                                                dict[str, int]]]:
        """Split one wave into per-pool subproblems, or ``None``.

        Builds ``pools`` disjoint device pools (column positions into
        the canonical cluster id order) by greedily packing residency
        groups — same-resident-model devices stay together, groups
        ordered by merged-frontier demand — then assigns every workflow
        wholly to one pool by resident-model affinity with
        load-balancing tie-breaks.  All choices are deterministic
        functions of the (sorted) inputs, so identical states partition
        identically.

        Returns ``None`` — caller falls back to the monolithic merged
        solve for this wave — whenever some workflow has a ready stage
        with no live eligible device in any single pool, or the pool
        count cannot be realized.  The fallback keeps the pool
        invariants (each pool solved independently ⇒ at most one
        assignment per device per wave requires disjoint pools covering
        every candidate device of every row in the subproblem).
        """
        ids = sim.cluster.ids()
        pos_of = {d: j for j, d in enumerate(ids)}
        if self._forced_partition is not None:
            pool_cols = [sorted(pos_of[d] for d in grp)
                         for grp in self._forced_partition]
            if sorted(j for cols in pool_cols for j in cols) \
                    != list(range(len(ids))):
                raise ValueError(
                    "forced partition must cover every device exactly "
                    "once")
        else:
            if not n_pools:
                n_pools = self.pools if self.pools != "auto" else 1
            if n_pools <= 1 or n_pools >= len(ids):
                return None
            groups = sim.residency_groups()
            ordered = sorted((m for m in groups if m is not None),
                             key=lambda m: (-counts.get(m, 0), m))
            if None in groups:
                ordered.append(None)
            pool_cols = [[] for _ in range(n_pools)]
            for m in ordered:
                pi = min(range(n_pools),
                         key=lambda i: (len(pool_cols[i]), i))
                pool_cols[pi].extend(pos_of[d] for d in groups[m])
            # no pool may be empty: steal trailing columns from the
            # fullest pool (deterministic donor choice)
            for pi in range(n_pools):
                while not pool_cols[pi]:
                    donor = max(range(n_pools),
                                key=lambda i: (len(pool_cols[i]), -i))
                    if len(pool_cols[donor]) <= 1:
                        return None
                    pool_cols[pi].append(pool_cols[donor].pop())
            pool_cols = [sorted(cols) for cols in pool_cols]
        down = getattr(sim, "down", None) or set()
        # per-pool live-device tallies by resident model (affinity) and
        # overall (feasibility fast path for unconstrained stages)
        n_pools = len(pool_cols)
        pool_live = [0] * n_pools
        aff: dict[str, list[int]] = {}
        for pi, cols in enumerate(pool_cols):
            for j in cols:
                d = ids[j]
                if d in down:
                    continue
                pool_live[pi] += 1
                m = sim.residency.get(d)
                if m is not None:
                    aff.setdefault(m, [0] * n_pools)[pi] += 1
        zeros = [0] * n_pools
        wid_pool: dict[str, int] = {}
        rows_per_pool = [0] * n_pools
        for wid, sids in by_wid.items():
            wf = workflows[wid]
            feasible = []
            for pi, cols in enumerate(pool_cols):
                if not pool_live[pi]:
                    continue
                ok = True
                for sid in sids:
                    elig = wf.stages[sid].eligible
                    if not elig:
                        continue        # any live device serves
                    if not any(ids[j] in elig and ids[j] not in down
                               for j in cols):
                        ok = False
                        break
                if ok:
                    feasible.append(pi)
            if not feasible:
                return None
            best = max(feasible, key=lambda pi: (
                sum(aff.get(wf.stages[sid].model, zeros)[pi]
                    for sid in sids),
                -rows_per_pool[pi], -pi))
            wid_pool[wid] = best
            rows_per_pool[best] += len(sids)
        return pool_cols, wid_pool

    def _solve_pooled(self, workflows: dict[str, Workflow],
                      sim: ExecutionState,
                      per_wf: list[tuple[str, FrontierScores, list[str]]],
                      margin: float,
                      partition: tuple[list[list[int]], dict[str, int]],
                      priorities: Optional[Mapping[str, float]] = None
                      ) -> list[Placement]:
        """Exact per-pool solves of one partitioned wave.

        Score tables are built (and delta-rescored) on the full device
        axis exactly as in the monolithic path — the wave margin too —
        then column-sliced per pool via :meth:`FrontierScores.restrict`,
        so a single-pool partition reproduces the monolithic solve
        bit-for-bit.  Pools are solved in index order and the disjoint
        per-pool assignments unioned (:func:`combine_solutions`), which
        keeps materialization order deterministic.
        """
        pool_cols, wid_pool = partition
        sols = []
        for pi, cols in enumerate(pool_cols):
            probs: list[FrontierProblem] = []
            n_rows = 0
            for wid, fs, sids in per_wf:
                if wid_pool.get(wid) != pi:
                    continue
                sub = self._mask_down(fs, sim).restrict(cols)
                rows, weights = self._rows_from_scores(
                    sub, sids, margin, key_of=lambda s, w=wid: (w, s))
                weights = _scale_weights(weights, priorities, wid)
                exclusive = None
                if self._router is not None:
                    # variants scored over the pool's device columns
                    # (solo_best pool-local, like the default rows);
                    # the scorer still carries this wave's merged
                    # counts/pressure from the scoring loop
                    vrows, vweights, groups = self._variant_rows(
                        workflows[wid], sim, self._scorer, sub, sids,
                        margin, key_of=lambda s, w=wid: (w, s))
                    if vrows:
                        rows = rows + vrows
                        weights = weights + _scale_weights(
                            vweights, priorities, wid)
                        exclusive = groups
                if not rows:
                    continue
                hint = None
                if self.warm_start and self._shared_hint:
                    # stale entries pointing outside the pool are
                    # ignored by the solver (absent-device hints)
                    hint = {r: self._shared_hint[r] for r in rows
                            if r in self._shared_hint} or None
                probs.append(FrontierProblem(
                    rows, sub.devices, np.array(weights), hint=hint,
                    exclusive=exclusive))
                n_rows += len(rows)
            if not probs:
                continue
            problem = merge_problems(probs)
            t0 = time.perf_counter()
            sol = solve_frontier_exact(problem, self.time_limit)
            self.phase_ms["solve"] += (time.perf_counter() - t0) * 1e3
            self.solve_log.append(SolveRecord(
                wall_time=sol.wall_time, nodes=sol.nodes,
                status=sol.status, n_rows=len(problem.rows),
                n_devices=len(problem.devices),
                objective=sol.objective))
            sols.append(sol)
        if not sols:
            return []
        combined = combine_solutions(sols)
        if self.warm_start:
            if len(self._shared_hint) > 8192:
                self._shared_hint = dict(combined.assignment)
            else:
                self._shared_hint.update(combined.assignment)
        return self._materialize_shared(workflows, sim, combined)

    # ------------------------------------------------------------------
    # vectorized wave
    # ------------------------------------------------------------------
    @staticmethod
    def _mask_down(fs: FrontierScores, state: ExecutionState
                   ) -> FrontierScores:
        """Solver view of a score table with downed devices excluded.

        Returns ``fs`` unchanged on the (fault-free) fast path.  When
        ``state.down`` is non-empty, a SHALLOW masked copy is built —
        downed columns forced to ``NEG`` / ``inf`` / ineligible, every
        row flagged constrained — so cached tables (the delta-rescore
        seeds) are never mutated and the mask costs nothing once the
        device recovers.
        """
        down = getattr(state, "down", None)
        if not down:
            return fs
        pos = [j for j, d in enumerate(fs.devices) if d in down]
        if not pos:
            return fs
        raw = fs.raw.copy()
        raw[:, pos] = NEG
        eft = fs.eft.copy()
        eft[:, pos] = np.inf
        eligible = fs.eligible.copy()
        eligible[:, pos] = False
        return dataclasses.replace(
            fs, raw=raw, eft=eft, eligible=eligible,
            constrained=[True] * len(fs.ready))

    def _variant_rows(self, wf: Workflow, sim: ExecutionState,
                      scorer: Scorer, fs: FrontierScores,
                      ready: list[str], margin: float,
                      key_of=lambda s: s
                      ) -> tuple[list[tuple], list[np.ndarray],
                                 list[list]]:
        """Extra solver rows for routed model-family variants.

        For every ready stage with admissible candidates
        (:class:`~repro_torch.core.routing.StageRouter`), scores the routed
        twin per (slot, device) through the scalar engine — bit-
        identical to a matrix row by the repo's parity invariant — and
        normalizes slot-0 weights against the DEFAULT family's best
        (``margin + raw − best_default``), so a family only outbids the
        default when its best device genuinely scores higher.  Returns
        ``(rows, weights, exclusive_groups)`` with rows keyed
        ``key_of(sid) + (alias,)``; all empty when routing is off or no
        stage declares candidates, leaving the solve untouched.
        """
        if self._router is None:
            return [], [], []
        rows: list[tuple] = []
        weights: list[np.ndarray] = []
        groups: list[list] = []
        devices = fs.devices
        down = getattr(sim, "down", None) or ()
        for i, sid in enumerate(ready):
            stage = wf.stages[sid]
            cands = self._router.candidates(wf.wid, stage, sim.profiles)
            if not cands:
                continue
            raw_def = fs.raw[i]
            if np.all(raw_def <= NEG / 2):
                continue            # default unplaceable: don't route
            best_def = raw_def[raw_def > NEG / 2].max()
            base_key = key_of(sid)
            group = [base_key]
            for alias, _quality, vstage in cands:
                eligible = (set(vstage.eligible) if vstage.eligible
                            else None)
                raw = np.full(len(devices), NEG)
                efts = np.full(len(devices), np.inf)
                for j, d in enumerate(devices):
                    if d in down:
                        continue
                    if eligible is not None and d not in eligible:
                        continue
                    raw[j] = scorer.planner_score(wf, vstage, 0, d, 0.0)
                    efts[j] = scorer.corrected_eft(wf, vstage, d)
                if np.all(raw <= NEG / 2):
                    continue
                key = (*base_key, alias) if isinstance(base_key, tuple) \
                    else (base_key, alias)
                rows.append((key, 0))
                weights.append(np.where(raw > NEG / 2,
                                        margin + raw - best_def, NEG))
                solo_best = float(np.min(efts))
                max_slots = (vstage.max_shards
                             if self.params.enable_shard else 1)
                for k in range(1, max_slots):
                    w = np.full(len(devices), NEG)
                    for j, d in enumerate(devices):
                        if d in down:
                            continue
                        if eligible is not None and d not in eligible:
                            continue
                        w[j] = scorer.planner_score(
                            wf, vstage, k, d, 0.0, solo_best=solo_best)
                    if np.all(w <= NEG / 2):
                        continue
                    rows.append((key, k))
                    weights.append(w)
                group.append(key)
            if len(group) > 1:
                groups.append(group)
        return rows, weights, groups

    def _rows_from_scores(self, fs: FrontierScores, ready: list[str],
                          margin: float, key_of=lambda s: s
                          ) -> tuple[list[tuple], list[np.ndarray]]:
        """Regret-margin solver rows from one score table."""
        rows: list[tuple] = []
        weights: list[np.ndarray] = []
        for i, sid in enumerate(ready):
            raw = fs.raw[i]
            if fs.constrained[i]:
                if np.all(raw <= NEG / 2):
                    continue
                best = raw[raw > NEG / 2].max()
                w0 = np.where(raw > NEG / 2, margin + raw - best, NEG)
            else:                       # no eligibility holes: fast path
                best = raw.max()
                w0 = margin + raw - best
            solo_best = float(np.min(fs.eft[i]))
            rows.append((key_of(sid), 0))
            weights.append(w0)
            for k in range(1, fs.max_slots[i]):
                w = fs.shard_weights(i, k, solo_best)
                if fs.constrained[i] and np.all(w <= NEG / 2):
                    continue
                rows.append((key_of(sid), k))
                weights.append(w)
        return rows, weights

    def _plan_wave_fast(self, wf: Workflow, state: ExecutionState,
                        ready: list[str], cm: CostModel,
                        scorer: Scorer,
                        prev: Optional[FrontierScores] = None,
                        consume: bool = True,
                        dirty: Optional[set] = None
                        ) -> tuple[list[Placement],
                                   Optional[FrontierScores]]:
        """One solver wave fed by the incremental scoring engine."""
        if not ready:
            return [], None
        scorer.set_frontier(wf, ready)
        t0 = time.perf_counter()
        fs = scorer.rescore_matrix(wf, ready, prev, consume=consume,
                                   dirty=dirty)
        key = "full_build" if fs.built_full else "delta_rescore"
        self.phase_ms[key] += (time.perf_counter() - t0) * 1e3
        devices = fs.devices

        # margin: same all-pairs mean as the scalar path, accumulated
        # in the same (row-major, builtin-sum) order for bit parity.
        flat = fs.base.reshape(-1).tolist()
        margin = (self.params.margin_factor * (sum(flat) / len(flat))
                  if flat else 1.0)

        fsm = self._mask_down(fs, state)
        rows, weights = self._rows_from_scores(fsm, ready, margin)
        exclusive = None
        if self._router is not None:
            vrows, vweights, groups = self._variant_rows(
                wf, state, scorer, fsm, ready, margin)
            if vrows:
                rows = rows + vrows
                weights = weights + vweights
                exclusive = groups
        if not rows:
            return [], fs

        problem = FrontierProblem(rows, devices, np.array(weights),
                                  exclusive=exclusive)
        t0 = time.perf_counter()
        sol = solve_frontier_exact(problem, self.time_limit)
        self.phase_ms["solve"] += (time.perf_counter() - t0) * 1e3
        self.solve_log.append(SolveRecord(
            wall_time=sol.wall_time, nodes=sol.nodes, status=sol.status,
            n_rows=len(rows), n_devices=len(devices),
            objective=sol.objective))
        return self._materialize(wf, state, cm, sol), fs

    # ------------------------------------------------------------------
    # scalar wave (seed reference path)
    # ------------------------------------------------------------------
    def _plan_wave(self, wf: Workflow, state: ExecutionState,
                   ready: list[str]) -> list[Placement]:
        """One CP-SAT wave over the current ready frontier."""
        if not ready:
            return []
        cm = CostModel(state, self.cost_params)
        scorer = Scorer(state, cm, self.params)
        scorer.set_frontier(wf, ready)
        q = wf.num_queries
        devices = state.cluster.ids()

        # Regret-based wave scores: each stage's best placement scores a
        # small positive margin; alternatives score margin − regret and
        # may go negative, in which case the solver defers the stage to
        # a later wave (e.g. queueing behind a model-resident device
        # instead of paying a switch now).  The sum objective then
        # approximates completion-time impact rather than raw placement
        # count — the "balancing versus future-state preservation"
        # tradeoff of §1 is decided by the score terms.
        base_costs = [cm.base_cost(wf.stages[sid], d, q)
                      for sid in ready for d in devices]
        margin = (self.params.margin_factor
                  * (sum(base_costs) / len(base_costs))
                  if base_costs else 1.0)

        rows: list[tuple] = []
        weights: list[np.ndarray] = []
        down = getattr(state, "down", None) or ()
        for sid in ready:
            stage = wf.stages[sid]
            eligible = set(stage.eligible) if stage.eligible else None
            max_slots = (stage.max_shards if self.params.enable_shard
                         else 1)
            raw = np.full(len(devices), NEG)
            efts = np.full(len(devices), np.inf)
            for j, d in enumerate(devices):
                if d in down:
                    continue
                if eligible is not None and d not in eligible:
                    continue
                raw[j] = scorer.planner_score(wf, stage, 0, d, 0.0)
                efts[j] = scorer.corrected_eft(wf, stage, d)
            if np.all(raw <= NEG / 2):
                continue
            best = raw[raw > NEG / 2].max()
            solo_best = float(np.min(efts))
            w0 = np.where(raw > NEG / 2, margin + raw - best, NEG)
            rows.append((sid, 0))
            weights.append(w0)
            for k in range(1, max_slots):
                w = np.full(len(devices), NEG)
                for j, d in enumerate(devices):
                    if d in down:
                        continue
                    if eligible is not None and d not in eligible:
                        continue
                    w[j] = scorer.planner_score(wf, stage, k, d, 0.0,
                                                solo_best=solo_best)
                if np.all(w <= NEG / 2):
                    continue
                rows.append((sid, k))
                weights.append(w)
        if not rows:
            return []

        problem = FrontierProblem(rows, devices, np.array(weights))
        sol = solve_frontier_exact(problem, self.time_limit)
        self.solve_log.append(SolveRecord(
            wall_time=sol.wall_time, nodes=sol.nodes, status=sol.status,
            n_rows=len(rows), n_devices=len(devices),
            objective=sol.objective))
        return self._materialize(wf, state, cm, sol)

    def _materialize(self, wf: Workflow, state: ExecutionState,
                     cm: CostModel, sol: FrontierSolution
                     ) -> list[Placement]:
        by_stage: dict = {}
        for (key, slot), dev in sol.assignment.items():
            by_stage.setdefault(key, {})[slot] = dev
        out: list[Placement] = []
        for key, slots in by_stage.items():
            if 0 not in slots:     # primary slot missing: drop (solver
                continue           # guarantees monotonicity, belt&braces)
            # routed variant rows key as (sid, alias); default as sid
            sid, model = key if isinstance(key, tuple) else (key, None)
            devs = tuple(slots[k] for k in sorted(slots))
            speeds = [state.cluster.devices[d].speed for d in devs]
            sizes = tuple(shard_partition(wf.num_queries, speeds))
            out.append(Placement(wid=wf.wid, sid=sid, devices=devs,
                                 shard_sizes=sizes, score=sol.objective,
                                 planned_at=state.now, model=model))
        return out

    def _materialize_shared(self, workflows: dict[str, Workflow],
                            state: ExecutionState, sol: FrontierSolution
                            ) -> list[Placement]:
        """Materialize a merged-frontier solution whose stage keys are
        ``(wid, sid)`` tuples."""
        by_stage: dict[tuple, dict[int, int]] = {}
        for (key, slot), dev in sol.assignment.items():
            by_stage.setdefault(key, {})[slot] = dev
        out: list[Placement] = []
        for key, slots in by_stage.items():
            if 0 not in slots:
                continue
            # routed variant rows key as (wid, sid, alias)
            wid, sid = key[0], key[1]
            model = key[2] if len(key) == 3 else None
            wf = workflows[wid]
            devs = tuple(slots[k] for k in sorted(slots))
            speeds = [state.cluster.devices[d].speed for d in devs]
            sizes = tuple(shard_partition(wf.num_queries, speeds))
            out.append(Placement(wid=wid, sid=sid, devices=devs,
                                 shard_sizes=sizes, score=sol.objective,
                                 planned_at=state.now, model=model))
        return out


def _simulate_copy(state: ExecutionState) -> ExecutionState:
    """Cheap planning copy of the execution state (dict-level)."""
    import copy
    sim = ExecutionState(
        cluster=state.cluster, profiles=state.profiles,
        residency=dict(state.residency),
        prefix={d: {g: copy.copy(e) for g, e in m.items()}
                for d, m in state.prefix.items()},
        output_loc=dict(state.output_loc),
        free_at=dict(state.free_at), now=state.now)
    sim.completed = set(state.completed)
    sim.down = set(state.down)
    sim.fault_epoch = state.fault_epoch
    return sim


def _scale_weights(weights: list, priorities: Optional[Mapping[str, float]],
                   wid: str) -> list:
    """Multiply one workflow's objective rows by its class priority.

    The exact-1.0 skip is load-bearing: uniform priorities must hand
    the solver the untouched weight arrays so single-class runs stay
    bit-identical to priority-free planning.
    """
    if not priorities:
        return weights
    w = float(priorities.get(wid, 1.0))
    if w == 1.0:
        return weights
    return [w * arr for arr in weights]


def _apply_estimate(wf: Workflow, sim: ExecutionState, p: Placement,
                    cm: Optional[CostModel] = None) -> None:
    """Advance the simulated state by a placement's estimated effects.

    A routed placement (``p.model`` set by :meth:`_variant_rows`' solver
    rows) is estimated against its routed twin — residency, prefix
    warmth, and duration all follow the family that will actually run.
    """
    if cm is None:
        cm = CostModel(sim)
    st = wf.stages[p.sid]
    if p.model is not None and p.model != st.model:
        st = variant_stage(st, p.model, sim.profiles)
    fins = []
    for d, nq in zip(p.devices, p.shard_sizes):
        t0 = max(sim.now, sim.device_free(d))
        dur = max(1e-6, cm.breakdown(wf, st, d, nq).total)
        sim.set_free_at(d, t0 + dur)
        # raw residency write (no switch counting / prefix pruning in
        # the planning estimate), but still marked for delta rescoring
        sim.residency[d] = st.model
        sim.touch_device(d)
        if st.keep_cache:
            sim.warm_prefix(d, st.prefix_group, st.model, nq, t0 + dur)
        fins.append(t0 + dur)
    sim.output_loc[(wf.wid, p.sid)] = p.devices
    sim.completed.add((wf.wid, p.sid))
