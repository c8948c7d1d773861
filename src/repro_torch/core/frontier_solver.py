"""Exact solver specialized to FATE's frontier placement problem.

The frontier ILP (Appendix A.2) is an assignment problem over
(stage-slot × device) with one side constraint family — monotone slot
activation.  We solve it exactly with branch-and-bound whose relaxation
drops only monotonicity and is solved by the Hungarian algorithm
(``scipy.optimize.linear_sum_assignment``):

  * relaxation optimum is an admissible upper bound;
  * if the relaxed solution already satisfies monotonicity it is OPTIMAL
    for the full problem (the common case: slot-0 scores dominate);
  * otherwise branch on a violated stage: (A) forbid the violating
    higher slot, (B) force the lower slot to be assigned.

Every solve returns status OPTIMAL with the true optimum (the paper's
Table 12 reports all-OPTIMAL CP-SAT solves; our analogue benchmark
reports the same property for this solver).  The generic
``repro_torch.core.cpsat`` solver cross-validates this one in the tests.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
from scipy.optimize import linear_sum_assignment

NEG = -1e15


@dataclasses.dataclass
class FrontierProblem:
    """weights[r][c]: score of placing row r = (stage, slot) on device c;
    -inf (<= NEG) marks ineligible pairs.  rows lists (stage_key, slot).

    ``hint`` is an optional warm-start vector mapping row keys
    ``(stage_key, slot)`` to device ids — typically the previous wave's
    solution.  The solver turns it into a feasible incumbent that seeds
    branch-and-bound pruning; it never changes the returned optimum (or
    which optimal assignment is returned — see
    :func:`solve_frontier_exact`).  Entries for rows or devices absent
    from this problem are ignored, so a stale hint is always safe.

    ``exclusive`` optionally lists mutual-exclusion groups of stage
    keys: within each group at most ONE key may have any assigned rows
    in a feasible solution.  The cost/quality router uses this to offer
    one stage under several model families — ``(wid, sid)`` plus its
    ``(wid, sid, alias)`` variants form one group — while guaranteeing
    a single family wins the stage.  ``None``/empty adds no constraint
    and no branching, so unrouted problems solve identically.
    """
    rows: list[tuple]             # (stage_key, slot_index)
    devices: list[int]
    weights: np.ndarray           # [n_rows, n_devices]
    hint: Optional[dict] = None   # (stage_key, slot) -> device id
    exclusive: Optional[list[list]] = None   # groups of stage keys

    def slot_rows(self, stage_key) -> list[int]:
        """Row indices belonging to ``stage_key`` (all slots)."""
        return [i for i, (s, _) in enumerate(self.rows) if s == stage_key]


def merge_problems(problems: list[FrontierProblem]) -> FrontierProblem:
    """Stack per-workflow frontier problems into one shared problem.

    All inputs must share the device axis (same ids, same order); rows
    keep their own keys — the shared-frontier planner keys them by
    ``(wid, sid)`` so stage ids from different DAGs never collide.  A
    single merged solve lets many in-flight workflows compete for the
    same devices under one exact optimum instead of sequential
    per-workflow greedy carve-outs.
    """
    if not problems:
        raise ValueError("merge_problems: empty problem list")
    devices = problems[0].devices
    for pr in problems[1:]:
        if pr.devices != devices:
            raise ValueError("merge_problems: mismatched device axes")
    rows: list[tuple] = []
    hint: dict = {}
    exclusive: list[list] = []
    for pr in problems:
        rows.extend(pr.rows)
        if pr.hint:
            hint.update(pr.hint)   # (wid, sid)-keyed rows never collide
        if pr.exclusive:
            exclusive.extend(pr.exclusive)
    weights = np.concatenate([pr.weights for pr in problems], axis=0)
    return FrontierProblem(rows, devices, weights, hint=hint or None,
                           exclusive=exclusive or None)


@dataclasses.dataclass
class FrontierSolution:
    """Result of one exact frontier solve: the optimal (or incumbent,
    on timeout) ``(stage_key, slot) -> device`` assignment plus solver
    statistics for the Table 12 analogue."""
    status: str
    objective: float
    assignment: dict[tuple, int]  # (stage_key, slot) -> device id
    wall_time: float
    nodes: int


def combine_solutions(sols: list["FrontierSolution"]) -> "FrontierSolution":
    """Union of per-pool solutions from a hierarchical sharded solve.

    The pools partition both the device axis and the row set, so the
    per-pool assignments are disjoint on rows *and* devices and their
    union is a feasible assignment of the original merged problem.
    Assignment insertion order follows pool order (the caller solves
    pools in index order), keeping downstream materialization
    deterministic.  Objective/nodes/wall-clock are summed; status
    degrades to the weakest member (any non-OPTIMAL pool makes the
    combined solve FEASIBLE).
    """
    if not sols:
        return FrontierSolution("OPTIMAL", 0.0, {}, 0.0, 0)
    assignment: dict[tuple, int] = {}
    for s in sols:
        assignment.update(s.assignment)
    status = "OPTIMAL" if all(s.status == "OPTIMAL" for s in sols) \
        else "FEASIBLE"
    return FrontierSolution(
        status=status,
        objective=float(sum(s.objective for s in sols)),
        assignment=assignment,
        wall_time=float(sum(s.wall_time for s in sols)),
        nodes=int(sum(s.nodes for s in sols)),
    )


_AUG_BUFFERS: dict[tuple[int, int], np.ndarray] = {}


def _aug_buffer(n_r: int, n_c: int) -> np.ndarray:
    """Reusable augmented-cost scratch matrix for `_hungarian`.

    The branch-and-bound loop calls the relaxation many times per solve
    with an identical shape; reusing one buffer per shape avoids a
    fresh (n_r × (n_c+n_r)) allocation per node.

    NOT thread-safe: concurrent solves with the same shape would share
    scratch; keep frontier solves on one thread (process-parallelism is
    fine) or make this thread-local first."""
    buf = _AUG_BUFFERS.get((n_r, n_c))
    if buf is None:
        buf = np.empty((n_r, n_c + n_r))
        if len(_AUG_BUFFERS) > 32:       # bound the cache
            _AUG_BUFFERS.clear()
        _AUG_BUFFERS[(n_r, n_c)] = buf
    buf.fill(NEG)
    return buf


def _hungarian(weights: np.ndarray, forced: set[int],
               banned: set[int]) -> Optional[tuple[float, dict[int, int]]]:
    """Max-weight assignment; rows may stay unassigned unless forced.

    Implemented by augmenting with per-row dummy columns of weight 0
    (or -inf for forced rows).  Returns (objective, {row: col}) over
    real columns only, or None if a forced row cannot be placed.
    """
    n_r, n_c = weights.shape
    aug = _aug_buffer(n_r, n_c)
    aug[:, :n_c] = weights
    for r in range(n_r):
        if r in banned:
            aug[r, :n_c] = NEG
        aug[r, n_c + r] = NEG if r in forced else 0.0
    rr, cc = linear_sum_assignment(aug, maximize=True)
    obj = 0.0
    out: dict[int, int] = {}
    for r, c in zip(rr, cc):
        v = aug[r, c]
        if v <= NEG / 2:
            if r in forced:
                return None          # forced row unplaceable
            continue
        if c < n_c:
            obj += v
            out[r] = c
    return obj, out


# how far below the hint incumbent's objective the pruning bound is
# seeded: strictly positive (and > the solver's 1e-12 tie tolerance) so
# the DFS still visits — in the same order — every node whose relaxation
# reaches the true optimum, making warm-started placements bit-identical
# to cold solves; large enough to actually prune dominated subtrees.
_HINT_EPS = 1e-9


def _hint_incumbent(problem: FrontierProblem
                    ) -> Optional[tuple[float, dict[int, int]]]:
    """Feasible warm-start assignment from ``problem.hint``.

    Walks rows in order, accepting each hinted (row, device) pair that
    keeps the assignment feasible: device eligible and unused, slot
    monotonicity (slot k only on top of an accepted slot k−1, which the
    planner's row ordering guarantees precedes it), and mutual
    exclusion (once one key of an ``exclusive`` group is accepted, the
    group's other keys are skipped).  Returns
    ``(objective, {row_index: col_index})`` or None when nothing from
    the hint is applicable.  Feasibility ⇒ the objective lower-bounds
    the optimum, so seeding with it can never cut the optimum off.
    """
    hint = problem.hint or {}
    if not hint:
        return None
    col_of = {d: j for j, d in enumerate(problem.devices)}
    group_of: dict = {}
    for gi, grp in enumerate(problem.exclusive or ()):
        for key in grp:
            group_of[key] = gi
    chosen: dict[int, tuple] = {}        # group index -> accepted key
    used: set[int] = set()
    accepted: set[tuple] = set()         # (stage_key, slot) taken
    out: dict[int, int] = {}
    obj = 0.0
    for r, (key, slot) in enumerate(problem.rows):
        d = hint.get((key, slot))
        if d is None:
            continue
        c = col_of.get(d)
        if c is None or c in used:
            continue
        w = float(problem.weights[r, c])
        if w <= NEG / 2:
            continue
        if slot > 0 and (key, slot - 1) not in accepted:
            continue
        gi = group_of.get(key)
        if gi is not None and chosen.get(gi, key) != key:
            continue
        if gi is not None:
            chosen[gi] = key
        used.add(c)
        accepted.add((key, slot))
        out[r] = c
        obj += w
    return (obj, out) if out else None


def solve_frontier_exact(problem: FrontierProblem,
                         time_limit: float = 5.0) -> FrontierSolution:
    """Exactly solve one frontier placement problem.

    Branch-and-bound over the Hungarian relaxation (see module
    docstring); always returns the true optimum with status
    ``OPTIMAL`` unless ``time_limit`` is exceeded (then ``FEASIBLE``
    with the incumbent).  When ``problem.hint`` carries a previous
    wave's assignment, a feasible incumbent is installed ε below its
    objective before the search, so dominated subtrees prune from node
    one while the returned assignment stays bit-identical to an
    unhinted (cold) solve.
    """
    t0 = time.perf_counter()
    rows = problem.rows
    stage_slots: dict = {}
    for i, (s, k) in enumerate(rows):
        stage_slots.setdefault(s, {})[k] = i
    # mutual-exclusion groups resolved to per-key row-index sets (keys
    # with no rows in this problem drop out; singleton groups constrain
    # nothing)
    ex_groups: list[list[frozenset]] = []
    for grp in problem.exclusive or ():
        rowsets = [frozenset(stage_slots[key].values())
                   for key in grp if key in stage_slots]
        if len(rowsets) > 1:
            ex_groups.append(rowsets)

    best_obj = -np.inf
    best_assign: dict[int, int] = {}
    warm = _hint_incumbent(problem)
    if warm is not None:
        # ε-below seeding: any subtree whose relaxation cannot beat the
        # hint's (feasible, hence ≤ optimal) objective is pruned; nodes
        # at or above the optimum survive, so the first optimum found in
        # DFS order — the cold solve's answer — is still the one kept.
        best_obj = warm[0] - _HINT_EPS
        best_assign = dict(warm[1])
    nodes = 0
    # stack of (forced_rows, banned_rows)
    stack: list[tuple[frozenset, frozenset]] = [(frozenset(), frozenset())]
    seen: set[tuple[frozenset, frozenset]] = set()
    deadline = t0 + time_limit
    status = "OPTIMAL"

    while stack:
        if time.perf_counter() > deadline:
            status = "FEASIBLE"
            break
        forced, banned = stack.pop()
        if (forced, banned) in seen:
            continue
        seen.add((forced, banned))
        nodes += 1
        sol = _hungarian(problem.weights, set(forced), set(banned))
        if sol is None:
            continue
        obj, assign = sol
        if obj <= best_obj + 1e-12:
            continue
        # check slot monotonicity: slot k assigned requires slot k-1
        violation = None
        for s, slots in stage_slots.items():
            for k in sorted(slots):
                if k == 0:
                    continue
                hi, lo = slots[k], slots[k - 1]
                if hi in assign and lo not in assign:
                    violation = (lo, hi)
                    break
            if violation:
                break
        if violation is None:
            # check mutual exclusion: at most one key per group assigned
            ex_violation = None
            for rowsets in ex_groups:
                live = [rs for rs in rowsets
                        if any(r in assign for r in rs)]
                if len(live) >= 2:
                    ex_violation = (live[0], live[1])
                    break
            if ex_violation is None:
                best_obj = obj
                best_assign = assign
                continue
            # two keys A, B of one group both hold rows: any feasible
            # solution uses at most one of them, so it survives the
            # branch banning the other — complete dichotomy
            rows_a, rows_b = ex_violation
            stack.append((forced, banned | rows_a))
            stack.append((forced, banned | rows_b))
            continue
        lo, hi = violation
        # branch A: ban the higher slot; branch B: force the lower slot
        stack.append((forced, banned | {hi}))
        stack.append((forced | {lo}, banned))

    if not np.isfinite(best_obj):
        best_obj = 0.0
        best_assign = {}
    assignment = {rows[r]: problem.devices[c]
                  for r, c in best_assign.items()}
    return FrontierSolution(status=status, objective=float(best_obj),
                            assignment=assignment,
                            wall_time=time.perf_counter() - t0,
                            nodes=nodes)
