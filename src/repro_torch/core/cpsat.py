"""Exact 0-1 solver for FATE's frontier placement ILP.

``ortools`` is not installable in the offline container, so this module
provides an exact branch-and-bound solver for the constraint class the
frontier planner emits (Appendix A.2):

  * binary variables
  * AddAtMostOne over variable groups (device capacity, slot uniqueness)
  * AddImplication(a, b): a -> b   (slot monotonicity)
  * Maximize(linear objective)

The interface mirrors CP-SAT (``BoolVar``/``AddAtMostOne``/
``AddImplication``/``Maximize``/``Solve`` returning ``OPTIMAL``), so the
real ortools solver can be swapped in unchanged.  DFS branch-and-bound
over variables in descending-weight order with an admissible bound (sum
of positive weights of free variables, tightened per at-most-one group)
proves optimality on every instance; frontier instances are ≤ 64 stages
× ≤ 2 slots × ≤ 8 devices and solve in well under a millisecond
(benchmarked in Table 12's analogue).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

OPTIMAL = "OPTIMAL"
INFEASIBLE = "INFEASIBLE"


@dataclasses.dataclass
class _Var:
    idx: int
    name: str


class CpModel:
    """Constraint model for the frontier ILP class (see module doc)."""

    def __init__(self) -> None:
        self._n = 0
        self._names: list[str] = []
        self._amo_groups: list[list[int]] = []     # at-most-one groups
        self._implications: list[tuple[int, int]] = []   # a -> b
        self._objective: dict[int, float] = {}
        self._fixed_false: set[int] = set()
        self._hints: dict[int, int] = {}           # solution hints

    def new_bool_var(self, name: str = "") -> _Var:
        v = _Var(self._n, name or f"x{self._n}")
        self._n += 1
        self._names.append(v.name)
        return v

    def add_at_most_one(self, vs: Sequence[_Var]) -> None:
        self._amo_groups.append([v.idx for v in vs])

    def add_implication(self, a: _Var, b: _Var) -> None:
        """a == 1 implies b == 1."""
        self._implications.append((a.idx, b.idx))

    def fix_false(self, v: _Var) -> None:
        self._fixed_false.add(v.idx)

    def add_hint(self, v: _Var, value: int = 1) -> None:
        """CP-SAT-style solution hint (``AddHint`` analogue).

        Hints with value 1 are tried first by the solver's warm-start
        pass, so a previous wave's assignment seeds the incumbent
        before the DFS.  Hints are advisory: infeasible or dominated
        hints are silently dropped and the returned optimum is
        unaffected.
        """
        self._hints[v.idx] = int(value)

    def maximize(self, terms: Sequence[tuple[_Var, float]]) -> None:
        """Set the linear objective to maximize."""
        self._objective = {v.idx: float(w) for v, w in terms}


@dataclasses.dataclass
class SolveResult:
    status: str
    objective: float
    values: dict[int, int]
    wall_time: float
    nodes: int
    proven_gap: float = 0.0


class CpSolver:
    """DFS branch-and-bound with group-aware admissible bound.

    A greedy warm-start incumbent (descending-weight feasible
    assignment — the best-per-row pick for frontier instances) is
    installed before the DFS so the bound prunes from the first node;
    the incumbent is feasible, so optimality is unaffected.  Scratch
    arrays are kept on the solver instance and reused across solves.
    """

    def __init__(self, time_limit: float = 5.0, warm_start: bool = True):
        self.time_limit = time_limit
        self.warm_start = warm_start
        self._assign_buf: list[int] = []
        self._group_buf: list[bool] = []

    def _scratch(self, n_vars: int, n_groups: int
                 ) -> tuple[list[int], list[bool]]:
        """Reusable assign/group-used arrays (resized, then re-filled)."""
        if len(self._assign_buf) < n_vars:
            self._assign_buf.extend([-1] * (n_vars - len(self._assign_buf)))
        if len(self._group_buf) < n_groups:
            self._group_buf.extend(
                [False] * (n_groups - len(self._group_buf)))
        for i in range(n_vars):
            self._assign_buf[i] = -1
        for g in range(n_groups):
            self._group_buf[g] = False
        return self._assign_buf, self._group_buf

    def solve(self, model: CpModel) -> SolveResult:
        t0 = time.perf_counter()
        n = model._n
        w = [model._objective.get(i, 0.0) for i in range(n)]
        # variable -> groups; variable -> implications (a->b: b required)
        groups_of: list[list[int]] = [[] for _ in range(n)]
        for gi, g in enumerate(model._amo_groups):
            for v in g:
                groups_of[v].append(gi)
        needs: list[list[int]] = [[] for _ in range(n)]   # a -> required b
        blocked_by: list[list[int]] = [[] for _ in range(n)]  # b=0 -> a=0
        for a, b in model._implications:
            needs[a].append(b)
            blocked_by[b].append(a)

        # branch order: descending weight (set-to-1 first)
        order = sorted(range(n), key=lambda i: -w[i])
        pos = {v: k for k, v in enumerate(order)}

        # admissible suffix bounds over positions [k:):
        #   suffix    — plain sum of positive weights
        #   gdev/gslot — group-capped: each at-most-one group contributes
        #   at most its best remaining member (designating each var to
        #   its first / second group resp.); min of all three is used.
        suffix = [0.0] * (len(order) + 1)
        for k in range(len(order) - 1, -1, -1):
            suffix[k] = suffix[k + 1] + max(0.0, w[order[k]])

        def group_capped(designate: int) -> list[float]:
            out = [0.0] * (len(order) + 1)
            gmax: dict[int, float] = {}
            total = 0.0
            for k in range(len(order) - 1, -1, -1):
                v = order[k]
                wp = max(0.0, w[v])
                gs = groups_of[v]
                if len(gs) > designate:
                    g = gs[designate]
                    old = gmax.get(g, 0.0)
                    if wp > old:
                        total += wp - old
                        gmax[g] = wp
                else:
                    total += wp
                out[k] = total
            return out

        gdev = group_capped(0)
        gslot = group_capped(1)
        bound_at = [min(a, b, c) for a, b, c in zip(suffix, gdev, gslot)]

        best_val = -1.0
        best_assign: dict[int, int] = {}
        assign, group_used = self._scratch(n, len(model._amo_groups))
        nodes = 0
        deadline = t0 + self.time_limit

        for i in model._fixed_false:
            assign[i] = 0

        def feasible_one(v: int) -> bool:
            if assign[v] == 0:
                return False
            for g in groups_of[v]:
                if group_used[g]:
                    return False
            for b in needs[v]:
                if assign[b] == 0:
                    return False
            return True

        def set_one(v: int) -> Optional[list]:
            """Set v=1 with propagation; returns undo log or None.
            Maintains ``value`` for every assignment it makes."""
            nonlocal value
            undo: list = []
            for g in groups_of[v]:
                group_used[g] = True
                undo.append(("g", g))
            assign[v] = 1
            value += w[v]
            undo.append(("v", v))
            # propagate: all needs must become 1 (chain)
            stack = list(needs[v])
            while stack:
                b = stack.pop()
                if assign[b] == 1:
                    continue
                if assign[b] == 0:
                    _undo(undo)
                    return None
                for g in groups_of[b]:
                    if group_used[g]:
                        _undo(undo)
                        return None
                for g in groups_of[b]:
                    group_used[g] = True
                    undo.append(("g", g))
                assign[b] = 1
                value += w[b]
                undo.append(("v", b))
                stack.extend(needs[b])
            return undo

        def set_zero(v: int) -> Optional[list]:
            undo: list = []
            stack = [v]
            while stack:
                x = stack.pop()
                if assign[x] == 0:
                    continue
                if assign[x] == 1:
                    _undo(undo)
                    return None
                assign[x] = 0
                undo.append(("v0", x))
                stack.extend(blocked_by[x])
            return undo

        value = 0.0

        def _undo(undo: list) -> None:
            nonlocal value
            for kind, x in reversed(undo):
                if kind == "g":
                    group_used[x] = False
                elif kind == "v":
                    assign[x] = -1
                    value -= w[x]
                else:
                    assign[x] = -1

        # greedy warm-start incumbent: walk variables in bound order —
        # solution-hinted variables first (a previous wave's assignment,
        # see CpModel.add_hint), then the rest — taking every
        # positive-weight feasible set-to-1 (with implied propagation).
        # Feasible by construction, so it seeds best_val without
        # cutting the optimum; the DFS then prunes against it from node
        # one instead of descending to a leaf first.
        if self.warm_start:
            hints = model._hints
            warm_order = order
            if hints:
                warm_order = ([v for v in order if hints.get(v) == 1]
                              + [v for v in order if hints.get(v) != 1])
            warm_undos: list[list] = []
            for v in warm_order:
                if assign[v] != -1 or w[v] <= 0 or not feasible_one(v):
                    continue
                u = set_one(v)
                if u is not None:
                    warm_undos.append(u)
            if value > best_val:
                # ε-below seeding (mirrors frontier_solver's hint
                # incumbent): the DFS still re-finds — in its own
                # deterministic order — any solution tying the greedy
                # value, so warm starts and hints only prune, they
                # never change which tied-optimal assignment is
                # returned.
                best_val = value - 1e-9
                best_assign = {i: (1 if assign[i] == 1 else 0)
                               for i in range(n)}
            for u in reversed(warm_undos):
                _undo(u)

        # iterative DFS: frames are (k, phase, undo_log); phase 0 = try
        # v=1 branch, phase 1 = try v=0 branch, phase 2 = done.
        stack: list[list] = [[0, 0, None]]
        while stack:
            frame = stack[-1]
            k, phase = frame[0], frame[1]
            if phase == 0:
                nodes += 1
                if (time.perf_counter() > deadline
                        or value + bound_at[k] <= best_val + 1e-12):
                    stack.pop()
                    if frame[2] is not None:
                        _undo(frame[2])
                    continue
                if k == len(order):
                    if value > best_val:
                        best_val = value
                        best_assign = {i: (1 if assign[i] == 1 else 0)
                                       for i in range(n)}
                    stack.pop()
                    if frame[2] is not None:
                        _undo(frame[2])
                    continue
                v = order[k]
                if assign[v] != -1:
                    frame[1] = 2
                    stack.append([k + 1, 0, None])
                    continue
                frame[1] = 1
                if w[v] > 0 and feasible_one(v):
                    undo = set_one(v)
                    if undo is not None:
                        stack.append([k + 1, 0, undo])
                        continue
                continue
            if phase == 1:
                v = order[k]
                frame[1] = 2
                undo = set_zero(v)
                if undo is not None:
                    stack.append([k + 1, 0, undo])
                continue
            # phase 2: unwind
            stack.pop()
            if frame[2] is not None:
                _undo(frame[2])
        wall = time.perf_counter() - t0
        status = OPTIMAL if wall <= self.time_limit else "FEASIBLE"
        if best_val < 0:
            # all-zeros is always feasible for this constraint class
            best_val = 0.0
            best_assign = {i: 0 for i in range(n)}
        return SolveResult(status=status, objective=best_val,
                           values=best_assign, wall_time=wall, nodes=nodes)


def solve_frontier(model: CpModel,
                   time_limit: float = 5.0) -> SolveResult:
    return CpSolver(time_limit).solve(model)
