"""Workflow DAG model: stages, attributes, and per-instance query batches.

Mirrors the paper's formulation (§2): each stage v carries
``(m(v), A(v), R(v), c_v, φ(v), Pa(v), Ch(v))`` — model type, eligible
devices, bounded shard degree, base runtime profile, stage-local
features (prompt metadata, shared-prefix group, cache flags), and DAG
neighbors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

# Globally-unique stage identity: (workflow id, stage id).  The
# single-workflow planner keys rows by bare ``sid``; the shared-frontier
# serving layer tags every row with its owning workflow so many in-flight
# DAGs can contend inside one frontier problem.
StageKey = tuple[str, str]


@dataclasses.dataclass
class Stage:
    sid: str
    model: str                               # m(v): model alias
    eligible: tuple[int, ...] = ()           # A(v): device ids; () = all
    max_shards: int = 1                      # R(v)
    # base runtime profile c_v(d): per-query seconds on device d;
    # keyed by device id, with -1 as the default entry.
    base_cost: dict[int, float] = dataclasses.field(default_factory=dict)
    # φ(v) — stage-local features
    prefix_group: Optional[str] = None       # shared-prefix group id
    shared_fraction: float = 1.0             # queries in shared groups
    keep_cache: bool = True
    cache_reuse: bool = True
    output_tokens: float = 256.0             # output-size proxy (tokens)
    prefill_fraction: float = 0.6            # share of cost that is prefill
    comm_weight: float = 1.0                 # communication weight
    role: str = "worker"
    level: int = 0
    parents: tuple[str, ...] = ()
    children: tuple[str, ...] = ()
    # cost/quality routing (core/routing.py): alternate model aliases
    # the planner may serve this stage with, as (alias, quality) pairs
    # where quality in (0, 1] is relative to the default ``model``
    # (implicitly quality 1.0).  Empty = routing never touches the
    # stage, so legacy workflows are untouched by construction.
    candidates: tuple[tuple[str, float], ...] = ()

    def cost_on(self, device: int) -> float:
        if device in self.base_cost:
            return self.base_cost[device]
        return self.base_cost.get(-1, 1.0)

    def to_dict(self) -> dict:
        """Plain-JSON document (``base_cost`` device keys stringified;
        derived ``children``/``level`` omitted — ``Workflow._wire``
        recomputes them).  Inverse of :meth:`from_dict`."""
        return {
            "sid": self.sid, "model": self.model,
            "eligible": list(self.eligible),
            "max_shards": self.max_shards,
            "base_cost": {str(d): c for d, c in self.base_cost.items()},
            "prefix_group": self.prefix_group,
            "shared_fraction": self.shared_fraction,
            "keep_cache": self.keep_cache,
            "cache_reuse": self.cache_reuse,
            "output_tokens": self.output_tokens,
            "prefill_fraction": self.prefill_fraction,
            "comm_weight": self.comm_weight,
            "role": self.role,
            "parents": list(self.parents),
            "candidates": [[m, q] for m, q in self.candidates],
        }

    @classmethod
    def from_dict(cls, doc: dict) -> "Stage":
        """Rebuild a stage from :meth:`to_dict` output."""
        doc = dict(doc)
        doc["eligible"] = tuple(doc.get("eligible") or ())
        doc["parents"] = tuple(doc.get("parents") or ())
        doc["base_cost"] = {int(d): c
                            for d, c in doc.get("base_cost", {}).items()}
        # pre-routing documents have no "candidates" key; absent or
        # null loads as "no alternates" (routing disabled for the stage)
        doc["candidates"] = tuple((str(m), float(q))
                                  for m, q in doc.get("candidates") or ())
        return cls(**doc)


@dataclasses.dataclass
class Workflow:
    wid: str
    stages: dict[str, Stage]
    num_queries: int = 16                    # batch of independent queries
    family: str = ""
    meta: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        self._generation = 0
        self._wire()

    @property
    def generation(self) -> int:
        """Topology generation counter.

        Bumped by :meth:`invalidate_topology` whenever the stage graph is
        mutated after construction.  Consumers that memoize per-workflow
        derived data (descendant tables here, base-cost rows and tail
        term plans in :mod:`repro_torch.core.scoring`) key or guard their
        caches on this counter so a mutated workflow is never scored
        against stale topology.
        """
        return self._generation

    def invalidate_topology(self) -> None:
        """Declare an in-place mutation of ``stages`` (added stages,
        rewired parents, edited cost profiles).  Re-wires children /
        levels / topo order, drops the descendant cache, and bumps
        :attr:`generation` so downstream memoized scorers re-derive."""
        self._generation += 1
        self._wire()

    def stage_key(self, sid: str) -> StageKey:
        """Workflow-tagged stage id for cross-DAG frontiers."""
        return (self.wid, sid)

    def _wire(self) -> None:
        """Recompute children from parents and topological levels."""
        self._desc_cache: dict[int, dict[str, tuple[tuple[str, int], ...]]]
        self._desc_cache = {}
        kids: dict[str, list[str]] = {s: [] for s in self.stages}
        for s in self.stages.values():
            for p in s.parents:
                if p not in self.stages:
                    raise ValueError(f"{self.wid}: unknown parent {p}")
                kids[p].append(s.sid)
        for sid, ch in kids.items():
            self.stages[sid].children = tuple(sorted(ch))
        # levels via Kahn topological pass (also validates acyclicity)
        indeg = {s.sid: len(s.parents) for s in self.stages.values()}
        frontier = [sid for sid, d in indeg.items() if d == 0]
        seen = 0
        level = {sid: 0 for sid in frontier}
        order: list[str] = []
        while frontier:
            nxt: list[str] = []
            for sid in frontier:
                order.append(sid)
                seen += 1
                for ch in self.stages[sid].children:
                    indeg[ch] -= 1
                    level[ch] = max(level.get(ch, 0),
                                    level.get(sid, 0) + 1)
                    if indeg[ch] == 0:
                        nxt.append(ch)
            frontier = nxt
        if seen != len(self.stages):
            raise ValueError(f"{self.wid}: cycle detected")
        for sid, lv in level.items():
            self.stages[sid].level = lv
        self._topo = order

    @property
    def topo_order(self) -> list[str]:
        return list(self._topo)

    def descendants_within(self, sid: str,
                           depth: int) -> tuple[tuple[str, int], ...]:
        """Horizon-bounded descendant list ``((uid, dist), ...)``.

        Cached per depth so the planner's per-(stage, device) scoring
        never re-walks the DAG (the seed implementation re-ran this BFS
        for every candidate pair).  The traversal order is the exact
        LIFO order of the original ``Scorer._descendants_within`` so
        vectorized score accumulation stays bit-identical to the scalar
        path.
        """
        table = self._desc_cache.get(depth)
        if table is None:
            table = {}
            for start in self.stages:
                out: list[tuple[str, int]] = []
                frontier = [(start, 0)]
                seen = {start}
                while frontier:
                    cur, d = frontier.pop()
                    if d >= depth:
                        continue
                    for ch in self.stages[cur].children:
                        if ch in seen:
                            continue
                        seen.add(ch)
                        out.append((ch, d + 1))
                        frontier.append((ch, d + 1))
                table[start] = tuple(out)
            self._desc_cache[depth] = table
        return table[sid]

    def levels(self) -> dict[int, list[str]]:
        out: dict[int, list[str]] = {}
        for s in self.stages.values():
            out.setdefault(s.level, []).append(s.sid)
        return {k: sorted(v) for k, v in sorted(out.items())}

    def max_level(self) -> int:
        return max((s.level for s in self.stages.values()), default=0)

    def sources(self) -> list[str]:
        return [s.sid for s in self.stages.values() if not s.parents]

    def sinks(self) -> list[str]:
        return [s.sid for s in self.stages.values() if not s.children]

    def validate(self) -> None:
        for s in self.stages.values():
            if s.max_shards < 1:
                raise ValueError(f"{s.sid}: R(v) must be >= 1")
            if not s.base_cost:
                raise ValueError(f"{s.sid}: missing runtime profile")

    def to_dict(self) -> dict:
        """Plain-JSON document of the DAG (stages in insertion order —
        ``stages`` dict order determines topo tie-breaks, so it is
        part of the serialized contract).  Inverse of
        :meth:`from_dict`; ``meta`` must be JSON-serializable."""
        return {
            "wid": self.wid,
            "stages": [s.to_dict() for s in self.stages.values()],
            "num_queries": self.num_queries,
            "family": self.family,
            "meta": dict(self.meta),
        }

    @classmethod
    def from_dict(cls, doc: dict) -> "Workflow":
        """Rebuild a workflow from :meth:`to_dict` output (re-wires
        children/levels/topo order from the stage parent lists)."""
        stages = {}
        for sdoc in doc["stages"]:
            st = Stage.from_dict(sdoc)
            stages[st.sid] = st
        return cls(wid=doc["wid"], stages=stages,
                   num_queries=doc.get("num_queries", 16),
                   family=doc.get("family", ""),
                   meta=dict(doc.get("meta") or {}))


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """Runtime proxy profile for a model alias (Appendix C.1)."""
    name: str
    size_gb: float                 # memory footprint
    prefill_coef: float            # sec per 1k prompt tokens per query
    decode_coef: float             # sec per 1k output tokens per query
    switch_cost: float             # model load/activation seconds
    family: str = "generic"


DEFAULT_PROFILES: dict[str, ModelProfile] = {
    # Qwen-style / DeepSeek-style / Llama-style 7–8B profiles (paper C.1)
    "qwen-7b": ModelProfile("qwen-7b", 15.0, 0.011, 0.105, 6.5,
                            family="qwen"),
    "deepseek-7b": ModelProfile("deepseek-7b", 14.5, 0.012, 0.115, 7.0,
                                family="deepseek"),
    "llama-8b": ModelProfile("llama-8b", 16.0, 0.013, 0.120, 7.5,
                             family="llama"),
    "qwen-14b": ModelProfile("qwen-14b", 28.0, 0.021, 0.195, 11.0,
                             family="qwen"),
    "llama-3b": ModelProfile("llama-3b", 6.5, 0.006, 0.055, 3.2,
                             family="llama"),
}
