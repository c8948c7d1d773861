"""DAG lifting: raw task DAGs -> LLM-stage execution graphs
(paper Appendix C.1).

Steps: (1) collapse tasks with the same normalized task-name prefix into
stage groups (splitting oversized groups so prefix collapse does not
over-compress, capping total stages at 64); (2) annotate structure
(level, in/out-degree); (3) assign role templates via deterministic
structural rules; (4) assign model aliases per role with a stable hash
(construction seed 20260423); (5) attach runtime / switch / transfer /
prefix-cache proxies.
"""
from __future__ import annotations

import hashlib
import random
from typing import Optional

from repro_torch.core.workflow import (DEFAULT_PROFILES, ModelProfile, Stage,
                                 Workflow)
from repro_torch.workflowbench.families import (FAMILIES, FIXED_MODEL_FAMILIES,
                                          RawDag)

CONSTRUCTION_SEED = 20260423
MAX_STAGES = 64
MIN_STAGES = 6
GROUP_SPLIT = 4          # max raw tasks collapsed into one stage group


# ---------------------------------------------------------------------------
# Role templates (paper C.1 "Stage-role templates")
# ---------------------------------------------------------------------------

ROLE_ATTRS: dict[str, dict] = {
    # role: complexity, prompt_ktokens, output_tokens, comm_w, R(v), cache
    "prompt_prep":   dict(cx=0.6, prompt=1.0, out=128, comm=0.6, r=1,
                          reuse=False),
    "retrieval":     dict(cx=0.8, prompt=2.0, out=256, comm=1.2, r=2,
                          reuse=True),
    "routing":       dict(cx=0.5, prompt=0.8, out=64, comm=0.5, r=1,
                          reuse=False),
    "decomposition": dict(cx=0.9, prompt=1.5, out=384, comm=1.0, r=1,
                          reuse=True),
    "worker":        dict(cx=1.0, prompt=2.5, out=512, comm=1.0, r=2,
                          reuse=True),
    "merge":         dict(cx=0.9, prompt=3.0, out=384, comm=1.5, r=1,
                          reuse=False),
    "aggregation":   dict(cx=1.0, prompt=3.5, out=512, comm=1.5, r=1,
                          reuse=False),
    "summarization": dict(cx=0.8, prompt=3.0, out=512, comm=1.0, r=1,
                          reuse=True),
    "validation":    dict(cx=0.7, prompt=2.0, out=192, comm=0.8, r=2,
                          reuse=True),
    "final_synthesis": dict(cx=1.1, prompt=3.5, out=768, comm=1.2, r=1,
                            reuse=False),
}

ROLE_MODELS: dict[str, list[str]] = {
    "prompt_prep": ["llama-3b", "qwen-7b"],
    "retrieval": ["qwen-7b", "deepseek-7b"],
    "routing": ["llama-3b"],
    "decomposition": ["qwen-14b", "deepseek-7b"],
    "worker": ["qwen-7b", "deepseek-7b", "llama-8b"],
    "merge": ["llama-8b", "qwen-7b"],
    "aggregation": ["qwen-14b", "llama-8b"],
    "summarization": ["qwen-7b", "llama-8b"],
    "validation": ["deepseek-7b", "llama-3b"],
    "final_synthesis": ["qwen-14b", "llama-8b"],
}


def _stable_hash(*parts: str) -> int:
    h = hashlib.sha256("|".join(parts).encode()).hexdigest()
    return int(h[:12], 16)


def collapse(raw: RawDag) -> tuple[dict[str, list[str]],
                                   dict[str, set[str]]]:
    """Group raw tasks by name family (split into chunks of GROUP_SPLIT);
    return (group -> member tasks, group -> parent groups)."""
    by_family: dict[str, list[str]] = {}
    for t in raw.values():
        by_family.setdefault(t.name_family, []).append(t.tid)
    groups: dict[str, list[str]] = {}
    task_group: dict[str, str] = {}
    for fam, tids in sorted(by_family.items()):
        tids = sorted(tids)
        n_chunks = max(1, (len(tids) + GROUP_SPLIT - 1) // GROUP_SPLIT)
        for c in range(n_chunks):
            gid = fam if n_chunks == 1 else f"{fam}.{c}"
            members = tids[c::n_chunks]
            groups[gid] = members
            for tid in members:
                task_group[tid] = gid
    # merge smallest groups if over MAX_STAGES
    while len(groups) > MAX_STAGES:
        fams: dict[str, list[str]] = {}
        for gid in groups:
            fams.setdefault(gid.split(".")[0], []).append(gid)
        fam, gids = max(((f, g) for f, g in fams.items() if len(g) > 1),
                        key=lambda kv: len(kv[1]), default=(None, None))
        if fam is None:
            break
        keep, drop = gids[0], gids[-1]
        groups[keep] = groups[keep] + groups.pop(drop)
        for tid in groups[keep]:
            task_group[tid] = keep
    edges: dict[str, set[str]] = {g: set() for g in groups}
    for t in raw.values():
        g = task_group[t.tid]
        for p in t.parents:
            pg = task_group[p]
            if pg != g:
                edges[g].add(pg)
    return groups, edges


def _assign_role(gid: str, level: int, max_level: int, indeg: int,
                 outdeg: int, n_members: int) -> str:
    if level == 0:
        if outdeg >= 4 or n_members >= 4:
            return "decomposition"
        if outdeg >= 2:
            return "retrieval"
        return "prompt_prep"
    if indeg >= 4:
        return "aggregation" if level >= max_level - 1 else "merge"
    if level >= max_level and indeg >= 1:
        return "final_synthesis"
    if level >= max_level - 1:
        if indeg >= 2:
            return "summarization"
        return "validation"
    if outdeg >= 3:
        return "decomposition"
    if n_members >= 3 or outdeg >= 1:
        return "worker"
    return "worker"


def lift(raw: RawDag, *, family: str, wid: str, num_queries: int,
         profiles: Optional[dict[str, ModelProfile]] = None,
         seed: int = CONSTRUCTION_SEED,
         prefix_sharing: bool = True) -> Workflow:
    profiles = profiles or DEFAULT_PROFILES
    groups, gedges = collapse(raw)

    # structural annotation: topological order + levels over the group DAG
    level: dict[str, int] = {}
    ordered: list[str] = []
    done: set[str] = set()
    frontier = sorted(g for g, ps in gedges.items() if not ps)
    while frontier:
        for g in frontier:
            level[g] = max([level[p] + 1 for p in gedges[g]] or [0])
            ordered.append(g)
            done.add(g)
        frontier = sorted(g for g in gedges if g not in done
                          and all(p in done for p in gedges[g]))
    if len(ordered) != len(groups):
        raise ValueError(f"{wid}: lifted group graph has a cycle")
    max_level = max(level.values(), default=0)
    outdeg: dict[str, int] = {g: 0 for g in groups}
    for g, ps in gedges.items():
        for p in ps:
            outdeg[p] += 1

    fixed_model = FIXED_MODEL_FAMILIES.get(family)
    stages: dict[str, Stage] = {}
    for gid in ordered:
        indeg = len(gedges[gid])
        role = _assign_role(gid, level[gid], max_level, indeg,
                            outdeg[gid], len(groups[gid]))
        attrs = ROLE_ATTRS[role]
        if fixed_model is not None:
            model = fixed_model
        else:
            cands = ROLE_MODELS[role]
            model = cands[_stable_hash(str(seed), wid, gid) % len(cands)]
        prof = profiles[model]
        # runtime proxy: per-query seconds (same on all devices of the
        # paper's homogeneous 8-GPU setting)
        prefill_part = prof.prefill_coef * attrs["prompt"] * attrs["cx"]
        decode_part = prof.decode_coef * attrs["out"] / 1000.0
        per_query = prefill_part + decode_part
        pgroup = None
        if prefix_sharing and attrs["reuse"]:
            # reuse-eligible stages share the workflow's long-context
            # prefix (system prompt + task context); reuse is realized
            # only when a later stage lands on a device whose cache was
            # warmed under the SAME model (state.py keys entries by
            # model), mirroring per-model KV incompatibility.
            pgroup = f"{wid}:ctx"
        stages[gid] = Stage(
            sid=gid, model=model, max_shards=attrs["r"],
            base_cost={-1: per_query},
            prefix_group=pgroup,
            keep_cache=True, cache_reuse=attrs["reuse"],
            output_tokens=float(attrs["out"]),
            prefill_fraction=prefill_part / per_query,
            comm_weight=attrs["comm"], role=role,
            parents=tuple(sorted(gedges[gid])),
        )
    wf = Workflow(wid=wid, stages=stages, num_queries=num_queries,
                  family=family, meta={"raw_tasks": len(raw)})
    return wf


def build_instance(family: str, index: int, num_queries: int,
                   seed: int = CONSTRUCTION_SEED) -> Workflow:
    gen, _ = FAMILIES[family]
    rng = random.Random(_stable_hash(str(seed), family, str(index)))
    raw = gen(rng)
    wid = f"{family}-{index:03d}-q{num_queries}"
    return lift(raw, family=family, wid=wid, num_queries=num_queries,
                seed=seed)


def build_benchmark(num_queries_list=(16, 32),
                    seed: int = CONSTRUCTION_SEED) -> list[Workflow]:
    """The full workflow-DAG benchmark (fixed manifest)."""
    out: list[Workflow] = []
    for family, (gen, count) in FAMILIES.items():
        for i in range(count):
            for nq in num_queries_list:
                out.append(build_instance(family, i, nq, seed))
    return out
