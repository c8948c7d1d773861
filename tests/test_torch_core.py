"""The scheduling closure copied into ``repro_torch.core`` plans exactly
as ``repro.core`` does, and the port imports nothing of the JAX package.
"""
import ast
from pathlib import Path

import pytest

import repro.core.devices as jax_devices
import repro.core.executor as jax_executor
import repro.core.policies as jax_policies
import repro.core.workflow as jax_workflow
import repro_torch.core.devices as port_devices
import repro_torch.core.executor as port_executor
import repro_torch.core.policies as port_policies
import repro_torch.core.workflow as port_workflow

ROOT = Path(__file__).resolve().parents[1]

SIDES = {
    "jax": (jax_workflow, jax_devices, jax_executor, jax_policies),
    "port": (port_workflow, port_devices, port_executor, port_policies),
}


def serving_workflow(wfmod, nq=4):
    """The workflow of tests/test_serving.py."""
    Stage, Workflow = wfmod.Stage, wfmod.Workflow
    stages = {
        "retrieve": Stage("retrieve", "qwen-7b", base_cost={-1: 0.01},
                          prefix_group="ctx", max_shards=2),
        "work_a": Stage("work_a", "llama-8b", base_cost={-1: 0.02},
                        parents=("retrieve",)),
        "work_b": Stage("work_b", "qwen-7b", base_cost={-1: 0.02},
                        prefix_group="ctx", parents=("retrieve",)),
        "merge": Stage("merge", "qwen-7b", base_cost={-1: 0.015},
                       prefix_group="ctx",
                       parents=("work_a", "work_b")),
    }
    return Workflow(wid="serve-test", stages=stages, num_queries=nq)


def wide_workflow(wfmod, nq=16):
    """One root, a frontier of eight workers over three models and two
    prefix groups, one merge."""
    Stage, Workflow = wfmod.Stage, wfmod.Workflow
    models = ["qwen-7b", "llama-8b", "qwen-14b"]
    stages = {"root": Stage("root", "qwen-7b", base_cost={-1: 0.01},
                            prefix_group="ctx", max_shards=4)}
    workers = []
    for i in range(8):
        sid = f"w{i}"
        workers.append(sid)
        stages[sid] = Stage(
            sid, models[i % 3], base_cost={-1: 0.01 + 0.005 * (i % 4)},
            parents=("root",), max_shards=1 + i % 3,
            prefix_group=("ctx", "aux", None)[i % 3])
    stages["merge"] = Stage("merge", "qwen-7b", base_cost={-1: 0.02},
                            prefix_group="ctx", parents=tuple(workers))
    return Workflow(wid="wide", stages=stages, num_queries=nq)


def drive(side: str, make_wf, policy_name: str, n_devices: int,
          hetero: bool):
    """Plan a workflow to its end the way the serving engine does (plan the
    ready set, commit, advance a deterministic clock) and return every
    placement in order."""
    wfmod, devmod, execmod, polmod = SIDES[side]
    wf = make_wf(wfmod)
    cluster = (devmod.heterogeneous_cluster(n_devices) if hetero
               else devmod.homogeneous_cluster(n_devices))
    state = execmod.fresh_state(cluster)
    policy = polmod.make_policy(policy_name)
    completed, trace, now = set(), [], 0.0
    while len(completed) < len(wf.stages):
        ready = [sid for sid in wf.topo_order if sid not in completed
                 and all(p in completed for p in wf.stages[sid].parents)]
        placements = policy.plan(wf, state, ready)
        assert placements, f"{side}/{policy_name}: nothing planned"
        for p in placements:
            if p.sid in completed:
                continue
            stage = wf.stages[p.sid]
            trace.append((p.wid, p.sid, tuple(p.devices),
                          tuple(p.shard_sizes), p.model))
            completed.add(p.sid)
            now += 0.125
            state.now = now
            for d in p.devices:
                state.set_free_at(d, now)
                state.set_resident(d, stage.model)
                if stage.keep_cache:
                    state.warm_prefix(d, stage.prefix_group, stage.model,
                                      wf.num_queries, now)
            state.output_loc[(wf.wid, p.sid)] = p.devices
            state.completed.add((wf.wid, p.sid))
    return trace


@pytest.mark.parametrize("policy", sorted(jax_policies.POLICY_REGISTRY))
@pytest.mark.parametrize("case", ["serving-2dev", "wide-4dev-hetero",
                                  "wide-8dev"])
def test_same_placements_as_jax_package(policy, case):
    make_wf, n, hetero = {
        "serving-2dev": (serving_workflow, 2, False),
        "wide-4dev-hetero": (wide_workflow, 4, True),
        "wide-8dev": (wide_workflow, 8, False),
    }[case]
    want = drive("jax", make_wf, policy, n, hetero)
    got = drive("port", make_wf, policy, n, hetero)
    assert got == want
    assert {t[1] for t in got} == set(make_wf(port_workflow).stages)


def test_policy_registries_agree():
    assert sorted(port_policies.POLICY_REGISTRY) == \
        sorted(jax_policies.POLICY_REGISTRY)
    assert {"FATE", "RoundRobin"} <= set(port_policies.POLICY_REGISTRY)


def test_fresh_state_matches():
    a = jax_executor.fresh_state(jax_devices.homogeneous_cluster(3))
    b = port_executor.fresh_state(port_devices.homogeneous_cluster(3))
    assert sorted(a.profiles) == sorted(b.profiles)
    for name in a.profiles:
        assert a.profiles[name].switch_cost == b.profiles[name].switch_cost
    assert a.now == b.now == 0.0


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    return roots


PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "serve_workflow_torch.py"]


def test_port_files_found():
    assert len(PORT_FILES) > 30


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax_and_no_repro(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "flax", "repro"}, (path, roots)
