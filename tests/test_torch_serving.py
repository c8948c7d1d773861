"""The port's serving engine on the CPU: the cases of
``tests/test_serving.py`` and the engine case of ``tests/test_faults.py``
re-run on ``repro_torch``, and — in float32, from converted parameters —
the same greedy tokens as the JAX engine for every stage of the workflow,
served by the dense pair (qwen3 + glm4) and by the MoE + RWKV6 pair
(granite-moe as ``"qwen-7b"``, rwkv6 as ``"llama-8b"``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import SMOKE as JAX_SMOKE
from repro.core.devices import homogeneous_cluster as jax_cluster
from repro.core.executor import fresh_state as jax_fresh_state
from repro.core.policies import make_policy as jax_make_policy
from repro.core.workflow import Stage as JaxStage
from repro.core.workflow import Workflow as JaxWorkflow
from repro.serving import engine as jax_engine
from repro_torch.configs.archs import SMOKE
from repro_torch.convert import params_from_jax
from repro_torch.core.calibration import CalibrationProfile
from repro_torch.core.devices import homogeneous_cluster
from repro_torch.core.executor import fresh_state
from repro_torch.core.faults import (FaultInjector, FaultPlan, ShardFailure,
                                     TransientStageFailure)
from repro_torch.core.policies import make_policy
from repro_torch.core.workflow import Stage, Workflow
from repro_torch.serving.engine import (ModelBundle, ServingEngine,
                                        calibrated_switch_sleep)


def _configs(smoke, dtype=None):
    cfg_a = smoke["qwen3-1.7b"]
    cfg_b = dataclasses.replace(smoke["glm4-9b"],
                                vocab_size=cfg_a.vocab_size)
    if dtype:
        cfg_a = dataclasses.replace(cfg_a, dtype=dtype)
        cfg_b = dataclasses.replace(cfg_b, dtype=dtype)
    return {"qwen-7b": (cfg_a, 0), "llama-8b": (cfg_b, 1)}


@pytest.fixture(scope="module")
def bundles():
    return {name: ModelBundle.create(name, cfg, seed=seed, device="cpu")
            for name, (cfg, seed) in _configs(SMOKE).items()}


def _workflow(stage_cls=Stage, workflow_cls=Workflow, nq=4):
    stages = {
        "retrieve": stage_cls("retrieve", "qwen-7b", base_cost={-1: 0.01},
                              prefix_group="ctx", max_shards=2),
        "work_a": stage_cls("work_a", "llama-8b", base_cost={-1: 0.02},
                            parents=("retrieve",)),
        "work_b": stage_cls("work_b", "qwen-7b", base_cost={-1: 0.02},
                            prefix_group="ctx", parents=("retrieve",)),
        "merge": stage_cls("merge", "qwen-7b", base_cost={-1: 0.015},
                           prefix_group="ctx",
                           parents=("work_a", "work_b")),
    }
    return workflow_cls(wid="serve-test", stages=stages, num_queries=nq)


def _prompts(seed, nq=4, plen=8):
    return np.random.default_rng(seed).integers(0, 256, (nq, plen))


def _engine(bundles, **kw):
    kw.setdefault("prompt_len", 8)
    return ServingEngine(bundles, device="cpu", **kw)


def test_serving_end_to_end(bundles):
    wf = _workflow()
    engine = _engine(bundles, n_devices=2, gen_len=4)
    state = fresh_state(homogeneous_cluster(2))
    results = engine.run_workflow(wf, make_policy("FATE"), state,
                                  torch.from_numpy(_prompts(0)))
    assert set(results) == set(wf.stages)
    for sid, res in results.items():
        assert tuple(res.tokens_out.shape) == (4, 4)
        assert bool((res.tokens_out >= 0).all())
        assert bool((res.tokens_out < 256).all())
    # residency: devices ended up hosting the models used
    hosted = {d.resident for d in engine.devices}
    assert hosted <= {"qwen-7b", "llama-8b", None}
    # measured wall time reached the planner's state
    assert state.now > 0.0
    assert state.completed == {(wf.wid, sid) for sid in wf.stages}


def test_serving_residency_switch_counted(bundles):
    wf = _workflow()
    engine = _engine(bundles, n_devices=1, gen_len=2)
    state = fresh_state(homogeneous_cluster(1))
    engine.run_workflow(wf, make_policy("RoundRobin"), state,
                        torch.from_numpy(_prompts(1)))
    # single device + two models => at least 2 switches happened
    switched = sum(1 for r in engine.log if r.switched)
    assert switched >= 2


def test_serving_emits_calibration_observations(bundles):
    wf = _workflow()
    engine = _engine(bundles, n_devices=2, gen_len=4)
    state = fresh_state(homogeneous_cluster(2))
    engine.run_workflow(wf, make_policy("FATE"), state,
                        torch.from_numpy(_prompts(3)))
    obs = engine.observations()
    assert len(obs) == len(engine.log) == len(wf.stages)
    for o in obs:
        assert o.queries == 4
        assert o.prompt_tokens == 8 and o.output_tokens == 4
        assert o.wall_s > 0.0
        assert o.family in {"qwen", "llama"}
        assert o.transfer_ktokens == 0.0
    assert sum(o.switches for o in obs) >= 1
    # the merge stage re-runs the warm prefix group on its device
    assert any(o.prefix_fraction > 0.0 for o in obs)


def test_serving_engine_asserts_profile_consistency(bundles):
    profile = CalibrationProfile.hand_set().perturbed(switch_mul=0.5)
    wf = _workflow()
    engine = _engine(bundles, n_devices=2, gen_len=2, calibration=profile)
    prompts = torch.from_numpy(_prompts(4))
    # state still carries the hand-set constants -> load-time error
    state = fresh_state(homogeneous_cluster(2))
    with pytest.raises(ValueError, match="calibration mismatch"):
        engine.run_workflow(wf, make_policy("FATE"), state, prompts)
    # loading the SAME profile into the state reconciles them
    state = fresh_state(homogeneous_cluster(2),
                        profiles=profile.model_profiles())
    results = engine.run_workflow(wf, make_policy("FATE"), state, prompts)
    assert set(results) == set(wf.stages)


def test_serving_deterministic_outputs(bundles):
    wf = _workflow()
    prompts = torch.from_numpy(_prompts(2))
    outs = []
    for _ in range(2):
        engine = _engine(bundles, n_devices=2, gen_len=3)
        state = fresh_state(homogeneous_cluster(2))
        res = engine.run_workflow(wf, make_policy("FATE"), state, prompts)
        outs.append({k: v.tokens_out for k, v in res.items()})
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k])


def test_engine_retries_injected_transient_failure():
    wf = Workflow(wid="w", stages={
        "a": Stage(sid="a", model="m", base_cost={-1: 0.01}),
        "b": Stage(sid="b", model="m", base_cost={-1: 0.01},
                   parents=("a",)),
    }, num_queries=2)
    bundle = ModelBundle.create("m", SMOKE["qwen3-1.7b"], device="cpu")
    plan = FaultPlan(failures=(ShardFailure(wid="w", sid="a"),),
                     max_retries=2)
    eng = ServingEngine({"m": bundle}, n_devices=2, device="cpu",
                        faults=FaultInjector(plan))
    state = fresh_state(homogeneous_cluster(2))
    prompts = torch.zeros((2, 8), dtype=torch.int32)
    results = eng.run_workflow(wf, make_policy("RoundRobin"), state,
                               prompts)
    assert set(results) == {"a", "b"}
    assert eng.n_fault_retries == 1

    # with a zero retry budget the failure escapes
    eng2 = ServingEngine({"m": bundle}, n_devices=2, device="cpu",
                         faults=FaultInjector(FaultPlan(
                             failures=(ShardFailure(wid="w", sid="a"),),
                             max_retries=0)))
    state2 = fresh_state(homogeneous_cluster(2))
    with pytest.raises(TransientStageFailure):
        eng2.run_workflow(wf, make_policy("RoundRobin"), state2, prompts)


def test_switch_sleep_emulation(bundles):
    """A uniform ``switch_sleep`` shows up in the measured stage time; a
    ``switch_time_scale`` derives it from the model's profile."""
    wf = _workflow()
    engine = _engine(bundles, n_devices=1, gen_len=2, switch_sleep=0.05)
    state = fresh_state(homogeneous_cluster(1))
    engine.run_workflow(wf, make_policy("RoundRobin"), state,
                        torch.from_numpy(_prompts(5)))
    for r in engine.log:
        if r.switched:
            assert r.wall_s >= 0.05 * r.switches
    scaled = _engine(bundles, n_devices=1, switch_time_scale=1e-3)
    prof = scaled._profiles["qwen-7b"]
    assert scaled._switch_sleep_for(bundles["qwen-7b"]) == \
        pytest.approx(calibrated_switch_sleep(prof, time_scale=1e-3))
    assert _engine(bundles, n_devices=1)._switch_sleep_for(
        bundles["qwen-7b"]) == 0.0


def test_engine_defaults_to_the_gpu_and_checks_bundle_devices(bundles):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(bundles, n_devices=1)
    with pytest.raises(RuntimeError, match="cuda"):
        ModelBundle.create("m", SMOKE["qwen3-1.7b"])


# ---------------------------------------------------------------------------
# the same greedy tokens as the JAX engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def float32_engines():
    """JAX bundles in float32 and port bundles converted from them."""
    jax_bundles, port_bundles = {}, {}
    port_cfgs = _configs(SMOKE, "float32")
    for name, (jcfg, seed) in _configs(JAX_SMOKE, "float32").items():
        jb = jax_engine.ModelBundle.create(name, jcfg, seed=seed)
        jax_bundles[name] = jb
        tree = jax.tree.map(
            lambda x: np.asarray(x.astype(jnp.float32)), jb.params)
        cfg = port_cfgs[name][0]
        port_bundles[name] = ModelBundle.create(
            name, cfg, device="cpu",
            params=params_from_jax(tree, cfg, device="cpu"))
    return jax_bundles, port_bundles


@pytest.mark.parametrize("policy,n_devices", [("FATE", 2),
                                              ("RoundRobin", 1)])
def test_same_greedy_tokens_as_jax_engine(float32_engines, policy,
                                          n_devices):
    jax_bundles, port_bundles = float32_engines
    prompts = _prompts(6)
    gen_len = 5

    jeng = jax_engine.ServingEngine(jax_bundles, n_devices=n_devices,
                                    gen_len=gen_len, prompt_len=8)
    jres = jeng.run_workflow(
        _workflow(JaxStage, JaxWorkflow), jax_make_policy(policy),
        jax_fresh_state(jax_cluster(n_devices)), jnp.asarray(prompts))

    peng = ServingEngine(port_bundles, n_devices=n_devices, device="cpu",
                         gen_len=gen_len, prompt_len=8)
    pres = peng.run_workflow(
        _workflow(), make_policy(policy),
        fresh_state(homogeneous_cluster(n_devices)),
        torch.from_numpy(prompts))

    assert set(pres) == set(jres)
    for sid in jres:
        want = np.asarray(jres[sid].tokens_out)
        got = pres[sid].tokens_out.numpy()
        assert got.shape == want.shape == (4, gen_len)
        assert np.array_equal(got, want), sid
        # the served tokens do not depend on how a stage was sharded,
        # but the bookkeeping should agree too when both planned alike
        if pres[sid].device_ids == jres[sid].device_ids:
            assert pres[sid].switched == jres[sid].switched
            assert pres[sid].prefix_hit == jres[sid].prefix_hit


def _moe_rwkv_configs(smoke):
    return {"qwen-7b": (dataclasses.replace(
                smoke["granite-moe-3b-a800m"], dtype="float32"), 0),
            "llama-8b": (dataclasses.replace(
                smoke["rwkv6-3b"], dtype="float32"), 1)}


@pytest.fixture(scope="module")
def moe_rwkv_engines():
    """granite-moe and rwkv6 SMOKE bundles in float32, JAX and port."""
    jax_bundles, port_bundles = {}, {}
    port_cfgs = _moe_rwkv_configs(SMOKE)
    for name, (jcfg, seed) in _moe_rwkv_configs(JAX_SMOKE).items():
        jb = jax_engine.ModelBundle.create(name, jcfg, seed=seed)
        jax_bundles[name] = jb
        tree = jax.tree.map(
            lambda x: np.asarray(x.astype(jnp.float32)), jb.params)
        cfg = port_cfgs[name][0]
        port_bundles[name] = ModelBundle.create(
            name, cfg, device="cpu",
            params=params_from_jax(tree, cfg, device="cpu"))
    return jax_bundles, port_bundles


@pytest.mark.parametrize("policy,n_devices", [("FATE", 2),
                                              ("RoundRobin", 1)])
def test_moe_rwkv_workflow_same_greedy_tokens_as_jax_engine(
        moe_rwkv_engines, policy, n_devices):
    """Prompt length 7 is not a multiple of rwkv6's chunk (4), so the
    scan's state-neutral padding is on the served path."""
    jax_bundles, port_bundles = moe_rwkv_engines
    prompts = _prompts(8, plen=7)
    gen_len = 4
    assert 7 % port_bundles["llama-8b"].cfg.rwkv.chunk

    jeng = jax_engine.ServingEngine(jax_bundles, n_devices=n_devices,
                                    gen_len=gen_len, prompt_len=7)
    jres = jeng.run_workflow(
        _workflow(JaxStage, JaxWorkflow), jax_make_policy(policy),
        jax_fresh_state(jax_cluster(n_devices)), jnp.asarray(prompts))

    peng = ServingEngine(port_bundles, n_devices=n_devices, device="cpu",
                         gen_len=gen_len, prompt_len=7)
    pres = peng.run_workflow(
        _workflow(), make_policy(policy),
        fresh_state(homogeneous_cluster(n_devices)),
        torch.from_numpy(prompts))

    assert set(pres) == set(jres) == set(_workflow().stages)
    for sid in jres:
        want = np.asarray(jres[sid].tokens_out)
        got = pres[sid].tokens_out.numpy()
        assert got.shape == want.shape == (4, gen_len)
        assert np.array_equal(got, want), sid
