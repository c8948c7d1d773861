"""The meta-device dry run on the CPU: model FLOPs from the tree, the
memory tracker and its weighted replay, dry-run cells, the CLI, and the
pricing ``chip_smoke.py``'s dryrun phase runs.

Model FLOPs are held to the reference's abstract tree; the tracker's
trace on the meta device to the same step run on the CPU with real
tensors.  A torch ``DeviceMesh`` needs a default process group: one of
PyTorch's fake backend, made and destroyed by the module-scoped fixture
``mesh`` (the tests run several files in one worker process).
"""
import dataclasses
import json
import math
import subprocess
import sys
import types
from pathlib import Path

import jax
import pytest
import torch

from repro.configs.archs import ARCHS as JAX_ARCHS
from repro.launch import steps as jax_steps
from repro_torch.configs.archs import ARCHS, SMOKE
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.kernels import _build
from repro_torch.launch import analysis, dryrun, steps
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.families import build_model
from repro_torch.training import optimizer as opt
from repro_torch.training.tree import tree_map, tree_paths

ROOT = Path(__file__).resolve().parents[1]
# one device: a stand-in with the two attributes the placements read
ONE = types.SimpleNamespace(axis_names=("data", "model"),
                            shape={"data": 1, "model": 1})


@pytest.fixture(scope="module")
def mesh():
    """A (1, 2) DeviceMesh over (data, model) on a fake process group of
    two ranks, destroyed after the module."""
    with mesh_mod.fake_world(2):
        yield mesh_mod.make_test_mesh((1, 2), ("data", "model"))


def ref_leaf_shapes(tree) -> list[tuple]:
    """The leaf shapes of a JAX tree."""
    return [tuple(leaf.shape) for leaf in jax.tree_util.tree_leaves(tree)]


# ---------------------------------------------------------------------------
# model FLOPs and the memory tracker
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_from_the_tree(arch):
    """6 N D for training, 2 N D for inference, N the active parameters
    counted from the model's tree: held to the reference's abstract tree,
    whose routed experts (its rank-4 leaves [layers, E, ., .]) count at
    top_k / E; not ``ArchConfig``'s count (ROADMAP H28)."""
    cfg = ARCHS[arch]
    ref = ref_leaf_shapes(
        jax_steps.abstract_serve_params(JAX_ARCHS[arch])[0])
    n = sum(math.prod(shape) for shape in ref)
    want = float(n)
    if cfg.moe is not None:
        e = cfg.moe.num_experts
        routed = sum(math.prod(shape) for shape in ref
                     if len(shape) == 4 and shape[1] == e)
        assert routed > 0
        want = n - routed * (1.0 - cfg.moe.top_k / e)
    assert analysis.param_count(cfg) == n
    active = analysis.active_params(cfg)
    assert active == pytest.approx(want, rel=1e-12)
    assert (active == n) == (cfg.moe is None)
    tr = SHAPES["train_4k"]
    assert analysis.model_flops(cfg, tr) == 6.0 * active * 256 * 4096
    assert analysis.model_flops(cfg, SHAPES["decode_32k"]) == \
        2.0 * active * 128


TRACED_ARCHS = ["qwen3-1.7b", "granite-moe-3b-a800m", "rwkv6-3b",
                "zamba2-2.7b", "gemma3-4b", "whisper-small",
                "llava-next-mistral-7b"]


@pytest.mark.parametrize("arch", TRACED_ARCHS[:-1])
def test_tracker_meta_trace_equals_cpu_run(arch, monkeypatch):
    """A SMOKE train step (two microbatches, accumulation, AdamW) traced
    on the meta device prices the same peaks, the same storages live at
    the peak and the same storages joined to the state as the same step
    run on the CPU with real tensors under a second tracker.  The CPU run
    takes the wrappers' own launch-free path (what a meta tensor takes),
    so the two runs make the same allocations; the kernels' meta paths
    are held to the card by ``chip_smoke.py``'s dryrun phase."""
    cfg = dataclasses.replace(SMOKE[arch], microbatch=2)
    sh = ShapeConfig("t", 32, 4, "train")
    meta, _ = dryrun.trace_step(cfg, sh, ONE)
    real = _build.kernel_device
    monkeypatch.setattr(_build, "kernel_device", lambda x, name: "meta"
                        if x.device.type == "cpu" else real(x, name))
    step, _ = steps.make_train_step(cfg, dp_size=1, global_batch=4,
                                    device="cpu")
    params, _, _, _ = steps.abstract_train_state(cfg)
    gen = torch.Generator().manual_seed(0)
    params = tree_map(lambda p: torch.randn(p.shape, generator=gen) * 0.02,
                      params)
    state = opt.init_state(params)
    batch = {k: torch.randint(0, cfg.vocab_size, v.shape, generator=gen)
             if v.dtype == torch.int64 else torch.zeros(v.shape, dtype=v.dtype)
             for k, v in steps.input_specs(cfg, sh).items()}
    cpu = analysis.MemoryTracker()
    cpu.track((params, state))
    cpu.track(batch, joins=False)
    with cpu:
        step(params, state, batch)
    assert cpu.peak == meta.peak > 0
    assert cpu.summary() == meta.summary()
    assert [w for _, w, _ in cpu.storages()] == \
        [w for _, w, _ in meta.storages()]


@pytest.mark.parametrize("arch", TRACED_ARCHS)
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_joined_storages_do_not_grow_with_the_batch(arch, kind):
    """What the tracker joins to the parameters and the optimizer state
    is sharded as they are, so none of it may grow with the batch: the
    joined storages of a SMOKE step at one row a microbatch have the
    same sizes as at two (the activations double), and the unjoined ones
    hold most of what does."""
    sizes = []
    for rows in (1, 2):
        cfg = dataclasses.replace(SMOKE[arch], microbatch=rows)
        n = 2 * rows if kind == "train" else rows
        tracker, _ = dryrun.trace_step(cfg, ShapeConfig("t", 32, n, kind),
                                       ONE)
        made = tracker.storages()
        sizes.append((sorted(b for b, w, d in made
                             if w is not None and d != "entry"),
                      sum(b for b, w, _ in made if w is None)))
    (joined1, free1), (joined2, free2) = sizes
    assert joined1 == joined2
    assert free2 > 1.8 * free1


def test_two_microbatches_price_the_whole_step():
    """``trace_step`` traces the first two microbatches of a training step
    (each later one starts from the same live storages and makes the same
    ones) with the inputs weighted to the whole batch: its peak is that
    of the whole step traced, eight rows in microbatches of two, but for
    a few small tensors the third microbatch holds at its peak beside
    them (260 bytes of 2.1 MB here: the running loss sum, one norm
    weight's gradient)."""
    cfg = dataclasses.replace(SMOKE["qwen3-1.7b"], microbatch=2)
    sh = ShapeConfig("t", 32, 8, "train")
    two, resident = dryrun.trace_step(cfg, sh, ONE)
    step, _ = steps.make_train_step(cfg, dp_size=1, global_batch=8,
                                    device="meta")
    params, state, _, _ = steps.abstract_train_state(cfg)
    batch = steps.input_specs(cfg, sh)
    whole = analysis.MemoryTracker()
    whole.track((params, state))
    whole.track(batch, joins=False)
    with whole:
        step(params, state, batch)
    assert two.peak < whole.peak
    got = two.summary()["device_peak_bytes"]
    want = whole.summary()["device_peak_bytes"]
    assert want - 1024 <= got <= want
    assert resident["inputs"] == sum(v.numel() * 8 for v in batch.values())


def test_tracker_counts_views_once_and_frees():
    """Views and in-place results add nothing; a freed storage leaves the
    live count; the peak stays."""
    tr = analysis.MemoryTracker()
    with tr:
        a = torch.empty(256, device="meta")          # 1024 bytes
        b = a.view(16, 16)
        b.add_(1)
        c = a * 2
        assert tr.live == 2048
        del a
        assert tr.live == 2048                       # b keeps the storage
        del b
        assert tr.live == 1024
        del c
        assert tr.live == 0
    assert tr.peak == 2048
    assert tr.summary()["live_at_peak"][0]["bytes"] == 1024


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,shape", [
    ("train", ShapeConfig("train_tiny", 32, 8, "train")),
    ("prefill", ShapeConfig("prefill_tiny", 32, 4, "prefill")),
    ("decode", ShapeConfig("decode_tiny", 64, 4, "decode"))])
def test_dryrun_cell_smoke(mesh, kind, shape):
    """A dry-run cell end to end at SMOKE size on a (1, 2) mesh: the
    resident state from the placements (the model axis halves what it
    shards), the step's total above it and below the unweighted trace,
    model FLOPs, the record JSON-serialisable."""
    cfg = dataclasses.replace(SMOKE["qwen3-1.7b"], microbatch=4)
    rec = dryrun.price_cell(cfg, shape, mesh)
    json.dumps(rec)
    res = rec["resident_bytes"]
    if kind == "train":
        params, state, pspecs, sspecs = steps.abstract_train_state(cfg)
    else:
        params, pspecs = steps.abstract_serve_params(cfg)
    full = sum(p.numel() * p.element_size() for _, p in tree_paths(params))
    assert res["params"] == mesh_mod.device_bytes(
        mesh, params, mesh_mod.shardings_for(mesh, params, pspecs))
    assert full / 2 < res["params"] < full
    assert rec["n_devices"] == 2 and rec["dp"] == 1
    assert sum(res.values()) < rec["total_bytes"] < rec["trace"]["peak_bytes"]
    assert 0 < rec["activation_peak_bytes"] < rec["total_bytes"]
    assert rec["fits_80gb"]
    assert rec["model_flops_global"] == analysis.model_flops(cfg, shape)
    if kind == "train":
        assert rec["microbatch_rows_per_device"] == 4
        # bf16 mu and nu (half the float32 masters each) and the step
        assert res["optimizer"] == res["params"] + 4 == mesh_mod.device_bytes(
            mesh, state, mesh_mod.shardings_for(mesh, state, sspecs))
        assert rec["gradient_bytes"] == res["params"]
    else:
        assert res["cache"] > 0 and res["optimizer"] == 0


def test_dryrun_cli_resumable(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on one registry cell of
    each mesh, on the CPU: a record with no error; a second run skips
    it."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "whisper-small", "--shape", "decode_32k", "--out", str(tmp_path)]
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    run = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    for m in ("single", "multi"):
        rec = json.loads(
            (tmp_path / f"whisper-small__decode_32k__{m}.json").read_text())
        assert "error" not in rec and rec["n_devices"] == \
            (256 if m == "single" else 512)
    again = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           timeout=300)
    assert "skipped=2" in again.stdout


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-3b-a800m",
                                  "rwkv6-3b"])
def test_chip_dryrun_comparison_on_smoke(mesh, arch):
    """``chip_smoke.py``'s dryrun check on the CPU: a ``price_cell``
    record of a SMOKE train step, its total against a measured peak, and
    its state priced leaf by leaf on a (1, 1) mesh against the state a
    train phase builds (float32 masters of the init, ``init_state``)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    cfg = dataclasses.replace(SMOKE[arch], microbatch=2)
    model = build_model(cfg, "cpu")
    masters = tree_map(lambda p: p.float(),
                       model.init(torch.Generator().manual_seed(0)))
    built = chip_smoke.state_leaves({"params": masters,
                                     "opt": opt.init_state(masters)})
    rec = dryrun.price_cell(cfg, ShapeConfig("t", 32, 8, "train"), mesh)
    params, state, pspecs, sspecs = steps.abstract_train_state(cfg)
    rec["state"] = json.loads(json.dumps(chip_smoke.state_leaves(
        {"params": params, "opt": state}, ONE,
        {"params": mesh_mod.shardings_for(ONE, params, pspecs),
         "opt": mesh_mod.shardings_for(ONE, state, sspecs)})))
    total = rec["total_bytes"]
    cases, problems = chip_smoke.dryrun_cases(
        {"train": rec}, {"train": total / 0.95}, {"train": built})
    assert not problems and cases["train"]["state_exact"]
    assert cases["train"]["state_leaves"] == len(tree_paths(params)) * 3 + 1
    assert cases["train"]["live_at_priced_peak"] == \
        rec["trace"]["live_at_peak"]
    _, problems = chip_smoke.dryrun_cases(
        {"train": rec}, {"train": total / 0.8},
        {"train": dict(built, x=[[1], "float32", 4])})
    assert len(problems) == 2


def test_chip_pricing_process():
    """``chip_smoke.py``'s pricing child on the CPU: one train spec (qwen3
    at its full widths, one layer, 4 x 32 tokens in microbatches of 2)
    priced on a (1, 1) mesh, where every weight is 1 and the total is the
    unweighted trace's peak; its state leaves and its window."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    spec = {"phase": "train", "arch": "qwen3-1.7b", "kind": "train",
            "overrides": {"microbatch": 2, "num_layers": 1}, "seq": 32,
            "rows": 4, "microbatch": 2}
    proc = chip_smoke.start_pricing([spec])
    try:
        stdout, stderr = proc.communicate(timeout=240)
    finally:
        chip_smoke.stop_process(proc)
    assert proc.returncode == 0, stderr[-2000:]
    out = json.loads(stdout.strip().splitlines()[-1])
    rec = out["cells"]["train"]
    start, end = out["window"]
    assert start <= end
    assert rec["total_bytes"] == rec["trace"]["peak_bytes"] > 0
    assert rec["rows_per_device"] == 4 and rec["n_devices"] == 1
    cfg = dataclasses.replace(ARCHS["qwen3-1.7b"], num_layers=1)
    params, _, _, _ = steps.abstract_train_state(cfg)
    assert len(rec["state"]) == len(tree_paths(params)) * 3 + 1
