"""The train step as one captured CUDA graph
(``training/graphs.py`` ``CapturedTrainStep``, the reference's jitted
step) on the CPU, where it runs eagerly on the same static buffers and
copies; the launch counts a capture takes back (``kernels.ops``); and
``examples/train_small_torch.py``, the twin of ``examples/train_small.py``
on the wrapper.

SMOKE qwen3 and SMOKE whisper (with its frames) in float32, their
parameters numpy draws handed to both packages (``Pair`` of
``tests/test_torch_training.py`` and ``tests/test_torch_whisper_training.py``).
Bars: the wrapper against the unwrapped step bitwise; against the
reference's jitted step those of ``test_make_train_step_matches_jitted_jax``:
the losses to 1e-4 relative, the state within ``_adamw_bars``.
"""
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.training import optimizer as jax_opt
from repro.training.data import DataConfig as JaxDataConfig
from repro.training.data import SyntheticTokens as JaxSyntheticTokens
from repro.training.trainer import TrainConfig as JaxTrainConfig
from repro.training.trainer import Trainer as JaxTrainer
from repro.launch import steps as jax_steps
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.training import optimizer as opt
from repro_torch.training.graphs import CapturedTrainStep
from repro_torch.training.trainer import TrainConfig, Trainer
from repro_torch.training.tree import tree_leaves
import test_torch_training
import test_torch_whisper_training
from test_torch_training import OCFG, _adamw_bars, _check_state

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE = ROOT / "examples" / "train_small_torch.py"


class Case:
    """One SMOKE pair, its port step and its batches (whisper's with the
    same seeded frames every time)."""

    def __init__(self, pair, gb):
        self.pair = pair
        self.step, _ = steps.make_train_step(
            pair.cfg, dp_size=1, global_batch=gb,
            opt_cfg=opt.AdamWConfig(**OCFG), device="cpu")

    def batch(self, t: int) -> dict:
        if hasattr(self.pair, "batches"):
            return self.pair.batches(t)[0]
        return self.pair.data.batch_at(t, device="cpu")

    def fresh(self):
        params = self.pair.params()
        return params, opt.init_state(params)


@pytest.fixture(scope="module")
def qwen3():
    return Case(test_torch_training.Pair(), test_torch_training.GB)


@pytest.fixture(scope="module")
def whisper():
    return Case(test_torch_whisper_training.Pair(),
                test_torch_whisper_training.GB)


@pytest.fixture(params=["qwen3", "whisper"])
def case(request):
    return request.getfixturevalue(request.param)


def _leaves(params, state):
    return tree_leaves({"params": params, "opt": state})


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b)) and len(a) == len(b)


def _steps(case, step_fn, params, state, ts):
    losses = []
    for t in ts:
        loss, params, state = step_fn(params, state, case.batch(t))
        losses.append(loss)
    return losses, params, state


def _eager(case, params, state, ts):
    return _steps(case, case.step, params, state, ts)


# --- the wrapper on the CPU --------------------------------------------------

def test_wrapped_step_equals_the_unwrapped_one_bitwise(case):
    """Three steps (two microbatches each; whisper's with its frames)
    through the wrapper and without it: every loss and the final
    parameters and state bit for bit, all run eagerly on the CPU."""
    want, params, state = _eager(case, *case.fresh(), range(3))
    graphed = CapturedTrainStep(case.step)
    got, gp, gs = _steps(case, graphed, *case.fresh(), range(3))
    assert _equal(got, want)
    assert _equal(_leaves(gp, gs), _leaves(params, state))
    assert (graphed.eager_steps, graphed.captures, graphed.replays) == \
        (3, 0, 0)


def test_returned_trees_are_the_donated_statics(qwen3):
    """The first call adopts the caller's tensors without copying them;
    every call returns those same objects, updated in place."""
    params, state = qwen3.fresh()
    donated = _leaves(params, state)
    before = [x.clone() for x in donated]
    graphed = CapturedTrainStep(qwen3.step)
    for t in range(3):
        _, params, state = graphed(params, state, qwen3.batch(t))
        assert all(a is b for a, b in zip(_leaves(params, state), donated))
    assert params is graphed.params and state is graphed.opt_state
    assert not torch.equal(donated[0], before[0])
    assert int(state.step) == 3


def test_a_foreign_tree_is_copied_in(qwen3):
    """After a call, a tree that is not the statics (as a restored
    checkpoint is) is copied into them, left as it was, and the step goes
    on from it exactly as the eager step from that tree."""
    graphed = CapturedTrainStep(qwen3.step)
    graphed(*qwen3.fresh(), qwen3.batch(0))
    _, fp, fs = _eager(qwen3, *qwen3.fresh(), [5])
    foreign = [x.clone() for x in _leaves(fp, fs)]
    loss, params, state = graphed(fp, fs, qwen3.batch(6))
    assert _equal(_leaves(fp, fs), foreign)
    assert all(a is not b for a, b in zip(_leaves(params, state),
                                          _leaves(fp, fs)))
    want, wp, ws = _eager(qwen3, fp, fs, [6])
    assert torch.equal(loss, want[0])
    assert _equal(_leaves(params, state), _leaves(wp, ws))


def test_a_batch_of_another_shape_takes_its_own_key(qwen3):
    """Batches of two shapes get two keys (one capture each on the card)
    over the same statics, and the steps equal the eager ones."""
    short = lambda t: {k: v[:, :8] for k, v in qwen3.batch(t).items()}
    batches = [qwen3.batch(0), short(1), qwen3.batch(2), short(3)]
    graphed = CapturedTrainStep(qwen3.step)
    params, state = qwen3.fresh()
    wp, ws = qwen3.fresh()
    for b in batches:
        loss, params, state = graphed(params, state, b)
        want, wp, ws = qwen3.step(wp, ws, b)
        assert torch.equal(loss, want)
    assert _equal(_leaves(params, state), _leaves(wp, ws))
    assert sorted(shape for key in graphed.slots
                  for name, shape, _ in key if name == "tokens") == \
        [(4, 8), (4, 16)]


def test_a_tree_that_does_not_match_raises(qwen3):
    """A tree of other leaves, or a leaf of another shape or dtype, is
    refused by name rather than copied into the statics."""
    graphed = CapturedTrainStep(qwen3.step)
    params, state = qwen3.fresh()
    graphed(params, state, qwen3.batch(0))
    with pytest.raises(ValueError, match="differ"):
        graphed({k: v for k, v in params.items() if k != "embed"}, state,
                qwen3.batch(1))
    wrong = dict(params, embed=params["embed"][:, :8].clone())
    with pytest.raises(ValueError, match="embed"):
        graphed(wrong, state, qwen3.batch(1))
    wrong = dict(params, embed=params["embed"].double())
    with pytest.raises(ValueError, match="embed"):
        graphed(wrong, state, qwen3.batch(1))


def _trainer(case, root, n, step_fn):
    params, state = case.fresh()
    return Trainer(case.pair.cfg, step_fn, params, state, case.pair.data,
                   TrainConfig(steps=n, ckpt_every=3, ckpt_dir=str(root)))


def test_trainer_failure_and_resume_through_the_wrapper(qwen3, tmp_path):
    """The Trainer's drill through the wrapper (a fresh one per trainer,
    as the reference jits per trainer): a failure at step 5, the emergency
    checkpoint of step 4 restored into the second wrapper's statics by
    copy, and the losses from step 5 on equal an uninterrupted run's
    through the wrapper and the eager step's, bit for bit."""
    eager = _trainer(qwen3, tmp_path / "eager", 8, qwen3.step).run()
    whole = _trainer(qwen3, tmp_path / "whole", 8,
                     CapturedTrainStep(qwen3.step)).run()
    assert whole.losses == eager.losses
    cut = _trainer(qwen3, tmp_path / "cut", 8, CapturedTrainStep(qwen3.step))
    with pytest.raises(RuntimeError, match="simulated node failure"):
        cut.run(fail_at=5)
    graphed = CapturedTrainStep(qwen3.step)
    report = _trainer(qwen3, tmp_path / "cut", 8, graphed).run()
    assert report.restored_from == 4 and report.final_step == 7
    assert report.losses == whole.losses[5:]
    assert graphed.eager_steps == 3


def test_wrapped_step_matches_jitted_jax(qwen3):
    """Three steps through the wrapper against the reference's jitted
    step on the same parameters: the losses to 1e-4 relative, the
    parameters, step and moments within ``_check_state``'s bars."""
    pair = qwen3.pair
    jstep = jax.jit(jax_steps.make_train_step(
        pair.jcfg, dp_size=1, global_batch=test_torch_training.GB,
        opt_cfg=jax_opt.AdamWConfig(**OCFG))[0])
    graphed = CapturedTrainStep(qwen3.step)
    params, state = qwen3.fresh()
    jparams, jstate = pair.jparams, jax_opt.init_state(pair.jparams)
    for t in range(3):
        loss, params, state = graphed(params, state, qwen3.batch(t))
        jloss, jparams, jstate = jstep(jparams, jstate,
                                       pair.jdata.batch_at(t))
        assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    _check_state(params, state, jparams, jstate,
                 _adamw_bars(jax_opt.AdamWConfig(**OCFG), 3))


# --- the launch counts a capture takes back -----------------------------------

@pytest.mark.parametrize("key", list(ops.counts()))
def test_counts_taken_back_and_added_again_give_the_eager_counts(key):
    """The bookkeeping of a capture (``training/graphs.py``,
    ``serving/graphs.py``) for every count, K1b's windowed calls and K3's
    gradients' persistent launches among them: the calls made while
    capturing count as an eager step would, the delta is taken back, and
    two replays add it twice, which gives two eager steps' counts."""
    ops.reset_launch_counts()
    try:
        step = {k: 0 for k in ops.counts()}
        step[key] = 3
        before = ops.counts()
        ops.add_counts(step)                 # what the capture's calls count
        after = ops.counts()
        delta = {k: after[k] - before[k] for k in after}
        ops.add_counts({k: -n for k, n in delta.items()})
        assert ops.counts() == before
        for _ in range(2):
            ops.add_counts(delta)            # a replay
        assert ops.counts() == {k: 2 * n for k, n in step.items()}
    finally:
        ops.reset_launch_counts()
    assert all(n == 0 for n in ops.counts().values())


def test_counts_carry_the_sub_counts():
    """``counts()`` carries every wrapper's launches and the counts some
    wrappers keep beside them, each read from its wrapper's attribute."""
    assert set(ops.counts()) == set(ops.KERNELS) | set(ops.SUB_COUNTS)
    assert set(ops.SUB_COUNTS) == {"moe_gemm_decode_tile",
                                   "flash_attention_bwd_window",
                                   "moe_gemm_dx_tma", "moe_gemm_dw_tma"}
    try:
        ops.flash_attention_bwd.window_launches = 5
        ops.moe_gemm_dw.tma_launches = 7
        got = ops.counts()
        assert (got["flash_attention_bwd_window"],
                got["moe_gemm_dw_tma"]) == (5, 7)
        with pytest.raises(KeyError):
            ops.add_counts({"no_such_kernel": 1})
    finally:
        ops.reset_launch_counts()


# --- examples/train_small_torch.py -----------------------------------------

def _example():
    spec = importlib.util.spec_from_file_location("train_small_torch",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_small_torch_runs_to_its_end():
    """The example as a user runs it on the CPU: 10 steps, the failure at
    step 6, the resume from the checkpoint of step 5, to step 9."""
    run = subprocess.run(
        [sys.executable, str(EXAMPLE), "--steps", "10", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert run.returncode == 0, run.stderr
    assert "simulated node failure at step 6" in run.stdout
    assert "resumed from step 5; finished at step 9" in run.stdout


def test_train_small_torch_matches_the_reference_example(qwen3, tmp_path):
    """The example's ``train`` against ``examples/train_small.py``'s
    program (``Trainer(cfg, jax.jit(step_fn), ...)``, AdamW at lr 3e-3,
    the failure at three fifths, the resume) over the same parameters and
    tokens, both in float32: the resumed steps' losses to 1e-4
    relative."""
    pair, n = qwen3.pair, 10
    report = _example().train(pair.cfg, pair.params(), n, "cpu",
                              log=lambda *_: None)
    jparams = jax.tree.map(lambda p: p.astype(jnp.float32), pair.jparams)
    jfn, _ = jax_steps.make_train_step(
        pair.jcfg, dp_size=1, global_batch=8,
        opt_cfg=jax_opt.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=n))
    data = JaxSyntheticTokens(JaxDataConfig(pair.jcfg.vocab_size, seq_len=32,
                                            global_batch=8))
    tc = JaxTrainConfig(steps=n, ckpt_every=50, ckpt_dir=str(tmp_path))
    first = JaxTrainer(pair.jcfg, jax.jit(jfn), jparams,
                       jax_opt.init_state(jparams), data, tc)
    with pytest.raises(RuntimeError):
        first.run(fail_at=n * 3 // 5)
    want = JaxTrainer(pair.jcfg, jax.jit(jfn), jparams,
                      jax_opt.init_state(jparams), data, tc).run()
    assert (report.restored_from, report.final_step) == \
        (want.restored_from, want.final_step) == (5, 9)
    assert len(report.losses) == len(want.losses) == 4
    for a, b in zip(report.losses, want.losses):
        assert abs(a - b) <= 1e-4 * abs(b)
