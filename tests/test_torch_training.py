"""The port's training stack against the JAX package's, on the CPU at
``SMOKE["qwen3-1.7b"]`` in float32 (the twin of ``tests/test_training.py``).

Parameters are numpy draws from a seed handed to both packages
(``numpy_params`` of ``tests/test_torch_smoke_archs.py``; the port's tree
through ``params_from_jax``), the batches the reference's own
``SyntheticTokens`` draw.  Bars:

* tokens, the int8 roundtrip, checkpoints, remat and the Trainer's
  resumed run: bitwise;
* ``softmax_xent``, ``lr_at``, ``global_norm``: 1e-6 relative (float32
  sums in another order);
* ``train_loss``: the loss to 1e-5 relative and each gradient leaf to 1e-4
  of its largest magnitude;
* AdamW steps: the step count exactly; each parameter to ``lr_t * 2**-7``
  per step taken (an ``m / sqrt(v)`` whose bf16 moments round one step
  apart moves a parameter by about that), each moment to one bf16 step
  of its magnitude (2**-7 relative, so that the float32 sums may round
  the other way); the train step's losses to 1e-4 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import SMOKE as JAX_SMOKE
from repro.launch import steps as jax_steps
from repro.models.families import build_model as jax_build_model
from repro.models.transformer import softmax_xent as jax_softmax_xent
from repro.training import compression as jax_comp
from repro.training import optimizer as jax_opt
from repro.training.data import DataConfig as JaxDataConfig
from repro.training.data import SyntheticTokens as JaxSyntheticTokens
from repro_torch.configs.archs import SMOKE
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models.families import build_model
from repro_torch.models.transformer import softmax_xent
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import compression, optimizer as opt
from repro_torch.training.data import DataConfig, SyntheticTokens
from repro_torch.training.trainer import TrainConfig, Trainer
from repro_torch.training.tree import (tree_leaves, tree_map, tree_paths,
                                       tree_unflatten)
from test_torch_smoke_archs import jax_tree, numpy_params

ARCH = "qwen3-1.7b"
SEQ, GB = 16, 4          # global batch 4: two microbatches of SMOKE's 2
OCFG = dict(lr=1e-2, warmup_steps=2, total_steps=50)


class Pair:
    """SMOKE qwen3 in float32 in both packages, from one numpy tree."""

    def __init__(self):
        self.cfg = dataclasses.replace(SMOKE[ARCH], dtype="float32")
        self.jcfg = dataclasses.replace(JAX_SMOKE[ARCH], dtype="float32")
        self.model = build_model(self.cfg, device="cpu")
        self.jmodel = jax_build_model(self.jcfg)
        defs = self.model.param_defs()
        self.tree = numpy_params(defs, np.random.default_rng(0))
        self.jparams = jax_tree(self.tree, defs)
        self.jdata = JaxSyntheticTokens(JaxDataConfig(self.cfg.vocab_size,
                                                      SEQ, GB))
        self.data = SyntheticTokens(DataConfig(self.cfg.vocab_size, SEQ, GB))

    def params(self):
        """A fresh copy of the port's float32 masters."""
        return params_from_jax(self.tree, self.cfg, device="cpu")


@pytest.fixture(scope="module")
def pair():
    return Pair()


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# --- data ------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 17])
def test_synthetic_tokens_equal_the_reference(pair, step):
    got = pair.data.batch_at(step, device="cpu")
    want = pair.jdata.batch_at(step)
    for key in ("tokens", "labels"):
        assert got[key].dtype == torch.int64
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
    assert not torch.equal(got["tokens"],
                           pair.data.batch_at(step + 1,
                                              device="cpu")["tokens"])


# --- loss and gradients ----------------------------------------------------

def test_softmax_xent_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 50), dtype=np.float32) * 4
    labels = rng.integers(0, 50, (2, 5))
    got = softmax_xent(torch.from_numpy(logits).bfloat16(),
                       torch.from_numpy(labels))
    want = jax_softmax_xent(jnp.asarray(logits).astype(jnp.bfloat16),
                            jnp.asarray(labels))
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


def _loss_and_grads(model, params, batch):
    paths, leaves = zip(*tree_paths(params))
    leaves = [x.detach().clone().requires_grad_() for x in leaves]
    loss = model.train_loss(tree_unflatten(params, leaves), batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def test_train_loss_and_grads_match_jax(pair):
    batch = pair.data.batch_at(0, device="cpu")
    loss, grads = _loss_and_grads(pair.model, pair.params(), batch)
    jloss, jgrads = jax.value_and_grad(pair.jmodel.train_loss)(
        pair.jparams, pair.jdata.batch_at(0))
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    for g, w in zip(grads, tree_leaves(jgrads)):
        assert _rel(g, w) <= 1e-4


def test_remat_equals_no_remat_bitwise(pair, monkeypatch):
    """``cfg.remat`` recomputes each block in the backward: the same loss
    and gradients, bit for bit on the CPU, and K1's forward called twice
    per layer (once in the backward's recompute)."""
    calls = []
    wrapped = ops.flash_attention

    def counting(*a, **k):
        calls.append(1)
        return wrapped(*a, **k)

    monkeypatch.setattr(ops, "flash_attention", counting)
    batch = pair.data.batch_at(1, device="cpu")
    out = {}
    for remat in (False, True):
        model = build_model(dataclasses.replace(pair.cfg, remat=remat),
                            device="cpu")
        calls.clear()
        out[remat] = _loss_and_grads(model, pair.params(), batch)
        assert len(calls) == pair.cfg.num_layers * (1 + remat)
    assert torch.equal(out[False][0], out[True][0])
    assert all(torch.equal(a, b) for a, b in zip(out[False][1],
                                                 out[True][1]))


# --- optimizer -------------------------------------------------------------

def test_lr_at_and_global_norm_match_jax():
    cfg, jcfg = opt.AdamWConfig(**OCFG), jax_opt.AdamWConfig(**OCFG)
    for step in (0, 1, 2, 3, 25, 50, 80):
        got = opt.lr_at(cfg, torch.tensor(step, dtype=torch.int32))
        want = jax_opt.lr_at(jcfg, jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= 1e-6 * max(float(want),
                                                           1e-12)
    rng = np.random.default_rng(4)
    tree = {"a": rng.standard_normal((30, 7), dtype=np.float32),
            "b": {"c": rng.standard_normal(11, dtype=np.float32)}}
    got = opt.global_norm({"a": torch.from_numpy(tree["a"]),
                           "b": {"c": torch.from_numpy(tree["b"]["c"])}})
    want = jax_opt.global_norm(jax.tree.map(jnp.asarray, tree))
    assert abs(float(got) - float(want)) <= 1e-6 * float(want)


def _adamw_bars(ocfg, n_steps):
    """The parameter bar after ``n_steps`` steps: 2**-7 of each step's
    learning rate, summed."""
    lrs = [float(jax_opt.lr_at(ocfg, jnp.asarray(t))) for t in
           range(1, n_steps + 1)]
    return sum(lrs) * 2.0 ** -7


def _check_state(params, state, jparams, jstate, bar):
    for p, w in zip(tree_leaves(params), tree_leaves(jparams)):
        assert float(np.abs(_np(p) - _np(w)).max()) <= bar
    assert int(state.step) == int(jstate.step)
    for m, w in zip(tree_leaves(state.mu) + tree_leaves(state.nu),
                    tree_leaves(jstate.mu) + tree_leaves(jstate.nu)):
        assert m.dtype == torch.bfloat16
        assert float(np.abs(_np(m) - _np(w)).max()) <= \
            2.0 ** -7 * max(float(np.abs(_np(w)).max()), 1e-30)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_apply_updates_matches_jax(pair, n_steps):
    """AdamW on the SMOKE masters with seeded gradients, clip binding."""
    ocfg, jcfg = opt.AdamWConfig(**OCFG), jax_opt.AdamWConfig(**OCFG)
    rng = np.random.default_rng(5)
    params, jparams = pair.params(), pair.jparams
    state, jstate = opt.init_state(params), jax_opt.init_state(jparams)
    for _ in range(n_steps):
        g = [rng.standard_normal(x.shape, dtype=np.float32)
             for x in tree_leaves(params)]
        grads = tree_unflatten(params, [torch.from_numpy(x) for x in g])
        jgrads = jax.tree.unflatten(jax.tree.structure(jparams),
                                    [jnp.asarray(x) for x in g])
        params, state = opt.apply_updates(ocfg, params, grads, state)
        jparams, jstate = jax_opt.apply_updates(jcfg, jparams, jgrads,
                                                jstate)
    _check_state(params, state, jparams, jstate, _adamw_bars(jcfg, n_steps))


# --- the train step ----------------------------------------------------------

def _jax_step(pair, grad_compression=None):
    fn, _ = jax_steps.make_train_step(
        pair.jcfg, dp_size=1, global_batch=GB,
        opt_cfg=jax_opt.AdamWConfig(**OCFG),
        grad_compression=grad_compression)
    return jax.jit(fn)


def _port_step(pair, grad_compression=None):
    fn, _ = steps.make_train_step(
        pair.cfg, dp_size=1, global_batch=GB,
        opt_cfg=opt.AdamWConfig(**OCFG), grad_compression=grad_compression,
        device="cpu")
    return fn


def test_make_train_step_matches_jitted_jax(pair):
    """Three steps of two microbatches each against the jitted JAX step."""
    assert steps.resolve_microbatch(pair.cfg, GB, 1) == 2
    step, jstep = _port_step(pair), _jax_step(pair)
    params, jparams = pair.params(), pair.jparams
    state, jstate = opt.init_state(params), jax_opt.init_state(jparams)
    for t in range(3):
        loss, params, state = step(params, state,
                                   pair.data.batch_at(t, device="cpu"))
        jloss, jparams, jstate = jstep(jparams, jstate,
                                       pair.jdata.batch_at(t))
        assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    _check_state(params, state, jparams, jstate,
                 _adamw_bars(jax_opt.AdamWConfig(**OCFG), 3))


def test_prefill_and_decode_steps_match_jax(pair):
    """``make_prefill_step`` over SEQ tokens, then ``make_decode_step`` at
    position SEQ, against the reference's: the logits and every cache
    leaf to 1e-4 of their largest magnitude (float32)."""
    prefill, model = steps.make_prefill_step(pair.cfg, device="cpu")
    decode, _ = steps.make_decode_step(pair.cfg, device="cpu")
    jprefill, jmodel = jax_steps.make_prefill_step(pair.jcfg)
    jdecode, _ = jax_steps.make_decode_step(pair.jcfg)
    toks = pair.data.batch_at(0, device="cpu")["tokens"]
    params = pair.params()
    with torch.inference_mode():
        cache = model.init_cache(GB, 2 * SEQ)
        logits, cache = prefill(params, {"tokens": toks[:, :-1],
                                         "cache": cache})
        dlogits, cache = decode(params, {"token": toks[:, -1:],
                                         "cache": cache, "pos": SEQ - 1})
    jtoks = jnp.asarray(toks.numpy())
    jlogits, jcache = jprefill(pair.jparams, {
        "tokens": jtoks[:, :-1], "cache": jmodel.init_cache(GB, 2 * SEQ)})
    jdlogits, jcache = jdecode(pair.jparams, {
        "token": jtoks[:, -1:], "cache": jcache,
        "pos": jnp.asarray(SEQ - 1, jnp.int32)})
    assert tuple(logits.shape) == (GB, 1, pair.cfg.vocab_size)
    assert _rel(logits, jlogits) <= 1e-4
    assert _rel(dlogits, jdlogits) <= 1e-4
    for (p, a), b in zip(tree_paths(cache), tree_leaves(jcache)):
        assert tuple(a.shape) == b.shape, p
        assert _rel(a, b) <= 1e-4, p


# --- compression -------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1000,), (3, 7, 40)])
def test_compress_roundtrip_equals_jax_bitwise(shape):
    g = np.random.default_rng(6).standard_normal(shape, dtype=np.float32)
    g *= 3.0
    got = compression.compress_roundtrip(torch.from_numpy(g))
    want = jax_comp.compress_roundtrip(jnp.asarray(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # int8 block quantisation: error bounded by half a block's scale
    flat = np.pad(g.reshape(-1), (0, (-g.size) % compression.BLOCK))
    scales = np.abs(flat.reshape(-1, compression.BLOCK)).max(1) / 127.0
    assert float(np.abs(got.numpy() - g).max()) <= \
        float(scales.max()) * 0.51 + 1e-6


def test_error_feedback_matches_jax_and_tracks_the_signal():
    compress, init = compression.make_error_feedback_compressor()
    jcompress, jinit = jax_comp.make_error_feedback_compressor()
    g = {"w": torch.full((300,), 0.003)}   # naive int8 would zero it
    jg = {"w": jnp.full((300,), 0.003, jnp.float32)}
    err, jerr = init(g), jinit(jg)
    total = torch.zeros(300)
    for _ in range(50):
        ghat, err = compress(g, err)
        jghat, jerr = jcompress(jg, jerr)
        np.testing.assert_array_equal(ghat["w"].numpy(),
                                      np.asarray(jghat["w"]))
        total += ghat["w"]
    assert float((total - 50 * g["w"]).abs().max()) < \
        float(50 * g["w"].abs().max()) * 0.1 + 0.01


def test_train_step_with_compression_matches_jax(pair):
    def port_c(g):
        return tree_map(compression.compress_roundtrip, g)

    step = _port_step(pair, port_c)
    jstep = _jax_step(pair, lambda g: jax.tree.map(
        jax_comp.compress_roundtrip, g))
    params = pair.params()
    loss, params, state = step(params, opt.init_state(params),
                               pair.data.batch_at(0, device="cpu"))
    jloss, jparams, jstate = jstep(pair.jparams,
                                   jax_opt.init_state(pair.jparams),
                                   pair.jdata.batch_at(0))
    assert bool(torch.isfinite(loss))
    assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    # the int8 roundtrip turns a float32 difference at a rounding boundary
    # into a whole quantisation step, and where a gradient is near AdamW's
    # eps (1e-8) the first update g / (|g| + eps) moves by a few percent
    # of lr for it (3 of the 16384 ffn/up entries, by 2 % of lr): 2**-5
    _check_state(params, state, jparams, jstate,
                 _adamw_bars(jax_opt.AdamWConfig(**OCFG), 1) * 4)


# --- checkpoints and the trainer --------------------------------------------

def _state_after_one_step(pair):
    step = _port_step(pair)
    params = pair.params()
    _, params, state = step(params, opt.init_state(params),
                            pair.data.batch_at(0, device="cpu"))
    return params, state


def test_checkpoint_roundtrip_bitwise(pair, tmp_path):
    params, state = _state_after_one_step(pair)
    tree = {"params": params, "opt": state}
    path = ckpt.save_checkpoint(tmp_path, 5, tree)
    assert ckpt.latest_step(tmp_path) == 5
    assert not list(tmp_path.glob(".tmp_*"))
    assert sorted(p.suffix for p in path.iterdir()) == \
        [".json"] + [".npy"] * len(tree_leaves(tree))
    like = {"params": pair.params(), "opt": opt.init_state(pair.params())}
    restored = ckpt.restore_checkpoint(tmp_path, 5, like)
    assert isinstance(restored["opt"], opt.AdamWState)
    for (p, a), (q, b) in zip(tree_paths(restored), tree_paths(tree)):
        assert p == q and a.dtype == b.dtype and torch.equal(a, b), p
    ckpt.save_checkpoint(tmp_path, 7, tree)
    assert ckpt.latest_step(tmp_path) == 7
    assert ckpt.latest_step(tmp_path / "none") is None


def test_checkpoint_refuses_a_mismatched_target(pair, tmp_path):
    params = pair.params()
    ckpt.save_checkpoint(tmp_path, 1, {"params": params})
    wrong = dict(params, embed=torch.zeros(3, 3))
    with pytest.raises(ValueError, match="embed"):
        ckpt.restore_checkpoint(tmp_path, 1, {"params": wrong})
    with pytest.raises(ValueError):
        ckpt.restore_checkpoint(tmp_path, 1, {"other": params})


def _trainer(pair, tmp_path, steps_):
    params = pair.params()
    return Trainer(pair.cfg, _port_step(pair), params,
                   opt.init_state(params), pair.data,
                   TrainConfig(steps=steps_, ckpt_every=3,
                               ckpt_dir=str(tmp_path)))


def test_trainer_failure_and_resume_equal_an_uninterrupted_run(pair,
                                                              tmp_path):
    """A simulated node failure at step 5 leaves an emergency checkpoint
    of step 4; a fresh trainer restores it bit for bit and its losses
    from step 5 on equal an uninterrupted run's."""
    whole = _trainer(pair, tmp_path / "whole", 8).run()
    tr = _trainer(pair, tmp_path / "cut", 8)
    with pytest.raises(RuntimeError, match="simulated node failure"):
        tr.run(fail_at=5)
    saved = {"params": tr.params, "opt": tr.opt_state}
    tr2 = _trainer(pair, tmp_path / "cut", 8)
    assert tr2.try_restore() == 4
    for (p, a), (_, b) in zip(tree_paths({"params": tr2.params,
                                          "opt": tr2.opt_state}),
                              tree_paths(saved)):
        assert torch.equal(a, b), p
    report = _trainer(pair, tmp_path / "cut", 8).run()
    assert report.restored_from == 4 and report.final_step == 7
    assert report.losses == whole.losses[5:]
    assert ckpt.latest_step(tmp_path / "cut") == 7
    assert len(list((tmp_path / "cut").glob("step_*"))) == 3   # keep_last


# --- microbatch resolution (ROADMAP H26) ------------------------------------

def test_resolve_microbatch_equals_the_reference_where_it_returns(pair):
    """On a grid of (microbatch, global batch, dp): where some multiple of
    dp from max(microbatch, dp) up to the global batch divides it, the
    reference returns and the port returns the same; elsewhere the
    reference's loop never ends (it is not called) and the port raises."""
    returned = raised = 0
    for mbs in (1, 2, 3, 16):
        cfg = dataclasses.replace(pair.cfg, microbatch=mbs)
        jcfg = dataclasses.replace(pair.jcfg, microbatch=mbs)
        for gb in range(1, 41):
            for dp in (1, 2, 4):
                m0 = max(mbs, dp)
                if any(gb % m == 0 for m in range(m0, gb + 1, dp)):
                    assert steps.resolve_microbatch(cfg, gb, dp) == \
                        jax_steps.resolve_microbatch(jcfg, gb, dp)
                    returned += 1
                else:
                    with pytest.raises(ValueError, match="microbatch"):
                        steps.resolve_microbatch(cfg, gb, dp)
                    raised += 1
    assert returned and raised
    # the train phase on the card: global batch 8 under the published
    # microbatch 16 has no microbatch at all
    with pytest.raises(ValueError):
        steps.resolve_microbatch(
            dataclasses.replace(pair.cfg, microbatch=16), 8, 1)
