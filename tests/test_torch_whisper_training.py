"""whisper-small's training in the port against the JAX package, on the CPU
at SMOKE whisper (2 encoder and 2 decoder layers, d 64, 4 heads / 2 KV
heads of 16, 12 frames, vocab 256) in float32, and ``chip_smoke.py``'s
counts for its ``train_whisper`` phase.

Parameters, tokens and frames are numpy draws from a seed handed to both
packages (the twin of ``tests/test_torch_smoke_archs.py``; the reference's
own ``SyntheticTokens`` draw the tokens).  Bars, those of
``tests/test_torch_training.py``: the train step's loss to 1e-4 relative;
after AdamW each parameter to ``lr_t * 2**-7`` per step taken (where its
gradient is resolved: see the test) and each bf16 moment to one bf16 step of
its magnitude; the step count exactly.  The counts are exact.
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
from repro.training import optimizer as jax_opt
from repro.training.data import DataConfig as JaxDataConfig
from repro.training.data import SyntheticTokens as JaxSyntheticTokens
from repro_torch.configs.archs import ARCHS, SMOKE
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models.families import build_model
from repro_torch.training import optimizer as opt
from repro_torch.training.data import DataConfig, SyntheticTokens
from repro_torch.training.tree import tree_leaves
from test_torch_deepseek_training import _chip_smoke, _n_params
from test_torch_smoke_archs import jax_tree, numpy_params
from test_torch_training import (_adamw_bars, _check_state, _loss_and_grads,
                                 _np)

ARCH = "whisper-small"
SEQ, GB = 16, 4          # global batch 4: two microbatches of SMOKE's 2
OCFG = dict(lr=1e-2, warmup_steps=2, total_steps=50)


class Pair:
    """SMOKE whisper in float32 in both packages from one numpy tree, the
    reference's token stream and seeded frames [GB, 12, 64] per step."""

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
        return params_from_jax(self.tree, self.cfg, device="cpu")

    def frames(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((7, step))
        return rng.standard_normal(
            (GB, self.cfg.encoder_frames, self.cfg.d_model),
            dtype=np.float32)

    def batches(self, step: int):
        """The port's batch and the reference's, the same frames in both."""
        frames = self.frames(step)
        got = self.data.batch_at(step, device="cpu")
        got["extra_embeds"] = torch.from_numpy(frames)
        want = dict(self.jdata.batch_at(step))
        want["extra_embeds"] = jnp.asarray(frames)
        return got, want


@pytest.fixture(scope="module")
def pair():
    return Pair()


def test_make_train_step_with_frames_matches_jitted_jax(pair):
    """One step of two microbatches with the frames in the batch (split
    with the tokens) against the reference's jitted step: the loss to 1e-4
    relative, the step count and each moment to one bf16 step of its
    largest magnitude (``_check_state``'s bars), and each parameter to the
    AdamW bar (2**-7 of the step's learning rate) where the step's
    gradient is 0 or at least 100 eps (1e-6).  Between them Adam's first
    step moves a parameter by a fraction of lr that two gradients agreeing
    within the gradient bar need not share (whisper's float32 gradients
    carry elements of 1e-8 whose last digits the two frameworks' sums
    decide), so such an element is held to 2 lr, and they must be fewer
    than one in 100 of each leaf's nonzero gradients: the rule of
    ``tests/test_torch_deepseek_training.py``'s train step."""
    assert steps.resolve_microbatch(pair.cfg, GB, 1) == 2
    step, _ = steps.make_train_step(pair.cfg, dp_size=1, global_batch=GB,
                                    opt_cfg=opt.AdamWConfig(**OCFG),
                                    device="cpu")
    jfn, _ = jax_steps.make_train_step(pair.jcfg, dp_size=1,
                                       global_batch=GB,
                                       opt_cfg=jax_opt.AdamWConfig(**OCFG))
    params, jparams = pair.params(), pair.jparams
    state, jstate = opt.init_state(params), jax_opt.init_state(jparams)
    batch, jbatch = pair.batches(0)
    half = GB // 2
    grads = [(a + b) / 2 for a, b in zip(*(
        _loss_and_grads(pair.model, pair.params(),
                        {k: v[i * half:(i + 1) * half]
                         for k, v in batch.items()})[1] for i in range(2)))]
    loss, params, state = step(params, state, batch)
    jloss, jparams, jstate = jax.jit(jfn)(jparams, jstate, jbatch)
    assert np.isfinite(float(loss))
    assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    ocfg = jax_opt.AdamWConfig(**OCFG)
    lr, bar = float(jax_opt.lr_at(ocfg, jnp.asarray(1))), _adamw_bars(ocfg, 1)
    for p, w, g in zip(tree_leaves(params), tree_leaves(jparams), grads):
        diff, g = np.abs(_np(p) - _np(w)), np.abs(_np(g))
        unresolved = (g > 0) & (g < 100 * ocfg.eps)
        assert unresolved.sum() < 1e-2 * max((g > 0).sum(), 1)
        assert diff[~unresolved].max(initial=0.0) <= bar
        assert diff[unresolved].max(initial=0.0) <= 2 * lr
    _check_state(jparams, state, jparams, jstate, bar)


def test_the_frames_reach_the_loss(pair):
    """The step's loss depends on the batch's frames: other frames, another
    loss (the microbatch split carries them to the encoder)."""
    batch, _ = pair.batches(0)
    other = dict(batch, extra_embeds=torch.from_numpy(pair.frames(1)))
    with torch.no_grad():
        a = pair.model.train_loss(pair.params(), batch)
        b = pair.model.train_loss(pair.params(), other)
    assert float(a) != float(b)


# --- chip_smoke's train_whisper phase ---------------------------------------

# whisper-small, by hand: d 768, 12 heads of 64, d_ff 3072 (a SwiGLU: three
# matrices), 1500 frames, vocab 51865, 12 + 12 layers
ATTN, FFN, NORM = 4 * 768 * 768, 3 * 768 * 3072, 768
ENC_LAYER = ATTN + FFN + 2 * NORM
DEC_LAYER = 2 * ATTN + FFN + 3 * NORM
# the encoder's stack, pos_enc, ln_enc, and the decoder's cross wk and wv
FRAMES_SIDE = 12 * ENC_LAYER + 1500 * 768 + NORM + 12 * 2 * 768 * 768
PARAMS = 12 * ENC_LAYER + 12 * DEC_LAYER + 1500 * 768 + 2 * NORM \
    + 2 * 51865 * 768


def test_whisper_parameter_counts():
    cs = _chip_smoke()
    cfg = ARCHS[ARCH]
    assert _n_params(cfg) == PARAMS == 335_668_224
    assert cs.frames_side_params(cfg) == FRAMES_SIDE == 128_573_184


def test_train_flops_for_an_encoder_decoder():
    """``train_flops`` at the train phase's shape (8 sequences of 4096
    tokens and 1500 frames): 6 x the frames-side parameters x frames, 6 x
    the rest x tokens, and attention at 6 x (64 + 64) flops a head and
    attended pair: 1500^2 on each encoder layer, the 4096 x 4097 / 2
    causal pairs on each decoder self-attention, 4096 x 1500 on each
    cross-attention."""
    cs = _chip_smoke()
    cfg = ARCHS[ARCH]
    b, s, f = 8, 4096, 1500
    pairs = 12 * f * f + 12 * (s * (s + 1) // 2 + s * f)
    want = (6 * b * (FRAMES_SIDE * f + (PARAMS - FRAMES_SIDE) * s)
            + 6 * 128 * b * 12 * pairs)
    assert cs.train_flops(cfg, PARAMS, b, s) == pytest.approx(want,
                                                              rel=1e-12)
    assert cs.layer_kinds(cfg) == ["G"] * 36


@pytest.mark.parametrize("n_accum,steps_,remat", [(4, 4, True), (1, 1, True),
                                                  (1, 1, False)])
def test_train_launches_for_an_encoder_decoder(n_accum, steps_, remat):
    """Per microbatch under remat: 36 attention calls (12 encoder, 12
    decoder self, 12 cross), each K1 twice (the forward and remat's
    recompute) and K1's backward once: 72 and 36; over the phase's 4
    steps of 4 microbatches 1152 and 576; without remat 36 and 36;
    nothing else."""
    cs = _chip_smoke()
    cfg = dataclasses.replace(ARCHS[ARCH], remat=remat)
    exp = cs.train_launches(cfg, n_accum, steps_)
    runs = n_accum * steps_
    assert {k: v for k, v in exp.items() if v} == {
        "flash_attention": (72 if remat else 36) * runs,
        "flash_attention_bwd": 36 * runs}
    assert set(exp) == set(ops.counts())
    if (n_accum, steps_) == (4, 4):
        assert (exp["flash_attention"], exp["flash_attention_bwd"]) == \
            (1152, 576)


def test_train_data_adds_frames_from_seed_and_step():
    """The phase's stream: the token stream's batch with frames
    [batch, 1500, 768] in bf16, the same for the same (seed, step) and
    other for another step or seed; a decoder-only model's stream has
    none."""
    cs = _chip_smoke()
    cfg = ARCHS[ARCH]
    data = cs.train_data(cfg, 32, 2, seed=3)
    a = data.batch_at(5, device="cpu")
    tokens = SyntheticTokens(DataConfig(cfg.vocab_size, 32, 2, seed=3))
    want = tokens.batch_at(5, device="cpu")
    assert all(torch.equal(a[k], want[k]) for k in ("tokens", "labels"))
    assert a["extra_embeds"].shape == (2, 1500, 768)
    assert a["extra_embeds"].dtype == torch.bfloat16
    assert torch.equal(a["extra_embeds"],
                       data.batch_at(5, device="cpu")["extra_embeds"])
    assert not torch.equal(a["extra_embeds"],
                           data.batch_at(6, device="cpu")["extra_embeds"])
    assert not torch.equal(a["extra_embeds"], cs.train_data(
        cfg, 32, 2, seed=4).batch_at(5, device="cpu")["extra_embeds"])
    plain = cs.train_data(ARCHS["qwen3-1.7b"], 32, 2, seed=3)
    assert set(plain.batch_at(5, device="cpu")) == {"tokens", "labels"}


def test_trainer_reads_the_frames_stream(tmp_path):
    """The ``Trainer`` at SMOKE whisper on the CPU over the phase's stream
    (the card's Trainer drill): finite losses, and a run that fails at
    step 3, resumed from the checkpoint of step 2, gives the uninterrupted
    run's last loss bit for bit."""
    from repro_torch.training.trainer import TrainConfig, Trainer
    from repro_torch.training.tree import tree_map
    cs = _chip_smoke()
    cfg = SMOKE[ARCH]
    step_fn, model = steps.make_train_step(
        cfg, dp_size=1, global_batch=4,
        opt_cfg=opt.AdamWConfig(**OCFG), device="cpu")
    data = cs.train_data(cfg, 16, 4, seed=0)

    def trainer(root):
        params = tree_map(lambda p: p.float(), model.init(
            torch.Generator().manual_seed(0)))
        return Trainer(cfg, step_fn, params, opt.init_state(params), data,
                       TrainConfig(steps=4, ckpt_every=2, ckpt_dir=root))

    whole = trainer(str(tmp_path / "whole")).run()
    assert np.all(np.isfinite(whole.losses))
    cut = trainer(str(tmp_path / "cut"))
    with pytest.raises(RuntimeError):
        cut.run(fail_at=3)
    resumed = trainer(str(tmp_path / "cut")).run()
    assert resumed.restored_from == 2
    assert resumed.losses == whole.losses[3:]
