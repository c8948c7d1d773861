"""gemma3's training in the port against the JAX package, on the CPU:
``SMOKE["gemma3-4b"]`` at the published head dim 256 (4 / 2 heads; 5
local layers with a sliding window of 8 and 2 global ones, every third
layer global) over sequences of 32 tokens, so that the window binds, in
float32.

On the card these layers run K1's backward at D = 256 (the column-split
kernel of ``csrc/flash_attention_bwd.cu``) under the window; here the
wrappers take the plain versions, which ``tests/test_torch_kernels.py``
holds to ``jax.vjp`` at D = 256.  Parameters are numpy draws from a seed
handed to both packages (``numpy_params``), the batches the reference's
own ``SyntheticTokens`` draw.  Bars:

* the layer kinds and the window each layer passes to K1, in the forward
  and in remat's recompute: exactly;
* ``train_loss``: the loss to 1e-5 relative and each gradient leaf to
  1e-4 of its largest magnitude (float32 sums in another order; the bars
  of ``tests/test_torch_training.py``);
* remat against no remat: bitwise;
* one ``make_train_step`` step of two microbatches against the jitted JAX
  step: the loss to 1e-4 relative, parameters and moments to the AdamW
  bars of ``tests/test_torch_training.py``, but a parameter whose
  gradient lies below the gradient bar (see the test).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import SMOKE as JAX_SMOKE
from repro.models.families import build_model as jax_build_model
from repro.training import optimizer as jax_opt
from repro.training.data import DataConfig as JaxDataConfig
from repro.training.data import SyntheticTokens as JaxSyntheticTokens
from repro_torch.configs.archs import SMOKE
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.models.families import build_model
from repro_torch.training import optimizer as opt
from repro_torch.training.data import DataConfig, SyntheticTokens
from repro_torch.training.tree import tree_leaves
from test_torch_smoke_archs import jax_tree, numpy_params
from test_torch_training import (GB, OCFG, _adamw_bars, _check_state,
                                 _jax_step, _loss_and_grads, _np,
                                 _port_step, _rel)

ARCH = "gemma3-4b"
HEAD_DIM, SEQ = 256, 32
LOSS_REL, GRAD_REL = 1e-5, 1e-4


class Pair:
    """SMOKE gemma3 at head dim 256 in float32 in both packages, from one
    numpy tree (as ``tests/test_torch_training.py``'s qwen3 pair)."""

    def __init__(self):
        over = dict(dtype="float32", head_dim=HEAD_DIM)
        self.cfg = dataclasses.replace(SMOKE[ARCH], **over)
        self.jcfg = dataclasses.replace(JAX_SMOKE[ARCH], **over)
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


def test_the_config_binds_the_window(pair):
    cfg = pair.cfg
    assert cfg.resolved_head_dim == HEAD_DIM
    assert 0 < cfg.sliding_window < SEQ
    assert pair.model.layer_kinds() == pair.jmodel.layer_kinds()
    assert pair.model.layer_kinds().count("G") == 2
    assert pair.model.layer_kinds().count("L") == 5


@pytest.mark.parametrize("remat", [False, True])
def test_each_layer_passes_its_window_to_k1(pair, monkeypatch, remat):
    """The window K1 receives per call, in execution order: the local
    layers' sliding window, 0 for the global ones; under remat the
    backward's recompute passes the same windows again, last layer
    first."""
    windows = []
    wrapped = ops.flash_attention

    def recording(*a, **k):
        windows.append(k["window"])
        assert k["causal"] and a[0].shape[-1] == HEAD_DIM
        return wrapped(*a, **k)

    monkeypatch.setattr(ops, "flash_attention", recording)
    model = build_model(dataclasses.replace(pair.cfg, remat=remat),
                        device="cpu")
    _loss_and_grads(model, pair.params(), pair.data.batch_at(0,
                                                             device="cpu"))
    want = [pair.cfg.sliding_window if kind == "L" else 0
            for kind in model.layer_kinds()]
    assert windows == want + (want[::-1] if remat else [])


def test_train_loss_and_grads_match_jax(pair):
    batch = pair.data.batch_at(0, device="cpu")
    loss, grads = _loss_and_grads(pair.model, pair.params(), batch)
    jloss, jgrads = jax.value_and_grad(pair.jmodel.train_loss)(
        pair.jparams, pair.jdata.batch_at(0))
    assert abs(float(loss) - float(jloss)) <= LOSS_REL * abs(float(jloss))
    jleaves = tree_leaves(jgrads)
    assert len(grads) == len(jleaves)
    for g, w in zip(grads, jleaves):
        assert _rel(g, w) <= GRAD_REL


def test_remat_equals_no_remat_bitwise(pair):
    batch = pair.data.batch_at(1, device="cpu")
    out = [_loss_and_grads(build_model(
        dataclasses.replace(pair.cfg, remat=remat), device="cpu"),
        pair.params(), batch) for remat in (False, True)]
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_make_train_step_matches_jitted_jax(pair):
    """One step of two microbatches against the jitted JAX step: the loss
    to 1e-4 relative, the step count, each moment to one bf16 step of its
    largest magnitude (``_check_state``'s bars), and each parameter to the
    AdamW bar (2**-7 of the step's learning rate) where the step's
    gradient is at least 100 eps (1e-6).  Adam's first step moves a
    parameter by lr g / (|g| + eps): from 100 eps up that is lr sign(g) to
    1 %, but near eps two gradients that agree within the gradient bar
    move it by different fractions of lr (at head dim 256 a few elements
    in 10^4 have |g| of 1e-9 to 2e-7).  Such an element is held to 2 lr,
    as each step moves it by at most lr, and they must be fewer than one
    in 100 of each leaf."""
    step, jstep = _port_step(pair), _jax_step(pair)
    params, jparams = pair.params(), pair.jparams
    state, jstate = opt.init_state(params), jax_opt.init_state(jparams)
    batch = pair.data.batch_at(0, device="cpu")
    half = GB // 2
    grads = [(a + b) / 2 for a, b in zip(*(
        _loss_and_grads(pair.model, pair.params(),
                        {k: v[i * half:(i + 1) * half]
                         for k, v in batch.items()})[1] for i in range(2)))]
    loss, params, state = step(params, state, batch)
    jloss, jparams, jstate = jstep(jparams, jstate, pair.jdata.batch_at(0))
    assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    ocfg = jax_opt.AdamWConfig(**OCFG)
    lr, bar = float(jax_opt.lr_at(ocfg, jnp.asarray(1))), _adamw_bars(ocfg, 1)
    for p, w, g in zip(tree_leaves(params), tree_leaves(jparams), grads):
        diff, g = np.abs(_np(p) - _np(w)), np.abs(_np(g))
        unresolved = g < 100 * ocfg.eps
        assert unresolved.mean() < 1e-2
        assert diff[~unresolved].max() <= bar
        assert diff[unresolved].max(initial=0.0) <= 2 * lr
    _check_state(jparams, state, jparams, jstate, bar)
