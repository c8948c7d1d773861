"""deepseek-v2's training in the port against the JAX package, on the CPU:
``SMOKE["deepseek-v2-236b"]`` (4 heads; one dense layer and two MoE layers
of 4 experts, top 2, and a shared expert) at its published latent
attention's head dims (query / key 128 + 64, value 128; SMOKE's latent
ranks 24 and 32) over sequences of 32 tokens, in float32.

On the card these layers run K1's backward at (D, Dv) = (192, 128) (the
kv-split kernel of ``csrc/flash_attention_bwd.cu``); here the wrappers take
the plain versions, which ``tests/test_torch_kernels.py`` holds to
``jax.vjp`` at (192, 128) and at SMOKE's own (24, 16).  Parameters are
numpy draws from a seed handed to both packages (``numpy_params``), the
batches the reference's own ``SyntheticTokens`` draw.  Bars:

* the head dims K1 sees in the forward and in remat's recompute: exactly;
* ``train_loss``: the loss to 1e-5 relative and each gradient leaf to
  1e-4 of its largest magnitude (float32 sums in another order; the bars
  of ``tests/test_torch_training.py``), at SMOKE's depth and at the card's
  depth of one dense layer;
* remat against no remat: bitwise;
* one ``make_train_step`` step of two microbatches against the jitted JAX
  step: the loss to 1e-4 relative, parameters and moments to the AdamW
  bars of ``tests/test_torch_training.py``, a parameter whose gradient
  lies below 100 Adam eps held as in ``tests/test_torch_gemma3_training.py``.

And ``chip_smoke.train_flops`` (which imports nothing of the JAX package)
for the three models that train at full width with their own attention
head dims: deepseek's (192, 128), qwen3's 128, gemma3's 256 under its
window.
"""
import dataclasses
import importlib
import math
import sys
from pathlib import Path

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
from repro_torch.configs.archs import ARCHS, SMOKE
from repro_torch.convert import params_from_jax
from repro_torch.kernels import _build, ops
from repro_torch.models.families import build_model
from repro_torch.models.layers import ParamDef
from repro_torch.training import optimizer as opt
from repro_torch.training.data import DataConfig, SyntheticTokens
from repro_torch.training.tree import tree_leaves, tree_unflatten
from test_torch_smoke_archs import jax_tree, numpy_params
from test_torch_training import (GB, OCFG, _adamw_bars, _check_state,
                                 _jax_step, _loss_and_grads, _np,
                                 _port_step, _rel)

ARCH = "deepseek-v2-236b"
SEQ = 32
LOSS_REL, GRAD_REL = 1e-5, 1e-4
PUBLISHED = ARCHS[ARCH].mla
HEAD_DIMS = dict(qk_nope_head_dim=PUBLISHED.qk_nope_head_dim,
                 qk_rope_head_dim=PUBLISHED.qk_rope_head_dim,
                 v_head_dim=PUBLISHED.v_head_dim)


def _published_head_dims(cfg, **over):
    return dataclasses.replace(
        cfg, mla=dataclasses.replace(cfg.mla, **HEAD_DIMS), **over)


class Pair:
    """SMOKE deepseek at the published MLA head dims in float32 in both
    packages, from one numpy tree (as ``tests/test_torch_training.py``'s
    qwen3 pair), at ``num_layers`` (0: SMOKE's 3)."""

    def __init__(self, num_layers=0):
        over = dict(dtype="float32")
        if num_layers:
            over["num_layers"] = num_layers
        self.cfg = _published_head_dims(SMOKE[ARCH], **over)
        self.jcfg = _published_head_dims(JAX_SMOKE[ARCH], **over)
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


def test_the_config_has_the_published_head_dims(pair):
    m = pair.cfg.mla
    assert (m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim) == \
        (192, 128)
    assert (192, 128) in _build.FLASH_HEAD_DIMS
    assert pair.cfg.num_layers == 3 and pair.cfg.moe_layer_start == 1
    assert pair.cfg.num_heads == pair.cfg.num_kv_heads == 4


@pytest.mark.parametrize("remat", [False, True])
def test_k1_sees_the_latent_head_dims(pair, monkeypatch, remat):
    """Every K1 call, in the forward and in remat's recompute (last layer
    first), takes q and k of D = 192 and v of Dv = 128 at G = 1, causal,
    without a window; one call a layer, twice under remat."""
    seen = []
    wrapped = ops.flash_attention

    def recording(q, k, v, **kw):
        seen.append((q.shape[-1], k.shape[-1], v.shape[-1], q.shape[2],
                     k.shape[2], kw["causal"], kw.get("window", 0)))
        return wrapped(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", recording)
    model = build_model(dataclasses.replace(pair.cfg, remat=remat),
                        device="cpu")
    _loss_and_grads(model, pair.params(), pair.data.batch_at(0,
                                                             device="cpu"))
    heads = pair.cfg.num_heads
    assert seen == [(192, 192, 128, heads, heads, True, 0)] * (
        pair.cfg.num_layers * (1 + remat))


@pytest.mark.parametrize("num_layers", [0, 1])
def test_train_loss_and_grads_match_jax(num_layers):
    """At SMOKE's depth (the dense layer and two MoE layers) and at the
    card's train_deepseek depth, the dense layer alone (an empty MoE
    stack)."""
    p = Pair(num_layers)
    if num_layers == 1:      # the MoE stack holds no layer
        stack = tree_leaves(p.model.param_defs()["blocks"])
        assert stack and all(d.shape[0] == 0 for d in stack)
    batch = p.data.batch_at(0, device="cpu")
    leaves = [x.detach().clone().requires_grad_()
              for x in tree_leaves(p.params())]
    loss = p.model.train_loss(tree_unflatten(p.params(), leaves), batch)
    # the empty stack's leaves take no part, as in make_train_step
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    jloss, jgrads = jax.value_and_grad(p.jmodel.train_loss)(
        p.jparams, p.jdata.batch_at(0))
    assert abs(float(loss) - float(jloss)) <= LOSS_REL * abs(float(jloss))
    jleaves = tree_leaves(jgrads)
    assert len(grads) == len(jleaves)
    for x, g, w in zip(leaves, grads, jleaves):
        if x.numel() == 0:
            assert g is None and w.size == 0
        else:
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
    gradient is 0 (an embedding row of a token the batch does not hold:
    weight decay alone moves it) or at least 100 eps (1e-6); between them
    Adam's first step moves a parameter by a fraction of lr that two
    gradients agreeing within the gradient bar need not share, so such an
    element is held to 2 lr (each step moves it by at most lr), and they
    must be fewer than one in 100 of each leaf's nonzero gradients."""
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
        unresolved = (g > 0) & (g < 100 * ocfg.eps)
        assert unresolved.sum() < 1e-2 * max((g > 0).sum(), 1)
        assert diff[~unresolved].max(initial=0.0) <= bar
        assert diff[unresolved].max(initial=0.0) <= 2 * lr
    _check_state(jparams, state, jparams, jstate, bar)


# --- chip_smoke's model FLOPs ------------------------------------------------

def _chip_smoke():
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


def _n_params(cfg) -> int:
    """The model's parameter count from its definitions (nothing
    allocated): what the train phases count."""
    def walk(d):
        if isinstance(d, ParamDef):
            return math.prod(d.shape)
        return sum(walk(v) for v in d.values())
    return walk(build_model(cfg, device="cpu").param_defs())


# (arch, layers, the step's model FLOPs at 8 x 4096 tokens): deepseek at its
# one dense layer (1.387 B parameters and attention at 6 (192 + 128) flops
# a head and pair), qwen3 at full depth (PERF.md: 176.9 TFLOP/s at 2.173 s),
# gemma3 at 18 layers, each local layer over its window (PERF.md: 4.817e14)
FLOPS = [("deepseek-v2-236b", 1, 2.891e14), ("qwen3-1.7b", 28, 3.845e14),
         ("gemma3-4b", 18, 4.817e14)]


@pytest.mark.parametrize("arch,layers,want", FLOPS)
def test_train_flops_count_each_models_attention(arch, layers, want):
    """``train_flops`` at the train phases' shape: 6 x parameters x tokens
    plus attention's products at 6 (D + Dv) flops a head and attended pair
    (the query / key and the value head dim, (192, 128) for deepseek's
    latent attention, not d_model / heads = 40), within 0.05 % of the
    figure PERF.md prints; chip_smoke imports nothing of the JAX
    package."""
    cs = _chip_smoke()
    assert "jax" not in vars(cs) and "repro" not in vars(cs)
    cfg = dataclasses.replace(ARCHS[arch], num_layers=layers)
    n = _n_params(cfg)
    got = cs.train_flops(cfg, n, 8, 4096)
    assert abs(got - want) <= 5e-4 * want, got
    d, dv = cs.attention_head_dims(cfg)
    attn = got - 6.0 * cs.active_params(cfg, n) * 8 * 4096
    pairs = sum(cs.attended_pairs(4096, 4096, True,
                                  cfg.sliding_window if kind == "L" else 0)
                for kind in cs.layer_kinds(cfg))
    assert attn == pytest.approx(6.0 * (d + dv) * 8 * cfg.num_heads * pairs)
    if arch == "deepseek-v2-236b":
        assert (d, dv) == (192, 128) and cfg.resolved_head_dim == 40
