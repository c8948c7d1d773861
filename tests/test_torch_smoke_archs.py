"""The port's twin of ``tests/test_smoke_archs.py``, over all ten SMOKE ids
(the registry is complete since whisper's ``EncDecLM``): the forward
against the JAX package's forward, the port's prefill and one decode step
against its own forward, the parameter totals of the ten full configs,
and ``train_loss`` with its gradient against ``jax.value_and_grad`` of the
JAX model's in float32 (the JAX file checks only that its gradient is
finite): the loss to 1e-5 of its value and every gradient leaf to 1e-4
of its largest magnitude (autograd through the plain kernels, sums in
another order).  Also the MoE auxiliary load-balancing loss against the
reference's.

Parameters are numpy draws from a seed, handed to both packages (JAX
arrays in each leaf's declared dtype, and the port's tree through
``params_from_jax``): every matrix normal / sqrt(its input width), norm
weights, biases and the other zero- or one-initialised leaves moved off
their value by 0.1 normal, so that the comparison sees them.  The input
width of the GQA projections ``wq``, ``wk``, ``wv`` [d, heads, hd] is d;
the reference's init scales them by the head count instead (fan-in axis
-2), which at SMOKE widths gives attention scores in the hundreds: the
softmax saturates, and float32 rounding of the scores alone then moves
whisper's logits by 1e-4 to 2.3e-4 between the packages (3.5e-6 at the
input width).  Bars: float32 logits to 1e-4 (two frameworks summing in
different orders), bfloat16 softmax to the 0.03 / 0.05 of
``tests/test_smoke_archs.py`` (the XLA twin rounds ``p`` to bf16, the
port's plain versions keep it float32: ROADMAP H1, H19).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import ARCHS as JAX_ARCHS
from repro.configs.archs import SMOKE as JAX_SMOKE
from repro.models.families import build_model as jax_build_model
from repro.models.layers import ParamDef as JaxParamDef
from repro.models.moe import aux_load_balance_loss as jax_aux_loss
from repro_torch.configs.archs import ARCHS, SMOKE
from repro_torch.convert import params_from_jax
from repro_torch.models.families import build_model
from repro_torch.models.layers import ParamDef
from repro_torch.models.moe import aux_load_balance_loss
from repro_torch.training.tree import tree_paths, tree_unflatten

ARCH_IDS = list(SMOKE)
B, S = 2, 16
GQA_PROJECTIONS = ("wq", "wk", "wv")


def numpy_params(defs, rng, path=()):
    """A float32 numpy tree for a ParamDef tree, leaves drawn in
    sorted-key order (see the module's note for the scales)."""
    if not isinstance(defs, ParamDef):
        return {k: numpy_params(defs[k], rng, path + (k,))
                for k in sorted(defs)}
    x = rng.standard_normal(defs.shape, dtype=np.float32)
    if defs.init in ("zeros", "ones"):
        return (defs.init == "ones") + 0.1 * x
    if path[-1] in GQA_PROJECTIONS and path[-2] in ("attn", "cross"):
        fan_in = defs.shape[-3]
    else:
        fan_in = int(np.prod([defs.shape[a] for a in defs.fan_in_axes]))
    return x / np.sqrt(fan_in) * (0.1 if defs.init == "small" else 1.0)


def jax_tree(np_tree, defs):
    """The numpy tree as JAX arrays in each leaf's declared dtype."""
    if isinstance(defs, ParamDef):
        return jnp.asarray(np_tree).astype(defs.dtype)
    return {k: jax_tree(np_tree[k], defs[k]) for k in defs}


def extra_embeds(cfg, rng):
    """Encoder frames (audio) or image patches (vlm), else None."""
    n = {"audio": cfg.encoder_frames, "vlm": cfg.num_patches}.get(
        cfg.family)
    if n is None:
        return None
    return rng.standard_normal((B, n, cfg.d_model), dtype=np.float32)


class Twin:
    """One SMOKE config built in both packages from the same numpy
    parameters, with tokens (and extra embeddings) from a seed."""

    def __init__(self, arch: str, dtype: str):
        self.cfg = dataclasses.replace(SMOKE[arch], dtype=dtype)
        self.jcfg = dataclasses.replace(JAX_SMOKE[arch], dtype=dtype)
        self.model = build_model(self.cfg, device="cpu")
        self.jmodel = jax_build_model(self.jcfg)
        defs = self.model.param_defs()
        tree = numpy_params(defs, np.random.default_rng(0))
        self.jparams = jax_tree(tree, defs)
        self.params = params_from_jax(tree, self.cfg, device="cpu")
        rng = np.random.default_rng(5)
        self.tokens = rng.integers(0, self.cfg.vocab_size, (B, S + 1))
        self.extra = extra_embeds(self.cfg, rng)

    def torch_extra(self):
        return None if self.extra is None else torch.from_numpy(self.extra)

    def jax_forward(self):
        extra = None if self.extra is None else jnp.asarray(self.extra)
        return self.jmodel.forward(self.jparams, jnp.asarray(self.tokens),
                                   extra)

    @torch.inference_mode()
    def forward(self):
        return self.model.forward(self.params,
                                  torch.from_numpy(self.tokens),
                                  self.torch_extra())


_TWINS: dict = {}


@pytest.fixture(scope="module")
def twin():
    def get(arch, dtype):
        if (arch, dtype) not in _TWINS:
            _TWINS[arch, dtype] = Twin(arch, dtype)
        return _TWINS[arch, dtype]
    yield get
    _TWINS.clear()


def _npy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(x.astype(jnp.float32))      # a writable copy


def _softmax_err(a, b) -> float:
    sa = torch.softmax(torch.from_numpy(_npy(a)), -1)
    sb = torch.softmax(torch.from_numpy(_npy(b)), -1)
    return float((sa - sb).abs().max())


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(arch, dtype, twin):
    t = twin(arch, dtype)
    got, want = t.forward(), t.jax_forward()
    assert tuple(got.shape) == (B, S + 1, t.cfg.vocab_size)
    assert got.dtype == getattr(torch, dtype)
    assert bool(torch.isfinite(got.float()).all())
    if dtype == "float32":
        assert float(np.max(np.abs(_npy(got) - _npy(want)))) < 1e-4
    else:
        assert _softmax_err(got, want) < 0.03


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_decode_consistency(arch, twin):
    """Prefill over S tokens and one decode step against the port's own
    forward over S + 1, in SMOKE's dtype, with the JAX file's bars."""
    t = twin(arch, SMOKE[arch].dtype)
    toks = torch.from_numpy(t.tokens)
    full = t.forward()
    with torch.inference_mode():
        cache = t.model.init_cache(B, 2 * S)
        pre, cache = t.model.prefill(t.params, toks[:, :S], cache,
                                     t.torch_extra())
        dec, _ = t.model.decode_step(t.params, toks[:, S: S + 1], cache, S)
    assert _softmax_err(full[:, S - 1], pre[:, 0]) < 0.03
    assert _softmax_err(full[:, S], dec[:, 0]) < 0.05


def _total(defs, leaf_cls) -> int:
    if isinstance(defs, leaf_cls):
        return int(np.prod(defs.shape))
    return sum(_total(v, leaf_cls) for v in defs.values())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_param_totals(arch):
    """From the shapes alone (nothing is allocated): the port's param_defs
    total equals the JAX package's, and lies within 7 % of the analytic
    ``ArchConfig.param_count``: the declared total is 0.939 of it for
    rwkv6 (whose mixing it approximates), 0.954 for deepseek-v2, 0.978 for
    granite, 1.048 for whisper (it counts the cross-attention in the
    encoder layers rather than the decoder layers) and within 0.02 % for
    the other six."""
    cfg = ARCHS[arch]
    total = _total(build_model(cfg, device="cpu").param_defs(), ParamDef)
    assert total == _total(jax_build_model(JAX_ARCHS[arch]).param_defs(),
                           JaxParamDef)
    assert abs(total / cfg.param_count() - 1) < 0.07


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_loss_and_grads_match_jax(arch, twin):
    t = twin(arch, "float32")
    batch = {"tokens": t.tokens[:, :S], "labels": t.tokens[:, 1:]}
    if t.extra is not None:
        batch["extra_embeds"] = t.extra
    jloss, jgrads = jax.value_and_grad(t.jmodel.train_loss)(
        t.jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    paths, leaves = zip(*tree_paths(t.params))
    leaves = [x.detach().clone().requires_grad_() for x in leaves]
    loss = t.model.train_loss(tree_unflatten(t.params, leaves),
                              {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(jloss)) <= \
        1e-5 * abs(float(jloss))
    want = dict(tree_paths(jgrads))
    assert set(want) == set(paths)
    for path, g in zip(paths, grads):
        w = _npy(want[path])
        scale = max(float(np.abs(w).max()), 1e-12)
        assert float(np.abs(g.numpy() - w).max()) <= 1e-4 * scale, path


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-v2-236b"])
def test_aux_load_balance_loss_matches_jax(arch, twin):
    """The router of the first MoE layer on a random input, in float32."""
    t = twin(arch, "float32")
    x = np.random.default_rng(9).standard_normal((B, S, t.cfg.d_model),
                                                 dtype=np.float32)
    p = {"router": t.params["blocks"]["moe"]["router"][0]}
    jp = {"router": t.jparams["blocks"]["moe"]["router"][0]}
    got = aux_load_balance_loss(p, t.cfg, torch.from_numpy(x))
    want = jax_aux_loss(jp, t.jcfg, jnp.asarray(x))
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    assert got.dtype == torch.float32
