"""MoE training in the port against the JAX package, on the CPU: K3's
gradients (``moe_gemm_dx`` / ``moe_gemm_dw`` and the autograd path of
``moe_gemm``), the MoE layer's VJP, the dispatch whose gradient is summed
in a fixed order, and granite-moe's train step, at
``SMOKE["granite-moe-3b-a800m"]``.

Inputs are numpy draws from a seed handed to both packages.  Bars:

* the plain gradients against ``jax.vjp`` of ``repro.kernels.ref.
  moe_gemm_ref``: 1e-5 of the largest magnitude in float32 (float32 sums
  in another order), 2**-7 in bfloat16 (both round the float32 sum to
  bf16 once; sums in another order can round one step apart);
* ``apply_moe``'s output and its VJP (x, router, w_gate, w_up, w_down)
  against the reference's in float32: 1e-5 and 1e-4 of each largest
  magnitude (the VJP chains three products and the softmax router);
* the dispatch: bitwise (it only copies rows);
* remat against no remat on the CPU, and the autograd path against
  autograd through the plain version: bitwise;
* the train step: the bars of ``tests/test_torch_training.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import SMOKE as JAX_SMOKE
from repro.kernels import ref as jax_ref
from repro.models import moe as jax_moe
from repro.training import optimizer as jax_opt
from repro.training.data import DataConfig as JaxDataConfig
from repro.training.data import SyntheticTokens as JaxSyntheticTokens
from repro_torch.configs.archs import SMOKE
from repro_torch.convert import params_from_jax
from repro_torch.kernels import moe_gemm as mg_mod
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps
from repro_torch.models import moe
from repro_torch.models.families import build_model
from repro_torch.training import optimizer as opt
from repro_torch.training.data import DataConfig, SyntheticTokens
from test_torch_smoke_archs import jax_tree, numpy_params
from test_torch_training import (GB, OCFG, SEQ, _adamw_bars, _check_state,
                                 _jax_step, _loss_and_grads, _port_step,
                                 _rel)

ARCH = "granite-moe-3b-a800m"
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


# --- K3's plain gradients against jax.vjp ----------------------------------

def _operands(rng, b, e, c, d, f, dtype, strided):
    """x [b, e, c, d] (or [e, c, d] for b None), w [e, d, f] and dy: numpy
    float32 arrays rounded to ``dtype``, and the torch operands, as the
    MoE layer hands them over where ``strided`` (x a view of a dispatch
    buffer without its last row, w a transposed view, dy a column slice)."""
    lead = (e, c) if b is None else (b, e, c)
    rnd = lambda a: torch.from_numpy(a).to(dtype).float().numpy()
    xs = rnd(rng.standard_normal(lead + (d,), dtype=np.float32))
    ws = rnd(rng.standard_normal((e, d, f), dtype=np.float32))
    dys = rnd(rng.standard_normal(lead + (f,), dtype=np.float32))
    x, w, dy = (torch.from_numpy(a).to(dtype) for a in (xs, ws, dys))
    if strided:
        bb = 1 if b is None else b
        buf = torch.full((bb, e * c + 1, d), float("nan"), dtype=dtype)
        buf[:, :-1] = x.reshape(bb, e * c, d)
        x = buf[:, :-1].view(lead + (d,))
        w = w.transpose(1, 2).contiguous().transpose(1, 2)
        wide = torch.zeros(lead + (f + 3,), dtype=dtype)
        wide[..., :f] = dy
        dy = wide[..., :f]
        assert not (w.is_contiguous() or dy.is_contiguous())
        assert b is None or not x.is_contiguous()
    return (xs, ws, dys), (x, w, dy)


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,e,c,d,f", [(None, 4, 24, 40, 56),
                                       (3, 5, 16, 72, 40),
                                       (2, 3, 1, 7, 5)])
def test_plain_gradients_match_jax_vjp(b, e, c, d, f, dtype, strided):
    rng = np.random.default_rng(11)
    (xs, ws, dys), (x, w, dy) = _operands(rng, b, e, c, d, f, dtype,
                                          strided)
    fn = jax_ref.moe_gemm_ref if b is None else \
        jax.vmap(jax_ref.moe_gemm_ref, (0, None))
    jx, jw = (jnp.asarray(a).astype(JNP[dtype]) for a in (xs, ws))
    _, vjp = jax.vjp(fn, jx, jw)
    want_dx, want_dw = vjp(jnp.asarray(dys).astype(JNP[dtype]))
    dx = ref.moe_gemm_dx_ref(dy, w)
    dw = ref.moe_gemm_dw_ref(x, dy)
    assert dx.shape == x.shape and dx.dtype == dtype
    assert dw.shape == w.shape and dw.dtype == dtype
    assert _rel(dx, want_dx) <= GRAD_TOL[dtype]
    assert _rel(dw, want_dw) <= GRAD_TOL[dtype]
    # the wrappers take the plain versions for CPU tensors, launching none
    before = ops.launch_counts()
    assert torch.equal(ops.moe_gemm_dx(dy, w), dx)
    assert torch.equal(ops.moe_gemm_dw(x, dy), dw)
    assert ops.launch_counts() == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_path_equals_autograd_of_the_plain_version(dtype):
    """Under grad, ``moe_gemm`` goes through its Function: the output and
    both gradients are those of autograd through ``moe_gemm_ref``, bit
    for bit on the CPU (the same float32 einsums, rounded once)."""
    rng = np.random.default_rng(12)
    _, (x0, w0, dy) = _operands(rng, 2, 4, 24, 40, 56, dtype, True)
    got, want = [], []
    for fn, out in ((ops.moe_gemm, got), (ref.moe_gemm_ref, want)):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        y = fn(x, w)
        y.backward(dy)
        out += [y.detach(), x.grad, w.grad]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("needs", ["x", "w", "both"])
def test_backward_computes_only_the_gradients_asked_for(needs, monkeypatch):
    calls = []
    for name in ("moe_gemm_dx", "moe_gemm_dw"):
        fn = getattr(mg_mod, name)
        monkeypatch.setattr(mg_mod, name, lambda *a, _f=fn, _n=name:
                            calls.append(_n) or _f(*a))
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((4, 8, 16), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 16, 8), dtype=np.float32))
    x.requires_grad_(needs in ("x", "both"))
    w.requires_grad_(needs in ("w", "both"))
    ops.moe_gemm(x, w).sum().backward()
    want = {"x": ["moe_gemm_dx"], "w": ["moe_gemm_dw"],
            "both": ["moe_gemm_dx", "moe_gemm_dw"]}[needs]
    assert calls == want
    assert (x.grad is not None) == (needs != "w")
    assert (w.grad is not None) == (needs != "x")


def test_gradient_wrappers_reject_bad_arguments():
    x, w, dy = torch.zeros(2, 4, 8), torch.zeros(2, 8, 3), torch.zeros(2, 4, 3)
    with pytest.raises(ValueError):
        ops.moe_gemm_dx(dy, torch.zeros(2, 8, 5))      # F disagrees
    with pytest.raises(ValueError):
        ops.moe_gemm_dw(x, torch.zeros(2, 5, 3))       # rows disagree
    with pytest.raises(TypeError):
        ops.moe_gemm_dx(dy, w.double())
    with pytest.raises(TypeError):
        ops.moe_gemm_dw(x, dy.bfloat16())
    with pytest.raises(ValueError):
        ops.moe_gemm_dw(torch.zeros(2, 0, 8), torch.zeros(2, 0, 3))


# --- the input gradient's plan (K3's kernel reading w K-major) --------------

BASE = 1 << 32           # an aligned device address for the plan's checks


@pytest.mark.parametrize("d_out,f_in,vector", [(1536, 512, True),
                                               (512, 1536, True),
                                               (100, 64, True),
                                               (64, 70, False)])
def test_dx_plan_reads_the_weight_k_major(d_out, f_in, vector):
    """dX = dy [2, 40, 1024, F] . w[e]^T for w [40, D, F]: the plan takes
    the weight as it lies (its rows along F, the contraction), sets the
    K-major bit and the 128-row tile, and keeps the vector loader while
    w's rows are whole 16 bytes (D is the output: any D)."""
    w = torch.empty((40, d_out, f_in), dtype=torch.bfloat16, device="meta")
    dy_strides = (40 * 1024 * f_in, 1024 * f_in, f_in, 1)
    plan = mg_mod.gemm_plan(2, 40, 1024, f_in, d_out, dy_strides, w.stride(),
                            BASE, BASE, kmajor=True)
    assert plan.kmajor and plan.vector == vector
    assert plan.code == 1 | 4 | (0 if vector else 2)
    assert plan.grid == (-(-d_out // mg_mod.BLOCK_N), 16, 40)
    fwd = mg_mod.gemm_plan(2, 40, 1024, d_out, f_in,
                           (40 * 1024 * d_out, 1024 * d_out, d_out, 1),
                           w.stride(), BASE, BASE)
    assert not fwd.kmajor and fwd.code & 4 == 0


# --- the dispatch ----------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,top_k,e", [(16, 2, 4), (64, 8, 40), (5, 3, 7)])
def test_dispatch_rows_equal_the_gather_form_bitwise(dtype, s, top_k, e):
    """``dispatch_rows`` gives the rows of the reference's
    ``take_along_axis(x, st)`` (the port's former ``gather(x, 1, st)``)
    bit for bit, negative zeros and all."""
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.standard_normal((2, s, 24), dtype=np.float32))
    x = x.to(dtype)
    x[0, 0, :4] = -0.0
    experts = torch.from_numpy(rng.integers(0, e, (2, s * top_k)))
    order = torch.argsort(experts, dim=-1, stable=True)
    st = torch.arange(s).repeat_interleave(top_k).expand(2, -1)
    st = torch.gather(st, 1, order)
    want = torch.gather(x, 1, st[..., None].expand(-1, -1, 24))
    got = moe.dispatch_rows(x, order, top_k)
    assert got.dtype == dtype
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32))


def test_dispatch_gradient_sums_each_tokens_copies():
    """The backward of ``dispatch_rows`` gives each token the sum of its
    top_k rows' gradients, as the reference's gather does."""
    rng = np.random.default_rng(15)
    s, top_k = 12, 3
    x = torch.from_numpy(rng.standard_normal((2, s, 8), dtype=np.float32))
    x.requires_grad_()
    order = torch.stack([torch.randperm(s * top_k,
                                        generator=torch.Generator()
                                        .manual_seed(i)) for i in range(2)])
    g = torch.from_numpy(rng.standard_normal((2, s * top_k, 8),
                                             dtype=np.float32))
    moe.dispatch_rows(x, order, top_k).backward(g)
    want = torch.zeros_like(x)
    for b in range(2):
        for i in range(s * top_k):
            want[b, int(order[b, i]) // top_k] += g[b, i]
    assert float((x.grad - want).abs().max()) <= 1e-6


# --- the MoE layer's VJP against the reference ------------------------------

def _layer_params(cfg, rng):
    """Router and expert weights drawn at their input widths (numpy)."""
    m, d = cfg.moe, cfg.d_model
    return {"router": rng.standard_normal((d, m.num_experts),
                                          dtype=np.float32) / d ** 0.5,
            "w_gate": rng.standard_normal((m.num_experts, d, m.d_expert),
                                          dtype=np.float32) / d ** 0.5,
            "w_up": rng.standard_normal((m.num_experts, d, m.d_expert),
                                        dtype=np.float32) / d ** 0.5,
            "w_down": rng.standard_normal((m.num_experts, m.d_expert, d),
                                          dtype=np.float32)
            / m.d_expert ** 0.5}


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_apply_moe_vjp_matches_jax(capacity_factor):
    """SMOKE granite's MoE layer in float32 at its own capacity (1.25) and
    at 0.5, which drops tokens: the output and the gradients of x, the
    router and the three expert weights against ``jax.vjp`` of the
    reference's ``apply_moe``."""
    cfg = SMOKE[ARCH]
    cfg = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    jcfg = JAX_SMOKE[ARCH]
    jcfg = dataclasses.replace(jcfg, dtype="float32", moe=dataclasses.replace(
        jcfg.moe, capacity_factor=capacity_factor))
    rng = np.random.default_rng(16)
    p = _layer_params(cfg, rng)
    x = rng.standard_normal((2, 32, cfg.d_model), dtype=np.float32)
    dy = rng.standard_normal(x.shape, dtype=np.float32)
    if capacity_factor < 1:
        cap = moe._capacity(32, cfg)
        _, top_e = moe.route({"router": torch.from_numpy(p["router"])}, cfg,
                             torch.from_numpy(x))
        counts = torch.nn.functional.one_hot(top_e, 4).sum((1, 2))
        assert int(counts.max()) > cap         # some tokens are dropped

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jy, vjp = jax.vjp(lambda pp, xx: jax_moe.apply_moe(pp, jcfg, xx), jp,
                      jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(dy))

    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y = moe.apply_moe(tp, cfg, tx)
    grads = torch.autograd.grad(y, [tx] + [tp[k] for k in sorted(tp)],
                                torch.from_numpy(dy))
    assert _rel(y, jy) <= 1e-5
    assert _rel(grads[0], jgx) <= 1e-4
    for k, g in zip(sorted(tp), grads[1:]):
        assert _rel(g, jgp[k]) <= 1e-4, k


# --- training --------------------------------------------------------------

class Pair:
    """SMOKE granite in float32 in both packages, from one numpy tree (as
    ``tests/test_torch_training.py``'s qwen3 pair)."""

    def __init__(self):
        self.cfg = dataclasses.replace(SMOKE[ARCH], dtype="float32")
        self.jcfg = dataclasses.replace(JAX_SMOKE[ARCH], dtype="float32")
        self.model = build_model(self.cfg, device="cpu")
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


def test_make_train_step_matches_jitted_jax(pair):
    """Three steps of two microbatches each against the jitted JAX step:
    the losses to 1e-4 relative, parameters and moments to the AdamW
    bars of ``tests/test_torch_training.py``."""
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


def test_remat_equals_no_remat_bitwise(pair, monkeypatch):
    """``cfg.remat`` recomputes each block, the router's top-k too, in the
    backward: the same loss and gradients bit for bit on the CPU; K3's
    forward runs three times a layer, twice under remat."""
    calls = []
    wrapped = mg_mod._moe_gemm_fwd

    def counting(*a):
        calls.append(1)
        return wrapped(*a)

    monkeypatch.setattr(mg_mod, "_moe_gemm_fwd", counting)
    batch = pair.data.batch_at(1, device="cpu")
    out = {}
    for remat in (False, True):
        model = build_model(dataclasses.replace(pair.cfg, remat=remat),
                            device="cpu")
        calls.clear()
        out[remat] = _loss_and_grads(model, pair.params(), batch)
        assert len(calls) == 3 * pair.cfg.num_layers * (1 + remat)
    assert torch.equal(out[False][0], out[True][0])
    assert all(torch.equal(a, b) for a, b in zip(out[False][1],
                                                 out[True][1]))
