"""rwkv6's training in the port against the JAX package, on the CPU.

On the card the WKV scan's gradient is K5b (``csrc/rwkv6_scan_bwd.cu``);
here the wrappers take the plain versions, and this file holds the plain
backward, ``rwkv6_scan_bwd_ref``, to ``jax.vjp`` of the reference's
chunked scan, ``repro.models.rwkv._wkv_chunked``, and SMOKE rwkv6's
training to the reference's.  Inputs are numpy draws from a seed handed
to both packages.  Bars:

* the scan's gradients in float32: each leaf to 1e-5 of its largest
  magnitude, dw to 1e-4 (float32 sums in another order, the chunked
  form's exponentials of summed log decays against the plain version's
  products of decays, dw a quotient by w); bf16 r, k, v give bf16 dr, dk,
  dv, which both packages round once from float32: 2**-7 of the largest
  magnitude (one bf16 step); their float32 leaves keep the float32 bars;
* strong decay is drawn at w = 2e-6, inside both clips: at w = 1e-6,
  exactly on the reference's bound, ``jnp.clip`` and ``torch.clamp`` may
  pass different shares of the gradient at the tie; there dw is held to
  autograd of the recurrence in float64, which the reference's float32
  vjp misses by 3 % (see the test);
* the autograd path against autograd through the plain forward: 1e-5;
* remat against no remat, the token stream: bitwise;
* one ``make_train_step`` step against the jitted JAX step: the bars of
  ``tests/test_torch_training.py``.
"""
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import SMOKE as JAX_SMOKE
from repro.models import rwkv as jax_rwkv
from repro.models.families import build_model as jax_build_model
from repro.training import optimizer as jax_opt
from repro.training.data import DataConfig as JaxDataConfig
from repro.training.data import SyntheticTokens as JaxSyntheticTokens
from repro_torch.configs.archs import SMOKE
from repro_torch.convert import params_from_jax
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import rwkv6_scan as rs_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.families import build_model
from repro_torch.training import optimizer as opt
from repro_torch.training.data import DataConfig, SyntheticTokens
from test_torch_smoke_archs import jax_tree, numpy_params
from test_torch_training import (GB, OCFG, _adamw_bars, _check_state,
                                 _jax_step, _loss_and_grads, _np,
                                 _port_step, _rel)

ARCH = "rwkv6-3b"
SEQ = 18                 # not a multiple of SMOKE's chunk of 4: padded
F32_REL, DW_REL, BF16_REL = 1e-5, 1e-4, 2.0 ** -7
STRONG = 2e-6
NAMES = ("dr", "dk", "dv", "dw", "dbonus", "dstate0")


def _scan_arrays(s, strong=False, b=2, h=2, d=16, seed=0):
    """r, k, v, w, bonus, state0, dout, dstate as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    n = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
    r, k, v = n(b, s, h, d) * 0.5, n(b, s, h, d) * 0.5, n(b, s, h, d)
    w = (np.full((b, s, h, d), STRONG, np.float32) if strong
         else 1.0 / (1.0 + np.exp(-n(b, s, h, d))))
    return (r, k, v, w, n(h, d) * 0.1, n(b, h, d, d), n(b, s, h, d),
            n(b, h, d, d))


def _jax_grads(arrays, chunk, dtype, state0, dstate):
    """The reference's gradients of (out, final state) at cotangents (dout,
    dstate): ``jax.vjp`` of ``_wkv_chunked`` behind ``rwkv6_time_mix``'s
    state-neutral padding."""
    r, k, v, w, bonus, s0, dout, dst = arrays
    s = r.shape[1]
    pad = (-s) % chunk
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def f(r, k, v, w, bonus, *st):
        zp = lambda a, c=0.0: jnp.pad(a, ((0, 0), (0, pad), (0, 0), (0, 0)),
                                      constant_values=c)
        out, fin = jax_rwkv._wkv_chunked(zp(r), zp(k), zp(v), zp(w, 1.0),
                                         bonus, chunk, *st)
        return out[:, :s], fin

    args = [jnp.asarray(x).astype(jdt) for x in (r, k, v)] + [
        jnp.asarray(w), jnp.asarray(bonus)] + (
        [jnp.asarray(s0)] if state0 else [])
    (_, fin), vjp = jax.vjp(f, *args)
    cot = jnp.asarray(dst) if dstate else jnp.zeros_like(fin)
    grads = vjp((jnp.asarray(dout), cot))
    return list(grads) + ([] if state0 else [None])


def _bars(dtype):
    rkv = F32_REL if dtype == torch.float32 else BF16_REL
    return (rkv, rkv, rkv, DW_REL, F32_REL, F32_REL)


@pytest.mark.parametrize("s,chunk", [(32, 8), (30, 8)])
@pytest.mark.parametrize("state0,dstate", [(False, False), (True, False),
                                           (True, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_backward_matches_jax_vjp(s, chunk, state0, dstate, dtype):
    """``rwkv6_scan_bwd_ref`` against ``jax.vjp`` of ``_wkv_chunked``; a
    sequence that is not a chunk multiple goes through ``_wkv_prefill``'s
    padding and clamp in autograd, whose scan backward is the plain one."""
    arrays = _scan_arrays(s)
    r, k, v, w, bonus, s0, dout, dst = (torch.from_numpy(a) for a in arrays)
    r, k, v = (x.to(dtype) for x in (r, k, v))
    s0 = s0 if state0 else None
    dst = dst if dstate else None
    if s % chunk == 0:
        got = ref.rwkv6_scan_bwd_ref(r, k, v, w, bonus, dout, chunk=chunk,
                                     state0=s0, dstate=dst)
    else:
        xs = [x.clone().requires_grad_() for x in (r, k, v, w, bonus)] + (
            [s0.clone().requires_grad_()] if state0 else [])
        y, fin = rwkv_mod._wkv_prefill(*xs[:5], chunk, *xs[5:] or [None])
        outs, cots = [y], [dout]
        if dstate:
            outs.append(fin)
            cots.append(dst)
        got = list(torch.autograd.grad(outs, xs, cots)) + (
            [] if state0 else [None])
    want = _jax_grads(arrays, chunk, dtype, state0, dstate)
    for name, g, x, bar in zip(NAMES, got, want, _bars(dtype)):
        if name == "dstate0" and not state0:
            continue
        assert g.dtype == (dtype if name in ("dr", "dk", "dv")
                           else torch.float32), name
        assert _rel(g, x) <= bar, name


def _float64_grads(ts):
    """Autograd of the step-by-step recurrence in float64 (no clip: w lies
    inside both clips), at cotangents (dout, dstate)."""
    r, k, v, w, bonus, s0 = (x.double().requires_grad_() for x in ts[:6])
    dout, dst = ts[6].double(), ts[7].double()
    st, outs = s0, []
    for t in range(r.shape[1]):
        rt, kt, vt = r[:, t], k[:, t], v[:, t]
        outs.append(torch.einsum("bhk,bhkv->bhv", rt, st)
                    + (rt * bonus * kt).sum(-1, keepdim=True) * vt)
        st = st * w[:, t][..., None] + kt[..., :, None] * vt[..., None, :]
    loss = (torch.stack(outs, 1) * dout).sum() + (st * dst).sum()
    return torch.autograd.grad(loss, [r, k, v, w, bonus, s0])


@pytest.mark.parametrize("s", [32, 30])
def test_plain_backward_matches_jax_vjp_under_strong_decay(s):
    """w = 2e-6 everywhere (each step keeps 2e-6 of the state), float32,
    an initial state and a final state's cotangent.  dw is held to autograd
    of the recurrence in float64 instead: the reference's own float32 dw
    departs from it by about 3 % of its largest magnitude here, since its
    autodiff of exp(cum_i - lw_i - cum_j) adds and cancels the neighbouring
    steps' undecayed terms, of order 1, where dlw is of order w."""
    arrays = _scan_arrays(s, strong=True, seed=1)
    ts = [torch.from_numpy(a) for a in arrays]
    r, k, v, w, bonus, s0, dout, dst = ts
    pad = (-s) % 8
    if pad:    # the state-neutral padding, as _wkv_prefill pads
        zp = lambda a, c=0.0: torch.nn.functional.pad(
            a, (0, 0, 0, 0, 0, pad), value=c)
        r, k, v, dout = zp(r), zp(k), zp(v), zp(dout)
        w = zp(w, 1.0).clamp(1e-6, 1 - 1e-6)
    got = ref.rwkv6_scan_bwd_ref(r, k, v, w, bonus, dout, state0=s0,
                                 dstate=dst)
    want = _jax_grads(arrays, 8, torch.float32, True, True)
    want[3] = _float64_grads(ts)[3]
    for name, g, x, bar in zip(NAMES, got, want, _bars(torch.float32)):
        g = g[:, :s] if g.dim() == 4 and g.shape[1] > s else g
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g, x) <= bar, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_path_matches_autograd_through_the_plain_forward(dtype):
    """``ops.rwkv6_scan`` under grad (the autograd function, whose backward
    is ``rwkv6_scan_bwd``) and ``rwkv6_scan_plain`` (the plain forward and
    backward that the card's parity runs swap in) against autograd
    through the step-by-step ``rwkv6_scan_ref``, with the final state used
    and an initial state."""
    r, k, v, w, bonus, s0, dout, dst = (
        torch.from_numpy(a) for a in _scan_arrays(24, seed=2))
    r, k, v = (x.to(dtype) for x in (r, k, v))
    grads = []
    for fn in (ops.rwkv6_scan, ref.rwkv6_scan_plain, ref.rwkv6_scan_ref):
        xs = [x.clone().requires_grad_() for x in (r, k, v, w, bonus, s0)]
        out, fin = fn(*xs[:5], chunk=8, state0=xs[5],
                      out_dtype=torch.float32)
        grads.append(torch.autograd.grad([out, fin], xs, [dout, dst]))
    for got in grads[:2]:
        for name, g, x in zip(NAMES, got, grads[2]):
            assert g.dtype == x.dtype, name
            assert _rel(g, x) <= F32_REL, name


@pytest.mark.parametrize("needs,passes,launches", [
    ((True,) * 6, 15, 4), ((True,) * 5 + (False,), 15, 4),
    ((True, False, False, False, False, False), 7, 3),
    ((False,) * 4 + (True, False), 15, 4),
    ((False,) * 5 + (True,), 2, 2), ((False,) * 6, 0, 0)])
def test_only_the_gradients_asked_for(monkeypatch, needs, passes, launches):
    """``needs_input_grad`` decides which gradients K5b returns and which of
    its passes it launches (``bwd_passes``; the two state passes share two
    launches, the chunks' contributions and the scan, ``bwd_launches``);
    autograd asks only for the inputs that require grad."""
    assert rs_mod.bwd_passes(needs) == passes
    assert rs_mod.bwd_launches(passes) == launches
    ts = [torch.from_numpy(a) for a in _scan_arrays(16, seed=3)]
    r, k, v, w, bonus, s0, dout, _ = ts
    got = rs_mod.rwkv6_scan_bwd(r, k, v, w, bonus, dout, chunk=8,
                                state0=s0, needs=needs)
    assert [g is not None for g in got] == list(needs)
    if not any(needs):
        return
    seen = []
    wrapped = rs_mod.rwkv6_scan_bwd

    def recording(*a, **kw):
        seen.append(kw["needs"])
        return wrapped(*a, **kw)

    monkeypatch.setattr(rs_mod, "rwkv6_scan_bwd", recording)
    xs = [x.clone().requires_grad_(n) for x, n in
          zip((r, k, v, w, bonus, s0), needs)]
    out, _ = ops.rwkv6_scan(*xs[:5], chunk=8, state0=xs[5])
    grads = torch.autograd.grad(out, [x for x in xs if x.requires_grad],
                                dout)
    assert seen == [needs]
    assert all(g.shape == x.shape for g, x in
               zip(grads, [x for x in xs if x.requires_grad]))


def test_the_kernels_reach():
    """K5b's bf16 per-chunk kernel (mma.sync) keeps r, k, v, d out's two
    bf16 terms and S0's (then dE's) two terms as bf16 rows of D+8, the
    summed log decays, P and the scores, four [Lp, D+8] float sums, the
    scores' partials and three sums a thread in shared memory: D up to 64
    takes every chunk up to 64, D = 128 up to 32; each head dim's kernel
    is instantiated."""
    fits = lambda d, c: rs_mod.bwd_smem_bytes(d, c) <= rs_mod.SMEM_LIMIT
    assert all(fits(d, 64) for d in (16, 32, 64))
    assert fits(128, 32) and not fits(128, 33)
    src = (Path(_build.CSRC) / "rwkv6_scan_bwd.cu").read_text()
    for launcher in ("launch_states", "launch_chunk_mma", "launch_chunk_fma"):
        assert {int(d) for d in re.findall(
            r"case (\d+): return " + launcher + r"<", src)} == \
            set(rs_mod.HEAD_DIMS), launcher
    lp, rs = 32, 64 + 8
    assert rs_mod.bwd_smem_bytes(64, 32) == (
        2 * (3 * lp * rs + 2 * lp * rs + 2 * 64 * rs)
        + 4 * (33 * rs + 2 * 32 * 36 + 4 * 32 * rs + 128 + 4 * 2 * 40
               + 3 * 256))
    assert rs_mod.bwd_smem_bytes(64, 32) == rs_mod.bwd_smem_bytes(
        64, 32, torch.bfloat16)


def test_the_float32_kernels_reach():
    """K5b's float32 per-chunk kernel (FMA) keeps six [L, D+4] float
    tiles, the summed log decays, one [D, D+4] state and two [L, L+1] pair
    tiles in shared memory: D = 64 takes every chunk up to 64, D = 128 up
    to 40; the wrapper refuses a chunk beyond it before any work."""
    fits = lambda d, c: (rs_mod.bwd_smem_bytes(d, c, torch.float32)
                         <= rs_mod.SMEM_LIMIT)
    assert all(fits(d, 64) for d in (16, 32, 64))
    assert fits(128, 40) and not fits(128, 41)
    assert rs_mod.bwd_smem_bytes(64, 32, torch.float32) == 4 * (
        6 * 32 * 68 + 33 * 68 + 64 * 68 + 2 * 32 * 33 + 128)
    with pytest.raises(ValueError, match="shared memory"):
        rs_mod._reach(128, 41, rs_mod.bwd_smem_bytes(128, 41, torch.float32))


@pytest.mark.parametrize("needs,with_factors", [
    ((True,) * 5 + (False,), True), ((False,) * 5 + (True,), True),
    ((False,) * 4 + (True, False), True)])
def test_bwd_buffers(needs, with_factors):
    """K5b's scratch: the chunk-end states and cotangents [B, H, NC, D, D]
    and the chunks' decay factors [B, H, NC, D] in float32, the factors
    only where a state pass runs; the gradients only where the per-chunk
    pass runs; dstate0 where asked."""
    r = torch.zeros((2, 96, 3, 16), dtype=torch.bfloat16)
    passes = rs_mod.bwd_passes(needs)
    bufs = rs_mod.bwd_buffers(r, 32, passes, needs[5])
    assert (bufs["factors"] is not None) == with_factors
    assert bufs["factors"].shape == (2, 3, 3, 16)
    assert bufs["factors"].dtype == torch.float32
    chunks = bool(passes & rs_mod.PASS_CHUNKS)
    assert (bufs["dr"] is not None) == chunks
    assert (bufs["states"] is not None) == bool(
        passes & (rs_mod.PASS_STATES | rs_mod.PASS_CHUNKS))
    if bufs["dstates"] is not None:
        assert bufs["dstates"].shape == (2, 3, 3, 16, 16)
    assert (bufs["dstate0"] is not None) == needs[5]
    # the per-chunk or bonus pass alone takes no factors
    for alone in (rs_mod.PASS_CHUNKS, rs_mod.PASS_BONUS):
        assert rs_mod.bwd_buffers(r, 32, alone, False)["factors"] is None


# --- the model and its train step -------------------------------------------

class Pair:
    """SMOKE rwkv6 in float32 in both packages, from one numpy tree."""

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
        self.data = SyntheticTokens(DataConfig(self.cfg.vocab_size, SEQ, GB),
                                    device="cpu")

    def params(self):
        """A fresh copy of the port's float32 masters."""
        return params_from_jax(self.tree, self.cfg, device="cpu")


@pytest.fixture(scope="module")
def pair():
    return Pair()


def test_synthetic_tokens_iterate_as_the_reference(pair):
    """``iter`` of the port's stream (on its device) gives the reference's
    first batches, bit for bit."""
    for got, want, step in zip(iter(pair.data), iter(pair.jdata), range(3)):
        for key in ("tokens", "labels"):
            assert got[key].device.type == "cpu"
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
            assert torch.equal(got[key], pair.data.batch_at(step)[key])


def test_remat_equals_no_remat_bitwise(pair, monkeypatch):
    """``cfg.remat`` recomputes each block in the backward: the same loss
    and gradients, bit for bit, with K5's forward called twice per layer
    and its backward once."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = ops.rwkv6_scan, rs_mod.rwkv6_scan_bwd

    def counting(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(ops, "rwkv6_scan", counting("fwd", fwd))
    monkeypatch.setattr(rs_mod, "rwkv6_scan_bwd", counting("bwd", bwd))
    batch = pair.data.batch_at(1)
    out = {}
    for remat in (False, True):
        model = build_model(dataclasses.replace(pair.cfg, remat=remat),
                            device="cpu")
        calls.update(fwd=0, bwd=0)
        out[remat] = _loss_and_grads(model, pair.params(), batch)
        layers = pair.cfg.num_layers
        assert calls == {"fwd": layers * (1 + remat), "bwd": layers}
    assert torch.equal(out[False][0], out[True][0])
    assert all(torch.equal(a, b) for a, b in zip(out[False][1],
                                                 out[True][1]))


def test_make_train_step_matches_jitted_jax(pair):
    """Two steps of two microbatches each, over sequences that the scan
    pads, against the jitted JAX step."""
    step, jstep = _port_step(pair), _jax_step(pair)
    params, jparams = pair.params(), pair.jparams
    state, jstate = opt.init_state(params), jax_opt.init_state(jparams)
    for t in range(2):
        loss, params, state = step(params, state, pair.data.batch_at(t))
        jloss, jparams, jstate = jstep(jparams, jstate,
                                       pair.jdata.batch_at(t))
        assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    _check_state(params, state, jparams, jstate,
                 _adamw_bars(jax_opt.AdamWConfig(**OCFG), 2))
    assert np.isfinite(_np(loss))


# --- chip_smoke's train_rwkv phase -------------------------------------------

def test_train_phase_counts_for_rwkv6():
    """``train_flops`` at the train phase's shape (8 x 4096 tokens, 32
    layers): 6 x parameters x tokens plus the scan's operations three times
    a layer; ``train_launches`` over 4 accumulation steps and 4 steps: K5
    twice a layer and microbatch (remat), K5b's four launches once,
    nothing else."""
    from repro_torch.configs.archs import ARCHS
    from test_torch_deepseek_training import _chip_smoke, _n_params
    cs = _chip_smoke()
    cfg = ARCHS[ARCH]
    n = _n_params(cfg)
    assert n == 3_073_315_840
    scan = cs.rwkv_flops(8, 4096, 40, 64, 32)
    assert cs.train_flops(cfg, n, 8, 4096) == pytest.approx(
        6.0 * n * 8 * 4096 + 3 * 32 * scan)
    exp = cs.train_launches(cfg, 4, 4)
    assert {k: v for k, v in exp.items() if v} == {
        "rwkv6_scan": 32 * 4 * 4 * 2, "rwkv6_scan_bwd": 32 * 4 * 4 * 4}
    assert set(exp) == set(ops.counts())
