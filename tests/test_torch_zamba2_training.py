"""zamba2's training in the port against the JAX package, on the CPU.

On the card the Mamba2 scan's gradient is K4b (``csrc/mamba2_scan_bwd.cu``);
here the wrappers take the plain versions, and this file holds the plain
backward, ``mamba2_scan_bwd_ref``, to ``jax.vjp`` of the reference's
chunked scan, ``repro.models.ssm._ssd_chunked``, and SMOKE zamba2's
training to the reference's.  Inputs are numpy draws from a seed handed
to both packages.  Bars, each relative to the leaf's largest magnitude:

* the scan's gradients in float32: dxh, db, dc and dstate0 to 1e-5; ddt
  and da_log, sums over the pairs and the steps of the chunk, to 1e-4;
  bf16 xh, b, c give bf16 dxh, db, dc, which both packages round once from
  float32: 2**-7 (one bf16 step); their float32 leaves keep the float32
  bars;
* where the reference's own vjp is not finite (ROADMAP H31: at its chunk
  of 128 ``_ssd_chunked`` exponentiates the whole [L, L] tile, and with
  dt = 1 the exponents above the diagonal pass 88), the port's gradients
  are held to autograd of the recurrence in float64 at the same bars;
* the autograd path against autograd through the plain forward: 1e-5;
* remat against no remat: bitwise;
* two ``make_train_step`` steps against the jitted JAX step: the bars of
  ``tests/test_torch_training.py``, parameters whose gradient lies below
  100 Adam eps held as in ``tests/test_torch_gemma3_training.py``.
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
from repro.models import ssm as jax_ssm
from repro.models.families import build_model as jax_build_model
from repro.training import optimizer as jax_opt
from repro.training.data import DataConfig as JaxDataConfig
from repro.training.data import SyntheticTokens as JaxSyntheticTokens
from repro_torch.configs.archs import ARCHS, SMOKE
from repro_torch.convert import params_from_jax
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import mamba2_scan as ms_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.families import build_model
from repro_torch.training import optimizer as opt
from repro_torch.training.data import DataConfig, SyntheticTokens
from test_torch_smoke_archs import jax_tree, numpy_params
from test_torch_training import (GB, OCFG, _adamw_bars, _check_state,
                                 _jax_step, _loss_and_grads, _np,
                                 _port_step, _rel)

ARCH = "zamba2-2.7b"
SEQ = 18                 # not a multiple of SMOKE's chunk of 4: padded
F32_REL, DT_REL, BF16_REL = 1e-5, 1e-4, 2.0 ** -7
NAMES = ("dxh", "db", "dc", "ddt", "da_log", "dstate0")


def _scan_arrays(s, b=2, h=3, p=16, n=8, seed=0, dt_value=None,
                 a_log_value=None):
    """xh, b, c, dt, a_log, state0, dy, dstate as float32 numpy arrays;
    dt softplus'd normals (or ``dt_value`` everywhere), a_log normals
    scaled by 0.5 (or ``a_log_value``)."""
    rng = np.random.default_rng(seed)
    r = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
    xh, bm, cm = r(b, s, h, p), r(b, s, n), r(b, s, n)
    dt = (np.full((b, s, h), dt_value, np.float32) if dt_value is not None
          else np.log1p(np.exp(r(b, s, h))).astype(np.float32))
    a_log = (np.full((h,), a_log_value, np.float32)
             if a_log_value is not None else r(h) * 0.5)
    return (xh, bm, cm, dt, a_log, r(b, h, p, n), r(b, s, h, p),
            r(b, h, p, n))


def _jax_vjp(arrays, chunk, dtype, state0, dstate):
    """The reference's (y, final state) and its gradients at cotangents
    (dy, dstate): ``jax.vjp`` of ``_ssd_chunked`` behind
    ``mamba2_forward``'s state-neutral padding."""
    xh, bm, cm, dt, a_log, s0, dy, dst = arrays
    s = xh.shape[1]
    pad = (-s) % chunk
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def f(xh, bm, cm, dt, a_log, *st):
        zp = lambda a: jnp.pad(a, ((0, 0), (0, pad)) + ((0, 0),) *
                               (a.ndim - 2))
        y, fin = jax_ssm._ssd_chunked(zp(xh), zp(bm), zp(cm), zp(dt), a_log,
                                      chunk, *st)
        return y[:, :s], fin

    args = [jnp.asarray(x).astype(jdt) for x in (xh, bm, cm)] + [
        jnp.asarray(dt), jnp.asarray(a_log)] + (
        [jnp.asarray(s0)] if state0 else [])
    (y, fin), vjp = jax.vjp(f, *args)
    cot = jnp.asarray(dst) if dstate else jnp.zeros_like(fin)
    grads = vjp((jnp.asarray(dy), cot))
    return y, list(grads) + ([] if state0 else [None])


def _bars(dtype):
    xbc = F32_REL if dtype == torch.float32 else BF16_REL
    return (xbc, xbc, xbc, DT_REL, DT_REL, F32_REL)


def _port_grads(arrays, chunk, dtype, state0, dstate):
    """The port's gradients: the plain backward for a chunk multiple,
    autograd through ``_ssd_prefill``'s padding (whose scan backward is the
    plain one) otherwise."""
    xh, bm, cm, dt, a_log, s0, dy, dst = (torch.from_numpy(a)
                                           for a in arrays)
    xh, bm, cm = (x.to(dtype) for x in (xh, bm, cm))
    s0 = s0 if state0 else None
    dst = dst if dstate else None
    if xh.shape[1] % chunk == 0:
        return list(ref.mamba2_scan_bwd_ref(xh, bm, cm, dt, a_log, dy,
                                            state0=s0, dstate=dst))
    xs = [x.clone().requires_grad_() for x in (xh, bm, cm, dt, a_log)] + (
        [s0.clone().requires_grad_()] if state0 else [])
    y, fin = ssm_mod._ssd_prefill(*xs[:5], chunk, *xs[5:] or [None])
    outs, cots = [y], [dy]
    if dstate:
        outs.append(fin)
        cots.append(dst)
    return list(torch.autograd.grad(outs, xs, cots)) + (
        [] if state0 else [None])


@pytest.mark.parametrize("s,chunk", [(32, 8), (30, 8)])
@pytest.mark.parametrize("state0,dstate", [(False, False), (True, False),
                                           (True, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_backward_matches_jax_vjp(s, chunk, state0, dstate, dtype):
    """``mamba2_scan_bwd_ref`` against ``jax.vjp`` of ``_ssd_chunked``; a
    sequence that is not a chunk multiple goes through ``_ssd_prefill``'s
    padding in autograd."""
    arrays = _scan_arrays(s)
    got = _port_grads(arrays, chunk, dtype, state0, dstate)
    _, want = _jax_vjp(arrays, chunk, dtype, state0, dstate)
    for name, g, x, bar in zip(NAMES, got, want, _bars(dtype)):
        if name == "dstate0" and not state0:
            continue
        assert g.dtype == (dtype if name in ("dxh", "db", "dc")
                           else torch.float32), name
        assert _rel(g, x) <= bar, name


def _float64_grads(arrays):
    """Autograd of the step-by-step recurrence in float64, at cotangents
    (dy, dstate), with an initial state."""
    xh, bm, cm, dt, a_log, s0 = (torch.from_numpy(a).double()
                                 .requires_grad_() for a in arrays[:6])
    dy, dst = (torch.from_numpy(a).double() for a in arrays[6:])
    a = -torch.exp(a_log)
    st, ys = s0, []
    for t in range(xh.shape[1]):
        st = st * torch.exp(dt[:, t] * a)[..., None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dt[:, t], xh[:, t], bm[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", st, cm[:, t]))
    loss = (torch.stack(ys, 1) * dy).sum() + (st * dst).sum()
    return torch.autograd.grad(loss, [xh, bm, cm, dt, a_log, s0])


def test_reference_vjp_overflows_where_the_port_stays_finite():
    """ROADMAP H31: at zamba2's chunk of 128 with dt = 1 and a_log = 0
    (a = -1), ``_ssd_chunked`` exponentiates cum_i - cum_j above the
    diagonal, which reaches 127: its y is finite (``where`` picks 0), its
    ddt and da_log are not (the vjp multiplies the masked cotangent 0 by
    exp(127) = inf).  The port's plain backward forms no positive exponent:
    every gradient is finite and equals autograd of the recurrence in
    float64."""
    arrays = _scan_arrays(256, b=1, h=2, seed=5, dt_value=1.0,
                          a_log_value=0.0)
    y, want = _jax_vjp(arrays, 128, torch.float32, True, True)
    assert bool(np.isfinite(np.asarray(y)).all())
    assert not np.isfinite(np.asarray(want[3])).all()     # ddt
    assert not np.isfinite(np.asarray(want[4])).all()     # da_log
    got = _port_grads(arrays, 128, torch.float32, True, True)
    exact = _float64_grads(arrays)
    for name, g, x, bar in zip(NAMES, got, exact, _bars(torch.float32)):
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g, x) <= bar, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_path_matches_autograd_through_the_plain_forward(dtype):
    """``ops.mamba2_scan`` under grad (the autograd function, whose
    backward is ``mamba2_scan_bwd``) and ``mamba2_scan_plain`` (the plain
    forward and backward that the card's parity runs swap in) against
    autograd through the step-by-step ``mamba2_scan_ref``, with the final
    state used and an initial state."""
    xh, bm, cm, dt, a_log, s0, dy, dst = (
        torch.from_numpy(a) for a in _scan_arrays(24, seed=2))
    xh, bm, cm = (x.to(dtype) for x in (xh, bm, cm))
    grads = []
    for fn in (ops.mamba2_scan, ref.mamba2_scan_plain, ref.mamba2_scan_ref):
        xs = [x.clone().requires_grad_() for x in (xh, bm, cm, dt, a_log,
                                                   s0)]
        y, fin = fn(*xs[:5], chunk=8, state0=xs[5], out_dtype=torch.float32)
        grads.append(torch.autograd.grad([y, fin], xs, [dy, dst]))
    for got in grads[:2]:
        for name, g, x in zip(NAMES, got, grads[2]):
            assert g.dtype == x.dtype, name
            assert _rel(g, x) <= F32_REL, name


@pytest.mark.parametrize("needs,passes,launches", [
    ((True,) * 6, 15, 4), ((True,) * 5 + (False,), 15, 4),
    ((True, False, False, False, False, False), 7, 3),
    ((False, False, False, True, False, False), 7, 3),
    ((False, True) + (False,) * 4, 15, 4),
    ((False,) * 4 + (True, False), 15, 4),
    ((False,) * 5 + (True,), 2, 2), ((False,) * 6, 0, 0)])
def test_only_the_gradients_asked_for(monkeypatch, needs, passes, launches):
    """``needs_input_grad`` decides which gradients K4b returns and which of
    its passes it launches (``bwd_passes``: the sums over the head groups
    only for b, c or a_log; the two state passes share two launches, the
    chunks' contributions and the scan, ``bwd_launches``); autograd asks
    only for the inputs that require grad."""
    assert ms_mod.bwd_passes(needs) == passes
    assert ms_mod.bwd_launches(passes) == launches
    xh, bm, cm, dt, a_log, s0, dy, _ = (torch.from_numpy(a)
                                        for a in _scan_arrays(16, seed=3))
    got = ms_mod.mamba2_scan_bwd(xh, bm, cm, dt, a_log, dy, chunk=8,
                                 state0=s0, needs=needs)
    assert [g is not None for g in got] == list(needs)
    if not any(needs):
        return
    seen = []
    wrapped = ms_mod.mamba2_scan_bwd

    def recording(*a, **kw):
        seen.append(kw["needs"])
        return wrapped(*a, **kw)

    monkeypatch.setattr(ms_mod, "mamba2_scan_bwd", recording)
    xs = [x.clone().requires_grad_(n) for x, n in
          zip((xh, bm, cm, dt, a_log, s0), needs)]
    y, _ = ops.mamba2_scan(*xs[:5], chunk=8, state0=xs[5])
    grads = torch.autograd.grad(y, [x for x in xs if x.requires_grad], dy)
    assert seen == [needs]
    assert all(g.shape == x.shape for g, x in
               zip(grads, [x for x in xs if x.requires_grad]))


@pytest.mark.parametrize("chunk,sub", [(128, 64), (64, 64), (4, 4),
                                       (100, 50), (96, 48), (127, 1)])
def test_bwd_chunk_divides_the_chunk(chunk, sub):
    """K4b's sub-chunk: the largest divisor of the chunk up to 64."""
    assert ms_mod.bwd_chunk(chunk) == sub


@pytest.mark.parametrize("needs", [(True,) * 5 + (False,),
                                   (False,) * 5 + (True,),
                                   (False, False, False, True, False,
                                    False)])
def test_bwd_buffers(needs):
    """K4b's scratch: the chunk-end states and cotangents [B, H, NC, P, N]
    and the chunks' decay factors [B, H, NC] in float32, the factors only
    where a state pass runs; dxh and ddt only where the per-chunk pass
    runs; the head groups' partial db, dc [B, ceil(H / 8), S, N] and the
    chunks' partial da_log [B, NC, H] where the per-chunk pass or the sums
    run; db, dc, da_log where the sums run; dstate0 where asked."""
    xh = torch.zeros((2, 192, 9, 16), dtype=torch.bfloat16)
    bm = torch.zeros((2, 192, 8), dtype=torch.bfloat16)
    passes = ms_mod.bwd_passes(needs)
    bufs = ms_mod.bwd_buffers(xh, bm, 64, passes, needs[5])
    assert bufs["factors"].shape == (2, 9, 3)
    assert bufs["factors"].dtype == torch.float32
    chunks = bool(passes & ms_mod.PASS_CHUNKS)
    sums = bool(passes & ms_mod.PASS_SUMS)
    assert (bufs["dx"] is not None) == (bufs["ddt"] is not None) == chunks
    if chunks:
        assert bufs["dx"].dtype == torch.bfloat16
        assert bufs["db_part"].shape == bufs["dc_part"].shape == (2, 2, 192,
                                                                 8)
        assert bufs["da_part"].shape == (2, 3, 9)
        assert bufs["dstates"].shape == (2, 9, 3, 16, 8)
    assert (bufs["db"] is not None) == (bufs["da_log"] is not None) == sums
    assert (bufs["dstate0"] is not None) == needs[5]
    for alone in (ms_mod.PASS_CHUNKS, ms_mod.PASS_SUMS):
        assert ms_mod.bwd_buffers(xh, bm, 64, alone, False)["factors"] \
            is None


def test_the_kernels_constants_and_instantiations():
    """``csrc/mamba2_scan_bwd.cu`` mirrors the wrapper: its longest
    sub-chunk, head group and passes are the module's; its state and
    per-chunk launchers are instantiated for both input types at every
    (P, N) of ``DIMS``; it holds no atomic."""
    src = (Path(_build.CSRC) / "mamba2_scan_bwd.cu").read_text()
    assert f"constexpr int MAXL = {ms_mod.BWD_MAX_CHUNK};" in src
    assert f"constexpr int HG = {ms_mod.HEAD_GROUP};" in src
    assert (f"PASS_STATES = {ms_mod.PASS_STATES}, PASS_COTANGENTS = "
            f"{ms_mod.PASS_COTANGENTS}, PASS_CHUNKS = {ms_mod.PASS_CHUNKS},"
            in src)
    assert f"PASS_SUMS = {ms_mod.PASS_SUMS};" in src
    dims = {(int(p), int(n)) for p, n in re.findall(
        r"if \(P == (\d+) && N == (\d+)\)\s+return chunks \? "
        r"launch_chunks<T, \1, \2>\(a\) : launch_states<T, \1, \2>\(a\);",
        src)}
    assert dims == set(ms_mod.DIMS)
    assert "dispatch<bf16>(a, P, N, " in src
    assert "dispatch<float>(a, P, N, " in src
    assert "atomic" not in src.lower().replace("no atomics", "")


def test_the_chunk_kernels_shared_memory():
    """K4b's per-chunk kernels for sub-chunks up to 64: the bf16 one at
    (64, 64) (mma.sync) keeps its float64 cum, twelve vectors, the block's
    partial sums, the scores and R as float32 and thirteen bf16 tiles of
    64 rows of 72 (b, c, x and two terms each of dy, S0, dE, M, E); the
    FMA one (float32, and bf16 at (16, 8)) padded float32 tiles.  Both fit
    the card's 227 KB at every (P, N) pair, one block an SM at zamba2's
    dims."""
    assert ms_mod.bwd_smem_bytes(64, 64) == 8 * 66 + 4 * (
        12 * 64 + 260 + 2 * 64 * 65) + 2 * 13 * 64 * 72
    assert ms_mod.bwd_smem_bytes(64, 64, torch.float32) == 8 * 66 + 4 * (
        7 * 64 + 16 * 64 + 260 + 2 * 64 * 65 * 3 + 2 * 64 * 65)
    assert ms_mod.bwd_smem_bytes(16, 8) == ms_mod.bwd_smem_bytes(
        16, 8, torch.float32)
    for dtype in (torch.float32, torch.bfloat16):
        assert all(ms_mod.bwd_smem_bytes(p, n, dtype) <= 232448
                   for p, n in ms_mod.DIMS)
        assert 2 * ms_mod.bwd_smem_bytes(64, 64, dtype) > 232448
    src = (Path(_build.CSRC) / "mamba2_scan_bwd.cu").read_text()
    assert "static constexpr int VEC = 7 * MAXL + 16 * MAXL + NT + 4;" in src
    assert "static constexpr int VEC = 12 * MAXL + NT + 4;" in src
    assert "static constexpr int NTILES = 13;" in src
    assert "constexpr int RB = 72;" in src
    assert "launch_chunks_mma<64, 64>(a)" in src
    assert "launch_states_mma<64, 64>(a)" in src


def test_the_probes_cuts_match_the_source_once():
    """``tools/kernel_probe.py mamba2-bwd-phases`` builds its variants from
    text cuts of ``csrc/mamba2_scan_bwd.cu``: each must be found there
    exactly once, or the probe exits naming it."""
    import sys
    tools = str(Path(__file__).resolve().parents[1] / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import kernel_probe
    src = (Path(_build.CSRC) / "mamba2_scan_bwd.cu").read_text()
    cuts = {**kernel_probe.MAMBA2_BWD_CUTS,
            **kernel_probe.MAMBA2_BWD_CHUNK_CUTS}
    assert all(src.count(old) == 1 for pairs in cuts.values()
               for old, _ in pairs)


def test_the_model_hands_the_scan_its_conv_slices_under_grad(monkeypatch):
    """``mamba2_forward`` under grad, as the train step calls it: xh, b and
    c reach ``_Mamba2Scan`` as views of the one conv output (no copy), dt
    and a_log in float32, the chunk of the config, no initial state."""
    cfg = SMOKE[ARCH]
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    seen = []
    apply = ms_mod._Mamba2Scan.apply

    def recording(*args):
        seen.append(args)
        return apply(*args)

    monkeypatch.setattr(ms_mod._Mamba2Scan, "apply", recording)
    layer = {k: v[0].detach().requires_grad_()
             for k, v in params["blocks"]["ssm"].items()}
    x = torch.randn(2, 8, cfg.d_model, dtype=torch.bfloat16)
    out, _ = ssm_mod.mamba2_forward(layer, cfg, x)
    out.float().sum().backward()
    (xh, bm, cm, dt, a_log, state0, chunk, out_dtype, plain), = seen
    base = xh.untyped_storage().data_ptr()
    assert not xh.is_contiguous() and xh.dtype == torch.bfloat16
    assert bm.untyped_storage().data_ptr() == base
    assert cm.untyped_storage().data_ptr() == base
    assert dt.dtype == a_log.dtype == torch.float32
    assert state0 is None and chunk == cfg.ssm.chunk and not plain
    assert out_dtype == torch.float32
    assert layer["a_log"].grad is not None and layer["w_in"].grad is not None


# --- the model and its train step -------------------------------------------

class Pair:
    """SMOKE zamba2 in float32 in both packages, from one numpy tree."""

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


def test_remat_equals_no_remat_bitwise(pair, monkeypatch):
    """``cfg.remat`` recomputes each Mamba2 block in the backward (not the
    shared attention block): the same loss and gradients, bit for bit,
    with K4's forward called twice per layer and its backward once, and
    K1's forward once per site either way."""
    calls = {"fwd": 0, "bwd": 0, "attn": 0}
    fwd, bwd, attn = (ops.mamba2_scan, ms_mod.mamba2_scan_bwd,
                      ops.flash_attention)

    def counting(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(ops, "mamba2_scan", counting("fwd", fwd))
    monkeypatch.setattr(ms_mod, "mamba2_scan_bwd", counting("bwd", bwd))
    monkeypatch.setattr(ops, "flash_attention", counting("attn", attn))
    batch = pair.data.batch_at(1)
    out = {}
    layers = pair.cfg.num_layers
    sites = layers // pair.cfg.attn_every
    for remat in (False, True):
        model = build_model(dataclasses.replace(pair.cfg, remat=remat),
                            device="cpu")
        calls.update(fwd=0, bwd=0, attn=0)
        out[remat] = _loss_and_grads(model, pair.params(), batch)
        assert calls == {"fwd": layers * (1 + remat), "bwd": layers,
                         "attn": sites}
    assert torch.equal(out[False][0], out[True][0])
    assert all(torch.equal(a, b) for a, b in zip(out[False][1],
                                                 out[True][1]))


def test_make_train_step_matches_jitted_jax(pair):
    """Two steps of two microbatches each, over sequences that the scan
    pads, against the jitted JAX step: the loss to 1e-4 relative, each
    moment to one bf16 step of its largest magnitude (``_check_state``'s
    bars), and each parameter to the AdamW bar (2**-7 of the steps'
    learning rates) where every step's gradient is 0 or at least 100 eps
    (1e-6).  As in ``tests/test_torch_gemma3_training.py``: Adam moves a
    parameter by lr g / (|g| + eps), which near eps turns two gradients
    that agree within the gradient bar into different fractions of lr.
    Here w_in and the shared block's wq hold such elements (|g| of 4e-9
    and 1.2e-7 at the first step, 1.5e-4 and 1.3e-4 apart after it,
    against the bar's 3.9e-5); each step moves one by at most lr, so they
    are held to 2 lr a step, and must be fewer than one in 100 of each
    leaf, or one element of a smaller leaf (a layer's a_log holds 8)."""
    from repro_torch.training.tree import tree_leaves
    step, jstep = _port_step(pair), _jax_step(pair)
    params, jparams = pair.params(), pair.jparams
    state, jstate = opt.init_state(params), jax_opt.init_state(jparams)
    ocfg = jax_opt.AdamWConfig(**OCFG)
    half = GB // 2
    unresolved, lr = None, 0.0
    for t in range(2):
        batch = pair.data.batch_at(t)
        grads = [(a + b) / 2 for a, b in zip(*(
            _loss_and_grads(pair.model, params,
                            {k: v[i * half:(i + 1) * half]
                             for k, v in batch.items()})[1]
            for i in range(2)))]
        small = [(np.abs(_np(g)) < 100 * ocfg.eps) & (_np(g) != 0)
                 for g in grads]
        unresolved = small if unresolved is None else [
            a | b for a, b in zip(unresolved, small)]
        lr += float(jax_opt.lr_at(ocfg, jnp.asarray(t + 1)))
        loss, params, state = step(params, state, batch)
        jloss, jparams, jstate = jstep(jparams, jstate,
                                       pair.jdata.batch_at(t))
        assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    bar = _adamw_bars(ocfg, 2)
    for p, w, u in zip(tree_leaves(params), tree_leaves(jparams),
                       unresolved):
        diff = np.abs(_np(p) - _np(w))
        assert u.sum() <= max(1, 1e-2 * u.size)
        assert diff[~u].max(initial=0.0) <= bar
        assert diff[u].max(initial=0.0) <= 2 * lr
    _check_state(jparams, state, jparams, jstate, bar)
    assert np.isfinite(_np(loss))


# --- chip_smoke's train_zamba2 phase -----------------------------------------

def test_train_phase_counts_for_zamba2():
    """``layer_kinds``: one global layer per site of the shared attention
    block, 9; ``train_flops`` at the train phase's shape (8 x 4096 tokens,
    54 layers): 6 x parameters (from the tree) x tokens, attention at 6
    (D + Dv) over the causal pairs of 32 heads of 80 at the 9 sites, the
    SSD scan's operations three times a layer; ``train_launches`` over 4
    accumulation steps and 4 steps: K4 twice a layer and microbatch
    (remat), K4b's four launches once, K1 and its backward once a site and
    microbatch, nothing else."""
    from test_torch_deepseek_training import _chip_smoke, _n_params
    cs = _chip_smoke()
    cfg = ARCHS[ARCH]
    assert cs.layer_kinds(cfg) == ["G"] * 9
    n = _n_params(cfg)
    assert 2.3e9 < n < 2.5e9
    scan = cs.mamba_flops(8, 4096, 80, 64, 64, 128)
    attn = 6.0 * (80 + 80) * 8 * 32 * 9 * cs.attended_pairs(4096, 4096,
                                                             True, 0)
    assert cs.train_flops(cfg, n, 8, 4096) == pytest.approx(
        6.0 * n * 8 * 4096 + attn + 3 * 54 * scan)
    exp = cs.train_launches(cfg, 4, 4)
    assert {k: v for k, v in exp.items() if v} == {
        "mamba2_scan": 54 * 4 * 4 * 2, "mamba2_scan_bwd": 54 * 4 * 4 * 4,
        "flash_attention": 9 * 4 * 4, "flash_attention_bwd": 9 * 4 * 4}
    assert set(exp) == set(ops.counts())
