"""Plain PyTorch versions of the ported kernels against the JAX package:
the pure-jnp oracles (``repro.kernels.ref``) AND the Pallas kernels in
interpret mode, on the parametrisations of ``tests/test_kernels.py``.

The CUDA kernels themselves cannot run without a GPU; ``chip_smoke.py``
holds them against these plain versions on the card.  Here the wrappers
in ``repro_torch.kernels.ops`` are given CPU tensors and must take the
plain version.  Inputs are made with numpy from a seed and handed to both
frameworks.  Tolerances are those of ``tests/test_kernels.py``: attention
2e-5 in float32 (sums taken in another order), 2e-2 in bfloat16 (output
rounding); the grouped GEMM 1e-5 / 3e-2 relative to the largest output;
the RWKV6 scan 5e-4 absolute (a sequential recurrence against chunked
forms) and finite.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models import rwkv as jax_rwkv
from repro_torch.kernels import decode_attention as torch_decode_mod
from repro_torch.kernels import ops, ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(rng, shape, dtype):
    """The same random values as a jax array and a torch tensor."""
    x = rng.standard_normal(shape, dtype=np.float32)
    return (jnp.asarray(x).astype(JNP[dtype]),
            torch.from_numpy(x).to(TORCH[dtype]))


def _err(t: torch.Tensor, j) -> float:
    want = np.asarray(j.astype(jnp.float32))
    return float(np.max(np.abs(t.float().numpy() - want)))


@pytest.mark.parametrize("b,sq,sk,h,kv,d", [
    (1, 128, 128, 4, 2, 64),
    (2, 256, 256, 4, 4, 32),
    (1, 64, 64, 8, 2, 128),
    (2, 100, 100, 4, 2, 64),      # ragged tail blocks
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 64)])
def test_flash_attention_plain_vs_jax(b, sq, sk, h, kv, d, dtype, causal,
                                      window):
    rng = np.random.default_rng(7)
    qj, qt = _pair(rng, (b, sq, h, d), dtype)
    kj, kt = _pair(rng, (b, sk, kv, d), dtype)
    vj, vt = _pair(rng, (b, sk, kv, d), dtype)
    out = ref.flash_attention_ref(qt, kt, vt, causal=causal, window=window)
    assert out.shape == (b, sq, h, d) and out.dtype == TORCH[dtype]
    oracle = jax_ref.flash_attention_ref(qj, kj, vj, causal=causal,
                                         window=window)
    pallas = jax_ops.flash_attention(qj, kj, vj, causal=causal,
                                     window=window, interpret=True)
    assert _err(out, oracle) < TOL[dtype]
    assert _err(out, pallas) < TOL[dtype]
    # a CPU tensor takes the plain version through the public wrapper
    before = ops.flash_attention.launches
    via_ops = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert torch.equal(via_ops, out)
    assert ops.flash_attention.launches == before


@pytest.mark.parametrize("clen", [512, 300, 17, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_vs_jax(clen, dtype):
    b, s, h, kv, d = 2, 512, 8, 4, 64
    rng = np.random.default_rng(7)
    qj, qt = _pair(rng, (b, 1, h, d), dtype)
    kj, kt = _pair(rng, (b, s, kv, d), dtype)
    vj, vt = _pair(rng, (b, s, kv, d), dtype)
    out = ref.decode_attention_ref(qt, kt, vt, clen)
    assert out.shape == (b, 1, h, d) and out.dtype == TORCH[dtype]
    oracle = jax_ref.decode_attention_ref(qj, kj, vj, clen)
    pallas = jax_ops.decode_attention(qj, kj, vj, jnp.int32(clen),
                                      interpret=True)
    assert _err(out, oracle) < TOL[dtype]
    assert _err(out, pallas) < TOL[dtype]
    before = ops.decode_attention.launches
    via_ops = ops.decode_attention(qt, kt, vt, clen)
    assert torch.equal(via_ops, out)
    assert ops.decode_attention.launches == before


@pytest.mark.parametrize("g", [1, 2, 16])
def test_decode_attention_group_sizes(g):
    """The group sizes of the served configs: 1 (qwen1.5), 2 (qwen3) and
    16 (glm4)."""
    b, s, kv, d, clen = 2, 96, 2, 32, 70
    rng = np.random.default_rng(g)
    qj, qt = _pair(rng, (b, 1, kv * g, d), "float32")
    kj, kt = _pair(rng, (b, s, kv, d), "float32")
    vj, vt = _pair(rng, (b, s, kv, d), "float32")
    out = ops.decode_attention(qt, kt, vt, clen)
    assert _err(out, jax_ref.decode_attention_ref(qj, kj, vj, clen)) < 2e-5


def test_flash_attention_reads_strided_views():
    """q, k, v sliced out of one fused projection (non-contiguous views)
    give the same result as their contiguous copies."""
    rng = np.random.default_rng(3)
    fused = torch.from_numpy(
        rng.standard_normal((2, 40, 8, 32), dtype=np.float32))
    q, k, v = fused[:, :, :4], fused[:, :, 4:6], fused[:, :, 6:8]
    a = ops.flash_attention(q, k, v)
    b = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(a, b)


@pytest.mark.parametrize("cache_len,batch_kv", [
    (1, 1), (17, 8), (300, 8), (512, 8), (544, 64), (544, 16), (544, 4),
    (4096, 2), (100000, 1), (33, 1000),
])
def test_decode_split_plan_covers_cache_exactly(cache_len, batch_kv):
    """Every split starts below cache_len (no block reads beyond it),
    together they cover it, and chunks are whole tiles."""
    chunk, nsplit = torch_decode_mod.split_plan(cache_len, batch_kv)
    assert chunk % torch_decode_mod.TILE_ROWS == 0 and chunk > 0
    assert nsplit >= 1
    assert nsplit * chunk >= cache_len
    assert (nsplit - 1) * chunk < cache_len


@pytest.mark.parametrize("bad", ["dtype", "heads", "head_dim", "len0",
                                 "len_big"])
def test_wrappers_reject_bad_arguments(bad):
    q = torch.zeros(1, 1, 4, 16)
    kc = torch.zeros(1, 8, 2, 16)
    if bad == "dtype":
        with pytest.raises(TypeError):
            ops.flash_attention(q.half(), kc.half(), kc.half())
    elif bad == "heads":
        with pytest.raises(ValueError):
            ops.flash_attention(torch.zeros(1, 1, 3, 16), kc, kc)
    elif bad == "head_dim":
        with pytest.raises(ValueError):
            ops.decode_attention(torch.zeros(1, 1, 4, 8), kc, kc, 1)
    elif bad == "len0":
        with pytest.raises(ValueError):
            ops.decode_attention(q, kc, kc, 0)
    else:
        with pytest.raises(ValueError):
            ops.decode_attention(q, kc, kc, 9)


def test_launch_counts_reset():
    ops.flash_attention.launches = 5
    ops.decode_attention.launches = 7
    ops.moe_gemm.launches = 3
    ops.rwkv6_scan.launches = 2
    assert ops.launch_counts() == {"flash_attention": 5,
                                   "decode_attention": 7, "moe_gemm": 3,
                                   "rwkv6_scan": 2}
    ops.reset_launch_counts()
    assert ops.launch_counts() == {"flash_attention": 0,
                                   "decode_attention": 0, "moe_gemm": 0,
                                   "rwkv6_scan": 0}


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """On a tensor that does not lie on the CPU the wrapper goes to the
    kernel's library (and raises where it cannot be built): it never
    falls back to the plain version."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import moe_gemm as mg_mod
    from repro_torch.kernels import rwkv6_scan as rs_mod

    def no_plain(*a, **k):
        raise AssertionError("plain version taken for a non-CPU tensor")

    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(fa_mod, "flash_attention_ref", no_plain)
    monkeypatch.setattr(torch_decode_mod, "decode_attention_ref", no_plain)
    monkeypatch.setattr(mg_mod, "moe_gemm_ref", no_plain)
    monkeypatch.setattr(rs_mod, "rwkv6_scan_ref", no_plain)
    monkeypatch.setattr(_build, "load", no_build)
    q = torch.zeros(1, 4, 4, 16, device="meta")
    kc = torch.zeros(1, 4, 2, 16, device="meta")
    with pytest.raises(RuntimeError):
        ops.flash_attention(q, kc, kc)
    with pytest.raises(RuntimeError):
        ops.decode_attention(q[:, :1], kc, kc, 2)
    with pytest.raises(RuntimeError):
        ops.moe_gemm(torch.zeros(2, 4, 8, 16, device="meta"),
                     torch.zeros(4, 16, 8, device="meta"))
    x = torch.zeros(1, 8, 2, 16, device="meta")
    with pytest.raises(RuntimeError):
        ops.rwkv6_scan(x, x, x, x, torch.zeros(2, 16, device="meta"),
                       chunk=4)


# ---------------------------------------------------------------------------
# K3: grouped per-expert GEMM
# ---------------------------------------------------------------------------


def _rel(t: torch.Tensor, j) -> float:
    want = np.asarray(j.astype(jnp.float32))
    return _err(t, j) / max(1e-6, float(np.max(np.abs(want))))


MOE_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


@pytest.mark.parametrize("e,c,d,f", [(4, 96, 160, 192), (2, 128, 64, 64),
                                     (8, 40, 100, 70)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gemm_plain_vs_jax(e, c, d, f, dtype):
    rng = np.random.default_rng(7)
    xj, xt = _pair(rng, (e, c, d), dtype)
    wj, wt = _pair(rng, (e, d, f), dtype)
    out = ref.moe_gemm_ref(xt, wt)
    assert out.shape == (e, c, f) and out.dtype == TORCH[dtype]
    assert _rel(out, jax_ref.moe_gemm_ref(xj, wj)) < MOE_TOL[dtype]
    assert _rel(out, jax_ops.moe_gemm(xj, wj, interpret=True)) < \
        MOE_TOL[dtype]
    before = ops.moe_gemm.launches
    assert torch.equal(ops.moe_gemm(xt, wt), out)
    assert ops.moe_gemm.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gemm_batched_strided_operand(dtype):
    """The MoE layer's operand: [B, E, C, D] as a view of its dispatch
    buffer without the last (dropped-token) row, against the reference
    applied sample by sample."""
    b, e, c, d, f = 3, 4, 8, 24, 40
    rng = np.random.default_rng(4)
    buf = rng.standard_normal((b, e * c + 1, d), dtype=np.float32)
    wj, wt = _pair(rng, (e, d, f), dtype)
    xt = torch.from_numpy(buf).to(TORCH[dtype])[:, :-1].view(b, e, c, d)
    assert not xt.is_contiguous()
    out = ops.moe_gemm(xt, wt)
    assert out.shape == (b, e, c, f)
    for i in range(b):
        xj = jnp.asarray(buf[i, :-1].reshape(e, c, d)).astype(JNP[dtype])
        assert _rel(out[i], jax_ref.moe_gemm_ref(xj, wj)) < MOE_TOL[dtype]


@pytest.mark.parametrize("bad", ["rank", "experts", "depth", "dtype",
                                 "empty"])
def test_moe_gemm_rejects_bad_arguments(bad):
    x, w = torch.zeros(2, 4, 8), torch.zeros(2, 8, 3)
    err = TypeError if bad == "dtype" else ValueError
    args = {"rank": (x[0], w), "experts": (x, torch.zeros(3, 8, 3)),
            "depth": (x, torch.zeros(2, 7, 3)), "dtype": (x, w.double()),
            "empty": (torch.zeros(2, 0, 8), w)}[bad]
    with pytest.raises(err):
        ops.moe_gemm(*args)


# ---------------------------------------------------------------------------
# K5: RWKV6 scan
# ---------------------------------------------------------------------------


def _rwkv_inputs(s, strong_decay, b=2, h=2, d=16, seed=7):
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((b, s, h, d), dtype=np.float32) * 0.5
    k = rng.standard_normal((b, s, h, d), dtype=np.float32) * 0.5
    v = rng.standard_normal((b, s, h, d), dtype=np.float32)
    if strong_decay:
        w = np.full((b, s, h, d), 1e-6, np.float32)
    else:
        w = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, h, d),
                                                      dtype=np.float32)))
    bonus = rng.standard_normal((h, d), dtype=np.float32) * 0.1
    return r, k, v, w, bonus


def _abs(t: torch.Tensor, j) -> float:
    return float(np.max(np.abs(t.float().numpy() - np.asarray(j))))


@pytest.mark.parametrize("s,chunk", [(64, 16), (96, 32)])
@pytest.mark.parametrize("strong_decay", [False, True])
def test_rwkv6_scan_plain_vs_jax(s, chunk, strong_decay):
    arrays = _rwkv_inputs(s, strong_decay)
    ts = [torch.from_numpy(a) for a in arrays]
    js = [jnp.asarray(a) for a in arrays]
    out, fin = ref.rwkv6_scan_ref(*ts, chunk=chunk)
    assert out.shape == (2, s, 2, 16) and fin.shape == (2, 2, 16, 16)
    assert fin.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
    for want_out, want_fin in (
            jax_ref.rwkv6_scan_ref(*js),
            jax_ops.rwkv6_scan(*js, chunk=chunk, interpret=True)):
        assert _abs(out, want_out) < 5e-4
        assert _abs(fin, want_fin) < 5e-4
    before = ops.rwkv6_scan.launches
    via_ops = ops.rwkv6_scan(*ts, chunk=chunk)
    assert torch.equal(via_ops[0], out) and torch.equal(via_ops[1], fin)
    assert ops.rwkv6_scan.launches == before


@pytest.mark.parametrize("s,chunk", [(64, 16), (96, 32)])
def test_rwkv6_scan_initial_state_matches_model_chunked_form(s, chunk):
    """With a non-zero initial state, against the JAX model's own chunked
    recurrence (``_wkv_chunked(state0=)``; its decays lie inside both
    clips here)."""
    r, k, v, w, bonus = _rwkv_inputs(s, False, seed=3)
    st0 = np.random.default_rng(8).standard_normal(
        (2, 2, 16, 16), dtype=np.float32)
    out, fin = ops.rwkv6_scan(
        *(torch.from_numpy(a) for a in (r, k, v, w, bonus)), chunk=chunk,
        state0=torch.from_numpy(st0))
    jout, jfin = jax_rwkv._wkv_chunked(
        *(jnp.asarray(a) for a in (r, k, v, w, bonus)), chunk,
        jnp.asarray(st0))
    assert _abs(out, jout) < 5e-4
    assert _abs(fin, jfin) < 5e-4


def test_rwkv6_scan_state_carries_across_calls():
    """Two calls over the halves, the second starting from the first's
    final state, equal one call over the whole sequence."""
    ts = [torch.from_numpy(a) for a in _rwkv_inputs(64, False, seed=5)]
    out, fin = ops.rwkv6_scan(*ts, chunk=16)
    head = [t[:, :32] if t.dim() == 4 else t for t in ts]
    tail = [t[:, 32:] if t.dim() == 4 else t for t in ts]
    o1, f1 = ops.rwkv6_scan(*head, chunk=16)
    o2, f2 = ops.rwkv6_scan(*tail, chunk=16, state0=f1)
    assert float((torch.cat([o1, o2], 1) - out).abs().max()) < 1e-5
    assert float((f2 - fin).abs().max()) < 1e-5


def test_rwkv6_scan_mixed_dtypes():
    """The model's call: r, k, v in bfloat16, w float32; the output comes
    back in bfloat16, the state in float32."""
    r, k, v, w, bonus = (torch.from_numpy(a)
                         for a in _rwkv_inputs(32, False))
    rb, kb, vb = (a.bfloat16() for a in (r, k, v))
    out, fin = ops.rwkv6_scan(rb, kb, vb, w, bonus, chunk=16)
    assert out.dtype == torch.bfloat16 and fin.dtype == torch.float32
    want, wfin = ref.rwkv6_scan_ref(rb.float(), kb.float(), vb.float(), w,
                                    bonus)
    assert float((out.float() - want).abs().max()) < \
        1e-2 * float(want.abs().max())
    assert float((fin - wfin).abs().max()) < 1e-5


@pytest.mark.parametrize("bad", ["shape", "bonus", "state", "dtype",
                                 "chunk"])
def test_rwkv6_scan_rejects_bad_arguments(bad):
    x = torch.zeros(1, 8, 2, 16)
    bonus, st = torch.zeros(2, 16), torch.zeros(1, 2, 16, 16)
    kw = {"chunk": 4}
    args = [x, x, x, x, bonus]
    err = ValueError
    if bad == "shape":
        args[1] = torch.zeros(1, 8, 2, 8)
    elif bad == "bonus":
        args[4] = torch.zeros(16)
    elif bad == "state":
        kw["state0"] = st[:, :1]
    elif bad == "dtype":
        args[2] = x.half()
        err = TypeError
    else:
        kw["chunk"] = 3
    with pytest.raises(err):
        ops.rwkv6_scan(*args, **kw)
