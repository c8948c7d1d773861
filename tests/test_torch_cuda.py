"""The hand-written CUDA kernels under pytest, on a machine with an NVIDIA
GPU and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test here carries the ``cuda`` marker and skips (from inside a
fixture, never at import) where there is no card; ``chip_smoke.py`` makes
the same comparisons without pytest.  Tolerances are those of
``tests/test_kernels.py``: attention 2e-5 / 2e-2 absolute, the grouped
GEMM 1e-5 / 3e-2 relative to the largest output, the Mamba2 and RWKV6
scans 5e-4 absolute in float32 (1e-2 relative for bfloat16 outputs, one
rounding).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention_fwd

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _randn(rng, shape, dtype, device):
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    return x.to(device, dtype)


@pytest.mark.parametrize("b,sq,sk,h,kv,d", [
    (1, 128, 128, 4, 2, 64), (2, 256, 256, 4, 4, 32),
    (1, 64, 64, 8, 2, 128), (2, 100, 100, 4, 2, 64),
    (1, 70, 200, 4, 1, 16),          # Sq != Sk, head dim 16
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 64), (False, 48)])
def test_flash_attention_kernel(card, b, sq, sk, h, kv, d, dtype, causal,
                                window):
    rng = np.random.default_rng(7)
    q = _randn(rng, (b, sq, h, d), dtype, card)
    k = _randn(rng, (b, sk, kv, d), dtype, card)
    v = _randn(rng, (b, sk, kv, d), dtype, card)
    before = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert float((out.float() - want.float()).abs().max()) < TOL[dtype]


@pytest.mark.parametrize("d,dv", [(64, 64), (128, 128), (256, 256),
                                  (192, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (False, 48)])
@pytest.mark.parametrize("q_offset", [0, 160, 50, 7])
def test_flash_attention_kernel_q_offset(card, d, dv, dtype, causal, window,
                                         q_offset):
    """Query row i at position q_offset + i over Sk > Sq keys (160 = Sk -
    Sq: the last Sq positions), against the plain version."""
    rng = np.random.default_rng(7)
    q = _randn(rng, (1, 100, 4, d), dtype, card)
    k = _randn(rng, (1, 260, 2, d), dtype, card)
    v = _randn(rng, (1, 260, 2, dv), dtype, card)
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    assert float((out.float() - want.float()).abs().max()) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("n_sp", [2, 4])
def test_flash_attention_sp_is_one_call(card, dtype, window, n_sp):
    """n_sp lanes of K1 at their q_offsets give one call's bits: each
    64-row query tile sees the same positions and key tiles."""
    from repro_torch.models.attention import flash_attention_sp
    rng = np.random.default_rng(7)
    q = _randn(rng, (2, 512, 8, 128), dtype, card)
    k, v = (_randn(rng, (2, 512, 4, 128), dtype, card) for _ in range(2))
    whole = ops.flash_attention(q, k, v, window=window)
    before = ops.flash_attention.launches
    lanes = flash_attention_sp(q, k, v, window=window, n_sp=n_sp)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + n_sp
    assert torch.equal(lanes, whole)


def test_flash_attention_q_offset_refuses_grad(card):
    """K1b takes no q_offset: under grad the card raises, naming H2."""
    q = torch.zeros(1, 64, 2, 64, device=card, requires_grad=True)
    k = torch.zeros(1, 128, 2, 64, device=card)
    with pytest.raises(NotImplementedError, match="H2"):
        ops.flash_attention(q, k, k, q_offset=64)


@pytest.mark.parametrize("clen", [512, 300, 17, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv,d", [(8, 4, 64), (16, 1, 128), (4, 4, 16)])
def test_decode_attention_kernel(card, clen, dtype, h, kv, d):
    rng = np.random.default_rng(7)
    q = _randn(rng, (2, 1, h, d), dtype, card)
    kc = _randn(rng, (2, 512, kv, d), dtype, card)
    vc = _randn(rng, (2, 512, kv, d), dtype, card)
    # rows at or beyond cache_len must never be read: poison them
    kc[:, clen:] = float("nan")
    vc[:, clen:] = float("nan")
    before = ops.decode_attention.launches
    out = ops.decode_attention(q, kc, vc, clen)
    torch.cuda.synchronize()
    assert ops.decode_attention.launches == before + 1
    want = ref.decode_attention_ref(q, kc[:, :clen], vc[:, :clen], clen)
    assert float((out.float() - want.float()).abs().max()) < TOL[dtype]


def test_kernels_read_strided_views(card):
    """Slices of a fused projection and one layer of a stacked cache go
    through their strides."""
    rng = np.random.default_rng(3)
    fused = _randn(rng, (2, 40, 8, 32), torch.bfloat16, card)
    q, k, v = fused[:, :, :4], fused[:, :, 4:6], fused[:, :, 6:8]
    a = ops.flash_attention(q, k, v)
    b = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(a, b)
    cache = _randn(rng, (3, 2, 64, 2, 32), torch.bfloat16, card)
    q1 = _randn(rng, (2, 1, 4, 32), torch.bfloat16, card)
    c = ops.decode_attention(q1, cache[1], cache[2], 50)
    d = ref.decode_attention_ref(q1, cache[1], cache[2], 50)
    assert float((c.float() - d.float()).abs().max()) < 2e-2


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_group_of_three(card, causal, dtype):
    """granite's grouping: 24 query heads over 8 KV heads, D = 64."""
    rng = np.random.default_rng(12)
    q = _randn(rng, (2, 96, 24, 64), dtype, card)
    k = _randn(rng, (2, 96, 8, 64), dtype, card)
    v = _randn(rng, (2, 96, 8, 64), dtype, card)
    out = ops.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    assert float((out.float() - want.float()).abs().max()) < TOL[dtype]


@pytest.mark.parametrize("clen", [1, 77, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_group_of_three(card, clen, dtype):
    rng = np.random.default_rng(13)
    q = _randn(rng, (3, 1, 24, 64), dtype, card)
    kc = _randn(rng, (3, 320, 8, 64), dtype, card)
    vc = _randn(rng, (3, 320, 8, 64), dtype, card)
    kc[:, clen:] = float("nan")
    vc[:, clen:] = float("nan")
    out = ops.decode_attention(q, kc, vc, clen)
    want = ref.decode_attention_ref(q, kc[:, :clen], vc[:, :clen], clen)
    assert float((out.float() - want.float()).abs().max()) < TOL[dtype]


def _rel(out, want) -> float:
    return float((out.float() - want.float()).abs().max()) / max(
        1e-6, float(want.float().abs().max()))


MOE_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


@pytest.mark.parametrize("e,c,d,f", [(4, 96, 160, 192), (2, 128, 64, 64),
                                     (8, 40, 100, 70), (3, 1, 7, 5),
                                     (40, 8, 1536, 512),
                                     (1, 64, 16, 64),     # one wgmma tile
                                     (2, 300, 72, 136),   # 128-row tiles
                                     (2, 300, 36, 20)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gemm_kernel(card, e, c, d, f, dtype):
    """The sweep (bf16 on the wgmma kernel with the loader the plan
    states: rows of a multiple of 8 elements take 16-byte copies, the
    ragged D = 100, 7, 36 and F = 70, 5, 20 the element-wise loader)."""
    from repro_torch.kernels import moe_gemm as mg_mod
    rng = np.random.default_rng(7)
    x = _randn(rng, (e, c, d), dtype, card)
    w = _randn(rng, (e, d, f), dtype, card)
    if dtype == torch.bfloat16:
        plan = mg_mod.gemm_plan(1, e, c, d, f, x.unsqueeze(0).stride(),
                                w.stride(), x.data_ptr(), w.data_ptr())
        assert plan.vector == (d % 8 == 0 and f % 8 == 0)
        assert plan.block_rows == (128 if c >= 256 else 64)
    before = ops.moe_gemm.launches
    before_tile = ops.moe_gemm.decode_tile_launches
    out = ops.moe_gemm(x, w)
    torch.cuda.synchronize()
    assert ops.moe_gemm.launches == before + 1
    # only a bf16 call on the 64-row tile counts as a decode-tile launch
    assert ops.moe_gemm.decode_tile_launches == before_tile + int(
        dtype == torch.bfloat16 and c < 256)
    assert out.shape == (e, c, f) and out.dtype == dtype
    assert _rel(out, ref.moe_gemm_ref(x, w)) < MOE_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gemm_kernel_strided_batch_never_reads_dropped_slot(card,
                                                                dtype):
    """[B, E, C, D] as the MoE layer hands it over: a view of the dispatch
    buffer whose last (dropped-token) row is poisoned with NaN, and a
    transposed weight view."""
    b, e, c, d, f = 3, 5, 24, 72, 40
    rng = np.random.default_rng(9)
    buf = _randn(rng, (b, e * c + 1, d), dtype, card)
    buf[:, -1] = float("nan")
    x = buf[:, :-1].view(b, e, c, d)
    w = _randn(rng, (e, f, d), dtype, card).transpose(1, 2)
    out = ops.moe_gemm(x, w)
    assert bool(torch.isfinite(out.float()).all())
    assert _rel(out, ref.moe_gemm_ref(x, w)) < MOE_TOL[dtype]
    # rows of one sample only depend on that sample
    one = ops.moe_gemm(x[1], w)
    assert torch.equal(one, out[1])


def _rwkv(rng, b, s, h, d, dtype, card, strong_decay=False):
    r = _randn(rng, (b, s, h, d), dtype, card) * 0.5
    k = _randn(rng, (b, s, h, d), dtype, card) * 0.5
    v = _randn(rng, (b, s, h, d), dtype, card)
    if strong_decay:
        w = torch.full((b, s, h, d), 1e-6, device=card)
    else:
        w = torch.sigmoid(_randn(rng, (b, s, h, d), torch.float32, card))
    bonus = _randn(rng, (h, d), torch.float32, card) * 0.1
    return r, k, v, w, bonus


@pytest.mark.parametrize("s,chunk", [(64, 16), (96, 32), (128, 64)])
@pytest.mark.parametrize("strong_decay", [False, True])
@pytest.mark.parametrize("d", [16, 64])
def test_rwkv6_scan_kernel(card, s, chunk, strong_decay, d):
    rng = np.random.default_rng(7)
    r, k, v, w, bonus = _rwkv(rng, 2, s, 3, d, torch.float32, card,
                              strong_decay)
    st0 = _randn(rng, (2, 3, d, d), torch.float32, card)
    before = ops.rwkv6_scan.launches
    out, fin = ops.rwkv6_scan(r, k, v, w, bonus, chunk=chunk, state0=st0)
    torch.cuda.synchronize()
    assert ops.rwkv6_scan.launches == before + 1
    want, wfin = ref.rwkv6_scan_ref(r, k, v, w, bonus, state0=st0)
    assert bool(torch.isfinite(out).all())
    assert float((out - want).abs().max()) < 5e-4
    assert float((fin - wfin).abs().max()) < 5e-4


def test_rwkv6_scan_kernel_bf16_strided_and_past_sequence_poisoned(card):
    """The model's mixed dtypes (bf16 r, k, v; float32 w), r, k, v sliced
    out of one fused buffer, and NaN in the steps past the sequence that
    the views leave out."""
    rng = np.random.default_rng(5)
    b, s, h, d = 2, 64, 4, 64
    fused = _randn(rng, (b, s + 16, 3, h, d), torch.bfloat16, card)
    fused[:, s:] = float("nan")
    r, k, v = (fused[:, :s, i] for i in range(3))
    w = torch.sigmoid(_randn(rng, (b, s, h, d), torch.float32, card))
    bonus = _randn(rng, (h, d), torch.float32, card) * 0.1
    out, fin = ops.rwkv6_scan(r, k, v, w, bonus, chunk=32)
    assert out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out.float()).all())
    want, wfin = ref.rwkv6_scan_ref(r, k, v, w, bonus)
    assert _rel(out, want) < 1e-2
    assert float((fin - wfin).abs().max()) < 5e-4


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv", [(32, 32), (8, 4)])
def test_flash_attention_kernel_head_dim_80(card, causal, dtype, h, kv):
    """zamba2's shared attention: head dim 80 (20 float4 per row, 5
    output columns per thread), G = 1 as zamba2 has it, and G = 2;
    a ragged query tile."""
    rng = np.random.default_rng(80)
    q = _randn(rng, (2, 100, h, 80), dtype, card)
    k = _randn(rng, (2, 100, kv, 80), dtype, card)
    v = _randn(rng, (2, 100, kv, 80), dtype, card)
    out = ops.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    assert float((out.float() - want.float()).abs().max()) < TOL[dtype]


@pytest.mark.parametrize("clen", [1, 77, 544])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv", [(32, 32), (8, 4)])
def test_decode_attention_kernel_head_dim_80(card, clen, dtype, h, kv):
    rng = np.random.default_rng(81)
    q = _randn(rng, (3, 1, h, 80), dtype, card)
    kc = _randn(rng, (3, 544, kv, 80), dtype, card)
    vc = _randn(rng, (3, 544, kv, 80), dtype, card)
    kc[:, clen:] = float("nan")
    vc[:, clen:] = float("nan")
    out = ops.decode_attention(q, kc, vc, clen)
    want = ref.decode_attention_ref(q, kc[:, :clen], vc[:, :clen], clen)
    assert float((out.float() - want.float()).abs().max()) < TOL[dtype]


def _mamba(rng, b, s, h, p, n, dtype, card):
    xh = _randn(rng, (b, s, h, p), dtype, card)
    bm = _randn(rng, (b, s, n), dtype, card)
    cm = _randn(rng, (b, s, n), dtype, card)
    dt = torch.nn.functional.softplus(
        _randn(rng, (b, s, h), torch.float32, card))
    a_log = _randn(rng, (h,), torch.float32, card) * 0.5
    return xh, bm, cm, dt, a_log


@pytest.mark.parametrize("s,chunk,p,n", [
    (64, 16, 16, 8), (128, 32, 16, 8), (32, 32, 16, 8),   # the sweep
    (256, 128, 64, 64), (256, 64, 64, 64),                # zamba2's dims
    (96, 32, 64, 64), (40, 40, 16, 8), (7, 7, 16, 8),
])
@pytest.mark.parametrize("initial_state", [False, True])
def test_mamba2_scan_kernel(card, s, chunk, p, n, initial_state):
    rng = np.random.default_rng(7)
    xh, bm, cm, dt, a_log = _mamba(rng, 2, s, 3, p, n, torch.float32, card)
    st0 = (_randn(rng, (2, 3, p, n), torch.float32, card)
           if initial_state else None)
    before = ops.mamba2_scan.launches
    y, fin = ops.mamba2_scan(xh, bm, cm, dt, a_log, chunk=chunk, state0=st0)
    torch.cuda.synchronize()
    assert ops.mamba2_scan.launches == before + 1
    want, wfin = ref.mamba2_scan_ref(xh, bm, cm, dt, a_log, state0=st0)
    assert bool(torch.isfinite(y).all())
    assert float((y - want).abs().max()) < 5e-4
    assert float((fin - wfin).abs().max()) < 5e-4


def test_mamba2_scan_kernel_long_sequence_float32(card):
    """zamba2's dims over 512 steps and 32 heads with an initial state:
    outputs reach about 100, and the decay weights exp(cum_i - cum_j)
    must keep float32 precision although cum reaches about -100 within a
    chunk of 128."""
    rng = np.random.default_rng(11)
    xh, bm, cm, dt, a_log = _mamba(rng, 4, 512, 32, 64, 64, torch.float32,
                                   card)
    st0 = _randn(rng, (4, 32, 64, 64), torch.float32, card)
    y, fin = ops.mamba2_scan(xh, bm, cm, dt, a_log, chunk=128, state0=st0)
    want, wfin = ref.mamba2_scan_ref(xh, bm, cm, dt, a_log, state0=st0)
    assert float((y - want).abs().max()) < 5e-4
    assert float((fin - wfin).abs().max()) < 5e-4


def test_mamba2_scan_kernel_strong_decay_stays_finite(card):
    """Large dt and a: |sum dt a| over a chunk of 128 reaches about
    1e4, so exp(cum_i - cum_j) above the diagonal would overflow; the
    kernel never forms it."""
    rng = np.random.default_rng(3)
    xh, bm, cm, _, _ = _mamba(rng, 1, 256, 2, 64, 64, torch.float32, card)
    dt = torch.full((1, 256, 2), 20.0, device=card)
    a_log = torch.full((2,), 1.5, device=card)
    y, fin = ops.mamba2_scan(xh, bm, cm, dt, a_log, chunk=128)
    want, wfin = ref.mamba2_scan_ref(xh, bm, cm, dt, a_log)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(fin).all())
    assert float((y - want).abs().max()) < 5e-4 * max(
        1.0, float(want.abs().max()))
    assert float((fin - wfin).abs().max()) < 5e-4 * max(
        1.0, float(wfin.abs().max()))


def test_mamba2_scan_kernel_bf16_column_slices_and_poison(card):
    """The model's operands: bf16 xh, b, c as column slices of one conv
    output [B, S + 16, H*P + 2N] whose steps past the sequence are NaN,
    float32 dt, an initial state; the serving dims P = N = 64, chunk
    128."""
    rng = np.random.default_rng(5)
    b, s, h, p, n = 2, 256, 4, 64, 64
    fused = _randn(rng, (b, s + 16, h * p + 2 * n), torch.bfloat16, card)
    fused[:, s:] = float("nan")
    xh = fused[:, :s, :h * p].view(b, s, h, p)
    bm, cm = fused[:, :s, h * p: h * p + n], fused[:, :s, h * p + n:]
    _, _, _, dt, a_log = _mamba(rng, b, s, h, p, n, torch.float32, card)
    st0 = _randn(rng, (b, h, p, n), torch.float32, card)
    y, fin = ops.mamba2_scan(xh, bm, cm, dt, a_log, chunk=128, state0=st0)
    assert y.dtype == torch.bfloat16 and fin.dtype == torch.float32
    assert bool(torch.isfinite(y.float()).all())
    want, wfin = ref.mamba2_scan_ref(xh, bm, cm, dt, a_log, state0=st0)
    assert _rel(y, want) < 1e-2
    assert float((fin - wfin).abs().max()) < 5e-4 * max(
        1.0, float(wfin.abs().max()))
    # every head reads the same b, c: one head alone gives its slice
    one, _ = ops.mamba2_scan(xh[:, :, 2:3], bm, cm, dt[:, :, 2:3],
                             a_log[2:3], chunk=128, state0=st0[:, 2:3])
    assert torch.equal(one, y[:, :, 2:3])



# ---------------------------------------------------------------------------
# The bf16 redesigns: K3 on wgmma, K1 on mma.sync
# ---------------------------------------------------------------------------


def _dispatch_view(rng, b, e, c, d, card):
    """x [B, E, C, D] as the MoE layer hands it over: a view of a
    [B, E*C + 1, D] buffer without its last (dropped-token) row, which is
    poisoned with NaN."""
    buf = _randn(rng, (b, e * c + 1, d), torch.bfloat16, card)
    buf[:, -1] = float("nan")
    return buf[:, :-1].view(b, e, c, d)


@pytest.mark.parametrize("b,c,d,f", [
    (8, 128, 1536, 512),     # granite prefill, gate / up
    (8, 128, 512, 1536),     # granite prefill, down
    (8, 8, 1536, 512),       # decode, 8 queries
    (4, 8, 1536, 512),       # decode, 4 queries (a 2-way shard)
])
def test_moe_gemm_kernel_bf16_granite_shapes(card, b, c, d, f):
    """granite-moe's own shapes (40 experts) through the dispatch view:
    the 128-row tile at prefill, the 64-row tile at decode, both on the
    vector loader, never reading the poisoned slot."""
    from repro_torch.kernels import moe_gemm as mg_mod
    rng = np.random.default_rng(14)
    x = _dispatch_view(rng, b, 40, c, d, card)
    w = _randn(rng, (40, d, f), torch.bfloat16, card)
    plan = mg_mod.gemm_plan(b, 40, c, d, f, x.stride(), w.stride(),
                            x.data_ptr(), w.data_ptr())
    assert plan.vector
    assert plan.block_rows == (128 if b * c >= 256 else 64)
    before = ops.moe_gemm.launches
    before_tile = ops.moe_gemm.decode_tile_launches
    out = ops.moe_gemm(x, w)
    torch.cuda.synchronize()
    assert ops.moe_gemm.launches == before + 1
    assert ops.moe_gemm.decode_tile_launches == before_tile + int(
        plan.block_rows == 64)
    assert bool(torch.isfinite(out.float()).all())
    assert _rel(out, ref.moe_gemm_ref(x, w)) < MOE_TOL[torch.bfloat16]


@pytest.mark.parametrize("name,h,kv,d", [
    ("qwen3", 16, 8, 128), ("glm4", 32, 2, 128), ("granite", 24, 8, 64),
    ("zamba2", 32, 32, 80),
])
def test_flash_attention_kernel_bf16_served_shapes(card, name, h, kv, d):
    """The four served prefill shapes (prompt 512, causal) at B = 2."""
    rng = np.random.default_rng(16)
    q = _randn(rng, (2, 512, h, d), torch.bfloat16, card)
    k = _randn(rng, (2, 512, kv, d), torch.bfloat16, card)
    v = _randn(rng, (2, 512, kv, d), torch.bfloat16, card)
    out = ops.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention_ref(q, k, v, causal=True)
    assert float((out.float() - want.float()).abs().max()) < 2e-2


# (Sq, Sk, causal, window), leaving out windows under which a row has no
# valid key at all (degenerate in the reference: ROADMAP H10)
RAGGED = [(sq, sk, causal, window)
          for sq, sk in ((100, 100), (70, 200), (150, 90))
          for causal, window in ((True, 0), (True, 48), (False, 0))
          if not window or sq - sk < window]


@pytest.mark.parametrize("d", [16, 32, 64, 80, 128])
@pytest.mark.parametrize("g", [1, 3, 16])
@pytest.mark.parametrize("sq,sk,causal,window", RAGGED)
def test_flash_attention_kernel_bf16_ragged(card, d, g, sq, sk, causal,
                                            window):
    """Ragged and unequal Sq, Sk, every head dim, groups of 1, 3 and 16."""
    rng = np.random.default_rng(17)
    q = _randn(rng, (2, sq, 2 * g, d), torch.bfloat16, card)
    k = _randn(rng, (2, sk, 2, d), torch.bfloat16, card)
    v = _randn(rng, (2, sk, 2, d), torch.bfloat16, card)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert float((out.float() - want.float()).abs().max()) < 2e-2


def test_flash_attention_kernel_bf16_misaligned_view_is_copied(card):
    """Heads of 32 inside rows of 36 elements: strides 4- but not
    8-aligned, which the bf16 kernel's 16-byte copies cannot read; the
    wrapper copies them, and the result equals the contiguous call."""
    rng = np.random.default_rng(18)
    buf = _randn(rng, (2, 80, 6, 36), torch.bfloat16, card)
    q, k, v = buf[:, :, :4, :32], buf[:, :, 4:5, :32], buf[:, :, 5:6, :32]
    assert q.stride(2) % 4 == 0 and q.stride(2) % 8
    a = ops.flash_attention(q, k, v)
    b = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The bf16 redesigns: K2 and K4 on mma.sync
# ---------------------------------------------------------------------------

# (name, H, KV, D) of the four served decode layouts, at B = 8 and the
# served cache of prompt 512 + 32 rows
DECODE_SERVED = [("qwen3", 16, 8, 128), ("glm4", 32, 2, 128),
                 ("granite", 24, 8, 64), ("zamba2", 32, 32, 80)]


def _decode_inputs(rng, h, kv, d, clen, card, b=8, s=544):
    q = _randn(rng, (b, 1, h, d), torch.bfloat16, card)
    kc = _randn(rng, (b, s, kv, d), torch.bfloat16, card)
    vc = _randn(rng, (b, s, kv, d), torch.bfloat16, card)
    kc[:, clen:] = float("nan")
    vc[:, clen:] = float("nan")
    return q, kc, vc


@pytest.mark.parametrize("clen", [1, 17, 513, 544])
@pytest.mark.parametrize("name,h,kv,d", DECODE_SERVED)
def test_decode_attention_kernel_bf16_served_shapes(card, name, h, kv, d,
                                                    clen):
    """The served decode shapes on the tensor-core kernel, rows past
    cache_len poisoned with NaN, against the plain version (2e-2)."""
    rng = np.random.default_rng(20)
    q, kc, vc = _decode_inputs(rng, h, kv, d, clen, card)
    before = ops.decode_attention.launches
    out = ops.decode_attention(q, kc, vc, clen)
    torch.cuda.synchronize()
    assert ops.decode_attention.launches == before + 1
    assert bool(torch.isfinite(out.float()).all())
    want = ref.decode_attention_ref(q, kc[:, :clen], vc[:, :clen], clen)
    assert float((out.float() - want.float()).abs().max()) < 2e-2


@pytest.mark.parametrize("name,h,kv,d", DECODE_SERVED)
def test_decode_attention_kernel_bf16_repeats_bitwise(card, name, h, kv, d):
    """Repeated calls give the same bits: the partials are combined in
    split order whichever block arrives last, and the tickets are handed
    back at 0 (a third call after a call of another size checks it)."""
    rng = np.random.default_rng(21)
    q, kc, vc = _decode_inputs(rng, h, kv, d, 544, card)
    a = ops.decode_attention(q, kc, vc, 544)
    b = ops.decode_attention(q, kc, vc, 544)
    ops.decode_attention(q[:2], kc[:2], vc[:2], 100)
    c = ops.decode_attention(q, kc, vc, 544)
    assert torch.equal(a, b) and torch.equal(a, c)


def test_decode_attention_kernel_bf16_one_device_kernel_per_call(card):
    """A bf16 call runs one kernel on the card (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(22)
    q, kc, vc = _decode_inputs(rng, 32, 2, 128, 544, card)   # split
    ops.decode_attention(q, kc, vc, 544)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            ops.decode_attention(q, kc, vc, 544)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.count
             and "decode" in e.key]
    counts = {e.key: e.count for e in prof.key_averages() if "decode" in e.key}
    assert len(names) == 1 and "decode_mma_kernel" in names[0], counts
    assert counts[names[0]] == 3


def _scan_bars(want, wfin):
    """scan_tols' bf16 bars: the output to 1e-2 of its largest magnitude,
    the float32 state to 5e-4 of max(1, its largest magnitude)."""
    return (1e-2 * float(want.float().abs().max()),
            5e-4 * max(1.0, float(wfin.abs().max())))


@pytest.mark.parametrize("s,chunk,p,n", [
    (64, 16, 16, 8), (128, 32, 16, 8), (32, 32, 16, 8),
    (256, 128, 64, 64), (256, 64, 64, 64),
    (96, 32, 64, 64), (40, 40, 16, 8), (7, 7, 16, 8),
])
@pytest.mark.parametrize("initial_state", [False, True])
def test_mamba2_scan_kernel_bf16(card, s, chunk, p, n, initial_state):
    """The sweep of test_mamba2_scan_kernel in bf16 on the tensor-core
    kernel, held to the bf16 bars of chip_smoke.scan_tols."""
    rng = np.random.default_rng(7)
    xh, bm, cm, dt, a_log = _mamba(rng, 2, s, 3, p, n, torch.bfloat16, card)
    st0 = (_randn(rng, (2, 3, p, n), torch.float32, card)
           if initial_state else None)
    before = ops.mamba2_scan.launches
    y, fin = ops.mamba2_scan(xh, bm, cm, dt, a_log, chunk=chunk, state0=st0)
    torch.cuda.synchronize()
    assert ops.mamba2_scan.launches == before + 1
    assert y.dtype == torch.bfloat16 and fin.dtype == torch.float32
    want, wfin = ref.mamba2_scan_ref(xh, bm, cm, dt, a_log, state0=st0)
    tol, fin_tol = _scan_bars(want, wfin)
    assert bool(torch.isfinite(y.float()).all())
    assert float((y.float() - want.float()).abs().max()) <= tol
    assert float((fin - wfin).abs().max()) <= fin_tol


def test_mamba2_scan_kernel_bf16_repeats_bitwise(card):
    """zamba2's dims over 512 steps and 8 heads from column slices:
    repeated calls give the same bits."""
    rng = np.random.default_rng(23)
    b, s, h, p, n = 2, 512, 8, 64, 64
    fused = _randn(rng, (b, s, h * p + 2 * n), torch.bfloat16, card)
    xh = fused[..., :h * p].view(b, s, h, p)
    bm, cm = fused[..., h * p: h * p + n], fused[..., h * p + n:]
    _, _, _, dt, a_log = _mamba(rng, b, s, h, p, n, torch.float32, card)
    st0 = _randn(rng, (b, h, p, n), torch.float32, card)
    y1, f1 = ops.mamba2_scan(xh, bm, cm, dt, a_log, chunk=128, state0=st0)
    y2, f2 = ops.mamba2_scan(xh, bm, cm, dt, a_log, chunk=128, state0=st0)
    assert torch.equal(y1, y2) and torch.equal(f1, f2)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("chunk", [4, 16, 32, 64])
@pytest.mark.parametrize("strong_decay", [False, True])
@pytest.mark.parametrize("initial_state", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_rwkv6_scan_kernel_bf16(card, d, chunk, strong_decay, initial_state,
                                out_dtype):
    """bf16 r, k, v on the tensor-core kernel against the plain version,
    held to the bf16 bars of chip_smoke.scan_tols, over every head dim and
    chunks from the SMOKE config's 4 (one padded sub-chunk) to 64."""
    rng = np.random.default_rng(11)
    r, k, v, w, bonus = _rwkv(rng, 2, 128, 3, d, torch.bfloat16, card,
                              strong_decay)
    st0 = (_randn(rng, (2, 3, d, d), torch.float32, card)
           if initial_state else None)
    before = ops.rwkv6_scan.launches
    out, fin = ops.rwkv6_scan(r, k, v, w, bonus, chunk=chunk, state0=st0,
                              out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert ops.rwkv6_scan.launches == before + 1
    assert out.dtype == out_dtype and fin.dtype == torch.float32
    want, wfin = ref.rwkv6_scan_ref(r, k, v, w, bonus, state0=st0,
                                    out_dtype=out_dtype)
    tol, fin_tol = _scan_bars(want, wfin)
    assert bool(torch.isfinite(out.float()).all())
    assert float((out.float() - want.float()).abs().max()) <= tol
    assert float((fin - wfin).abs().max()) <= fin_tol


@pytest.mark.parametrize("chunk", [4, 40, 64])
def test_rwkv6_scan_kernel_bf16_fused_views_float32_out(card, chunk):
    """The model's call: r, k, v sliced out of one fused buffer with NaN in
    the steps past the sequence, float32 w, a carried state and a float32
    output (a chunk of 40 pads its last sub-chunk)."""
    rng = np.random.default_rng(13)
    b, s, h, d = 2, 120 if chunk == 40 else 128, 4, 64
    fused = _randn(rng, (b, s + 16, 3, h, d), torch.bfloat16, card)
    fused[:, s:] = float("nan")
    r, k, v = (fused[:, :s, i] for i in range(3))
    w = torch.sigmoid(_randn(rng, (b, s, h, d), torch.float32, card))
    bonus = _randn(rng, (h, d), torch.float32, card) * 0.1
    st0 = _randn(rng, (b, h, d, d), torch.float32, card)
    out, fin = ops.rwkv6_scan(r, k, v, w, bonus, chunk=chunk, state0=st0,
                              out_dtype=torch.float32)
    assert out.dtype == torch.float32
    want, wfin = ref.rwkv6_scan_ref(r, k, v, w, bonus, state0=st0,
                                    out_dtype=torch.float32)
    tol, fin_tol = _scan_bars(want, wfin)
    assert bool(torch.isfinite(out).all())
    assert float((out - want).abs().max()) <= tol
    assert float((fin - wfin).abs().max()) <= fin_tol


def test_rwkv6_scan_kernel_bf16_repeats_bitwise(card):
    """rwkv6-3b's head dim and chunk over 512 steps: repeated calls give
    the same bits, with a call of another shape in between."""
    rng = np.random.default_rng(29)
    r, k, v, w, bonus = _rwkv(rng, 2, 512, 8, 64, torch.bfloat16, card)
    st0 = _randn(rng, (2, 8, 64, 64), torch.float32, card)
    o1, f1 = ops.rwkv6_scan(r, k, v, w, bonus, chunk=32, state0=st0,
                            out_dtype=torch.float32)
    other = _rwkv(rng, 1, 80, 2, 16, torch.bfloat16, card)
    ops.rwkv6_scan(*other, chunk=40)
    o2, f2 = ops.rwkv6_scan(r, k, v, w, bonus, chunk=32, state0=st0,
                            out_dtype=torch.float32)
    assert torch.equal(o1, o2) and torch.equal(f1, f2)


def test_scan_kernels_float32_out_of_bf16_inputs(card):
    """K4 and K5 store a float32 output of bf16 inputs (the models' call)
    that agrees with their bf16 output up to its one rounding."""
    rng = np.random.default_rng(31)
    r, k, v, w, bonus = _rwkv(rng, 2, 64, 3, 64, torch.bfloat16, card)
    o32, f32 = ops.rwkv6_scan(r, k, v, w, bonus, chunk=32,
                              out_dtype=torch.float32)
    o16, f16 = ops.rwkv6_scan(r, k, v, w, bonus, chunk=32)
    assert o32.dtype == torch.float32 and o16.dtype == torch.bfloat16
    assert torch.equal(o32.bfloat16(), o16) and torch.equal(f32, f16)
    xh, bm, cm, dt, a_log = _mamba(rng, 2, 128, 3, 64, 64, torch.bfloat16,
                                   card)
    y32, g32 = ops.mamba2_scan(xh, bm, cm, dt, a_log, chunk=64,
                               out_dtype=torch.float32)
    y16, g16 = ops.mamba2_scan(xh, bm, cm, dt, a_log, chunk=64)
    assert y32.dtype == torch.float32 and y16.dtype == torch.bfloat16
    assert torch.equal(y32.bfloat16(), y16) and torch.equal(g32, g16)


# ---------------------------------------------------------------------------
# Head dim 256 (gemma3): K1 with and without its sliding window, K2 at
# every split plan up to the global cache of prompt 2048 + 32 rows
# ---------------------------------------------------------------------------

# (Sq, Sk, window): the served prompt, a ragged one, Sq != Sk; windows of
# none, gemma3's 1024 and one below a KV tile, leaving out those under
# which a row has no valid key at all (ROADMAP H10)
D256_FLASH = [(sq, sk, window)
              for sq, sk in ((2048, 2048), (300, 300), (150, 90))
              for window in (0, 1024, 20)
              if not window or sq - sk < window]


@pytest.mark.parametrize("sq,sk,window", D256_FLASH)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_head_dim_256(card, sq, sk, window, dtype):
    """gemma3's heads (8 over 4 KV heads of 256), causal, against the
    plain version (2e-5 / 2e-2)."""
    rng = np.random.default_rng(27)
    q = _randn(rng, (2, sq, 8, 256), dtype, card)
    k = _randn(rng, (2, sk, 4, 256), dtype, card)
    v = _randn(rng, (2, sk, 4, 256), dtype, card)
    before = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    assert bool(torch.isfinite(out.float()).all())
    assert float((out.float() - want.float()).abs().max()) < TOL[dtype]


@pytest.mark.parametrize("sq", [1, 17, 64, 512])
@pytest.mark.parametrize("h,kv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_value_dim(card, sq, h, kv, dtype):
    """deepseek-v2's prefill pair (D, Dv) = (192, 128), causal, Sk = Sq:
    the kernel against its plain version, and a second call bitwise
    equal."""
    rng = np.random.default_rng(192)
    q = _randn(rng, (2, sq, h, 192), dtype, card)
    k = _randn(rng, (2, sq, kv, 192), dtype, card)
    v = _randn(rng, (2, sq, kv, 128), dtype, card)
    before = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert out.shape == (2, sq, h, 128) and out.dtype == dtype
    want = ref.flash_attention_ref(q, k, v, causal=True)
    assert float((out.float() - want.float()).abs().max()) < TOL[dtype]
    assert torch.equal(ops.flash_attention(q, k, v, causal=True), out)


@pytest.mark.parametrize("s", [16, 64, 100, 544, 1024, 2080])
@pytest.mark.parametrize("b", [1, 2, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_head_dim_256(card, s, b, dtype):
    """gemma3's decode (8 heads over 4 KV heads of 256) at caches of up to
    2080 rows (prompt 2048 + 32) and 1024 (the local ring), B = 1, 2, 8:
    every split plan those give, at lengths 1, S / 2 + 1 and S, rows past
    the length poisoned; the device length gives the int length's bits."""
    from repro_torch.kernels import decode_attention as dec_mod
    rng = np.random.default_rng(28)
    q = _randn(rng, (b, 1, 8, 256), dtype, card)
    kc = _randn(rng, (b, s, 4, 256), dtype, card)
    vc = _randn(rng, (b, s, 4, 256), dtype, card)
    assert dec_mod.split_plan(s, b * 4)[1] >= 1
    for clen in sorted({1, s // 2 + 1, s}):
        kp, vp = kc.clone(), vc.clone()
        kp[:, clen:] = float("nan")
        vp[:, clen:] = float("nan")
        out = ops.decode_attention(q, kp, vp, clen)
        length = torch.full((), clen, dtype=torch.int32, device=card)
        dev = ops.decode_attention(q, kp, vp, length)
        torch.cuda.synchronize()
        assert torch.equal(out, dev), clen
        want = ref.decode_attention_ref(q, kc[:, :clen], vc[:, :clen], clen)
        assert float((out.float() - want.float()).abs().max()) < \
            TOL[dtype], clen


# whisper-small: 12 heads of 64 over 12 KV heads (G = 1), the encoder's
# 1500 frames (23 full 64-row tiles and a tail of 28), the decoder's
# 224-token prompt and its self cache of 256 rows
WHISPER_H, WHISPER_D, WHISPER_FRAMES, WHISPER_PROMPT = 12, 64, 1500, 224


@pytest.mark.parametrize("sq,causal", [(WHISPER_FRAMES, False),
                                       (WHISPER_PROMPT, False),
                                       (WHISPER_PROMPT, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_whisper_shapes(card, sq, causal, dtype):
    """K1 at whisper's three forms: the encoder's bidirectional
    self-attention (Sq = Sk = 1500, non-causal), the decoder prefill's
    cross-attention (224 queries over the 1500 frames, non-causal) and its
    causal self-attention (224 x 224), B = 2."""
    rng = np.random.default_rng(30)
    sk = sq if causal else WHISPER_FRAMES
    h, d = WHISPER_H, WHISPER_D
    q = _randn(rng, (2, sq, h, d), dtype, card)
    k = _randn(rng, (2, sk, h, d), dtype, card)
    v = _randn(rng, (2, sk, h, d), dtype, card)
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    assert bool(torch.isfinite(out.float()).all())
    assert float((out.float() - want.float()).abs().max()) < TOL[dtype]


@pytest.mark.parametrize("b", [2, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_whisper_cross_cache(card, b, dtype):
    """K2 over whisper's cross K/V, 1500 rows (B = 2 in 5 splits, B = 8
    in one), at the int length 1500 a decode step gives it, and at
    lengths 1 and 751 with the rows past them poisoned; the device length
    gives the int length's bits."""
    from repro_torch.kernels import decode_attention as dec_mod
    rng = np.random.default_rng(31)
    h, d, s = WHISPER_H, WHISPER_D, WHISPER_FRAMES
    q = _randn(rng, (b, 1, h, d), dtype, card)
    kc = _randn(rng, (b, s, h, d), dtype, card)
    vc = _randn(rng, (b, s, h, d), dtype, card)
    assert dec_mod.split_plan(s, b * h)[1] == (5 if b == 2 else 1)
    for clen in (1, s // 2 + 1, s):
        kp, vp = kc.clone(), vc.clone()
        kp[:, clen:] = float("nan")
        vp[:, clen:] = float("nan")
        out = ops.decode_attention(q, kp, vp, clen)
        length = torch.full((), clen, dtype=torch.int32, device=card)
        dev = ops.decode_attention(q, kp, vp, length)
        torch.cuda.synchronize()
        assert torch.equal(out, dev), clen
        want = ref.decode_attention_ref(q, kc[:, :clen], vc[:, :clen], clen)
        assert float((out.float() - want.float()).abs().max()) < \
            TOL[dtype], clen


# ---------------------------------------------------------------------------
# The decode step as a captured CUDA graph, K2 reading its length on the
# device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,h,kv,d", DECODE_SERVED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_device_length_in_a_graph(card, name, h, kv,
                                                          d, dtype):
    """One captured call with a device length, replayed at every length
    from 1 to S = 544 at the served shapes (B = 8; glm4's G = 16 in 7
    splits): the bits of the call with the same int length, and within
    the plain version's bar."""
    rng = np.random.default_rng(24)
    s = 544
    q = _randn(rng, (8, 1, h, d), dtype, card)
    kc = _randn(rng, (8, s, kv, d), dtype, card)
    vc = _randn(rng, (8, s, kv, d), dtype, card)
    length = torch.ones((), dtype=torch.int32, device=card)
    ops.decode_attention(q, kc, vc, length)      # the scratch, before capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.decode_attention(q, kc, vc, length)
    worst = torch.zeros((), device=card)
    for clen in range(1, s + 1):
        length.fill_(clen)
        graph.replay()
        want = ops.decode_attention(q, kc, vc, clen)
        assert torch.equal(out, want), clen
        plain = ref.decode_attention_ref(q, kc, vc, clen)
        worst = torch.maximum(worst, (out.float() - plain.float()).abs().max())
    assert float(worst) < TOL[dtype]


def _graph_model(arch, size, dtype, card):
    """``arch``'s SMOKE config, or its published width cut to one layer
    stack (two layers, whisper's two encoder and two decoder layers over
    its 1500 frames; zamba2's first attention site and a tail layer;
    gemma3's first five local layers and its first global one, with a
    window of 16 rows, so that a decode after a 16-token prompt wraps the
    local layers' ring), in ``dtype``, with weights from a seeded
    generator on the card."""
    from repro_torch.configs.archs import ARCHS, SMOKE
    from repro_torch.models.families import build_model
    if size == "smoke":
        cfg = SMOKE[arch]
    elif ARCHS[arch].encoder_layers:
        cfg = dataclasses.replace(ARCHS[arch], num_layers=2,
                                  encoder_layers=2)
    elif ARCHS[arch].local_global_pattern:
        cfg = dataclasses.replace(
            ARCHS[arch], num_layers=ARCHS[arch].local_global_pattern,
            sliding_window=16)
    else:
        cfg = ARCHS[arch]
        layers = cfg.attn_every + 1 if cfg.attn_every else 2
        cfg = dataclasses.replace(cfg, num_layers=layers)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    model = build_model(cfg, card)
    params = model.init(torch.Generator(device=card).manual_seed(0))
    return cfg, model, params


GRAPH_ARCHS = ["qwen3-1.7b", "granite-moe-3b-a800m", "rwkv6-3b",
               "zamba2-2.7b", "gemma3-4b", "whisper-small", "qwen1.5-4b",
               "llava-next-mistral-7b"]


def _frames(cfg, b, card, plen):
    """An encoder-decoder model's frames [b, encoder_frames, d], or a VLM's
    image embeddings [b, patches, d] for the first positions of a prompt
    of ``plen`` tokens (its num_patches, at most half the prompt: a full
    width llava's 576 would not fit the tests' prompts), from a seed; else
    None."""
    n = {"audio": cfg.encoder_frames,
         "vlm": min(cfg.num_patches, plen // 2)}.get(cfg.family)
    if n is None:
        return None
    rng = np.random.default_rng(27)
    return _randn(rng, (b, n, cfg.d_model), getattr(torch, cfg.dtype), card)


def _mla_narrow_model(dtype, card):
    """deepseek-v2 with its published head dims (query/key 128 + 64, value
    128, latent rank 512, query rank 1536) in a narrow stack: d_model 512,
    4 heads, a dense layer and two MoE layers of 8 experts (top 2) and a
    shared expert, vocabulary 4096; weights from a seeded generator on the
    card.  SMOKE deepseek's 24 / 16 head dims are not instantiated in K1."""
    from repro_torch.configs.archs import ARCHS
    from repro_torch.models.families import build_model
    full = ARCHS["deepseek-v2-236b"]
    cfg = dataclasses.replace(
        full, num_layers=3, d_model=512, num_heads=4, num_kv_heads=4,
        d_ff=1024, vocab_size=4096, dtype=dtype,
        moe=dataclasses.replace(full.moe, num_experts=8, top_k=2,
                                d_expert=256, num_shared_experts=1,
                                d_shared=256))
    model = build_model(cfg, card)
    params = model.init(torch.Generator(device=card).manual_seed(0))
    return cfg, model, params


@pytest.mark.parametrize("arch", GRAPH_ARCHS)
@pytest.mark.parametrize("size", ["smoke", "full_width"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_graph_replays_equal_eager_steps(card, arch, size, dtype):
    """A bundle's captured decode step against the same step run eagerly
    (and against the model's decode step at int positions): the same
    greedy tokens, and logits bitwise equal at every step, where the
    second stage of the key runs on replays alone from a reset cache
    (whisper's from new frames written into the same cache leaf; llava's
    prefill with image embeddings)."""
    _graph_equals_eager(*_graph_model(arch, size, dtype, card), card)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_graph_replays_equal_eager_steps(card, dtype):
    """The same for deepseek-v2's latent attention: the absorbed decode
    step inside the graph, its compressed cache row written at the device
    position."""
    _graph_equals_eager(*_mla_narrow_model(dtype, card), card)


def _graph_equals_eager(cfg, model, params, card):
    from repro_torch.serving.graphs import DecodeGraphs, StaticDecode
    b, plen, steps = 4, 16, 6
    max_len = plen + steps + 1
    rng = np.random.default_rng(25)
    prompts = torch.from_numpy(rng.integers(
        0, min(cfg.vocab_size, 4096), (b, plen))).to(card)
    frames = _frames(cfg, b, card, plen)
    with torch.inference_mode():
        eager = StaticDecode(model, params, b, max_len)
        eager.prefill(prompts, frames)
        want = [eager.step().clone() for _ in range(steps)]
        cache = model.init_cache(b, max_len)
        model.prefill(params, prompts, cache, frames)
        for i in range(steps):
            logits, _ = model.decode_step(
                params, eager.tokens[:, plen + i: plen + i + 1], cache,
                plen + i)
            assert torch.equal(logits, want[i]), i
        graphs = DecodeGraphs(model, params)
        tokens, _ = graphs.generate(prompts, steps + 1, max_len, frames)
        assert torch.equal(tokens, eager.tokens[:, plen:])
        assert (graphs.captures, graphs.eager_steps, graphs.replays) == \
            (1, 1, steps - 1)
        slot = graphs.slots[(b, max_len)]
        if cfg.family == "audio":
            # a stage of other frames first: the replays below must read
            # the frames of their own prefill, from the leaf the graph holds
            other = torch.flip(frames, dims=[0])
            graphs.generate(prompts, steps + 1, max_len, other)
            assert not torch.equal(slot.cache["enc_out"],
                                   model.encode(params, frames))
        slot.prefill(prompts, frames)
        for i in range(steps):
            slot.replay()
            assert torch.equal(slot.graph_logits, want[i]), i
        assert torch.equal(slot.tokens[:, plen:], eager.tokens[:, plen:])
        tokens, _ = graphs.generate(prompts, steps + 1, max_len, frames)
        assert torch.equal(tokens, eager.tokens[:, plen:])
        assert graphs.captures == 1


@pytest.mark.parametrize("arch", GRAPH_ARCHS + ["deepseek-v2-236b"])
def test_stage_launch_counts_equal_an_eager_run(card, arch):
    """The launch counts of a stage served from a captured graph equal
    those of the same stage run eagerly: the capture counts nothing, and
    each replay adds what it launched (K3's decode-tile count too).
    deepseek (its narrow stack) launches K1 and K3 and no K2; whisper K1
    three times per layer pair at its prefill (encoder self, decoder self
    and cross) and K2 twice per decoder layer at each step."""
    from repro_torch.serving.graphs import DecodeGraphs
    if arch == "deepseek-v2-236b":
        cfg, model, params = _mla_narrow_model("bfloat16", card)
    else:
        cfg, model, params = _graph_model(arch, "smoke", "bfloat16", card)
    b, plen, gen_len = 4, 12, 5
    max_len = plen + gen_len
    prompts = torch.from_numpy(np.random.default_rng(26).integers(
        0, cfg.vocab_size, (b, plen))).to(card)
    frames = _frames(cfg, b, card, plen)
    with torch.inference_mode():
        ops.reset_launch_counts()
        cache = model.init_cache(b, max_len)
        logits, _ = model.prefill(params, prompts, cache, frames)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        want_tokens = [tok]
        for i in range(gen_len - 1):
            logits, _ = model.decode_step(params, tok, cache, plen + i)
            tok = torch.argmax(logits, dim=-1)
            want_tokens.append(tok)
        torch.cuda.synchronize()
        eager = ops.counts()
        if arch == "deepseek-v2-236b":
            assert eager["decode_attention"] == 0
            assert eager["flash_attention"] == cfg.num_layers
            assert eager["moe_gemm"] == 3 * 2 * gen_len
        elif arch == "whisper-small":
            # per prefill: encoder self, decoder self and cross; per
            # decode step: the self cache and the cross K/V
            assert eager["flash_attention"] == cfg.encoder_layers \
                + 2 * cfg.num_layers
            assert eager["decode_attention"] == \
                2 * cfg.num_layers * (gen_len - 1)
        else:
            assert eager["decode_attention" if arch != "rwkv6-3b"
                         else "rwkv6_scan"] > 0
        graphs = DecodeGraphs(model, params)
        for _ in range(2):      # the stage that captures, then replays only
            ops.reset_launch_counts()
            tokens, _ = graphs.generate(prompts, gen_len, max_len, frames)
            torch.cuda.synchronize()
            assert ops.counts() == eager
            assert torch.equal(tokens, torch.cat(want_tokens, dim=1))
        assert graphs.captures == 1 and graphs.replays == 2 * gen_len - 3


# --- K1's backward ----------------------------------------------------------

# relative to each gradient's largest magnitude.  float32: FMA sums in
# another order than the plain version's einsums.  bf16: the kernel rounds
# p and ds to bf16 as the operands of its products (the plain version keeps
# them float32) and rounds its outputs.  chip_smoke.py's sweep of these
# shapes on an H100 stays below 3.2e-6 and 7.7e-3.
BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# (Sq, Sk, H, KV) at B = 1: a ragged tile, whisper's 1500 frames (23 x 64
# + 28), Sq != Sk at G = 16; (B, Sq, Sk, H, KV): B = 2 with Sq > Sk, both
# ragged, G = 2 (every query row keeps a key under the window of 64)
BWD_SHAPES = [(200, 200, 4, 2), (1500, 1500, 2, 1), (70, 200, 16, 1),
              (2, 250, 190, 8, 4)]
BWD_MODES = [(True, 0), (False, 0), (True, 64)]
# (D, Dv) pairs of the backward's dispatch: 16, 32 and 80 padded to 64 and
# 128, gemma3's 256 on the column-split kernel, deepseek's (192, 128) on
# the kv-split kernel
BWD_DIMS = [(16, 16), (32, 32), (64, 64), (80, 80), (128, 128), (256, 256),
            (192, 128)]


def _bwd_case(rng, shape, d, dtype, causal, window, card, dv=None):
    """Inputs of a backward call: q, k, v, dO and K1's own o and lse;
    ``shape`` is (Sq, Sk, H, KV) at B = 1 or (B, Sq, Sk, H, KV); v and dO
    are ``dv`` (None: ``d``) wide."""
    b, sq, sk, h, kv = shape if len(shape) == 5 else (1, *shape)
    dv = dv or d
    q = _randn(rng, (b, sq, h, d), dtype, card)
    k = _randn(rng, (b, sk, kv, d), dtype, card)
    v = _randn(rng, (b, sk, kv, dv), dtype, card)
    do = _randn(rng, (b, sq, h, dv), dtype, card)
    o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                 return_lse=True)
    return q, k, v, o, do, lse


def _rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


@pytest.mark.parametrize("shape", BWD_SHAPES)
@pytest.mark.parametrize("causal,window", BWD_MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims", BWD_DIMS)
def test_flash_attention_bwd_kernel(card, shape, causal, window, dtype, dims):
    rng = np.random.default_rng(41)
    q, k, v, o, do, lse = _bwd_case(rng, shape, dims[0], dtype, causal,
                                    window, card, dims[1])
    before = ops.flash_attention_bwd.launches
    got = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                  window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention_bwd.launches == before + 1
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal,
                                       window=window)
    errs = [_rel_err(g, w) for g, w in zip(got, want)]
    assert all(g.dtype == dtype and g.shape == w.shape
               for g, w in zip(got, want))
    assert max(errs) < BWD_TOL[dtype], errs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", BWD_MODES)
def test_flash_attention_lse_leaves_output_bits(card, dtype, causal, window):
    """K1 with the log-sum-exp gives the output of K1 without it, bit for
    bit, and the plain version's log-sum-exp."""
    rng = np.random.default_rng(42)
    q = _randn(rng, (2, 300, 16, 128), dtype, card)
    k = _randn(rng, (2, 300, 8, 128), dtype, card)
    v = _randn(rng, (2, 300, 8, 128), dtype, card)
    plain = flash_attention_fwd(q, k, v, causal=causal, window=window)
    out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   return_lse=True)
    assert torch.equal(out, plain)
    _, want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                      return_lse=True)
    assert lse.shape == (2, 16, 300) and lse.dtype == torch.float32
    assert float((lse - want).abs().max()) < 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims", [(64, 64), (80, 80), (128, 128),
                                  (256, 256), (192, 128)])
def test_flash_attention_rows_without_keys(card, dtype, dims):
    """Sq > Sk + window (ROADMAP H10): K1 gives the rows that attend no
    key 0 and a log-sum-exp of +inf (a 64-row tile where every row has
    none, and rows beside rows that have keys), the plain version's
    output elsewhere, and its backward is the gradient of that forward:
    the plain backward with those rows' dO set to 0, to BWD_TOL."""
    rng = np.random.default_rng(46)
    sq, sk, window = 200, 70, 64
    q, k, v, o, do, lse = _bwd_case(rng, (sq, sk, 4, 2), dims[0], dtype,
                                    True, window, card, dims[1])
    has = torch.arange(sq, device=card) < sk + window - 1
    assert bool((o[:, ~has] == 0).all())
    assert bool(torch.isposinf(lse[..., ~has]).all())
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    assert float((o[:, has].float() - want[:, has].float()).abs().max()) \
        < TOL[dtype]
    got = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=True,
                                  window=window)
    want = ref.flash_attention_bwd_ref(q, k, v, o,
                                       do * has[None, :, None, None], lse,
                                       causal=True, window=window)
    assert bool((got[0][:, ~has] == 0).all())
    errs = [_rel_err(g, w) for g, w in zip(got, want)]
    assert max(errs) < BWD_TOL[dtype], errs


@pytest.mark.parametrize("causal,window", BWD_MODES)
@pytest.mark.parametrize("dims", BWD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel_repeats_bitwise(card, dtype, dims,
                                                    causal, window):
    """Two calls give the same bits: in bf16 the wgmma kernels sum each
    query tile's dq in ascending key-tile order (B = 2, G = 2, 24 query
    tiles a head, every mask, every pair: 16, 32 and 80 padded to 64 and
    128, 256 on the column-split kernel, (192, 128) on the kv-split one),
    whatever order its blocks run in."""
    rng = np.random.default_rng(43)
    args = _bwd_case(rng, (2, 1500, 1500, 4, 2), dims[0], dtype, causal,
                     window, card, dims[1])
    a = ops.flash_attention_bwd(*args, causal=causal, window=window)
    b = ops.flash_attention_bwd(*args, causal=causal, window=window)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dims", [(128, 128), (256, 256), (192, 128)])
@pytest.mark.parametrize("sq,sk,causal,window", [
    (4096, 4096, True, 0), (300, 700, True, 0), (700, 300, False, 0),
    (1500, 1500, True, 64), (600, 200, True, 100), (333, 1000, False, 200)])
def test_flash_attention_bwd_counters_follow_tile_plan(card, sq, sk, causal,
                                                       window, dims):
    """After a bf16 call at (D, Dv) = (128, 128), (256, 256) or (192, 128),
    each (b, head, query tile) counter of the wgmma kernel holds the number
    of key tiles that added into that tile's dq, which must be the number
    of key tiles (128 keys, or 64 at 256 and (192, 128): ``bwd_tiles``)
    holding a pair the mask keeps with
    one of the tile's queries (the kernel's
    key_tile_queries; tests/test_torch_kernels.py holds its copy to the
    same walk), and the work counter every work tile plus one last take
    per block.  The call ends only if first_key_tile is right: a key tile
    is admitted when its counter reaches the count of its predecessors,
    and a wrong count would never be reached (the kernel traps)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(47)
    b, h, kv = 2, 4, 2
    d, dv_dim = dims
    q, k, v, o, do, lse = _bwd_case(rng, (b, sq, sk, h, kv), d,
                                    torch.bfloat16, causal, window, card,
                                    dv_dim)
    delta, acc, counters = fa.bwd_scratch(b, h, sq, d, dv_dim, q.dtype,
                                          q.device)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    rc = _build.load().fate_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), acc.data_ptr(),
        counters.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b,
        sq, sk, h, kv, d, dv_dim, int(causal), window, 1,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    bk, bq = fa.bwd_tiles(*dims)
    n_qt, n_kt = -(-sq // bq), -(-sk // bk)
    qi, ki = np.arange(sq)[:, None], np.arange(sk)[None, :]
    mask = np.ones((sq, sk), bool)
    if causal:
        mask &= qi >= ki
    if window:
        mask &= qi - ki < window
    visits = [sum(bool(mask[qt * bq:(qt + 1) * bq, kt * bk:(kt + 1) * bk]
                       .any()) for kt in range(n_kt)) for qt in range(n_qt)]
    counters = counters.cpu()
    assert counters[:-1].reshape(b * h, n_qt).tolist() == [visits] * (b * h)
    items = n_kt * b * kv
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert int(counters[-1]) == items + min(sms, items)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_autograd_on_card(card, dtype):
    """Gradients through ``flash_attention`` on the card (K1 with its
    log-sum-exp, then the backward kernel) against autograd of the plain
    version, on strided views as the models pass them."""
    rng = np.random.default_rng(44)
    fused = _randn(rng, (2, 130, 8, 64), dtype, card)
    dout = _randn(rng, (2, 130, 4, 64), dtype, card)
    grads = []
    for fn in (ops.flash_attention, ref.flash_attention_ref):
        x = fused.clone().requires_grad_()
        q, k, v = x[:, :, :4], x[:, :, 4:6], x[:, :, 6:8]
        f0, b0 = ops.flash_attention.launches, \
            ops.flash_attention_bwd.launches
        out = fn(q, k, v, causal=True, window=0)
        out.backward(dout)
        if fn is ops.flash_attention:
            assert ops.flash_attention.launches == f0 + 1
            assert ops.flash_attention_bwd.launches == b0 + 1
        grads.append(x.grad)
    assert _rel_err(*grads) < BWD_TOL[dtype]


def test_flash_attention_bwd_refuses_unported_head_dims(card):
    """A (D, Dv) pair outside ``_build.FLASH_HEAD_DIMS`` has no kernel:
    under grad the forward raises ValueError before any work, and so does a
    direct backward call.  deepseek's (192, 128) trains: under grad K1 and
    its backward launch once each."""
    from repro_torch.kernels import _build
    assert (256, 128) not in _build.FLASH_HEAD_DIMS
    q = torch.randn(1, 64, 2, 256, device=card, dtype=torch.bfloat16)
    v = torch.randn(1, 64, 2, 128, device=card, dtype=torch.bfloat16)
    before = ops.counts()
    with pytest.raises(ValueError, match="not in"):
        ops.flash_attention(q.clone().requires_grad_(), q, v)
    with pytest.raises(ValueError, match="not in"):
        ops.flash_attention_bwd(q, q, v, v, v, torch.zeros(
            1, 2, 64, device=card))
    assert ops.counts() == before
    q = torch.randn(1, 64, 2, 192, device=card, dtype=torch.bfloat16)
    x = q.clone().requires_grad_()
    ops.flash_attention(x, q, v).sum().backward()
    after = ops.counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    assert x.grad.shape == q.shape and bool(torch.isfinite(
        x.grad.float()).all())


def test_wrappers_without_backward_refuse_grad_on_card(card):
    """K2 has no backward kernel: under grad on the card it raises and
    names the ROADMAP item; without grad it launches as before (K3 has its
    gradients since ROADMAP item 14a, K5 since 14d:
    test_rwkv6_scan_autograd_on_card, K4 since 14e:
    test_mamba2_scan_launches_k4b_under_grad_on_card)."""
    rng = np.random.default_rng(45)
    bf = torch.bfloat16
    calls = {
        "decode_attention": lambda t: ops.decode_attention(
            t(2, 1, 4, 64), t(2, 32, 2, 64), t(2, 32, 2, 64), 20),
    }
    items = {"decode_attention": "item 14"}
    for name, call in calls.items():
        plain = lambda *s: _randn(rng, s, bf, card)
        graded = lambda *s: _randn(rng, s, bf, card).requires_grad_()
        call(plain)
        with pytest.raises(NotImplementedError, match=items[name]):
            call(graded)


def test_mamba2_scan_launches_k4b_under_grad_on_card(card, monkeypatch):
    """bf16 xh, b, c that require grad on the card: ``mamba2_scan`` launches
    K4 once and, in the backward, K4b's kernels (``bwd_launches``), never
    a plain version, where it raised before ROADMAP item 14e."""
    from repro_torch.kernels import mamba2_scan as ms_mod
    rng = np.random.default_rng(45)
    bf = torch.bfloat16
    xh, bm, cm = (_randn(rng, s, bf, card).requires_grad_()
                  for s in ((1, 64, 2, 64), (1, 64, 64), (1, 64, 64)))
    dt = torch.rand(1, 64, 2, device=card)
    a_log = _randn(rng, (2,), torch.float32, card)
    monkeypatch.setattr(ms_mod, "mamba2_scan_ref", None)
    monkeypatch.setattr(ms_mod, "mamba2_scan_bwd_ref", None)
    before = ops.counts()
    y, _ = ops.mamba2_scan(xh, bm, cm, dt, a_log, chunk=32,
                           out_dtype=torch.float32)
    grads = torch.autograd.grad(y.sum(), [xh, bm, cm])
    after = ops.counts()
    assert after["mamba2_scan"] - before["mamba2_scan"] == 1
    assert after["mamba2_scan_bwd"] - before["mamba2_scan_bwd"] == \
        ms_mod.bwd_launches(ms_mod.bwd_passes((True,) * 3 + (False,) * 3))
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads)


# --- K4's backward, K4b (ROADMAP item 14e) ---------------------------------

# K4b against its plain version, each gradient relative to its largest
# magnitude: float32 sums in another order and the chunked form's
# exponentials of summed decays against the plain version's products
# (1e-4); ddt and da_log, sums of many such terms, 1e-3; bf16 dxh, db, dc
# rounded once (1e-2)
MAMBA_BWD_REL, MAMBA_BWD_DT_REL, MAMBA_BWD_BF16_REL = 1e-4, 1e-3, 1e-2
MAMBA_BWD_CHUNKS = [4, 16, 64, 100, 128]


def _mamba_bwd_bars(dtype):
    """The bars of (dxh, db, dc, ddt, da_log, dstate0)."""
    xbc = MAMBA_BWD_REL if dtype == torch.float32 else MAMBA_BWD_BF16_REL
    return (xbc, xbc, xbc, MAMBA_BWD_DT_REL, MAMBA_BWD_DT_REL, MAMBA_BWD_REL)


def _mamba_bwd_operands(rng, b, s, h, p, n, dtype, card, state0=False,
                        dstate=False, strong_decay=False):
    xh, bm, cm, dt, a_log = _mamba(rng, b, s, h, p, n, dtype, card)
    if strong_decay:      # |dt a| about 150 a step
        dt = torch.full((b, s, h), 20.0, device=card)
        a_log = torch.full((h,), 2.0, device=card)
    st0 = _randn(rng, (b, h, p, n), torch.float32, card) if state0 else None
    dy = _randn(rng, (b, s, h, p), torch.float32, card)
    dst = _randn(rng, (b, h, p, n), torch.float32, card) if dstate else None
    return (xh, bm, cm, dt, a_log, dy), dict(state0=st0, dstate=dst)


def _check_mamba_bwd(got, want, dtype, needs=(True,) * 6):
    for g, x, bar, need in zip(got, want, _mamba_bwd_bars(dtype), needs):
        if not need:
            assert g is None
            continue
        assert g.dtype == x.dtype and bool(torch.isfinite(g.float()).all())
        assert _rel(g, x) <= bar


@pytest.mark.parametrize("p,n", [(16, 8), (64, 64)])
@pytest.mark.parametrize("chunk", MAMBA_BWD_CHUNKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("state0,dstate", [(False, False), (True, False),
                                           (True, True)])
def test_mamba2_scan_bwd_kernel(card, p, n, chunk, dtype, state0, dstate):
    """K4b against its plain version over both (P, N) pairs, chunks from 4
    to 128 (sub-chunks of ``bwd_chunk``: 4, 16, 64, 50, 64), both input
    types, an initial state and a final state's cotangent."""
    from repro_torch.kernels import mamba2_scan as ms_mod
    rng = np.random.default_rng(71)
    s = chunk * max(2, 192 // chunk)
    args, kw = _mamba_bwd_operands(rng, 2, s, 3, p, n, dtype, card, state0,
                                   dstate)
    before = ops.mamba2_scan_bwd.launches
    got = ops.mamba2_scan_bwd(*args, chunk=chunk, **kw)
    torch.cuda.synchronize()
    assert ops.mamba2_scan_bwd.launches == before + ms_mod.bwd_launches(
        ms_mod.bwd_passes((True,) * 6))
    _check_mamba_bwd(got, ref.mamba2_scan_bwd_ref(*args, **kw), dtype)


@pytest.mark.parametrize("mask", range(64))
def test_mamba2_scan_bwd_kernel_needs(card, mask):
    """Every subset of the gradients (xh, b, c, dt, a_log, state0): K4b
    returns those asked for, launches ``bwd_launches(bwd_passes(needs))``
    kernels, and each gradient equals the whole call's plain version."""
    from repro_torch.kernels import mamba2_scan as ms_mod
    needs = tuple(bool(mask >> k & 1) for k in range(6))
    rng = np.random.default_rng(72)
    args, kw = _mamba_bwd_operands(rng, 2, 128, 9, 64, 64, torch.bfloat16,
                                   card, state0=True, dstate=True)
    before = ops.mamba2_scan_bwd.launches
    got = ops.mamba2_scan_bwd(*args, chunk=128, needs=needs, **kw)
    torch.cuda.synchronize()
    assert ops.mamba2_scan_bwd.launches - before == ms_mod.bwd_launches(
        ms_mod.bwd_passes(needs))
    _check_mamba_bwd(got, ref.mamba2_scan_bwd_ref(*args, **kw),
                     torch.bfloat16, needs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,n", [(16, 8), (64, 64)])
def test_mamba2_scan_bwd_kernel_strong_decay(card, dtype, p, n):
    """dt a = -150 a step over 256 steps, an initial state and a final
    state's cotangent: every exponent K4b forms is at most 0, so every
    gradient is finite and equals the plain version's."""
    rng = np.random.default_rng(73)
    args, kw = _mamba_bwd_operands(rng, 2, 256, 3, p, n, dtype, card,
                                   state0=True, dstate=True,
                                   strong_decay=True)
    got = ops.mamba2_scan_bwd(*args, chunk=128, **kw)
    _check_mamba_bwd(got, ref.mamba2_scan_bwd_ref(*args, **kw), dtype)


def test_mamba2_scan_bwd_kernel_long_scan(card):
    """zamba2's dims over 2048 steps (32 sub-chunks of 64) and 17 heads
    (three head groups, the last of one head), float32, with both ends:
    the chunk-end scan, the ordered sums over the groups and da_log over
    the chunks."""
    rng = np.random.default_rng(74)
    args, kw = _mamba_bwd_operands(rng, 1, 2048, 17, 64, 64, torch.float32,
                                   card, state0=True, dstate=True)
    got = ops.mamba2_scan_bwd(*args, chunk=128, **kw)
    _check_mamba_bwd(got, ref.mamba2_scan_bwd_ref(*args, **kw),
                     torch.float32)


@pytest.mark.parametrize("chunk", [4, 64, 100, 128])
@pytest.mark.parametrize("strong_decay", [False, True])
def test_mamba2_scan_bwd_mma_against_fma(card, chunk, strong_decay):
    """The same bf16-representable xh, b, c at zamba2's (P, N) = (64, 64)
    through the bf16 tensor-core per-chunk kernel and, as float32, through
    the FMA kernel, with an initial state and a final state's cotangent:
    every gradient within the bf16 bars of the other, which keeps the
    products on the tensor cores apart from the rounding to bf16."""
    rng = np.random.default_rng(78)
    s = chunk * max(2, 192 // chunk)
    (xh, bm, cm, dt, a_log, dy), kw = _mamba_bwd_operands(
        rng, 2, s, 9, 64, 64, torch.bfloat16, card, state0=True,
        dstate=True, strong_decay=strong_decay)
    tc = ops.mamba2_scan_bwd(xh, bm, cm, dt, a_log, dy, chunk=chunk, **kw)
    fma = ops.mamba2_scan_bwd(xh.float(), bm.float(), cm.float(), dt, a_log,
                              dy, chunk=chunk, **kw)
    for g, x, bar in zip(tc, fma, _mamba_bwd_bars(torch.bfloat16)):
        assert bool(torch.isfinite(g.float()).all())
        assert _rel(g.float(), x.float()) <= bar


def test_mamba2_scan_bwd_reads_conv_slices_uncopied(card, monkeypatch):
    """The model's operands: bf16 xh, b, c as column slices of one conv
    output (row stride H*P + 2N) reach K4b as they lie, no copy; two calls
    give the same bits, with a call of another shape in between, and each
    launches ``bwd_launches`` kernels."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import mamba2_scan as ms_mod
    rng = np.random.default_rng(75)
    b, s, h, p, n = 2, 512, 16, 64, 64
    fused = _randn(rng, (b, s, h * p + 2 * n), torch.bfloat16, card)
    xh = fused[..., :h * p].view(b, s, h, p)
    bm, cm = fused[..., h * p: h * p + n], fused[..., h * p + n:]
    (_, _, _, dt, a_log, dy), _ = _mamba_bwd_operands(
        rng, b, s, h, p, n, torch.bfloat16, card)
    seen = []
    operand = _build.kernel_operand

    def spying(x):
        out = operand(x)
        seen.append((x.data_ptr(), out.data_ptr()))
        return out

    monkeypatch.setattr(_build, "kernel_operand", spying)
    n0 = ops.mamba2_scan_bwd.launches
    g1 = ops.mamba2_scan_bwd(xh, bm, cm, dt, a_log, dy, chunk=128)
    assert ops.mamba2_scan_bwd.launches - n0 == ms_mod.bwd_launches(
        ms_mod.bwd_passes((True,) * 6))
    assert seen[:3] == [(t.data_ptr(),) * 2 for t in (xh, bm, cm)]
    other, kw = _mamba_bwd_operands(rng, 1, 80, 2, 16, 8, torch.bfloat16,
                                    card, state0=True, dstate=True)
    ops.mamba2_scan_bwd(*other, chunk=40, **kw)
    g2 = ops.mamba2_scan_bwd(xh, bm, cm, dt, a_log, dy, chunk=128)
    assert all(torch.equal(x, y) for x, y in zip(g1, g2) if x is not None)
    _check_mamba_bwd(g1[:5], ref.mamba2_scan_bwd_ref(
        xh, bm, cm, dt, a_log, dy)[:5], torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba2_scan_autograd_on_card(card, dtype, monkeypatch):
    """Under grad on the card ``mamba2_scan`` launches K4 once and K4b's
    kernels, never a plain version; the gradients, with an initial state
    and the final state used, equal those of the plain backward; a call
    whose only differentiable input is state0 launches the cotangents'
    pass alone (its two launches), one with dt alone no ordered sums."""
    from repro_torch.kernels import mamba2_scan as ms_mod
    rng = np.random.default_rng(76)
    args, kw = _mamba_bwd_operands(rng, 2, 256, 4, 64, 64, dtype, card,
                                   state0=True, dstate=True)
    xh, bm, cm, dt, a_log, dy = args
    leaves = [x.detach().clone().requires_grad_()
              for x in (xh, bm, cm, dt, a_log, kw["state0"])]
    with monkeypatch.context() as m:
        m.setattr(ms_mod, "mamba2_scan_ref", None)
        m.setattr(ms_mod, "mamba2_scan_bwd_ref", None)
        before = ops.counts()
        y, fin = ops.mamba2_scan(*leaves[:5], chunk=128, state0=leaves[5],
                                 out_dtype=torch.float32)
        grads = torch.autograd.grad([y, fin], leaves, [dy, kw["dstate"]])
        after = ops.counts()
        assert after["mamba2_scan"] - before["mamba2_scan"] == 1
        assert after["mamba2_scan_bwd"] - before["mamba2_scan_bwd"] == \
            ms_mod.bwd_launches(ms_mod.bwd_passes((True,) * 6))
        for needs, launches in ((5, 2), (3, 3)):
            xs = [x.detach() for x in leaves]
            xs[needs] = xs[needs].clone().requires_grad_()
            o, _ = ops.mamba2_scan(*xs[:5], chunk=128, state0=xs[5],
                                   out_dtype=torch.float32)
            n0 = ops.mamba2_scan_bwd.launches
            g, = torch.autograd.grad(o, [xs[needs]], dy)
            assert ops.mamba2_scan_bwd.launches - n0 == launches
            assert g.shape == xs[needs].shape
    _check_mamba_bwd(grads, ref.mamba2_scan_bwd_ref(*args, **kw), dtype)


def test_mamba2_ssd_prefill_gradient_on_card(card):
    """The model's call under grad, a sequence that is not a chunk
    multiple (the state-neutral padding): the gradients of xh, b, c, dt
    and a_log through K4 and K4b on the card equal autograd through the
    plain versions on the CPU."""
    from repro_torch.models import ssm as ssm_mod
    rng = np.random.default_rng(77)
    (xh, bm, cm, dt, a_log, dy), _ = _mamba_bwd_operands(
        rng, 2, 150, 3, 64, 64, torch.bfloat16, card)
    grads = []
    for dev in (card, torch.device("cpu")):
        xs = [x.detach().to(dev).requires_grad_()
              for x in (xh, bm, cm, dt, a_log)]
        y, _ = ssm_mod._ssd_prefill(*xs, 128, None)
        grads.append(torch.autograd.grad(y, xs, dy.to(dev)))
    for g, x, bar in zip(*grads, _mamba_bwd_bars(torch.bfloat16)):
        assert _rel(g, x.to(card)) <= bar


# --- K5's backward, K5b (ROADMAP item 14d) ---------------------------------

# K5b against its plain version, each gradient relative to its largest
# magnitude: float32 sums in another order, and the chunked form's
# exponentials of summed log decays against the plain version's products
# of decays (SCAN_BWD_REL); dw, a quotient by w, SCAN_BWD_DW_REL; bf16 dr,
# dk, dv rounded once (SCAN_BWD_BF16_REL)
SCAN_BWD_REL, SCAN_BWD_DW_REL, SCAN_BWD_BF16_REL = 1e-4, 1e-3, 1e-2


def _scan_bwd_bars(dtype):
    """The bars of (dr, dk, dv, dw, dbonus, dstate0)."""
    rkv = SCAN_BWD_REL if dtype == torch.float32 else SCAN_BWD_BF16_REL
    return (rkv, rkv, rkv, SCAN_BWD_DW_REL, SCAN_BWD_REL, SCAN_BWD_REL)


def _scan_bwd_operands(rng, b, s, h, d, dtype, card, strong_decay=False,
                       state0=False, dstate=False):
    r, k, v, w, bonus = _rwkv(rng, b, s, h, d, dtype, card, strong_decay)
    st0 = _randn(rng, (b, h, d, d), torch.float32, card) if state0 else None
    dout = _randn(rng, (b, s, h, d), torch.float32, card)
    dst = _randn(rng, (b, h, d, d), torch.float32, card) if dstate else None
    return (r, k, v, w, bonus, dout), dict(state0=st0, dstate=dst)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("chunk", [4, 16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("strong_decay", [False, True])
@pytest.mark.parametrize("state0,dstate", [(False, False), (True, False),
                                           (True, True)])
def test_rwkv6_scan_bwd_kernel(card, d, chunk, dtype, strong_decay, state0,
                               dstate):
    """K5b against its plain version over every head dim, chunks from the
    SMOKE config's 4 to 64, both input types, strong decay (w = 1e-6), an
    initial state and a final state's cotangent; a chunk whose per-chunk
    kernel does not fit in shared memory raises before any work."""
    from repro_torch.kernels import rwkv6_scan as rs_mod
    rng = np.random.default_rng(61)
    args, kw = _scan_bwd_operands(rng, 2, 128, 3, d, dtype, card,
                                  strong_decay, state0, dstate)
    before = ops.rwkv6_scan_bwd.launches
    if rs_mod.bwd_smem_bytes(d, chunk, dtype) > rs_mod.SMEM_LIMIT:
        with pytest.raises(ValueError, match="shared memory"):
            ops.rwkv6_scan_bwd(*args, chunk=chunk, **kw)
        assert ops.rwkv6_scan_bwd.launches == before
        return
    got = ops.rwkv6_scan_bwd(*args, chunk=chunk, **kw)
    torch.cuda.synchronize()
    assert ops.rwkv6_scan_bwd.launches == before + rs_mod.bwd_launches(
        rs_mod.bwd_passes((True,) * 6))
    want = ref.rwkv6_scan_bwd_ref(*args, **kw)
    for g, x, bar in zip(got, want, _scan_bwd_bars(dtype)):
        assert g.dtype == x.dtype and bool(torch.isfinite(g.float()).all())
        assert _rel(g, x) <= bar


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64])
def test_rwkv6_scan_bwd_kernel_long_scan(card, dtype, d):
    """A scan over 128 chunks (S 2048, chunk 16) under strong decay (w =
    1e-6) with an initial state and a final state's cotangent: the
    chunk-end states' and cotangents' elementwise scan against the plain
    version, dstate0 among the gradients."""
    rng = np.random.default_rng(65)
    args, kw = _scan_bwd_operands(rng, 1, 2048, 2, d, dtype, card,
                                  strong_decay=True, state0=True,
                                  dstate=True)
    got = ops.rwkv6_scan_bwd(*args, chunk=16, **kw)
    want = ref.rwkv6_scan_bwd_ref(*args, **kw)
    for g, x, bar in zip(got, want, _scan_bwd_bars(dtype)):
        assert g.dtype == x.dtype and bool(torch.isfinite(g.float()).all())
        assert _rel(g, x) <= bar


@pytest.mark.parametrize("d,chunk", [(64, 32), (16, 4), (128, 32), (32, 64)])
@pytest.mark.parametrize("strong_decay", [False, True])
def test_rwkv6_scan_bwd_mma_against_fma(card, d, chunk, strong_decay):
    """The same bf16-representable r, k, v through the bf16 tensor-core
    per-chunk kernel and, as float32, through the FMA kernel, with an
    initial state and a final state's cotangent: every gradient within the
    bf16 bars of the other, which keeps the new products apart from the
    rounding to bf16."""
    rng = np.random.default_rng(66)
    (r, k, v, w, bonus, dout), kw = _scan_bwd_operands(
        rng, 2, 192, 3, d, torch.bfloat16, card, strong_decay,
        state0=True, dstate=True)
    tc = ops.rwkv6_scan_bwd(r, k, v, w, bonus, dout, chunk=chunk, **kw)
    fma = ops.rwkv6_scan_bwd(r.float(), k.float(), v.float(), w, bonus,
                             dout, chunk=chunk, **kw)
    for g, x, bar in zip(tc, fma, _scan_bwd_bars(torch.bfloat16)):
        assert bool(torch.isfinite(g.float()).all())
        assert _rel(g.float(), x.float()) <= bar


def test_rwkv6_scan_bwd_kernel_repeats_bitwise(card):
    """rwkv6-3b's head dim and chunk over 1024 steps, strided bf16 views of
    one fused buffer: two calls give the same bits, with a call of another
    shape in between."""
    rng = np.random.default_rng(62)
    b, s, h, d = 2, 1024, 8, 64
    fused = _randn(rng, (b, s, 3, h, d), torch.bfloat16, card)
    (_, _, _, w, bonus, dout), _ = _scan_bwd_operands(
        rng, b, s, h, d, torch.bfloat16, card)
    r, k, v = (fused[:, :, i] for i in range(3))
    g1 = ops.rwkv6_scan_bwd(r, k, v, w, bonus, dout, chunk=32)
    other, kw = _scan_bwd_operands(rng, 1, 80, 2, 16, torch.bfloat16, card,
                                   state0=True, dstate=True)
    ops.rwkv6_scan_bwd(*other, chunk=40, **kw)
    g2 = ops.rwkv6_scan_bwd(r, k, v, w, bonus, dout, chunk=32)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    want = ref.rwkv6_scan_bwd_ref(r, k, v, w, bonus, dout)
    for g, x, bar in zip(g1, want, _scan_bwd_bars(torch.bfloat16)):
        if g is not None:
            assert _rel(g, x) <= bar


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_scan_autograd_on_card(card, dtype, monkeypatch):
    """Under grad on the card ``rwkv6_scan`` launches K5 once and K5b's
    four kernels (``bwd_launches``), never a plain version; the gradients,
    with an initial state and the final state used, equal those of the
    plain backward; a call whose only differentiable input is state0
    launches the cotangents' pass alone (its two launches), one without
    bonus no ordered sum."""
    from repro_torch.kernels import rwkv6_scan as rs_mod
    rng = np.random.default_rng(63)
    (r, k, v, w, bonus, dout), kw = _scan_bwd_operands(
        rng, 2, 96, 4, 64, dtype, card, state0=True, dstate=True)
    leaves = [x.detach().clone().requires_grad_()
              for x in (r, k, v, w, bonus, kw["state0"])]
    with monkeypatch.context() as m:
        m.setattr(rs_mod, "rwkv6_scan_ref", None)
        m.setattr(rs_mod, "rwkv6_scan_bwd_ref", None)
        before = ops.counts()
        out, fin = ops.rwkv6_scan(*leaves[:5], chunk=32, state0=leaves[5],
                                  out_dtype=torch.float32)
        grads = torch.autograd.grad([out, fin], leaves, [dout, kw["dstate"]])
        after = ops.counts()
        assert after["rwkv6_scan"] - before["rwkv6_scan"] == 1
        assert after["rwkv6_scan_bwd"] - before["rwkv6_scan_bwd"] == \
            rs_mod.bwd_launches(rs_mod.bwd_passes((True,) * 6))
        for needs, launches in ((5, 2), (0, 3)):
            xs = [x.detach() for x in leaves]
            xs[needs] = xs[needs].clone().requires_grad_()
            o, _ = ops.rwkv6_scan(*xs[:5], chunk=32, state0=xs[5],
                                  out_dtype=torch.float32)
            n0 = ops.rwkv6_scan_bwd.launches
            g, = torch.autograd.grad(o, [xs[needs]], dout)
            assert ops.rwkv6_scan_bwd.launches - n0 == launches
            assert g.shape == xs[needs].shape
    want = ref.rwkv6_scan_bwd_ref(r, k, v, w, bonus, dout, **kw)
    for g, x, bar in zip(grads, want, _scan_bwd_bars(dtype)):
        assert g.dtype == x.dtype
        assert _rel(g, x) <= bar


def test_rwkv6_wkv_prefill_gradient_on_card(card):
    """The model's call under grad, a sequence that is not a chunk multiple
    (the state-neutral padding, then the clamp): the gradients of r, k, v,
    w and bonus through K5 and K5b on the card equal autograd through the
    plain versions on the CPU."""
    from repro_torch.models import rwkv as rwkv_mod
    rng = np.random.default_rng(64)
    (r, k, v, w, bonus, dout), _ = _scan_bwd_operands(
        rng, 2, 50, 3, 64, torch.bfloat16, card)
    grads = []
    for dev in (card, torch.device("cpu")):
        xs = [x.detach().to(dev).requires_grad_()
              for x in (r, k, v, w, bonus)]
        y, _ = rwkv_mod._wkv_prefill(*xs, 16, None)
        grads.append(torch.autograd.grad(y, xs, dout.to(dev)))
    for g, x, bar in zip(*grads, _scan_bwd_bars(torch.bfloat16)):
        assert _rel(g, x.to(card)) <= bar


# --- K3's gradients (ROADMAP item 14a) -------------------------------------

# (B or None for [E, C, D], E, C, D, F): tiles of one wgmma, ragged C, D
# and F (the element-wise loaders), C of one, granite's training shapes
# (gate / up and down, microbatch 2 at capacity 1024), deepseek's 160
# experts of d 5120 / d_expert 1536 with few rows, 128-row tiles
GRAD_SWEEP = [(None, 4, 96, 160, 192), (2, 8, 40, 100, 70),
              (1, 3, 1, 7, 5), (None, 5, 1, 64, 128),
              (2, 40, 1024, 1536, 512), (2, 40, 1024, 512, 1536),
              (1, 160, 4, 5120, 1536), (2, 2, 300, 72, 136)]


def _grad_operands(rng, b, e, c, d, f, dtype, card):
    """x as the MoE layer hands it over (a view of a dispatch buffer whose
    dropped-token row is NaN), w [E, D, F] and dy [..., E, C, F]."""
    lead = (e, c) if b is None else (b, e, c)
    bb = 1 if b is None else b
    buf = _randn(rng, (bb, e * c + 1, d), dtype, card)
    buf[:, -1] = float("nan")
    x = buf[:, :-1].view(lead + (d,))
    w = _randn(rng, (e, d, f), dtype, card) * d ** -0.5
    dy = _randn(rng, lead + (f,), dtype, card)
    return x, w, dy


@pytest.mark.parametrize("shape", GRAD_SWEEP)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gemm_dx_kernel(card, shape, dtype):
    """K3's input gradient (K3's kernel reading w K-major in bf16, the FMA
    kernel through w's transposed strides in float32) against its plain
    version, relative to the largest output."""
    from repro_torch.kernels import moe_gemm as mg_mod
    b, e, c, d, f = shape
    _, w, dy = _grad_operands(np.random.default_rng(50), b, e, c, d, f,
                              dtype, card)
    tma = 0
    if dtype == torch.bfloat16:
        dy4 = dy if b else dy.unsqueeze(0)
        plan = mg_mod.gemm_plan(b or 1, e, c, f, d, dy4.stride(), w.stride(),
                                dy4.data_ptr(), w.data_ptr(), kmajor=True)
        assert plan.kmajor and plan.vector == (f % 8 == 0)
        grad = mg_mod.grad_plan("dx", b or 1, e, c, d, f, dy4.shape,
                                dy4.stride(), dy4.data_ptr(), w.shape,
                                w.stride(), w.data_ptr(), 132)
        assert grad.route == ("tma" if d % 8 == 0 and f % 8 == 0
                              else "cp_async")
        tma = int(grad.route == "tma")
    counts = ops.counts()
    got = ops.moe_gemm_dx(dy, w)
    torch.cuda.synchronize()
    after = ops.counts()
    assert after["moe_gemm_dx"] == counts["moe_gemm_dx"] + 1
    # the persistent kernel's launches are counted apart as well
    assert after["moe_gemm_dx_tma"] == counts["moe_gemm_dx_tma"] + tma
    own = ("moe_gemm_dx", "moe_gemm_dx_tma")
    assert {k: n for k, n in after.items() if k not in own} == \
        {k: n for k, n in counts.items() if k not in own}
    want = ref.moe_gemm_dx_ref(dy, w)
    assert got.shape == want.shape and got.dtype == dtype
    assert bool(torch.isfinite(got.float()).all())
    assert _rel(got, want) < MOE_TOL[dtype]


@pytest.mark.parametrize("shape", GRAD_SWEEP)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gemm_dw_kernel(card, shape, dtype):
    """K3's weight gradient (wgmma in bf16, FMA in float32) against its
    plain version on the dispatch view, never reading its NaN row."""
    b, e, c, d, f = shape
    x, w, dy = _grad_operands(np.random.default_rng(51), b, e, c, d, f,
                              dtype, card)
    before = ops.moe_gemm_dw.launches
    got = ops.moe_gemm_dw(x, dy)
    torch.cuda.synchronize()
    assert ops.moe_gemm_dw.launches == before + 1
    want = ref.moe_gemm_dw_ref(x, dy)
    assert got.shape == w.shape and got.dtype == dtype
    assert bool(torch.isfinite(got.float()).all())
    assert _rel(got, want) < MOE_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gemm_gradients_on_strided_operands(card, dtype):
    """A transposed weight view (dX's element-wise loader) and a column
    slice of dy (dW's)."""
    rng = np.random.default_rng(52)
    x = _randn(rng, (3, 5, 24, 72), dtype, card)
    w = _randn(rng, (5, 40, 72), dtype, card).transpose(1, 2)
    dy = _randn(rng, (3, 5, 24, 48), dtype, card)[..., :40]
    assert _rel(ops.moe_gemm_dx(dy, w), ref.moe_gemm_dx_ref(dy, w)) < \
        MOE_TOL[dtype]
    assert _rel(ops.moe_gemm_dw(x, dy), ref.moe_gemm_dw_ref(x, dy)) < \
        MOE_TOL[dtype]


@pytest.mark.parametrize("shape", GRAD_SWEEP[:3] + GRAD_SWEEP[4:6])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gemm_gradients_repeat_bitwise(card, shape, dtype):
    """Both kernels sum in a fixed order: two calls, the same bits."""
    b, e, c, d, f = shape
    x, w, dy = _grad_operands(np.random.default_rng(53), b, e, c, d, f,
                              dtype, card)
    assert torch.equal(ops.moe_gemm_dx(dy, w), ops.moe_gemm_dx(dy, w))
    assert torch.equal(ops.moe_gemm_dw(x, dy), ops.moe_gemm_dw(x, dy))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gemm_autograd_on_card(card, dtype, monkeypatch):
    """Under grad on the card ``moe_gemm`` launches its forward kernel and
    its dX and dW kernels once each, never a plain version; the gradients
    equal autograd through the plain version."""
    from repro_torch.kernels import moe_gemm as mg_mod
    rng = np.random.default_rng(54)
    x0, w0, dy = _grad_operands(rng, 2, 8, 40, 64, 96, dtype, card)
    x = x0.detach().clone().requires_grad_()
    w = w0.detach().clone().requires_grad_()
    names = ("moe_gemm", "moe_gemm_dx", "moe_gemm_dw")
    with monkeypatch.context() as m:
        for name in names:
            m.setattr(mg_mod, name + "_ref", None)
        before = ops.counts()
        ops.moe_gemm(x, w).backward(dy)
        after = ops.counts()
    assert {k: after[k] - before[k] for k in names} == dict.fromkeys(names, 1)
    xp = x0.detach().clone().requires_grad_()
    wp = w0.detach().clone().requires_grad_()
    ref.moe_gemm_ref(xp, wp).backward(dy)
    assert _rel(x.grad, xp.grad) < MOE_TOL[dtype]
    assert _rel(w.grad, wp.grad) < MOE_TOL[dtype]


# --- K3's gradients on the persistent kernel (csrc/moe_gemm_grad.cu) --------

# (B, E, C, D, F): C of 1, 63, 64, 100 and 1024 (row tiles and dW's stages
# ending inside a sample), D and F among 64, 128, 200, 512 and 1536 (column
# tiles clipped at the edge), E of 1, 3 and 40, B of 1 and 2; granite's
# training shapes among them
TMA_SWEEP = [(1, 1, 1, 64, 64), (2, 3, 63, 200, 128), (1, 3, 64, 128, 200),
             (2, 3, 100, 512, 64), (2, 40, 1024, 1536, 512),
             (2, 40, 1024, 512, 1536), (1, 40, 100, 200, 1536),
             (2, 1, 1024, 64, 200), (1, 3, 63, 1536, 64),
             (2, 1, 64, 200, 512), (1, 40, 1, 128, 128),
             (2, 3, 1, 1536, 200), (1, 1, 100, 64, 1536),
             (2, 40, 63, 64, 64), (1, 3, 1024, 128, 512)]


def _first_design(monkeypatch, mg_mod):
    """Send every bf16 gradient call to the first design (the route the plan
    keeps for operands a tensor map cannot take)."""
    real = mg_mod.grad_plan
    monkeypatch.setattr(mg_mod, "grad_plan", lambda *a: dataclasses.replace(
        real(*a), route="cp_async"))


def _tma_calls(kind, a, b):
    """One call of ``moe_gemm_<kind>`` that must take the persistent
    kernel, its output."""
    fn = getattr(ops, "moe_gemm_" + kind)
    before = (fn.launches, fn.tma_launches)
    out = fn(a, b)
    torch.cuda.synchronize()
    assert (fn.launches, fn.tma_launches) == (before[0] + 1, before[1] + 1)
    return out


@pytest.mark.parametrize("shape", TMA_SWEEP)
@pytest.mark.parametrize("kind", ["dx", "dw"])
def test_moe_gemm_grad_persistent_kernel(card, kind, shape, monkeypatch,
                                         record_property):
    """The persistent kernel against the plain version (``MOE_TOL``, x the
    dispatch view with its NaN row), twice for the same bits, and against
    the first design within ``MOE_TOL``; whether the two designs agree
    bitwise is recorded (they sum the same k16 groups in the same order
    except where dW's stages of the first design cross a sample)."""
    from repro_torch.kernels import moe_gemm as mg_mod
    b, e, c, d, f = shape
    x, w, dy = _grad_operands(np.random.default_rng(60), b, e, c, d, f,
                              torch.bfloat16, card)
    a, bb = (dy, w) if kind == "dx" else (x, dy)
    got = _tma_calls(kind, a, bb)
    want = getattr(ref, f"moe_gemm_{kind}_ref")(a, bb)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.float()).all())
    assert _rel(got, want) < MOE_TOL[torch.bfloat16]
    assert torch.equal(got, _tma_calls(kind, a, bb))
    with monkeypatch.context() as m:
        _first_design(m, mg_mod)
        fn = getattr(ops, "moe_gemm_" + kind)
        n = fn.tma_launches
        first = fn(a, bb)
        assert fn.tma_launches == n
    assert _rel(got, first) < MOE_TOL[torch.bfloat16]
    record_property("first_design_bitwise", bool(torch.equal(got, first)))


@pytest.mark.parametrize("grid", [1, 3])
@pytest.mark.parametrize("shape", [(2, 3, 100, 200, 64),
                                   (1, 3, 300, 1536, 264),
                                   (2, 5, 1024, 512, 1536)])
def test_moe_gemm_grad_small_grid(card, shape, grid, monkeypatch):
    """The grid forced down to 1 and 3 blocks through the plan (its SM
    count), so that each block walks many tiles and the ring's mbarrier
    phases run on across them: the same bits as one block per SM."""
    from repro_torch.kernels import moe_gemm as mg_mod
    b, e, c, d, f = shape
    x, w, dy = _grad_operands(np.random.default_rng(61), b, e, c, d, f,
                              torch.bfloat16, card)
    full = [_tma_calls("dx", dy, w), _tma_calls("dw", x, dy)]
    monkeypatch.setattr(mg_mod, "_sm_count", lambda index: grid)
    plan = mg_mod.grad_plan("dw", b, e, c, d, f, x.shape, x.stride(),
                            x.data_ptr(), dy.shape, dy.stride(),
                            dy.data_ptr(), mg_mod._sm_count(0))
    assert plan.grid == grid and plan.tiles >= 2 * grid
    small = [_tma_calls("dx", dy, w), _tma_calls("dw", x, dy)]
    assert all(torch.equal(p, q) for p, q in zip(full, small))
    assert _rel(small[1], ref.moe_gemm_dw_ref(x, dy)) < \
        MOE_TOL[torch.bfloat16]


def test_moe_gemm_grad_routes(card):
    """An odd width or a transposed weight takes the first design; the
    aligned call beside it the persistent kernel."""
    rng = np.random.default_rng(62)
    x, w, dy = _grad_operands(rng, 2, 3, 40, 72, 100, torch.bfloat16, card)
    n = (ops.moe_gemm_dx.tma_launches, ops.moe_gemm_dw.tma_launches)
    ops.moe_gemm_dx(dy, w)                       # F = 100: not 8 | F
    ops.moe_gemm_dw(x, dy)
    assert (ops.moe_gemm_dx.tma_launches,
            ops.moe_gemm_dw.tma_launches) == n
    wt = _randn(rng, (3, 64, 72), torch.bfloat16, card).transpose(1, 2)
    dy2 = _randn(rng, (2, 3, 40, 64), torch.bfloat16, card)
    got = ops.moe_gemm_dx(dy2, wt)               # w's last stride not 1
    assert ops.moe_gemm_dx.tma_launches == n[0]
    assert _rel(got, ref.moe_gemm_dx_ref(dy2, wt)) < MOE_TOL[torch.bfloat16]
    _tma_calls("dw", x[..., :64].contiguous(), dy2)


def _granite_smoke_grads(card, remat=False, dtype="bfloat16"):
    """SMOKE granite's ``grads_of`` on one microbatch on the card (through
    ``make_train_step``'s own function), from seeded float32 masters."""
    from repro_torch.configs.archs import SMOKE
    from repro_torch.launch import steps
    from repro_torch.training.data import DataConfig, SyntheticTokens
    from repro_torch.training.tree import (tree_leaves, tree_map,
                                           tree_unflatten)
    cfg = dataclasses.replace(SMOKE["granite-moe-3b-a800m"], remat=remat,
                              dtype=dtype)
    _, model = steps.make_train_step(cfg, dp_size=1, global_batch=2,
                                     device=card)
    params = tree_map(lambda p: p.float(), model.init(
        torch.Generator(device=card).manual_seed(0)))
    batch = SyntheticTokens(DataConfig(cfg.vocab_size, 64, 2)).batch_at(
        0, device=card)
    dt = getattr(torch, dtype)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    cast = tree_map(lambda p: p.to(dt) if p.dim() > 1 else p,
                    tree_unflatten(params, leaves))
    loss = model.train_loss(cast, batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def test_granite_smoke_gradients_repeat_bitwise(card):
    """Two gradient calls of SMOKE granite in bf16 on one microbatch give
    the same bits: K3's kernels, the dispatch's gather by a permutation and
    the combine's gather sum in fixed orders."""
    before = ops.counts()
    a = _granite_smoke_grads(card)
    b = _granite_smoke_grads(card)
    after = ops.counts()
    assert after["moe_gemm_dx"] > before["moe_gemm_dx"]
    assert after["moe_gemm_dw"] > before["moe_gemm_dw"]
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))


def test_granite_smoke_remat_equals_no_remat_bitwise(card):
    """Remat recomputes each block in the backward, the router's top-k
    among it: it must choose the same experts, so the gradients are the
    no-remat run's bit for bit."""
    a = _granite_smoke_grads(card, remat=False)
    b = _granite_smoke_grads(card, remat=True)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel_granite_groups(card, dtype):
    """K1's backward at granite's G = 3, D = 64 (24 heads over 8), causal,
    against its plain version and repeated bit for bit."""
    rng = np.random.default_rng(55)
    q = _randn(rng, (1, 320, 24, 64), dtype, card)
    k = _randn(rng, (1, 320, 8, 64), dtype, card)
    v = _randn(rng, (1, 320, 8, 64), dtype, card)
    do = _randn(rng, (1, 320, 24, 64), dtype, card)
    o, lse = flash_attention_fwd(q, k, v, causal=True, return_lse=True)
    got = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=True)
    again = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=True)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=True)
    assert max(_rel_err(a, b) for a, b in zip(got, want)) < BWD_TOL[dtype]
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("window", [1024, 0])
def test_flash_attention_bwd_gemma3_training_shape(card, window):
    """K1's backward at gemma3-4b's training shape in bf16 (q [2, 4096, 8,
    256], k, v [2, 4096, 4, 256], causal; the column-split kernel): a local
    layer (window 1024) and a global one, against the plain version and
    repeated bit for bit."""
    rng = np.random.default_rng(56)
    args = _bwd_case(rng, (2, 4096, 4096, 8, 4), 256, torch.bfloat16, True,
                     window, card)
    got = ops.flash_attention_bwd(*args, causal=True, window=window)
    again = ops.flash_attention_bwd(*args, causal=True, window=window)
    want = ref.flash_attention_bwd_ref(*args, causal=True, window=window)
    errs = [_rel_err(a, b) for a, b in zip(got, want)]
    assert max(errs) < BWD_TOL[torch.bfloat16], errs
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# whisper-small's three training forms (12 heads of 64, G = 1, microbatch
# 2): (Sq, Sk, causal) of the encoder over its 1500 frames, the decoder's
# causal self-attention over train_4k's 4096 tokens, its cross-attention
WHISPER_BWD = {"encoder": (1500, 1500, False), "decoder": (4096, 4096, True),
               "cross": (4096, 1500, False)}


@pytest.mark.parametrize("kind", list(WHISPER_BWD))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_bwd_whisper_training_shapes(card, kind, dtype):
    """K1's backward at whisper-small's training shapes (q [2, Sq, 12, 64]
    over k, v [2, Sk, 12, 64]; the wgmma kernel at D = 64 in bf16): the
    encoder's bidirectional form, the decoder's causal one and the cross-
    attention with Sq != Sk, against the plain version and repeated bit
    for bit."""
    sq, sk, causal = WHISPER_BWD[kind]
    rng = np.random.default_rng(58)
    args = _bwd_case(rng, (2, sq, sk, 12, 12), 64, dtype, causal, 0, card)
    got = ops.flash_attention_bwd(*args, causal=causal)
    again = ops.flash_attention_bwd(*args, causal=causal)
    want = ref.flash_attention_bwd_ref(*args, causal=causal)
    errs = [_rel_err(a, b) for a, b in zip(got, want)]
    assert max(errs) < BWD_TOL[dtype], errs
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _whisper_smoke_grads(card, remat=False, dtype="bfloat16"):
    """SMOKE whisper (2 encoder and 2 decoder layers, head dim 16, 12
    frames) over 256 tokens and chip_smoke's seeded frames: one
    microbatch's loss and gradients on the card from seeded float32
    masters, as ``make_train_step`` takes them."""
    import chip_smoke
    from repro_torch.configs.archs import SMOKE
    from repro_torch.launch import steps
    from repro_torch.training.tree import (tree_leaves, tree_map,
                                           tree_unflatten)
    cfg = dataclasses.replace(SMOKE["whisper-small"], remat=remat,
                              dtype=dtype)
    _, model = steps.make_train_step(cfg, dp_size=1, global_batch=2,
                                     device=card)
    params = tree_map(lambda p: p.float(), model.init(
        torch.Generator(device=card).manual_seed(0)))
    batch = chip_smoke.train_data(cfg, 256, 2, seed=0).batch_at(
        0, device=card)
    dt = getattr(torch, dtype)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    cast = tree_map(lambda p: p.to(dt) if p.dim() > 1 else p,
                    tree_unflatten(params, leaves))
    loss = model.train_loss(cast, batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def test_whisper_smoke_gradients_repeat_bitwise(card, monkeypatch):
    """SMOKE whisper with its frames: in float32 the kernels' loss and
    gradients against autograd through K1's plain version (1e-5 relative
    on the loss, 1e-3 of each leaf's largest magnitude, chip_smoke's
    float32 training bars), one K1 backward per attention call (2 encoder,
    2 decoder self, 2 cross); in bf16 two calls give the same bits, and
    remat gives the bits of no remat."""
    before = ops.counts()
    loss, grads = _whisper_smoke_grads(card, dtype="float32")
    assert ops.counts()["flash_attention_bwd"] - \
        before["flash_attention_bwd"] == 6
    with monkeypatch.context() as m:
        m.setattr(ops, "flash_attention", ref.flash_attention_ref)
        ploss, pgrads = _whisper_smoke_grads(card, dtype="float32")
    assert abs(float(loss) - float(ploss)) <= 1e-5 * abs(float(ploss))
    assert max(_rel_err(a, b) for a, b in zip(grads, pgrads)) < 1e-3
    a = _whisper_smoke_grads(card)
    b = _whisper_smoke_grads(card)
    c = _whisper_smoke_grads(card, remat=True)
    for x in (b, c):
        assert torch.equal(a[0], x[0])
        assert all(torch.equal(g, h) for g, h in zip(a[1], x[1]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_bwd_deepseek_training_shape(card, dtype):
    """K1's backward at deepseek-v2's training shape (q, k [2, 4096, 128,
    192], v [2, 4096, 128, 128], causal, G = 1: the kv-split kernel in
    bf16) against the plain version 16 heads at a time (with G = 1 a
    head's gradients depend on its own head alone, so the slices together
    are the whole check; the whole plain backward would need about 70 GB),
    and repeated bit for bit; in float32 on 8 of the heads."""
    rng = np.random.default_rng(57)
    heads = 128 if dtype == torch.bfloat16 else 8
    args = _bwd_case(rng, (2, 4096, 4096, heads, heads), 192, dtype, True,
                     0, card, 128)
    got = ops.flash_attention_bwd(*args, causal=True)
    again = ops.flash_attention_bwd(*args, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    q, k, v, o, do, lse = args
    errs = []
    for h0 in range(0, heads, 16):
        sl = slice(h0, h0 + 16)
        want = ref.flash_attention_bwd_ref(
            q[:, :, sl], k[:, :, sl], v[:, :, sl], o[:, :, sl], do[:, :, sl],
            lse[:, sl], causal=True)
        errs.append(max(_rel_err(a[:, :, sl], b) for a, b in zip(got, want)))
        del want
    assert max(errs) < BWD_TOL[dtype], errs


def _deepseek_smoke_grads(card, remat=False, dtype="bfloat16"):
    """SMOKE deepseek (one dense layer, two MoE layers of 4 experts) at its
    published latent attention's head dims (query / key 128 + 64, value
    128) over 256 tokens: one microbatch's loss and gradients on the card
    from seeded float32 masters, as ``make_train_step`` takes them."""
    from repro_torch.configs.archs import ARCHS, SMOKE
    from repro_torch.launch import steps
    from repro_torch.training.data import DataConfig, SyntheticTokens
    from repro_torch.training.tree import (tree_leaves, tree_map,
                                           tree_unflatten)
    ml = ARCHS["deepseek-v2-236b"].mla
    cfg = dataclasses.replace(SMOKE["deepseek-v2-236b"], remat=remat,
                              dtype=dtype, mla=dataclasses.replace(
                                  SMOKE["deepseek-v2-236b"].mla,
                                  qk_nope_head_dim=ml.qk_nope_head_dim,
                                  qk_rope_head_dim=ml.qk_rope_head_dim,
                                  v_head_dim=ml.v_head_dim))
    _, model = steps.make_train_step(cfg, dp_size=1, global_batch=2,
                                     device=card)
    params = tree_map(lambda p: p.float(), model.init(
        torch.Generator(device=card).manual_seed(0)))
    batch = SyntheticTokens(DataConfig(cfg.vocab_size, 256, 2)).batch_at(
        0, device=card)
    dt = getattr(torch, dtype)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    cast = tree_map(lambda p: p.to(dt) if p.dim() > 1 else p,
                    tree_unflatten(params, leaves))
    loss = model.train_loss(cast, batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def test_deepseek_smoke_gradients_at_published_head_dims(card, monkeypatch):
    """SMOKE deepseek at (D, Dv) = (192, 128): in float32 the kernels' loss
    and gradients against autograd through K1's plain version with the
    routing of the kernel run (1e-5 relative on the loss, 1e-3 of each
    leaf's largest magnitude, chip_smoke's float32 training bars), one K1
    backward a layer; in bf16 two calls give the same bits, and remat gives
    the bits of no remat."""
    import chip_smoke
    from repro_torch.models import moe as moe_mod
    log = []
    before = ops.counts()
    with chip_smoke.held_routing(moe_mod, log):
        loss, grads = _deepseek_smoke_grads(card, dtype="float32")
    assert ops.counts()["flash_attention_bwd"] - \
        before["flash_attention_bwd"] == 3
    stats = {"decisions": 0, "flipped": 0}
    with monkeypatch.context() as m, \
            chip_smoke.held_routing(moe_mod, log, stats):
        m.setattr(ops, "flash_attention", ref.flash_attention_ref)
        ploss, pgrads = _deepseek_smoke_grads(card, dtype="float32")
    assert abs(float(loss) - float(ploss)) <= 1e-5 * abs(float(ploss))
    assert max(_rel_err(a, b) for a, b in zip(grads, pgrads)) < 1e-3
    a = _deepseek_smoke_grads(card)
    b = _deepseek_smoke_grads(card)
    c = _deepseek_smoke_grads(card, remat=True)
    for x in (b, c):
        assert torch.equal(a[0], x[0])
        assert all(torch.equal(g, h) for g, h in zip(a[1], x[1]))


def _gemma3_smoke_grads(card, remat=False, dtype="bfloat16"):
    """SMOKE gemma3 at head dim 256 with a window of 64 over 256 tokens (5
    local layers, 2 global): one microbatch's loss and gradients on the
    card from seeded float32 masters, as ``make_train_step`` takes them."""
    from repro_torch.configs.archs import SMOKE
    from repro_torch.launch import steps
    from repro_torch.training.data import DataConfig, SyntheticTokens
    from repro_torch.training.tree import (tree_leaves, tree_map,
                                           tree_unflatten)
    cfg = dataclasses.replace(SMOKE["gemma3-4b"], head_dim=256,
                              sliding_window=64, remat=remat, dtype=dtype)
    _, model = steps.make_train_step(cfg, dp_size=1, global_batch=2,
                                     device=card)
    params = tree_map(lambda p: p.float(), model.init(
        torch.Generator(device=card).manual_seed(0)))
    batch = SyntheticTokens(DataConfig(cfg.vocab_size, 256, 2)).batch_at(
        0, device=card)
    dt = getattr(torch, dtype)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    cast = tree_map(lambda p: p.to(dt) if p.dim() > 1 else p,
                    tree_unflatten(params, leaves))
    loss = model.train_loss(cast, batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def test_gemma3_smoke_gradients_at_head_dim_256(card, monkeypatch):
    """SMOKE gemma3 at head dim 256 under its window: in float32 the
    kernels' loss and gradients against autograd through K1's plain
    version (1e-5 relative on the loss, 1e-3 of each leaf's largest
    magnitude, chip_smoke's float32 training bars), one K1 backward a
    layer; in bf16 two calls give the same bits, and remat gives the bits
    of no remat."""
    before = ops.counts()
    loss, grads = _gemma3_smoke_grads(card, dtype="float32")
    assert ops.counts()["flash_attention_bwd"] - \
        before["flash_attention_bwd"] == 7
    with monkeypatch.context() as m:
        m.setattr(ops, "flash_attention", ref.flash_attention_ref)
        ploss, pgrads = _gemma3_smoke_grads(card, dtype="float32")
    assert abs(float(loss) - float(ploss)) <= 1e-5 * abs(float(ploss))
    assert max(_rel_err(a, b) for a, b in zip(grads, pgrads)) < 1e-3
    a = _gemma3_smoke_grads(card)
    b = _gemma3_smoke_grads(card)
    c = _gemma3_smoke_grads(card, remat=True)
    for x in (b, c):
        assert torch.equal(a[0], x[0])
        assert all(torch.equal(g, h) for g, h in zip(a[1], x[1]))


# --- the train step as one captured CUDA graph (training/graphs.py) ---------

TRAIN_GRAPH_ARCHS = ["qwen3-1.7b", "granite-moe-3b-a800m", "gemma3-4b",
                     "deepseek-v2-236b", "rwkv6-3b", "zamba2-2.7b",
                     "whisper-small"]


def _train_graph_setup(arch, remat=True):
    """The Trainer drill's config of ``arch`` (``chip_smoke.drill_cfg``:
    SMOKE, gemma3 at head dim 256 under a window of 128, deepseek at its
    published latent attention's head dims), bf16 over float32 masters,
    ``make_train_step`` over 4 sequences of 512 tokens in two
    microbatches, its stream (with frames for whisper), and a function
    that makes the seeded masters and their AdamW state."""
    import chip_smoke
    from repro_torch.launch import steps
    from repro_torch.training import optimizer as opt
    cfg = dataclasses.replace(chip_smoke.drill_cfg(arch), remat=remat)
    step, model = steps.make_train_step(
        cfg, dp_size=1, global_batch=4,
        opt_cfg=opt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=50),
        device="cuda")
    data = chip_smoke.train_data(cfg, 512, 4, seed=0)

    def fresh():
        params = chip_smoke.master_params(model, 0)
        return params, opt.init_state(params)

    return step, data, fresh


def _leaves(params, state):
    from repro_torch.training.tree import tree_leaves
    return tree_leaves({"params": params, "opt": state})


def _count_delta(before):
    after = ops.counts()
    return {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("arch", TRAIN_GRAPH_ARCHS)
@pytest.mark.parametrize("remat", [True, False])
def test_train_graph_replays_equal_eager_steps(card, arch, remat):
    """Three eager steps against the captured step's three calls (the
    eager step and the capture, then two replays) from the same seeded
    state: every loss and the final parameters and state bitwise equal,
    the returned trees the statics at every call, and the launch counts
    (K1b's windowed calls and K3's gradients' persistent launches among
    them) those of the eager steps."""
    from repro_torch.training.graphs import CapturedTrainStep
    step, data, fresh = _train_graph_setup(arch, remat)
    params, state = fresh()
    before = ops.counts()
    want = []
    for t in range(3):
        loss, params, state = step(params, state, data.batch_at(t))
        want.append(loss)
    eager_counts = _count_delta(before)
    eager_state = _leaves(params, state)
    graphed = CapturedTrainStep(step)
    params, state = fresh()
    statics = _leaves(params, state)
    before = ops.counts()
    for t in range(3):
        loss, params, state = graphed(params, state, data.batch_at(t))
        assert torch.equal(loss, want[t]), t
        assert all(a is b for a, b in zip(_leaves(params, state), statics))
    assert _count_delta(before) == eager_counts
    assert (graphed.eager_steps, graphed.captures, graphed.replays) == \
        (1, 1, 2)
    assert all(torch.equal(a, b) for a, b in zip(statics, eager_state))


@pytest.mark.parametrize("arch", TRAIN_GRAPH_ARCHS)
def test_train_graph_replays_repeat_bitwise(card, arch):
    """Two replays from the same state (copied into the statics from a
    saved tree, the path after ``Trainer.try_restore``) on the same batch
    give the same loss and state bit for bit, and each adds the capture's
    launch counts."""
    from repro_torch.training.graphs import CapturedTrainStep
    from repro_torch.training.tree import tree_map
    step, data, fresh = _train_graph_setup(arch)
    graphed = CapturedTrainStep(step)
    params, state = fresh()
    graphed(params, state, data.batch_at(0))
    saved = tree_map(torch.clone, {"params": graphed.params,
                                   "opt": graphed.opt_state})
    (slot,) = graphed.slots.values()
    runs = []
    for _ in range(2):
        before = ops.counts()
        loss, params, state = graphed(saved["params"], saved["opt"],
                                      data.batch_at(1))
        assert _count_delta(before) == slot.counts
        runs.append([loss] + [x.clone() for x in _leaves(params, state)])
    assert graphed.replays == 2
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert any(n for n in slot.counts.values())


def test_train_graph_new_batch_shape_takes_its_own_capture(card):
    """A batch of another shape is captured once more into the same pool,
    with the same statics; both graphs then replay."""
    import chip_smoke
    from repro_torch.training.graphs import CapturedTrainStep
    step, data, fresh = _train_graph_setup("qwen3-1.7b")
    short = chip_smoke.train_data(chip_smoke.drill_cfg("qwen3-1.7b"), 256,
                                  4, seed=0)
    graphed = CapturedTrainStep(step)
    params, state = fresh()
    for batch in (data.batch_at(0), short.batch_at(1), data.batch_at(2),
                  short.batch_at(3)):
        loss, params, state = graphed(params, state, batch)
        assert torch.isfinite(loss)
    assert len(graphed.slots) == 2
    assert (graphed.eager_steps, graphed.captures, graphed.replays) == \
        (2, 2, 2)


def test_train_graph_under_expandable_segments(card):
    """The allocator with expandable segments, as the gemma3, rwkv6 and
    zamba2 train phases run: the captured step equals the eager one bit
    for bit there too."""
    import chip_smoke
    from repro_torch.training.graphs import CapturedTrainStep
    with chip_smoke.expandable_segments():
        step, data, fresh = _train_graph_setup("zamba2-2.7b")
        params, state = fresh()
        want = []
        for t in range(3):
            loss, params, state = step(params, state, data.batch_at(t))
            want.append(loss)
        eager_state = _leaves(params, state)
        graphed = CapturedTrainStep(step)
        params, state = fresh()
        for t in range(3):
            loss, params, state = graphed(params, state, data.batch_at(t))
            assert torch.equal(loss, want[t]), t
        assert graphed.replays == 2
        assert all(torch.equal(a, b) for a, b in
                   zip(_leaves(params, state), eager_state))
        del graphed


def test_train_graph_capture_of_a_host_read_raises(card):
    """A step that reads a CUDA value on the host cannot be captured: the
    call raises after its eager step, no graph is kept, the launch counts
    hold the eager step's alone, and the next call raises again (no eager
    path takes over)."""
    from repro_torch.training.graphs import CapturedTrainStep
    step, data, fresh = _train_graph_setup("qwen3-1.7b")

    def reading(params, state, batch):
        loss, params, state = step(params, state, batch)
        float(loss)
        return loss, params, state

    params, state = fresh()
    before = ops.counts()
    step(params, state, data.batch_at(0))
    one_step = _count_delta(before)
    graphed = CapturedTrainStep(reading)
    before = ops.counts()
    with pytest.raises(RuntimeError):
        graphed(params, state, data.batch_at(0))
    torch.cuda.synchronize()
    assert _count_delta(before) == one_step
    (slot,) = graphed.slots.values()
    assert slot.graph is None and graphed.captures == 0
    with pytest.raises(RuntimeError):
        graphed(params, state, data.batch_at(1))
    torch.cuda.synchronize()
    assert graphed.replays == 0
