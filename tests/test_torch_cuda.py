"""The hand-written CUDA kernels under pytest, on a machine with an NVIDIA
GPU and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test here carries the ``cuda`` marker and skips (from inside a
fixture, never at import) where there is no card; ``chip_smoke.py`` makes
the same comparisons without pytest.  Tolerances are those of
``tests/test_kernels.py``: attention 2e-5 / 2e-2 absolute, the grouped
GEMM 1e-5 / 3e-2 relative to the largest output, the RWKV6 scan 5e-4
absolute in float32 (1e-2 relative for bfloat16 outputs, one rounding).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

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
                                     (40, 8, 1536, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gemm_kernel(card, e, c, d, f, dtype):
    rng = np.random.default_rng(7)
    x = _randn(rng, (e, c, d), dtype, card)
    w = _randn(rng, (e, d, f), dtype, card)
    before = ops.moe_gemm.launches
    out = ops.moe_gemm(x, w)
    torch.cuda.synchronize()
    assert ops.moe_gemm.launches == before + 1
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
