"""The hand-written CUDA kernels under pytest, on a machine with an NVIDIA
GPU and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test here carries the ``cuda`` marker and skips (from inside a
fixture, never at import) where there is no card; ``chip_smoke.py`` makes
the same comparisons without pytest.  Tolerances are those of
``tests/test_kernels.py``.
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
