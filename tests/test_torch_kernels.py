"""Plain PyTorch versions of the ported kernels against the JAX package:
the pure-jnp oracles (``repro.kernels.ref``) AND the Pallas kernels in
interpret mode, on the parametrisations of ``tests/test_kernels.py``.

The CUDA kernels themselves cannot run without a GPU; ``chip_smoke.py``
holds them against these plain versions on the card.  Here the wrappers
in ``repro_torch.kernels.ops`` are given CPU tensors and must take the
plain version.  Inputs are made with numpy from a seed and handed to both
frameworks.  Tolerances are those of ``tests/test_kernels.py``: 2e-5 in
float32 (sums taken in another order), 2e-2 in bfloat16 (output rounding).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
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
    assert ops.launch_counts() == {"flash_attention": 5,
                                   "decode_attention": 7}
    ops.reset_launch_counts()
    assert ops.launch_counts() == {"flash_attention": 0,
                                   "decode_attention": 0}


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """On a tensor that does not lie on the CPU the wrapper goes to the
    kernel's library (and raises where it cannot be built): it never
    falls back to the plain version."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa_mod

    def no_plain(*a, **k):
        raise AssertionError("plain version taken for a non-CPU tensor")

    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(fa_mod, "flash_attention_ref", no_plain)
    monkeypatch.setattr(torch_decode_mod, "decode_attention_ref", no_plain)
    monkeypatch.setattr(_build, "load", no_build)
    q = torch.zeros(1, 4, 4, 16, device="meta")
    kc = torch.zeros(1, 4, 2, 16, device="meta")
    with pytest.raises(RuntimeError):
        ops.flash_attention(q, kc, kc)
    with pytest.raises(RuntimeError):
        ops.decode_attention(q[:, :1], kc, kc, 2)
