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
the Mamba2 and RWKV6 scans 5e-4 absolute (a sequential recurrence
against chunked forms), the RWKV6 scan finite.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models import attention as jax_attention
from repro.models import rwkv as jax_rwkv
from repro.models import ssm as jax_ssm
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
    (2, 72, 72, 4, 4, 80),        # zamba2's head dim, G = 1
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


# K1's backward: (B, Sq, Sk, H, KV, D, Dv) over causal, windowed and
# bidirectional masks; Sq != Sk both ways, G in {1, 2, 4}, ragged tiles;
# gemma3's head dim 256 at G = 2 (the window of 24 binds in both); value
# head dims unlike the query's: SMOKE deepseek's (24, 16) and the
# published (192, 128) of its latent attention
BWD_CASES = [(1, 64, 64, 4, 2, 32, 32), (2, 100, 100, 4, 1, 16, 16),
             (1, 70, 130, 2, 2, 16, 16), (1, 130, 70, 4, 4, 32, 32),
             (1, 70, 70, 2, 1, 256, 256), (1, 130, 100, 4, 2, 256, 256),
             (2, 70, 90, 4, 4, 24, 16), (1, 100, 70, 4, 2, 24, 16),
             (1, 130, 100, 2, 2, 192, 128)]


@pytest.mark.parametrize("b,sq,sk,h,kv,d,dv", BWD_CASES)
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 24)])
def test_flash_attention_bwd_plain_vs_jax_vjp(b, sq, sk, h, kv, d, dv,
                                              causal, window):
    """The plain backward against ``jax.vjp`` of the reference's oracle
    (of its XLA twin ``repro.models.attention.flash_attention`` where
    Dv != D, which the oracle does not take; deepseek's ``train_loss``
    differentiates the twin) and against torch autograd of the plain
    forward, in float32 (1e-5 of each gradient's largest magnitude: sums
    in another order); the plain forward's log-sum-exp against the
    oracle's masked scores, and the public wrapper's gradient on CPU
    tensors (the Function's plain directions) equal to the plain
    backward's."""
    rng = np.random.default_rng(11)
    qj, qt = _pair(rng, (b, sq, h, d), "float32")
    kj, kt = _pair(rng, (b, sk, kv, d), "float32")
    vj, vt = _pair(rng, (b, sk, kv, dv), "float32")
    doj, dot = _pair(rng, (b, sq, h, dv), "float32")
    out, lse = ref.flash_attention_ref(qt, kt, vt, causal=causal,
                                       window=window, return_lse=True)
    assert out.shape == (b, sq, h, dv)
    got = ref.flash_attention_bwd_ref(qt, kt, vt, out, dot, lse,
                                      causal=causal, window=window)
    oracle = jax_ref.flash_attention_ref if dv == d else \
        jax_attention.flash_attention
    _, vjp = jax.vjp(lambda q, k, v: oracle(
        q, k, v, causal=causal, window=window), qj, kj, vj)
    for g, w in zip(got, vjp(doj)):
        scale = float(jnp.max(jnp.abs(w)))
        assert _err(g, w) <= 1e-5 * scale
    leaves = [x.clone().requires_grad_() for x in (qt, kt, vt)]
    ref.flash_attention_ref(*leaves, causal=causal,
                            window=window).backward(dot)
    for g, x in zip(got, leaves):
        assert float((g - x.grad).abs().max()) <= \
            1e-5 * float(x.grad.abs().max())
    leaves = [x.clone().requires_grad_() for x in (qt, kt, vt)]
    before = ops.flash_attention_bwd.launches
    ops.flash_attention(*leaves, causal=causal, window=window).backward(dot)
    assert ops.flash_attention_bwd.launches == before
    for g, x in zip(got, leaves):
        assert torch.equal(g, x.grad)
    # lse: the oracle's scores, masked as it masks them
    s = jnp.einsum("bqkgd,bskd->bkgqs",
                   qj.reshape(b, sq, kv, h // kv, d), kj) * d ** -0.5
    qi, ki = np.arange(sq)[:, None], np.arange(sk)[None, :]
    mask = np.ones((sq, sk), bool)
    if causal:
        mask &= qi >= ki
    if window:
        mask &= qi - ki < window
    want = jax.nn.logsumexp(jnp.where(mask, s, jax_ref.NEG_INF), axis=-1)
    assert _err(lse, want.reshape(b, h, sq)) < 1e-5


def test_flash_attention_bwd_rejects_bad_arguments():
    q = torch.zeros(1, 8, 4, 16)
    kv = torch.zeros(1, 8, 2, 16)
    lse = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError):      # lse [B, Sq, H] instead
        ops.flash_attention_bwd(q, kv, kv, q, q, torch.zeros(1, 8, 4))
    with pytest.raises(ValueError):      # dO of another shape
        ops.flash_attention_bwd(q, kv, kv, q, q[:, :4], lse)


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_device_length_equals_int_length(dtype):
    """``cache_len`` as a one-element int32 tensor (the model's decode
    step, read on the device by the kernel) gives the bits of the same
    int, at every length in [1, S], in the plain version and through the
    wrapper, which takes the plain version for CPU tensors."""
    b, s, h, kv, d = 2, 40, 8, 2, 16
    rng = np.random.default_rng(17)
    _, qt = _pair(rng, (b, 1, h, d), dtype)
    _, kt = _pair(rng, (b, s, kv, d), dtype)
    _, vt = _pair(rng, (b, s, kv, d), dtype)
    for clen in range(1, s + 1):
        want = ref.decode_attention_ref(qt, kt, vt, clen)
        length = torch.tensor(clen, dtype=torch.int32)
        assert torch.equal(ref.decode_attention_ref(qt, kt, vt, length),
                           want), clen
        assert torch.equal(ops.decode_attention(qt, kt, vt, length),
                           want), clen
        assert torch.equal(ops.decode_attention(qt, kt, vt,
                                                length.view(1)), want)


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
    # the served decode calls, 8 queries (and 4 in a 2-way shard): qwen3
    # and granite 64 (32), glm4 16 (8), zamba2 256 (128) (b, KV) pairs
    (513, 64), (513, 16), (544, 256), (513, 256), (544, 32), (544, 8),
    (544, 128),
])
def test_decode_split_plan_covers_cache_exactly(cache_len, batch_kv):
    """Every split starts below cache_len (no block reads beyond it),
    together they cover it, chunks are whole tiles and give every warp
    of a block a tile, and there is no split where the (batch, KV head)
    pairs alone reach the card's block target."""
    chunk, nsplit = torch_decode_mod.split_plan(cache_len, batch_kv)
    assert chunk % torch_decode_mod.TILE_ROWS == 0 and chunk > 0
    assert chunk >= torch_decode_mod.BLOCK_ROWS
    assert nsplit >= 1
    assert nsplit * chunk >= cache_len
    assert (nsplit - 1) * chunk < cache_len
    if batch_kv >= torch_decode_mod.TARGET_BLOCKS:
        assert nsplit == 1
    else:
        assert batch_kv * nsplit <= max(
            batch_kv, torch_decode_mod.TARGET_BLOCKS)


@pytest.mark.parametrize("h,kv,d", [(4, 2, 128), (32, 2, 128), (6, 2, 64),
                                    (4, 4, 80)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_served_layouts_plain_vs_jax(h, kv, d, dtype):
    """The served head layouts, G = 2 / 16 at D = 128 (qwen3, glm4), G = 3
    at D = 64 (granite), G = 1 at D = 80 (zamba2), at B = 2 and a cache
    of 80 rows filled to 67: the plain version against the JAX oracle
    and the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(d + h)
    qj, qt = _pair(rng, (2, 1, h, d), dtype)
    kj, kt = _pair(rng, (2, 80, kv, d), dtype)
    vj, vt = _pair(rng, (2, 80, kv, d), dtype)
    out = ops.decode_attention(qt, kt, vt, 67)
    assert out.shape == (2, 1, h, d) and out.dtype == TORCH[dtype]
    assert _err(out, jax_ref.decode_attention_ref(qj, kj, vj, 67)) < \
        TOL[dtype]
    pallas = jax_ops.decode_attention(qj, kj, vj, jnp.int32(67),
                                      interpret=True)
    assert _err(out, pallas) < TOL[dtype]


@pytest.mark.parametrize("bad", ["dtype", "heads", "head_dim", "len0",
                                 "len_big", "len_int64", "len_two"])
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
    elif bad == "len_int64":      # the kernel reads an int32
        with pytest.raises(ValueError):
            ops.decode_attention(q, kc, kc, torch.tensor(3))
    elif bad == "len_two":
        with pytest.raises(ValueError):
            ops.decode_attention(q, kc, kc,
                                 torch.tensor([3, 4], dtype=torch.int32))
    else:
        with pytest.raises(ValueError):
            ops.decode_attention(q, kc, kc, 9)


# The wgmma backward's tile plan, copied from csrc/flash_attention_bwd.cu
# (key_tile_queries, first_key_tile, the work counter's order) to hold it
# against a walk over the mask here; the card test
# test_flash_attention_bwd_counters_follow_tile_plan reads the kernel's
# own counts.
def bwd_key_tile_queries(kt, sq, sk, causal, window, dims=(128, 128)):
    """The query tiles that key tile ``kt`` visits (the key tile of head
    dims ``dims``, (D, Dv)): those holding a query that sees a key of the
    tile.  Both ends never decrease as ``kt`` grows."""
    from repro_torch.kernels.flash_attention import bwd_tiles
    bk, bq = bwd_tiles(*dims)
    k0 = kt * bk
    k_last = min(k0 + bk, sk) - 1
    q_begin = k0 if causal else 0
    q_end = min(sq, k_last + window) if window > 0 else sq
    lo = q_begin // bq
    hi = -(-q_end // bq) if q_end > q_begin else lo
    return range(lo, hi)


def ks_head_group() -> int:
    """KS_HEAD_GROUP of csrc/flash_attention_bwd.cu."""
    import re
    from pathlib import Path
    from repro_torch.kernels import _build
    src = (Path(_build.CSRC) / "flash_attention_bwd.cu").read_text()
    return int(re.search(r"constexpr int KS_HEAD_GROUP = (\d+);",
                         src).group(1))


def bwd_work_tiles(b, kv, sk, dims=(128, 128), group=None):
    """The work tiles (key tile, batch, KV head) in the order the blocks
    take them from the work counter: key tile major, but in the kv-split
    kernel of (192, 128) key tile major within groups of ``group``
    (None: the kernel's KS_HEAD_GROUP) (batch, KV head) pairs, the last
    group holding the rest."""
    from repro_torch.kernels.flash_attention import bwd_tiles
    n, n_kt = b * kv, -(-sk // bwd_tiles(*dims)[0])
    group = n if dims != (192, 128) else group or ks_head_group()
    tiles = []
    for item in range(n_kt * n):
        g = item // (group * n_kt)
        size = min(group, n - g * group)
        r = item - g * group * n_kt
        bh = g * group + r % size
        tiles.append((r // size, bh // kv, bh % kv))
    return tiles


def bwd_first_key_tile(qt, sq, sk, causal, window, dims=(128, 128)):
    """The first key tile that visits query tile ``qt``: a key tile ``kt``
    that visits it has ``kt - bwd_first_key_tile(qt)`` predecessors in its
    dq sum.  Without a window every key tile's range reaches the last
    query tile; with one, the first key tile whose last key is within the
    window of the tile's first query."""
    from repro_torch.kernels.flash_attention import bwd_tiles
    bk, bq = bwd_tiles(*dims)
    if window <= 0:
        return 0
    return max(0, qt * bq - window + 1) // bk


def _bwd_plan_case(seed):
    """A random (Sq, Sk, causal, window) for the backward's tile plan:
    lengths around the tiles' multiples, windows from none to wide."""
    rng = np.random.default_rng(seed)
    sq, sk = (int(x) for x in rng.integers(1, 700, size=2))
    causal = bool(rng.integers(2))
    window = int(rng.choice([0, 1, 63, 64, 100, 300]))
    return sq, sk, causal, window


@pytest.mark.parametrize("dims", [(128, 128), (256, 256), (192, 128)])
@pytest.mark.parametrize("seed", range(8))
def test_flash_attention_bwd_tile_plan_matches_mask(seed, dims):
    """The wgmma backward's tile plan against a brute-force walk over the
    mask, for the 128-key tiles of D <= 128 and the 64-key tiles of
    D = 256 and (D, Dv) = (192, 128): key tile kt visits exactly the
    query tiles that hold a pair the mask keeps with one of its keys, the
    key tiles that visit a query tile are a run that starts at
    bwd_first_key_tile, and every predecessor in a query tile's dq sum is
    taken from the work counter (key tile major, within groups of heads
    at (192, 128)) before its successor."""
    from repro_torch.kernels import flash_attention as fa
    for sq, sk, causal, window in [_bwd_plan_case(seed),
                                   _bwd_plan_case(100 + seed)]:
        qi = np.arange(sq)[:, None]
        ki = np.arange(sk)[None, :]
        mask = np.ones((sq, sk), bool)
        if causal:
            mask &= qi >= ki
        if window:
            mask &= qi - ki < window
        bk, bq = fa.bwd_tiles(*dims)
        n_qt, n_kt = -(-sq // bq), -(-sk // bk)
        visits = {}
        for kt in range(n_kt):
            want = [qt for qt in range(n_qt)
                    if mask[qt * bq:(qt + 1) * bq, kt * bk:(kt + 1) * bk].any()]
            got = list(bwd_key_tile_queries(kt, sq, sk, causal, window,
                                            dims))
            assert got == want, (sq, sk, causal, window, kt)
            for qt in got:
                visits.setdefault(qt, []).append(kt)
        # the kv-split kernel's groups of heads: its own, and groups of 4
        # and of one head (6 heads: a partial group)
        for group in ([None, 4, 1] if dims == (192, 128) else [None]):
            taken = {t: i for i, t in enumerate(
                bwd_work_tiles(2, 3, sk, dims, group))}
            assert len(taken) == n_kt * 6
            for qt, kts in visits.items():
                first = bwd_first_key_tile(qt, sq, sk, causal, window, dims)
                assert kts == list(range(first, first + len(kts)))
                for b in range(2):
                    for hk in range(3):
                        order = [taken[(kt, b, hk)] for kt in kts]
                        assert order == sorted(order)
        # query tiles no key tile visits hold only rows without keys
        for qt in set(range(n_qt)) - set(visits):
            assert not mask[qt * bq:(qt + 1) * bq].any()


@pytest.mark.parametrize("dtype,d,dv", [(torch.bfloat16, 128, 128),
                                        (torch.bfloat16, 64, 64),
                                        (torch.bfloat16, 80, 80),
                                        (torch.bfloat16, 256, 256),
                                        (torch.bfloat16, 192, 128),
                                        (torch.float32, 128, 128)])
def test_flash_attention_bwd_scratch_layout(dtype, d, dv):
    """The wrapper's scratch for the backward kernel: the wgmma kernels
    (bf16) take delta and lse log2 e over Sq rounded up to the query tile,
    a float32 dq accumulator of whole query tiles and of the query head
    dim rounded up to 64 (128 at D = 80, 256 at gemma3's 256, 192 at
    deepseek's (192, 128): dq is D wide) and one counter per (batch, head,
    query tile) plus the work counter; float32 takes delta [B, H, Sq]
    alone."""
    from repro_torch.kernels import flash_attention as fa
    b, h, sq = 2, 4, 130
    delta, acc, cnt = fa.bwd_scratch(b, h, sq, d, dv, dtype, "cpu")
    assert delta.dtype == torch.float32
    if dtype == torch.bfloat16:
        bq = fa.bwd_tiles(d, dv)[1]
        n_qt = -(-sq // bq)
        pad = n_qt * bq
        assert pad >= sq > pad - bq
        assert delta.shape == (2, b, h, pad)
        d_pad = {64: 64, 80: 128, 128: 128, 256: 256, 192: 192}[d]
        assert acc.shape == (b, h, pad, d_pad) and acc.dtype == torch.float32
        assert cnt.shape == (b * h * n_qt + 1,) and cnt.dtype == torch.int32
    else:
        assert delta.shape == (b, h, sq) and acc is None and cnt is None


def test_launch_counts_reset():
    ops.flash_attention.launches = 5
    ops.flash_attention_bwd.launches = 6
    ops.decode_attention.launches = 7
    ops.moe_gemm.launches = 3
    ops.moe_gemm_dx.launches = 8
    ops.moe_gemm_dw.launches = 9
    ops.mamba2_scan.launches = 4
    ops.mamba2_scan_bwd.launches = 6
    ops.rwkv6_scan.launches = 2
    ops.rwkv6_scan_bwd.launches = 3
    ops.moe_gemm.decode_tile_launches = 1
    ops.flash_attention_bwd.window_launches = 2
    ops.moe_gemm_dx.tma_launches = 4
    ops.moe_gemm_dw.tma_launches = 5
    assert ops.launch_counts() == {"flash_attention": 5,
                                   "flash_attention_bwd": 6,
                                   "decode_attention": 7, "moe_gemm": 3,
                                   "moe_gemm_dx": 8, "moe_gemm_dw": 9,
                                   "mamba2_scan": 4, "mamba2_scan_bwd": 6,
                                   "rwkv6_scan": 2, "rwkv6_scan_bwd": 3}
    ops.reset_launch_counts()
    assert ops.launch_counts() == {"flash_attention": 0,
                                   "flash_attention_bwd": 0,
                                   "decode_attention": 0, "moe_gemm": 0,
                                   "moe_gemm_dx": 0, "moe_gemm_dw": 0,
                                   "mamba2_scan": 0, "mamba2_scan_bwd": 0,
                                   "rwkv6_scan": 0, "rwkv6_scan_bwd": 0}
    assert ops.moe_gemm.decode_tile_launches == 0
    assert ops.flash_attention_bwd.window_launches == 0
    assert ops.moe_gemm_dx.tma_launches == ops.moe_gemm_dw.tma_launches == 0


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """On a tensor that does not lie on the CPU the wrapper goes to the
    kernel's library (and raises where it cannot be built): it never
    falls back to the plain version."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import mamba2_scan as ms_mod
    from repro_torch.kernels import moe_gemm as mg_mod
    from repro_torch.kernels import rwkv6_scan as rs_mod

    def no_plain(*a, **k):
        raise AssertionError("plain version taken for a non-CPU tensor")

    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(fa_mod, "flash_attention_ref", no_plain)
    monkeypatch.setattr(fa_mod, "flash_attention_bwd_ref", no_plain)
    monkeypatch.setattr(torch_decode_mod, "decode_attention_ref", no_plain)
    monkeypatch.setattr(mg_mod, "moe_gemm_ref", no_plain)
    monkeypatch.setattr(mg_mod, "moe_gemm_dx_ref", no_plain)
    monkeypatch.setattr(mg_mod, "moe_gemm_dw_ref", no_plain)
    monkeypatch.setattr(rs_mod, "rwkv6_scan_ref", no_plain)
    monkeypatch.setattr(rs_mod, "rwkv6_scan_bwd_ref", no_plain)
    monkeypatch.setattr(ms_mod, "mamba2_scan_ref", no_plain)
    monkeypatch.setattr(ms_mod, "mamba2_scan_bwd_ref", no_plain)
    monkeypatch.setattr(_build, "load", no_build)
    q = torch.zeros(1, 4, 4, 16, device="meta")
    kc = torch.zeros(1, 4, 2, 16, device="meta")
    with pytest.raises(RuntimeError):
        ops.flash_attention(q, kc, kc)
    with pytest.raises(RuntimeError):
        ops.flash_attention_bwd(q, kc, kc, q, q, torch.zeros(
            1, 4, 4, device="meta"))
    with pytest.raises(RuntimeError):
        ops.decode_attention(q[:, :1], kc, kc, 2)
    with pytest.raises(RuntimeError):
        ops.moe_gemm(torch.zeros(2, 4, 8, 16, device="meta"),
                     torch.zeros(4, 16, 8, device="meta"))
    with pytest.raises(RuntimeError):
        ops.moe_gemm_dx(torch.zeros(2, 4, 8, 8, device="meta"),
                        torch.zeros(4, 16, 8, device="meta"))
    with pytest.raises(RuntimeError):
        ops.moe_gemm_dw(torch.zeros(2, 4, 8, 16, device="meta"),
                        torch.zeros(2, 4, 8, 8, device="meta"))
    x = torch.zeros(1, 8, 2, 16, device="meta")
    with pytest.raises(RuntimeError):
        ops.rwkv6_scan(x, x, x, x, torch.zeros(2, 16, device="meta"),
                       chunk=4)
    with pytest.raises(RuntimeError):
        ops.rwkv6_scan_bwd(x, x, x, x, torch.zeros(2, 16, device="meta"),
                           x, chunk=4)
    bc = torch.zeros(1, 8, 8, device="meta")
    with pytest.raises(RuntimeError):
        ops.mamba2_scan(x, bc, bc, torch.zeros(1, 8, 2, device="meta"),
                        torch.zeros(2, device="meta"), chunk=4)
    with pytest.raises(RuntimeError):
        ops.mamba2_scan_bwd(x, bc, bc, torch.zeros(1, 8, 2, device="meta"),
                            torch.zeros(2, device="meta"), x, chunk=4)


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_bwd",
                                  "decode_attention", "rwkv6_scan",
                                  "mamba2_scan"])
def test_wrapper_dims_match_kernel_instantiations(name):
    """Each wrapper accepts exactly the dims its source's dispatch
    instantiates (a dim outside them would reach the kernel and come
    back as -1): 80 for both attention kernels (zamba2), not for the
    RWKV6 scan; K1's (D, Dv) pairs, (192, 128) among them (deepseek-v2's
    latent attention), in both of its dispatches and both of its
    backward's; K4's (P, N) pairs."""
    import re
    from pathlib import Path
    from repro_torch.kernels import _build
    from repro_torch.kernels import mamba2_scan as ms_mod
    from repro_torch.kernels import rwkv6_scan as rs_mod

    src = (Path(_build.CSRC) / f"{name}.cu").read_text()
    if name == "flash_attention_bwd":
        # one `if (D == . && Dv == .) return launch_bwd_...<...>(a);` per
        # pair in each dispatch: float32 (FMA at (D, Dv)) and bf16 (wgmma
        # at D == Dv rounded up to 64, the columns past D zero; the
        # column-split kernel at 256, the kv-split kernel at (192, 128))
        got = re.findall(r"if \(D == (\d+) && Dv == (\d+)\) return "
                         r"(launch_bwd_\w+)<([\d, ]+)>\(a\);", src)
        pairs = lambda fns: {(int(d), int(dv)): (
            fn, tuple(int(x) for x in args.split(",")))
            for d, dv, fn, args in got if fn in fns}
        fma = pairs(("launch_bwd_fma",))
        bf16 = pairs(("launch_bwd_wgmma", "launch_bwd_colsplit",
                      "launch_bwd_kvsplit"))
        want = sorted(_build.FLASH_HEAD_DIMS)
        assert sorted(fma) == want and sorted(bf16) == want
        assert len(fma) + len(bf16) == len(got)
        assert all(args == pair for pair, (_, args) in fma.items())
        assert all(fn == "launch_bwd_wgmma" and args == (-(-d // 64) * 64,)
                   for (d, dv), (fn, args) in bf16.items()
                   if max(d, dv) <= 128)
        assert {bf16[(64, 64)][1], bf16[(128, 128)][1]} == {(64,), (128,)}
        assert bf16[(256, 256)] == ("launch_bwd_colsplit", (256,))
        assert bf16[(192, 128)] == ("launch_bwd_kvsplit", (192, 128))
        return
    if name == "mamba2_scan":
        got = {(int(p), int(n)) for p, n in
               re.findall(r"if \(P == (\d+) && N == (\d+)\)", src)}
        assert got == set(ms_mod.DIMS)
        assert (64, 64) in got and (16, 8) in got
        return
    if name == "flash_attention":
        # one `if (D == . && Dv == .) return launch_...<., .>(a);` per pair
        # in each dispatch (the float32 FMA kernel's, the bf16 mma.sync's)
        pairs = re.findall(r"if \(D == (\d+) && Dv == (\d+)\) return "
                           r"(launch_flash\w*)<(\d+), (\d+)>\(a\);", src)
        assert all((d, dv) == (d2, dv2) for d, dv, _, d2, dv2 in pairs)
        for launcher in ("launch_flash", "launch_flash_mma"):
            got = [(int(d), int(dv)) for d, dv, fn, _, _ in pairs
                   if fn == launcher]
            assert sorted(got) == sorted(set(got)) == \
                sorted(_build.FLASH_HEAD_DIMS), launcher
        assert (80, 80) in _build.FLASH_HEAD_DIMS
        assert (192, 128) in _build.FLASH_HEAD_DIMS
        return
    got = {int(d) for d in re.findall(r"case (\d+): return ", src)}
    dims = rs_mod.HEAD_DIMS if name == "rwkv6_scan" else \
        _build.DECODE_HEAD_DIMS
    assert got == set(dims)
    assert (80 in got) == (name != "rwkv6_scan")
    # every dispatch of the source (the float32 FMA kernel's and the bf16
    # mma.sync kernel's) takes exactly those dims
    switches = re.findall(r"switch \(D\) \{(.*?)\}", src, re.S)
    assert len(switches) == 2
    for block in switches:
        assert {int(d) for d in re.findall(r"case (\d+):", block)} == \
            set(dims)


def test_decode_attention_head_dim_80_plain_vs_jax():
    """G = 1 and G = 2 at head dim 80 against the JAX oracle."""
    rng = np.random.default_rng(80)
    for h, kv in ((4, 4), (4, 2)):
        qj, qt = _pair(rng, (2, 1, h, 80), "float32")
        kj, kt = _pair(rng, (2, 40, kv, 80), "float32")
        vj, vt = _pair(rng, (2, 40, kv, 80), "float32")
        out = ops.decode_attention(qt, kt, vt, 33)
        assert _err(out, jax_ref.decode_attention_ref(qj, kj, vj, 33)) < 2e-5


@pytest.mark.parametrize("window", [0, 100, 20])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_head_dim_256_plain_vs_jax(window, dtype):
    """gemma3's heads (4 over 2 KV heads of 256; SMOKE halves the served 8
    over 4), causal, with no window, a window that binds (100 of a
    256-token prompt, as gemma3's 1024 of 2048) and one below a KV tile,
    against the JAX oracle and the Pallas kernel in interpret mode (in
    whole blocks of 128 rows: the interpreter pads a ragged block with
    NaN)."""
    rng = np.random.default_rng(256 + window)
    qj, qt = _pair(rng, (1, 256, 4, 256), dtype)
    kj, kt = _pair(rng, (1, 256, 2, 256), dtype)
    vj, vt = _pair(rng, (1, 256, 2, 256), dtype)
    out = ops.flash_attention(qt, kt, vt, causal=True, window=window)
    assert out.shape == (1, 256, 4, 256) and out.dtype == TORCH[dtype]
    oracle = jax_ref.flash_attention_ref(qj, kj, vj, causal=True,
                                         window=window)
    pallas = jax_ops.flash_attention(qj, kj, vj, causal=True, window=window,
                                     interpret=True)
    assert _err(out, oracle) < TOL[dtype]
    assert _err(out, pallas) < TOL[dtype]


@pytest.mark.parametrize("s,clen", [(512, 512), (512, 259), (128, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_head_dim_256_plain_vs_jax(s, clen, dtype):
    """gemma3's decode at head dim 256 (G = 2), a global cache of 512 rows
    at full length and just past half, and a ring of 128 rows at length 1,
    against the JAX oracle and the Pallas kernel in interpret mode (whole
    blocks of 256 rows); the int and device lengths give the same
    bits."""
    rng = np.random.default_rng(s + clen)
    qj, qt = _pair(rng, (2, 1, 8, 256), dtype)
    kj, kt = _pair(rng, (2, s, 4, 256), dtype)
    vj, vt = _pair(rng, (2, s, 4, 256), dtype)
    out = ops.decode_attention(qt, kt, vt, clen)
    assert out.shape == (2, 1, 8, 256) and out.dtype == TORCH[dtype]
    assert _err(out, jax_ref.decode_attention_ref(qj, kj, vj, clen)) < \
        TOL[dtype]
    pallas = jax_ops.decode_attention(qj, kj, vj, jnp.int32(clen),
                                      interpret=True)
    assert _err(out, pallas) < TOL[dtype]
    dev = ops.decode_attention(qt, kt, vt,
                               torch.tensor(clen, dtype=torch.int32))
    assert torch.equal(dev, out)


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


# K3's tile and loader plan (the bf16 wgmma kernel's; decided in Python)

BASE = 1 << 32           # an aligned device address for the plan's checks


def _granite_operands(b, c, up=True):
    """granite-moe's K3 operands on the meta device, with the layouts the
    MoE layer gives them: the gate / up input is the dispatch buffer minus
    its dropped slot, the down input the contiguous activation."""
    from repro_torch.configs.archs import ARCHS
    cfg = ARCHS["granite-moe-3b-a800m"]
    e, dm, de = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_expert
    if up:
        buf = torch.empty((b, e * c + 1, dm), dtype=torch.bfloat16,
                          device="meta")
        return buf[:, :-1].view(b, e, c, dm), torch.empty(
            (e, dm, de), dtype=torch.bfloat16, device="meta")
    return (torch.empty((b, e, c, de), dtype=torch.bfloat16, device="meta"),
            torch.empty((e, de, dm), dtype=torch.bfloat16, device="meta"))


def _plan(x, w, x_ptr=BASE, w_ptr=BASE):
    from repro_torch.kernels import moe_gemm as mg_mod
    x4 = x if x.dim() == 4 else x.unsqueeze(0)
    b, e, c, d = x4.shape
    return mg_mod.gemm_plan(b, e, c, d, w.shape[2], x4.stride(), w.stride(),
                            x_ptr, w_ptr)


@pytest.mark.parametrize("stage,b,c,up,block_rows", [
    ("prefill", 8, 128, True, 128), ("prefill", 8, 128, False, 128),
    ("prefill", 4, 128, True, 128), ("prefill", 4, 128, False, 128),
    ("decode", 8, 8, True, 64), ("decode", 8, 8, False, 64),
    ("decode", 4, 8, True, 64), ("decode", 4, 8, False, 64),
])
def test_moe_gemm_plan_granite_serving_shapes(stage, b, c, up, block_rows):
    """Every K3 call of granite's serving path (8 queries, or 4 in a
    2-way shard; prompt 512 gives capacity 128, a decode step 8) takes the
    16-byte vector loader with no copy, the 128-row two-warpgroup tile at
    prefill and the 64-row tile at decode."""
    from repro_torch.kernels import moe_gemm as mg_mod
    from repro_torch.models.moe import _capacity
    from repro_torch.configs.archs import ARCHS
    cfg = ARCHS["granite-moe-3b-a800m"]
    assert c == _capacity(512 if stage == "prefill" else 1, cfg)
    x, w = _granite_operands(b, c, up)
    plan = _plan(x, w)
    assert plan.vector and plan.block_rows == block_rows
    assert plan.code == (1 if block_rows == mg_mod.PREFILL_ROWS else 0)
    f = w.shape[2]
    assert plan.grid == (-(-f // mg_mod.BLOCK_N), -(-b * c // block_rows),
                         cfg.moe.num_experts)


@pytest.mark.parametrize("case", ["d100", "d7", "f70", "w_transposed",
                                  "x_base", "w_base"])
def test_moe_gemm_plan_ragged_operands_take_the_element_loader(case):
    """Rows that are not 16-byte aligned (the sweep's D = 100, 7; F = 70),
    a weight whose F is not contiguous, or an odd base address go through
    the element-wise loader (code bit 1); aligned operands do not."""
    def t(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")
    x, w = t(8, 40, 64), t(8, 64, 64)
    assert _plan(x, w).vector
    x_ptr = w_ptr = BASE
    if case == "d100":
        x, w = t(8, 40, 100), t(8, 100, 72)
    elif case == "d7":
        x, w = t(3, 1, 7), t(3, 7, 8)
    elif case == "f70":
        w = t(8, 64, 70)
    elif case == "w_transposed":
        w = t(8, 64, 64).transpose(1, 2)
    elif case == "x_base":
        x_ptr += 8
    else:
        w_ptr += 2
    plan = _plan(x, w, x_ptr, w_ptr)
    assert not plan.vector and plan.code & 2


@pytest.mark.parametrize("b,c,f", [(1, 1, 1), (1, 64, 128), (1, 65, 129),
                                   (8, 8, 512), (4, 8, 1536), (2, 128, 200),
                                   (8, 128, 512), (3, 255, 70), (1, 256, 5)])
def test_moe_gemm_plan_covers_every_output_tile_once(b, c, f):
    """The plan's grid of block_rows x BLOCK_N tiles covers the [B*C, F]
    output of each expert exactly once: no element twice, none missed,
    and no tile starts beyond the output."""
    from repro_torch.kernels import moe_gemm as mg_mod
    x = torch.empty((b, 3, c, 16), dtype=torch.bfloat16, device="meta")
    w = torch.empty((3, 16, f), dtype=torch.bfloat16, device="meta")
    plan = _plan(x, w)
    cols, row_tiles, experts = plan.grid
    assert experts == 3
    rows = b * c
    cover = np.zeros((rows, f), np.int32)
    for bx in range(cols):
        assert bx * mg_mod.BLOCK_N < f
        for by in range(row_tiles):
            assert by * plan.block_rows < rows
            cover[by * plan.block_rows:(by + 1) * plan.block_rows,
                  bx * mg_mod.BLOCK_N:(bx + 1) * mg_mod.BLOCK_N] += 1
    assert (cover == 1).all()


def test_moe_gemm_plan_rejects_grid_overflow():
    from repro_torch.kernels import moe_gemm as mg_mod
    rows = mg_mod.MAX_ROW_TILES * mg_mod.PREFILL_ROWS + 1
    with pytest.raises(ValueError):
        mg_mod.gemm_plan(1, 2, rows, 16, 16, (0, rows * 16, 16, 1),
                         (256, 16, 1), BASE, BASE)


def test_kernel_operand_16_byte_rule():
    """bf16 views need strides that are multiples of 8 elements (16 bytes)
    and a 16-byte base: 4-aligned heads inside 36-element rows are copied;
    float32 needs 4 elements, so the same view in float32 passes; dims of
    size 1 do not count."""
    from repro_torch.kernels import _build
    for dtype, copied in ((torch.bfloat16, True), (torch.float32, False)):
        buf = torch.zeros((2, 40, 6, 36), dtype=dtype)
        q = buf[:, :, :4, :32]
        out = _build.kernel_operand(q)
        assert (out is not q) == copied
        assert torch.equal(out, q) and (not copied or out.is_contiguous())
    fused = torch.zeros((2, 40, 8, 32), dtype=torch.bfloat16)
    for view in (fused[:, :, :4], fused[:, :, 4:6], fused[:, :, 6:8]):
        assert _build.kernel_operand(view) is view
    assert _build.aligned16((1, 8, 16), (5, 16, 1), BASE, 2)
    assert not _build.aligned16((2, 8, 16), (5, 16, 1), BASE, 2)
    assert not _build.aligned16((2, 8, 16), (128, 16, 1), BASE + 8, 2)
    assert not _build.aligned16((2, 8, 16), (256, 32, 2), BASE, 2)


def test_kernel_operand_passes_mamba2_conv_slices_uncopied():
    """zamba2's Mamba2 operands are column slices of one bf16 conv output
    with row stride H*P + 2N = 5248 at offsets 0, 5120 and 5184: the
    16-byte rule takes all three as they lie."""
    from repro_torch.configs.archs import ARCHS
    from repro_torch.kernels import _build
    cfg = ARCHS["zamba2-2.7b"]
    sc = cfg.ssm
    d_inner, n = sc.expand * cfg.d_model, sc.state_dim
    assert (d_inner, d_inner + 2 * n) == (5120, 5248)
    xbc = torch.zeros((2, 8, d_inner + 2 * n), dtype=torch.bfloat16)
    xh = xbc[..., :d_inner].view(2, 8, d_inner // sc.head_dim, sc.head_dim)
    bm, cm = xbc[..., d_inner:d_inner + n], xbc[..., d_inner + n:]
    assert [t.storage_offset() for t in (xh, bm, cm)] == [0, 5120, 5184]
    for t in (xh, bm, cm):
        assert not t.is_contiguous()
        assert _build.kernel_operand(t) is t


@pytest.mark.parametrize("name", ["flash_attention", "moe_gemm",
                                  "decode_attention", "mamba2_scan",
                                  "rwkv6_scan"])
def test_bf16_never_reaches_an_fma_kernel(name):
    """The FMA kernels are instantiated for float32 inputs only, and the C
    entry points send dtype 1 (bf16) to the tensor-core kernels: K1's,
    K2's, K4's and K5's mma.sync kernels (each for every dim its dispatch
    takes, K4's and K5's for both output types) and K3's wgmma kernel."""
    import re
    from pathlib import Path
    from repro_torch.kernels import _build
    src = (Path(_build.CSRC) / f"{name}.cu").read_text()
    if name == "flash_attention":
        assert re.findall(r"flash_fma_kernel<(\w+)", src) == ["float"]
        assert "if (dtype == 1) return aligned_for_mma(a) ? " \
            "dispatch_mma(a, D, Dv)" in src
        mma = re.search(r"int dispatch_mma\(.*?\n\}", src, re.S).group(0)
        assert {(int(d), int(dv)) for d, dv in re.findall(
            r"return launch_flash_mma<(\d+), (\d+)>", mma)} == \
            set(_build.FLASH_HEAD_DIMS)
    elif name == "moe_gemm":
        assert re.search(r"moe_gemm_fma_kernel\(const float\* __restrict__ "
                         r"x, const float\* __restrict__ w,\s+float\*", src)
        assert "if (dtype == 0) return launch_fma(a);" in src
        assert src.count("launch_fma(") == 2   # its definition, that call
    elif name == "decode_attention":
        # the FMA passes launch only in float32, reached from dtype 0
        assert set(re.findall(r"return launch_decode<(\w+), \d+>", src)) \
            == {"float"}
        assert "if (dtype == 0) return dispatch_fma(a, D);" in src
        assert "if (dtype == 1) return aligned_for_mma(a) ? " \
            "dispatch_mma(a, D) : -1;" in src
        mma = re.search(r"int dispatch_mma\(.*?\n\}", src, re.S).group(0)
        assert {int(d) for d in re.findall(
            r"return launch_decode_mma<(\d+)>", mma)} == \
            set(_build.DECODE_HEAD_DIMS)
        assert src.count("dispatch_fma(") == 2
        assert src.count("decode_partial_kernel<") == 1   # in launch_decode
    elif name == "mamba2_scan":
        from repro_torch.kernels import mamba2_scan as ms_mod
        # the first template argument is the input type, the last y's
        assert set(re.findall(r"launch_scan<(\w+), \d+, \d+, \w+>", src)) \
            == {"float"}
        assert "if (dtype == 0) return dispatch_fma(a, P, N);" in src
        assert "if (dtype == 1) return aligned_for_mma(a) ? " \
            "dispatch_mma(a, P, N) : -1;" in src
        mma = set(re.findall(r"launch_scan_mma<(\d+), (\d+), (\w+)>", src))
        assert {(int(p), int(n)) for p, n, _ in mma} == set(ms_mod.DIMS)
        assert {ot for _, _, ot in mma} == {"float", "bf16"}
        assert src.count("dispatch_fma(") == 2
        assert src.count("mamba2_scan_kernel<") == 2   # attribute, launch
    else:
        from repro_torch.kernels import rwkv6_scan as rs_mod
        # the FMA kernel's r, k, v are float32 by its signature
        assert re.search(r"rwkv6_scan_kernel\(const float\* __restrict__ r, "
                         r"const float\* __restrict__ k,\s+const float\* "
                         r"__restrict__ v,", src)
        assert "return dispatch_fma(a, D);" in src
        assert "return aligned_for_mma(a) ? dispatch_mma(a, D) : -1;" in src
        entry = src[src.index('extern "C" int fate_rwkv6_scan('):]
        assert entry.index("if (dtype == 0) {") < \
            entry.index("dispatch_fma(a, D)") < \
            entry.index("if (dtype == 1) {") < entry.index("dispatch_mma(a, D)")
        mma = re.search(r"int dispatch_mma\(.*?\n\}", src, re.S).group(0)
        got = set(re.findall(r"launch_scan_mma<(\d+), (\w+)>", mma))
        assert {int(d) for d, _ in got} == set(rs_mod.HEAD_DIMS)
        assert {ot for _, ot in got} == {"float", "bf16"}
        assert src.count("dispatch_fma(") == 2
        assert src.count("rwkv6_scan_kernel<") == 2   # attribute, launch


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


def _bf16_round(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to bf16 (to nearest even), as float32."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def test_rwkv6_model_scan_output_stays_float32_as_in_the_reference():
    """The model's prefill scan (``_wkv_prefill``) on bf16 r, k, v hands a
    float32 output on, as the reference's ``_wkv_chunked`` keeps it: within
    1e-4 of its largest magnitude, where one bf16 rounding of the output
    costs up to about 2e-3 of it."""
    from repro_torch.models import rwkv as rwkv_mod
    r, k, v, w, bonus = _rwkv_inputs(64, False, seed=17)
    r, k, v = (_bf16_round(a) for a in (r, k, v))
    st0 = np.random.default_rng(18).standard_normal((2, 2, 16, 16),
                                                    dtype=np.float32)
    out, fin = rwkv_mod._wkv_prefill(
        *(torch.from_numpy(a).bfloat16() for a in (r, k, v)),
        torch.from_numpy(w), torch.from_numpy(bonus), 16,
        torch.from_numpy(st0))
    assert out.dtype == torch.float32 and fin.dtype == torch.float32
    jout, jfin = jax_rwkv._wkv_chunked(
        *(jnp.asarray(a) for a in (r, k, v, w, bonus)), 16, jnp.asarray(st0))
    assert _abs(out, jout) <= 1e-4 * float(np.abs(np.asarray(jout)).max())
    assert _abs(fin, jfin) < 5e-4


def _split_bf16(x: torch.Tensor):
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _mm_split(a: torch.Tensor, b: torch.Tensor, b_exact: bool = False):
    """a @ b as the mma.sync kernel forms it: each float32 factor as hi + lo
    bf16 terms, hi.hi + hi.lo + lo.hi (hi + lo against an exact bf16 b),
    every product and sum in float32."""
    ah, al = _split_bf16(a)
    if b_exact:
        return al @ b + ah @ b
    bh, bl = _split_bf16(b)
    return al @ bh + ah @ bl + ah @ bh


def _factored_scores(rc, kc, ce, ci, e, rows, cols):
    """Scores of ``rows`` against earlier ``cols`` factored through the
    boundary row e: (r * exp(ce - ce_e)) (k * exp(ce_e - ci))^T, both
    exponents <= 0, on split terms."""
    qt = rc[:, :, rows] * torch.exp(
        torch.clamp(ce[:, :, rows] - ce[:, :, e:e + 1], max=0.0))
    kt = kc[:, :, cols] * torch.exp(
        torch.clamp(ce[:, :, e:e + 1] - ci[:, :, cols], max=0.0))
    return _mm_split(qt, kt.transpose(-1, -2))


def _rwkv6_mma_emulation(r, k, v, w, bonus, chunk, state0):
    """The bf16 kernel's arithmetic (csrc/rwkv6_scan.cu, rwkv6_mma_kernel)
    in torch: per chunk the cumulative log decays in float32; the diagonal
    8 x 8 blocks pair by pair in float32, every other score below the
    diagonal factored through a boundary row (the first row of the 16-row
    sub-chunk, or its row 8 for the block of its rows 8..15 and columns
    0..7); every product on split terms.  r, k, v: bf16-exact float32
    [B, S, H, D]."""
    bsz, s, h, d = r.shape
    lp = -(-chunk // 16) * 16
    to_bh = lambda x: x.permute(0, 2, 1, 3)            # [B, H, S, D]
    r, k, v = to_bh(r), to_bh(k), to_bh(v)
    lw = to_bh(torch.log(w.clamp(1e-8, 1.0)))
    st = state0.clone()
    outs = []
    tri = torch.tril(torch.ones(8, 8, dtype=torch.bool), -1)
    for t0 in range(0, s, chunk):
        pad = lambda x: torch.nn.functional.pad(
            x[:, :, t0:t0 + chunk], (0, 0, 0, lp - chunk))
        rc, kc, vc, lwc = pad(r), pad(k), pad(v), pad(lw)
        cum = torch.cat([torch.zeros_like(lwc[:, :, :1]),
                         torch.cumsum(lwc, dim=2)], dim=2)
        ce, ci = cum[:, :, :lp], cum[:, :, 1:]
        sc = torch.zeros(bsz, h, lp, lp)
        for b0 in range(0, lp, 8):
            rows = slice(b0, b0 + 8)
            pair = torch.exp(torch.clamp(
                ce[:, :, rows, None] - ci[:, :, None, rows], max=0.0))
            blk = torch.einsum("bhik,bhjk,bhijk->bhij", rc[:, :, rows],
                               kc[:, :, rows], pair) * tri
            sc[:, :, rows, rows] = blk + torch.diag_embed(
                (rc[:, :, rows] * bonus[None, :, None] * kc[:, :, rows])
                .sum(-1))
        for a0 in range(0, lp, 16):
            sc[:, :, a0 + 8:a0 + 16, a0:a0 + 8] = _factored_scores(
                rc, kc, ce, ci, a0 + 8, slice(a0 + 8, a0 + 16),
                slice(a0, a0 + 8))
            if a0:
                sc[:, :, a0:a0 + 16, :a0] = _factored_scores(
                    rc, kc, ce, ci, a0, slice(a0, a0 + 16), slice(0, a0))
        out = (_mm_split(rc * torch.exp(ce), st)
               + _mm_split(sc, vc, b_exact=True))
        outs.append(out[:, :, :chunk])
        total = cum[:, :, lp]
        fac = kc * torch.exp(torch.clamp(total[:, :, None] - ci, max=0))
        st = (st * torch.exp(total)[..., None]
              + _mm_split(fac.transpose(-1, -2), vc, b_exact=True))
    return torch.cat(outs, dim=2).permute(0, 2, 1, 3), st


@pytest.mark.parametrize("d,chunk,strong_decay,initial_state", [
    (64, 32, False, True), (64, 32, True, True), (64, 32, False, False),
    (16, 4, False, True),
])
def test_rwkv6_mma_kernel_arithmetic_holds_the_bf16_bars(d, chunk,
                                                         strong_decay,
                                                         initial_state):
    """The bf16 kernel's precision design, emulated on the CPU (the
    kernel itself runs only on the card): the sub-chunk factoring and the
    hi + lo splits hold chip_smoke.scan_tols' bf16 bars against the plain
    version, the output within 1e-2 of its largest magnitude and the state
    within 5e-4 of max(1, its largest magnitude), with strong decay (w =
    1e-6) too."""
    r, k, v, w, bonus = (torch.from_numpy(a) for a in _rwkv_inputs(
        128, strong_decay, b=1, h=2, d=d, seed=23))
    r, k, v = (a.bfloat16().float() for a in (r, k, v))
    st0 = (torch.from_numpy(np.random.default_rng(24).standard_normal(
        (1, 2, d, d), dtype=np.float32)) if initial_state
        else torch.zeros(1, 2, d, d))
    out, fin = _rwkv6_mma_emulation(r, k, v, w, bonus, chunk, st0)
    want, wfin = ref.rwkv6_scan_ref(r, k, v, w, bonus, state0=st0)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(fin).all())
    assert float((out - want).abs().max()) <= \
        1e-2 * float(want.abs().max())
    assert float((fin - wfin).abs().max()) <= \
        5e-4 * max(1.0, float(wfin.abs().max()))


# ---------------------------------------------------------------------------
# K4: Mamba2 (SSD) scan
# ---------------------------------------------------------------------------


def _mamba_inputs(s, b=2, h=3, p=16, n=8, seed=7):
    """xh, b, c, dt (softplus of a normal) and a_log (non-zero, so that
    the decay is not the same for every head)."""
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((b, s, h, p), dtype=np.float32)
    bm = rng.standard_normal((b, s, n), dtype=np.float32)
    cm = rng.standard_normal((b, s, n), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h), dtype=np.float32)))
    a_log = (0.5 * rng.standard_normal(h, dtype=np.float32))
    return xh, bm, cm, dt, a_log


@pytest.mark.parametrize("s,chunk", [(64, 16), (128, 32), (32, 32)])
def test_mamba2_scan_plain_vs_jax(s, chunk):
    """The sweep of tests/test_kernels.py: against the JAX oracle and the
    Pallas kernel in interpret mode."""
    arrays = _mamba_inputs(s)
    ts = [torch.from_numpy(a) for a in arrays]
    js = [jnp.asarray(a) for a in arrays]
    y, fin = ref.mamba2_scan_ref(*ts, chunk=chunk)
    assert y.shape == (2, s, 3, 16) and fin.shape == (2, 3, 16, 8)
    assert y.dtype == fin.dtype == torch.float32
    for want_y, want_fin in (
            jax_ref.mamba2_scan_ref(*js),
            jax_ops.mamba2_scan(*js, chunk=chunk, interpret=True)):
        assert _abs(y, want_y) < 5e-4
        assert _abs(fin, want_fin) < 5e-4
    before = ops.mamba2_scan.launches
    via_ops = ops.mamba2_scan(*ts, chunk=chunk)
    assert torch.equal(via_ops[0], y) and torch.equal(via_ops[1], fin)
    assert ops.mamba2_scan.launches == before


@pytest.mark.parametrize("s,chunk", [(64, 16), (128, 32)])
def test_mamba2_scan_initial_state_matches_model_chunked_form(s, chunk):
    """With a non-zero initial state, against the JAX model's own chunked
    form (``_ssd_chunked(state0=)``)."""
    arrays = _mamba_inputs(s, seed=3)
    st0 = np.random.default_rng(8).standard_normal((2, 3, 16, 8),
                                                   dtype=np.float32)
    y, fin = ops.mamba2_scan(*(torch.from_numpy(a) for a in arrays),
                             chunk=chunk, state0=torch.from_numpy(st0))
    jy, jfin = jax_ssm._ssd_chunked(*(jnp.asarray(a) for a in arrays),
                                    chunk, jnp.asarray(st0))
    assert _abs(y, jy) < 5e-4
    assert _abs(fin, jfin) < 5e-4


def test_mamba2_scan_state_carries_across_calls():
    """Two calls over the halves, the second starting from the first's
    final state, equal one call over the whole sequence."""
    xh, bm, cm, dt, a_log = (torch.from_numpy(a)
                             for a in _mamba_inputs(64, seed=5))
    y, fin = ops.mamba2_scan(xh, bm, cm, dt, a_log, chunk=16)
    y1, f1 = ops.mamba2_scan(xh[:, :32], bm[:, :32], cm[:, :32], dt[:, :32],
                             a_log, chunk=16)
    y2, f2 = ops.mamba2_scan(xh[:, 32:], bm[:, 32:], cm[:, 32:], dt[:, 32:],
                             a_log, chunk=16, state0=f1)
    assert float((torch.cat([y1, y2], 1) - y).abs().max()) < 1e-5
    assert float((f2 - fin).abs().max()) < 1e-5


def test_mamba2_scan_reads_column_slices_of_the_conv_output():
    """xh, b, c as the model hands them over: column slices of one
    [B, S, H*P + 2N] conv output (row stride H*P + 2N), and bf16 inputs
    give a bf16 output and a float32 state."""
    b, s, h, p, n = 2, 32, 3, 16, 8
    rng = np.random.default_rng(9)
    fused = torch.from_numpy(
        rng.standard_normal((b, s, h * p + 2 * n), dtype=np.float32))
    xh = fused[..., :h * p].view(b, s, h, p)
    bm, cm = fused[..., h * p: h * p + n], fused[..., h * p + n:]
    assert not (xh.is_contiguous() or bm.is_contiguous())
    _, _, _, dt, a_log = (torch.from_numpy(a) for a in _mamba_inputs(s))
    y, fin = ops.mamba2_scan(xh, bm, cm, dt, a_log, chunk=16)
    want, wfin = ref.mamba2_scan_ref(xh.contiguous(), bm.contiguous(),
                                     cm.contiguous(), dt, a_log)
    assert torch.equal(y, want) and torch.equal(fin, wfin)
    yb, finb = ops.mamba2_scan(xh.bfloat16(), bm.bfloat16(), cm.bfloat16(),
                               dt, a_log, chunk=16)
    assert yb.dtype == torch.bfloat16 and finb.dtype == torch.float32
    assert float((yb.float() - want).abs().max()) < \
        2e-2 * float(want.abs().max())


@pytest.mark.parametrize("bad", ["rank", "bc", "dt", "a_log", "state",
                                 "dtype", "chunk"])
def test_mamba2_scan_rejects_bad_arguments(bad):
    xh, bm, dt, a_log = (torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 4),
                         torch.zeros(1, 8, 2), torch.zeros(2))
    args = [xh, bm, bm, dt, a_log]
    kw = {"chunk": 4}
    err = ValueError
    if bad == "rank":
        args[0] = xh[0]
    elif bad == "bc":
        args[2] = torch.zeros(1, 8, 5)
    elif bad == "dt":
        args[3] = torch.zeros(1, 8, 3)
    elif bad == "a_log":
        args[4] = torch.zeros(3)
    elif bad == "state":
        kw["state0"] = torch.zeros(1, 2, 16, 5)
    elif bad == "dtype":
        args[1] = bm.half()
        err = TypeError
    else:
        kw["chunk"] = 3
    with pytest.raises(err):
        ops.mamba2_scan(*args, **kw)


def test_mamba2_model_scan_output_stays_float32_as_in_the_reference():
    """The model's prefill scan (``_ssd_prefill``) on bf16 xh, b, c hands
    a float32 output on, as the reference's ``_ssd_chunked`` keeps it
    into the ``d_skip`` sum: within 1e-4 of its largest magnitude, where
    one bf16 rounding of the output costs up to about 2e-3 of it."""
    from repro_torch.models import ssm as ssm_mod
    xh, bm, cm, dt, a_log = _mamba_inputs(64, seed=19)
    xh, bm, cm = (_bf16_round(a) for a in (xh, bm, cm))
    st0 = np.random.default_rng(20).standard_normal((2, 3, 16, 8),
                                                    dtype=np.float32)
    y, fin = ssm_mod._ssd_prefill(
        *(torch.from_numpy(a).bfloat16() for a in (xh, bm, cm)),
        torch.from_numpy(dt), torch.from_numpy(a_log), 16,
        torch.from_numpy(st0))
    assert y.dtype == torch.float32 and fin.dtype == torch.float32
    jy, jfin = jax_ssm._ssd_chunked(
        *(jnp.asarray(a) for a in (xh, bm, cm, dt, a_log)), 16,
        jnp.asarray(st0))
    assert _abs(y, jy) <= 1e-4 * float(np.abs(np.asarray(jy)).max())
    assert _abs(fin, jfin) < 5e-4


@pytest.mark.parametrize("name", ["rwkv6_scan", "mamba2_scan"])
def test_scan_out_dtype_keeps_the_pallas_contract_by_default(name):
    """``out_dtype=None`` returns the input dtype (the Pallas kernels'
    contract); float32 and bf16 may be asked for, anything else raises."""
    if name == "rwkv6_scan":
        r, k, v, w, bonus = (torch.from_numpy(a)
                             for a in _rwkv_inputs(32, False))
        args = [r.bfloat16(), k.bfloat16(), v.bfloat16(), w, bonus]
    else:
        xh, bm, cm, dt, a_log = (torch.from_numpy(a)
                                 for a in _mamba_inputs(32))
        args = [xh.bfloat16(), bm.bfloat16(), cm.bfloat16(), dt, a_log]
    fn = getattr(ops, name)
    plain = getattr(ref, name + "_ref")
    assert fn(*args, chunk=16)[0].dtype == torch.bfloat16
    out32 = fn(*args, chunk=16, out_dtype=torch.float32)[0]
    assert out32.dtype == torch.float32
    assert torch.equal(out32.bfloat16(), fn(*args, chunk=16)[0])
    assert torch.equal(out32, plain(*args, out_dtype=torch.float32)[0])
    with pytest.raises(TypeError):
        fn(*args, chunk=16, out_dtype=torch.float16)
