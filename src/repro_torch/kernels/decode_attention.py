"""Decode attention (one token against a static KV cache): CUDA kernel
wrapper and plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/decode_attention.py ::
decode_attention``.  The kernel is ``csrc/decode_attention.cu``: the valid
part of the cache is split across blocks (``nsplit x KV x B``), each block
runs the online softmax over its rows for all ``G`` query heads of its KV
head and writes a partial ``(m, l, acc)``, and a second small kernel
combines the partials.  It is bound by bytes (each cache row is read once,
through the ``[B, S, KV, D]`` strides, and rows at or beyond ``cache_len``
are never read); the split spreads the reads over the card's SMs (see the
source note).

``cache_len`` is a Python int: the serving engine knows it on the host,
and nothing is read back from the device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30

MAX_GROUP = 16          # query heads per KV head the kernel takes
TILE_ROWS = 32          # cache rows per tile inside a block
TARGET_BLOCKS = 264     # two blocks for each of the card's 132 SMs


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         cache_len: int) -> torch.Tensor:
    """Plain version: float32 scores over the whole cache, positions
    ``>= cache_len`` masked with -1e30, softmax, product with the values.
    q: [B, 1, H, D]; caches: [B, S, KV, D]; returns [B, 1, H, D]."""
    b, _, h, d = q.shape
    _, s, kv, _ = k_cache.shape
    g = h // kv
    qr = q.reshape(b, kv, g, d).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qr, k_cache.float()) * d ** -0.5
    valid = torch.arange(s, device=q.device) < cache_len
    scores = torch.where(valid[None, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return o.reshape(b, 1, h, d).to(q.dtype)


def split_plan(cache_len: int, batch_kv: int) -> tuple[int, int]:
    """(chunk, nsplit): rows per block and blocks per (batch, KV head).

    Enough splits to reach about ``TARGET_BLOCKS`` blocks in all, in
    chunks that are whole tiles of ``TILE_ROWS`` rows and at least two
    tiles long, and such that every split starts below ``cache_len``.
    """
    want = max(1, TARGET_BLOCKS // max(1, batch_kv))
    chunk = -(-cache_len // want)
    chunk = max(2 * TILE_ROWS, -(-chunk // TILE_ROWS) * TILE_ROWS)
    nsplit = -(-cache_len // chunk)
    return chunk, nsplit


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int) -> torch.Tensor:
    """q: [B, 1, H, D]; caches: [B, S, KV, D] -> [B, 1, H, D].

    A CUDA tensor goes through the kernel (which is built at first use)
    or raises; the plain version is taken only for tensors that lie on
    the CPU.  ``decode_attention.launches`` counts calls that launched
    the kernel (its two passes count as one).
    """
    if q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4 \
            or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"expected q [B,1,H,D] and caches [B,S,KV,D], got "
            f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
            f"{tuple(v_cache.shape)}")
    b, _, h, d = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != b or k_cache.shape[3] != d or h % kv:
        raise ValueError(
            f"q {tuple(q.shape)} and cache {tuple(k_cache.shape)} do not "
            f"agree on batch, head dim or H % KV == 0")
    if not (q.dtype == k_cache.dtype == v_cache.dtype) \
            or q.dtype not in _build.DTYPE_CODE:
        raise TypeError(
            f"q and caches must share float32 or bfloat16, got {q.dtype}, "
            f"{k_cache.dtype}, {v_cache.dtype}")
    if not (q.device == k_cache.device == v_cache.device):
        raise ValueError("q and caches must lie on one device")
    cache_len = int(cache_len)
    if not 1 <= cache_len <= s:
        raise ValueError(f"cache_len {cache_len} outside [1, {s}]")
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, cache_len)
    if q.device.type != "cuda":
        raise RuntimeError(f"no decode_attention kernel for {q.device}")
    g = h // kv
    if d not in _build.HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {_build.HEAD_DIMS}")
    if g > MAX_GROUP:
        raise ValueError(f"{g} query heads per KV head; the kernel takes "
                         f"at most {MAX_GROUP}")
    q = _build.kernel_operand(q)
    k_cache = _build.kernel_operand(k_cache)
    v_cache = _build.kernel_operand(v_cache)
    chunk, nsplit = split_plan(cache_len, b * kv)
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    part_acc = torch.empty((b, kv, nsplit, g, d), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((2, b, kv, nsplit, g), dtype=torch.float32,
                          device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fate_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), part_acc.data_ptr(), part_ml[0].data_ptr(),
            part_ml[1].data_ptr(),
            b, h, kv, d, cache_len, chunk, nsplit,
            q.stride(0), q.stride(2),
            k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
            v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
            out.stride(0), out.stride(2),
            _build.DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"decode_attention kernel launch failed (code {rc}) for q "
            f"{tuple(q.shape)}, cache {tuple(k_cache.shape)}, "
            f"cache_len {cache_len}, {q.dtype}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
