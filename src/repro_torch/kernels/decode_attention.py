"""Decode attention (one token against a static KV cache): CUDA kernel
wrapper and plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/decode_attention.py ::
decode_attention``.  The kernel is ``csrc/decode_attention.cu``.  It is
bound by bytes: each valid cache row is read once, through the
``[B, S, KV, D]`` strides, for ``4 G D`` flops, and rows at or beyond
``cache_len`` are never read.  :func:`split_plan` spreads the cache's S
rows over ``nsplit x KV x B`` blocks, so that about one block runs on each
of the card's SMs (no split where ``B x KV`` already fills them).

bf16 (the served type) runs on the tensor cores in ONE launch: the G
query heads of a KV head, padded to 16 rows, are the A operand of
``mma.sync`` products with K and V tiles that each warp streams through
its own ``cp.async`` ring; the warps merge in shared memory, and where
``nsplit > 1`` the last block of a (batch, KV head) to arrive combines
the float32 partials in split order (an atomic ticket per pair says which
block is last; it is handed back at 0).  p is rounded to bf16 for P V, as
the JAX model rounds it (ROADMAP H20).  float32 keeps the FMA kernels of
the first port (a partial pass and a combine pass) for the 2e-5 bar.

``cache_len`` is a Python int or, as the Pallas kernel's ``lens`` operand,
a one-element int32 tensor on the device of ``q`` that the kernel reads
when it runs: a captured CUDA graph replays one call while the length
grows.  The grid is planned from S, never from the length, so both forms
launch the same blocks and give the same bits; a block whose rows start at
or past the length reads none and leaves an empty partial.  An int is
checked against ``[1, S]``; a device length is trusted (the kernel clamps
it to S), and nothing is read back to the host.

There is no ``window`` argument, as the Pallas kernel has none: a sliding
window's cache is a ring whose valid rows are its first
``min(pos + 1, S)`` (``models.attention.decode_index``), in another
order than the positions, which the softmax does not see.

The scratch (partials and tickets) is one pair of buffers per device,
allocated before any capture and grown only outside one: calls on a
device run in order on one stream (the serving engine's eager calls and
its graph replays share it).  An outgrown pair is kept, since a captured
graph may still write into it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30

MAX_GROUP = 16          # query heads per KV head the kernel takes
TILE_ROWS = 16          # cache rows per tile of one warp (bf16 kernel)
BLOCK_ROWS = 64         # one tile for each of a block's 4 warps
TARGET_BLOCKS = 132     # one block for each of the card's SMs (and at most
                        # the 132 splits the bf16 kernel combines)

# device -> (float32 partials, int32 tickets), grown on demand
_scratch: dict = {}
_outgrown: list = []    # earlier pairs, which captured graphs may hold


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len) -> torch.Tensor:
    """Plain version: float32 scores over the whole cache, positions
    ``>= cache_len`` (an int or a one-element integer tensor) masked with
    -1e30, softmax, product with the values.  q: [B, 1, H, D]; caches:
    [B, S, KV, D]; returns [B, 1, H, D]."""
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
    """(chunk, nsplit): rows per block and blocks per (batch, KV head),
    for ``cache_len`` rows (the wrapper passes the cache's row count S).

    No split where ``batch_kv`` blocks reach ``TARGET_BLOCKS``; below
    that, about ``TARGET_BLOCKS`` blocks in all, in chunks that are whole
    tiles of ``TILE_ROWS`` rows and at least ``BLOCK_ROWS`` long (a tile
    for every warp), and such that every split starts below
    ``cache_len``.
    """
    want = max(1, TARGET_BLOCKS // max(1, batch_kv))
    chunk = -(-cache_len // want)
    chunk = max(BLOCK_ROWS, -(-chunk // TILE_ROWS) * TILE_ROWS)
    nsplit = -(-cache_len // chunk)
    return chunk, nsplit


def _scratch_for(device: torch.device, n_part: int,
                 n_pairs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Float32 partials of at least ``n_part`` elements and ``n_pairs``
    int32 tickets, zeroed once at allocation (the kernel hands every
    ticket back at 0), kept for later calls on the device.  Raises where
    they would have to grow inside a CUDA graph capture."""
    part, tickets = _scratch.get(device, (None, None))
    if part is not None and part.numel() >= n_part \
            and tickets.numel() >= n_pairs:
        return part, tickets
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "decode_attention's scratch is too small for this call and "
            "cannot be allocated inside a CUDA graph capture: make the "
            "same call once before capturing")
    if part is not None:
        _outgrown.append((part, tickets))
        n_part = max(n_part, part.numel())
        n_pairs = max(n_pairs, tickets.numel())
    part = torch.empty(n_part, dtype=torch.float32, device=device)
    tickets = torch.zeros(n_pairs, dtype=torch.int32, device=device)
    _scratch[device] = (part, tickets)
    return part, tickets


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len) -> torch.Tensor:
    """q: [B, 1, H, D]; caches: [B, S, KV, D] -> [B, 1, H, D];
    ``cache_len``: a Python int in ``[1, S]`` or a one-element int32
    tensor on the device of ``q`` (see the module's note).

    A CUDA tensor goes through the kernel (which is built at first use) or
    raises; the plain version is taken only for tensors that lie on the
    CPU.  With grad enabled and an input that requires it, a CUDA call
    raises ``NotImplementedError``: there is no backward kernel (autograd
    runs through the plain version on the CPU).
    ``decode_attention.launches`` counts calls that launched the kernel
    (the float32 path's two passes count as one).
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
    on_device = isinstance(cache_len, torch.Tensor)
    if on_device:
        if cache_len.dtype != torch.int32 or cache_len.numel() != 1 \
                or cache_len.device != q.device:
            raise ValueError(
                f"a cache_len tensor must hold one int32 on {q.device}, "
                f"got {cache_len.dtype} {tuple(cache_len.shape)} on "
                f"{cache_len.device}")
    else:
        cache_len = int(cache_len)
        if not 1 <= cache_len <= s:
            raise ValueError(f"cache_len {cache_len} outside [1, {s}]")
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, cache_len)
    if q.device.type != "cuda":
        raise RuntimeError(f"no decode_attention kernel for {q.device}")
    _build.refuse_grad("decode_attention; a decode step is never trained "
                       "(ROADMAP item 14 trains through flash_attention, "
                       "whose backward is K1's)", q, k_cache, v_cache)
    g = h // kv
    if d not in _build.DECODE_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {_build.DECODE_HEAD_DIMS}")
    if g > MAX_GROUP:
        raise ValueError(f"{g} query heads per KV head; the kernel takes "
                         f"at most {MAX_GROUP}")
    q = _build.kernel_operand(q)
    k_cache = _build.kernel_operand(k_cache)
    v_cache = _build.kernel_operand(v_cache)
    chunk, nsplit = split_plan(s, b * kv)
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        n_ml = b * kv * nsplit * g
        part, tickets = _scratch_for(q.device, n_ml * (d + 2), b * kv)
        acc_ptr = part.data_ptr()
        m_ptr = acc_ptr + 4 * n_ml * d
        rc = lib.fate_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), acc_ptr, m_ptr, m_ptr + 4 * n_ml,
            tickets.data_ptr(), b, h, kv, d, s,
            cache_len.data_ptr() if on_device else None,
            0 if on_device else cache_len, chunk, nsplit,
            q.stride(0), q.stride(2),
            k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
            v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
            out.stride(0), out.stride(2),
            _build.DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"decode_attention kernel launch failed (code {rc}) for q "
            f"{tuple(q.shape)}, cache {tuple(k_cache.shape)}, "
            f"cache_len {'on the device' if on_device else cache_len}, "
            f"{q.dtype}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
