"""Prefill attention (GQA + causal + sliding window): CUDA kernel wrapper
and plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py ::
flash_attention``.  The kernel is ``csrc/flash_attention.cu``: one block
per (batch, head, 64-row query tile) loops over the KV tiles with the
online-softmax state in registers, skips tiles above the causal diagonal
or below the window, and reads ``q [B, Sq, H, D]``, ``k [B, Sk, KV, D]``
and ``v [B, Sk, KV, Dv]`` through their strides.  ``Dv`` is ``D`` but for
deepseek-v2's multi-head latent attention, whose prefill attends with
``D = 192`` (128 + 64 rope dims) over ``Dv = 128``; the scale is
``D ** -0.5`` either way, as in the XLA twin of the JAX models (the Pallas
kernel takes one head dim).  On an H100 the function's least
time is set by bytes (about 171 flops per byte at B = 8, S = 512, H = 16,
KV = 8, D = 128 in bf16, against 295 for the card: 0.015 ms).  bf16 runs on
the tensor cores (``mma.sync`` m16n8k16, K and V through a ``cp.async``
ring, p kept in registers); float32 keeps the FMA kernel of the first port
for its 2e-5 bar (see the source note).

Scores and the accumulator are float32 for either input type.  In float32
``p`` stays float32, as in the TPU kernel body; in bf16 the kernel rounds
``p`` to bf16 for the PV product, as the XLA twin in
``repro.models.attention`` does (the plain version below keeps it
float32; ROADMAP H19).  The bf16 kernel reads rows in 16-byte pieces:
an operand whose strides are not multiples of 8 elements is copied first
(``_build.kernel_operand``).

``q_offset`` (an int >= 0, default 0) puts query row i at position
``q_offset + i`` for the causal and window tests, as the XLA twin's
argument does: a lane of a sequence-parallel prefill
(``models/attention.py :: flash_attention_sp``) attends the whole
sequence's keys from its own positions.  The kernel shifts the range of
key tiles it visits and its mask by the offset; at 0 it computes the
bits it computed before the argument existed.

Training: where grad is enabled and an input requires it,
:func:`flash_attention` goes through a ``torch.autograd.Function`` whose
forward also writes each row's log-sum-exp (float32 [B, H, Sq], from the
same kernel; the output's bits are those of a call without it) and whose
backward is the hand-written kernel ``csrc/flash_attention_bwd.cu``.  In
bf16 it is one wgmma pass after FlashAttention-3's, at the head dim rounded
up to 64: a block per (batch, KV head, key tile) streams the query tiles
of the G heads that see its keys and computes dk and dv, and each tile's
dq is summed into a float32 accumulator in ascending key-tile order,
admitted by a counter per query tile, so two calls give the same bits.
Up to D = 128 a key tile is 128 keys, 64 a warpgroup; at D = 256
(gemma3) it is 64 keys whose dk and dv columns the two warpgroups split;
at deepseek-v2's (D, Dv) = (192, 128) it is 64 keys too, with dk's 192
columns on one warpgroup and dv's 128 on the other, each computing s and
dp for half the queries (:func:`bwd_tiles`).  float32 keeps
FlashAttention-2's design (a dk / dv kernel per key tile, a dq kernel per
query tile; no atomics) at D and Dv.  The TPU kernel has no backward: the
JAX models differentiate its XLA twin.  On the CPU both directions take
their plain versions; on the card there is no fallback.  The backward
takes the (D, Dv) pairs of the forward, ``_build.FLASH_HEAD_DIMS``, and
no ``q_offset`` (ROADMAP item 15 part two, H2).  A meta tensor takes the
card's path up to the launch (``_build.kernel_device``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30


def bwd_tiles(d: int, dv: int) -> tuple[int, int]:
    """The bf16 backward's tiles at head dims (``d``, ``dv``): keys of a
    work tile and queries of a streamed tile (csrc/flash_attention_bwd.cu
    :: WG_BC, WG_BR up to D = Dv = 128; CS_BC, WG_BR for the column-split
    kernel of D = 256 and the kv-split kernel of (192, 128))."""
    return (64, 64) if max(d, dv) > 128 else (128, 64)


def _scores(q, k, causal, window, q_offset=0):
    """Float32 masked scores [B, KV, G, Sq, Sk] of the plain versions, and
    the mask [Sq, Sk] (True where a query attends a key; query row i at
    position ``q_offset + i``, key row j at j)."""
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    qr = q.reshape(b, sq, kv, h // kv, d).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qr, k.float()) * d ** -0.5
    qi = q_offset + torch.arange(sq, device=q.device)[:, None]
    ki = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= ki
    if window:
        mask &= qi - ki < window
    return torch.where(mask[None, None, None], s,
                       torch.full_like(s, NEG_INF)), mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, return_lse: bool = False):
    """Plain version: full float32 score matrix, masked with -1e30,
    softmax, product with ``v``.  q: [B, Sq, H, D]; k: [B, Sk, KV, D]; v:
    [B, Sk, KV, Dv]; ``H % KV == 0``; query row i at position ``q_offset +
    i`` for the causal and window tests; returns [B, Sq, H, Dv] in
    ``q.dtype``, and with ``return_lse`` also each row's log-sum-exp of
    its scaled, masked scores, float32 [B, H, Sq]."""
    b, sq, h, _ = q.shape
    s, _ = _scores(q, k, causal, window, q_offset)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    o = o.reshape(b, sq, h, v.shape[-1]).to(q.dtype)
    if not return_lse:
        return o
    return o, torch.logsumexp(s, dim=-1).reshape(b, h, sq)


def flash_attention_bwd_ref(q, k, v, o, dout, lse, *, causal: bool = True,
                            window: int = 0):
    """Plain version of the backward: the same formulas as the kernel with
    a full float32 score matrix.  p = exp(s - lse), dv = sum over the G
    heads of p^T dO, ds = p (dO v^T - rowsum(dO o)) where the mask keeps
    the pair (a masked score is a constant), dq = ds k D^-0.5, dk = sum
    over the G heads of ds^T q D^-0.5.  Shapes as
    :func:`flash_attention_ref`, ``lse`` float32 [B, H, Sq]; returns (dq,
    dk, dv) in the input dtype.  A row that attends no key at all (only
    with a window and Sq > Sk + window) takes p = 1 / Sk, the gradient of
    the plain forward's uniform average over its masked keys, which its
    log-sum-exp cannot express in float32 (the kernel's forward gives such
    a row 0 instead, and its backward no gradient)."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    s, mask = _scores(q, k, causal, window)
    p = torch.where(mask.any(-1, keepdim=True),
                    torch.exp(s - lse.reshape(b, kv, g, sq, 1)),
                    torch.full((), 1.0 / k.shape[1], device=s.device))
    do = dout.reshape(b, sq, kv, g, -1).float()
    delta = (do * o.reshape(b, sq, kv, g, -1).float()).sum(-1)   # [B,Sq,KV,G]
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, do)
    dp = torch.einsum("bqkgd,bskd->bkgqs", do, v.float())
    ds = torch.where(mask, p * (dp - delta.permute(0, 2, 3, 1)[..., None]),
                     torch.zeros((), device=p.device))
    scale = d ** -0.5
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds,
                      q.reshape(b, sq, kv, g, d).float()) * scale
    return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or \
            v.shape[:3] != k.shape[:3]:
        raise ValueError(
            f"expected q [B,Sq,H,D], k [B,Sk,KV,D] and v [B,Sk,KV,Dv], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(
            f"q {tuple(q.shape)} and k {tuple(k.shape)} do not agree on "
            f"batch, head dim or H % KV == 0")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _build.DTYPE_CODE:
        raise TypeError(
            f"q, k, v must share float32 or bfloat16, got {q.dtype}, "
            f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")


def _offset(q_offset) -> int:
    """``q_offset`` as a non-negative Python int."""
    q_offset = int(q_offset)
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    return q_offset


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, return_lse: bool = False):
    """K1's forward without autograd: the output, and with ``return_lse``
    also each row's log-sum-exp (float32 [B, H, Sq], written by the same
    kernel; the output's bits do not change).  The kernel for CUDA
    tensors, :func:`flash_attention_ref` for CPU ones, and for meta
    tensors the wrapper's checks and allocations with no launch; counts
    kernel launches in ``flash_attention.launches``."""
    _check(q, k, v)
    q_offset = _offset(q_offset)
    dev = _build.kernel_device(q, "flash_attention")
    if dev == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, return_lse=return_lse)
    b, sq, h, d = q.shape
    sk, kv, dv = k.shape[1], k.shape[2], v.shape[3]
    if (d, dv) not in _build.FLASH_HEAD_DIMS:
        raise ValueError(f"head dims (D, Dv) = {(d, dv)} not in "
                         f"{_build.FLASH_HEAD_DIMS}")
    if sq < 1 or sk < 1 or window < 0:
        raise ValueError(f"need Sq, Sk >= 1 and window >= 0, got "
                         f"{sq}, {sk}, {window}")
    q, k, v = (_build.kernel_operand(x) for x in (q, k, v))
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if dev == "meta":
        return (out, lse) if return_lse else out
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fate_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None,
            b, sq, sk, h, kv, d, dv,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            int(bool(causal)), int(window), q_offset,
            _build.DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed (code {rc}) for q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype}")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


def bwd_scratch(b: int, h: int, sq: int, d: int, dv: int, dtype, device):
    """The backward kernel's scratch (``fate_flash_attention_bwd``'s
    ``delta``, ``dq_accum`` and ``counters``) at head dims (``d``, ``dv``):
    for the wgmma kernels (bf16), with Sq and D rounded up to the query
    tile and to 64, float32 [2, B, H, Sq_pad] (delta, then lse log2 e),
    the float32 dq accumulator [B, H, Sq_pad, D_pad] (dq is D wide) and
    int32 counters (one per query tile and head, then the work counter); in
    float32 delta [B, H, Sq] alone."""
    f32 = dict(dtype=torch.float32, device=device)
    if dtype != torch.bfloat16:
        return torch.empty((b, h, sq), **f32), None, None
    query_tile = bwd_tiles(d, dv)[1]
    n_qt = -(-sq // query_tile)
    sq_pad = n_qt * query_tile
    return (torch.empty((2, b, h, sq_pad), **f32),
            torch.empty((b, h, sq_pad, -(-d // 64) * 64), **f32),
            torch.empty(b * h * n_qt + 1, dtype=torch.int32, device=device))


def _dense16(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous at a 16-byte aligned address (the backward's
    layout), copied if it is not."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def flash_attention_bwd(q, k, v, o, dout, lse, *, causal: bool = True,
                        window: int = 0):
    """Gradients (dq, dk, dv) of :func:`flash_attention` at ``dout``, from
    the forward's inputs, output ``o`` and log-sum-exp ``lse`` (float32
    [B, H, Sq]).  (D, Dv) must be one of ``_build.FLASH_HEAD_DIMS``.

    A CUDA tensor goes through the kernel (``csrc/flash_attention_bwd.cu``,
    built at first use) or raises; :func:`flash_attention_bwd_ref` is
    taken only for tensors that lie on the CPU.
    ``flash_attention_bwd.launches`` counts kernel calls (each launches
    three kernels: the pre-pass, then a wgmma pass and the dq pass, or
    the dk / dv kernel and the dq kernel), and ``.window_launches`` those
    of them under a sliding window.  The scratch
    (:func:`bwd_scratch`) is allocated here.
    """
    _check(q, k, v)
    b, sq, h, _ = q.shape
    if o.shape != (b, sq, h, v.shape[3]) or dout.shape != o.shape or \
            lse.shape != (b, h, sq):
        raise ValueError(
            f"expected o, dout {(b, sq, h, v.shape[3])} and lse "
            f"{(b, h, sq)}, got {tuple(o.shape)}, {tuple(dout.shape)}, "
            f"{tuple(lse.shape)}")
    dev = _build.kernel_device(q, "flash_attention_bwd")
    if dev == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, dout, lse, causal=causal,
                                       window=window)
    d, sk, kv, dv = q.shape[3], k.shape[1], k.shape[2], v.shape[3]
    if (d, dv) not in _build.FLASH_HEAD_DIMS:
        raise ValueError(f"head dims (D, Dv) = {(d, dv)} not in "
                         f"{_build.FLASH_HEAD_DIMS}")
    q, k, v, o, dout = (_dense16(x.to(q.dtype)) for x in (q, k, v, o, dout))
    lse = _dense16(lse.float())
    delta, dq_accum, counters = bwd_scratch(b, h, sq, d, dv, q.dtype,
                                            q.device)
    dq, dk, dvv = (torch.empty_like(x) for x in (q, k, v))
    if dev == "meta":
        return dq, dk, dvv
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fate_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            None if dq_accum is None else dq_accum.data_ptr(),
            None if counters is None else counters.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dvv.data_ptr(), b, sq, sk, h, kv,
            d, dv, int(bool(causal)), int(window),
            _build.DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention_bwd kernel launch failed (code {rc}) for q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype}")
    flash_attention_bwd.launches += 1
    if window:
        flash_attention_bwd.window_launches += 1
    return dq, dk, dvv


class _FlashAttention(torch.autograd.Function):
    """K1 with a gradient: the forward saves q, k, v, o and the rows'
    log-sum-exp; the backward is :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse,
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q: [B, Sq, H, D]; k: [B, Sk, KV, D]; v: [B, Sk, KV, Dv]; returns
    [B, Sq, H, Dv].  (D, Dv) must be one of ``_build.FLASH_HEAD_DIMS``.
    Query row i sits at position ``q_offset + i`` (an int >= 0), key row
    j at j, for the causal test ``q_pos >= k_pos`` and the window's
    ``q_pos - k_pos < window``.

    A CUDA tensor goes through the kernel (which is built at first use)
    or raises; the plain version is taken only for tensors that lie on
    the CPU.  ``flash_attention.launches`` counts kernel launches.  Where
    grad is enabled and an input requires it, the call is differentiable:
    the forward also writes the rows' log-sum-exp and the backward is
    :func:`flash_attention_bwd` (its kernel on the card, its plain version
    on the CPU).  K1's backward takes no ``q_offset``: under grad a
    ``q_offset != 0`` differentiates the plain version on the CPU and
    raises ``NotImplementedError`` on the card (and on meta tensors,
    which stand for the card's).
    """
    _check(q, k, v)
    q_offset = _offset(q_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if not q_offset:
            return _FlashAttention.apply(q, k, v, causal, window)
        if q.device.type == "cpu":
            return flash_attention_ref(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset)
        _build.refuse_grad(
            "flash_attention with q_offset != 0 (a sequence-parallel "
            "prefill lane); K1b takes no q_offset yet (ROADMAP item 15 "
            "part two, H2)", q, k, v)
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)


flash_attention.launches = 0
flash_attention_bwd.launches = 0
flash_attention_bwd.window_launches = 0
