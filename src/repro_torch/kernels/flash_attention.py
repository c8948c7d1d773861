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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """Plain version: full float32 score matrix, masked with -1e30,
    softmax, product with ``v``.  q: [B, Sq, H, D]; k: [B, Sk, KV, D]; v:
    [B, Sk, KV, Dv]; ``H % KV == 0``; returns [B, Sq, H, Dv] in
    ``q.dtype``."""
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    dv = v.shape[-1]
    g = h // kv
    qr = q.reshape(b, sq, kv, g, d).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qr, k.float()) * d ** -0.5
    qi = torch.arange(sq, device=q.device)[:, None]
    ki = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= ki
    if window:
        mask &= qi - ki < window
    s = torch.where(mask[None, None, None], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(b, sq, h, dv).to(q.dtype)


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B, Sq, H, D]; k: [B, Sk, KV, D]; v: [B, Sk, KV, Dv]; returns
    [B, Sq, H, Dv].  (D, Dv) must be one of ``_build.FLASH_HEAD_DIMS``.

    A CUDA tensor goes through the kernel (which is built at first use)
    or raises; the plain version is taken only for tensors that lie on
    the CPU.  ``flash_attention.launches`` counts kernel launches.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise RuntimeError(f"no flash_attention kernel for {q.device}")
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
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fate_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, sk, h, kv, d, dv,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            int(bool(causal)), int(window), _build.DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed (code {rc}) for q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
