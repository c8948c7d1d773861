"""Grouped per-expert GEMM of the MoE FFN: CUDA kernel wrapper and plain
PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/moe_gemm.py :: moe_gemm``
(``x [E, C, D] @ w [E, D, F] -> [E, C, F]``, float32 accumulation, cast to
``x.dtype``).  The kernel is ``csrc/moe_gemm.cu``.  Besides that form it
takes the MoE layer's batched operand ``x [B, E, C, D]`` directly: the
``(b, c)`` rows of one expert form one row range read through the batch
stride, so each block loads its slice of the expert's weights once for
all samples, and strided views (the layer's dispatch buffer minus its
dropped-token slot) are read in place.  At decode the function is bound by
the bytes of the expert weights, at prefill it sits near the card's bf16
ridge; this first version runs float32 FMAs on the CUDA cores (see the
source note and ``PERF.md``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def moe_gemm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: the float32 einsum of the reference.  x: [E, C, D]
    or [B, E, C, D]; w: [E, D, F]; returns [..., E, C, F] in ``x.dtype``."""
    return torch.einsum("...ecd,edf->...ecf", x.float(),
                        w.float()).to(x.dtype)


def _check(x, w):
    if x.dim() not in (3, 4) or w.dim() != 3:
        raise ValueError(
            f"expected x [E,C,D] or [B,E,C,D] and w [E,D,F], got "
            f"{tuple(x.shape)}, {tuple(w.shape)}")
    if x.shape[-3] != w.shape[0] or x.shape[-1] != w.shape[1]:
        raise ValueError(
            f"x {tuple(x.shape)} and w {tuple(w.shape)} do not agree on the "
            f"expert count or the contraction dim")
    if x.dtype != w.dtype or x.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"x and w must share float32 or bfloat16, got "
                        f"{x.dtype}, {w.dtype}")
    if x.device != w.device:
        raise ValueError("x and w must lie on one device")
    if min(x.shape) < 1 or min(w.shape) < 1:
        raise ValueError(f"empty operand: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")


def moe_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [E, C, D] or [B, E, C, D]; w: [E, D, F] -> [..., E, C, F].

    A CUDA tensor goes through the kernel (which is built at first use)
    or raises; the plain version is taken only for tensors that lie on
    the CPU.  ``moe_gemm.launches`` counts kernel launches.
    """
    _check(x, w)
    if x.device.type == "cpu":
        return moe_gemm_ref(x, w)
    if x.device.type != "cuda":
        raise RuntimeError(f"no moe_gemm kernel for {x.device}")
    x4 = x if x.dim() == 4 else x.unsqueeze(0)
    b, e, c, d = x4.shape
    f = w.shape[2]
    if b * c >= 2 ** 31 or e > 65535:
        raise ValueError(f"x {tuple(x.shape)} exceeds the kernel's grid")
    out = torch.empty((b, e, c, f), dtype=x.dtype, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fate_moe_gemm(
            x4.data_ptr(), w.data_ptr(), out.data_ptr(), b, e, c, d, f,
            *x4.stride(), *w.stride(), *out.stride()[:3],
            _build.DTYPE_CODE[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"moe_gemm kernel launch failed (code {rc}) for x "
            f"{tuple(x.shape)}, w {tuple(w.shape)}, {x.dtype}")
    moe_gemm.launches += 1
    return out if x.dim() == 4 else out[0]


moe_gemm.launches = 0
