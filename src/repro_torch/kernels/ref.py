"""Plain PyTorch versions of every ported kernel (the allclose targets;
the counterpart of ``repro.kernels.ref``).

Deliberately simple implementations: O(S^2) attention with no tiling and
no online softmax, one float32 einsum for the grouped GEMM, the RWKV6
recurrence step by step.  Each lives in its kernel's own module and is
re-exported here.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import decode_attention_ref
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.moe_gemm import moe_gemm_ref
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_ref

__all__ = ["decode_attention_ref", "flash_attention_ref", "moe_gemm_ref",
           "rwkv6_scan_ref"]
