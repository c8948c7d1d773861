"""Plain PyTorch versions of every ported kernel (the allclose targets;
the counterpart of ``repro.kernels.ref``).

Deliberately simple implementations: O(S^2) attention with no tiling and
no online softmax (and its backward from a full score matrix), one
float32 einsum for the grouped GEMM and for each of its gradients, the
Mamba2 and RWKV6 recurrences step by step (and their reverse
recurrences; ``mamba2_scan_plain`` and ``rwkv6_scan_plain`` take both
under autograd).  Each lives
in its kernel's own module and is re-exported here.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import decode_attention_ref
from repro_torch.kernels.flash_attention import (flash_attention_bwd_ref,
                                                  flash_attention_ref)
from repro_torch.kernels.mamba2_scan import (mamba2_scan_bwd_ref,
                                              mamba2_scan_plain,
                                              mamba2_scan_ref)
from repro_torch.kernels.moe_gemm import (moe_gemm_dw_ref, moe_gemm_dx_ref,
                                          moe_gemm_ref)
from repro_torch.kernels.rwkv6_scan import (rwkv6_scan_bwd_ref,
                                             rwkv6_scan_plain,
                                             rwkv6_scan_ref)

__all__ = ["decode_attention_ref", "flash_attention_bwd_ref",
           "flash_attention_ref", "mamba2_scan_bwd_ref",
           "mamba2_scan_plain", "mamba2_scan_ref",
           "moe_gemm_dw_ref", "moe_gemm_dx_ref", "moe_gemm_ref",
           "rwkv6_scan_bwd_ref", "rwkv6_scan_plain", "rwkv6_scan_ref"]
