"""Plain PyTorch versions of every ported kernel (the allclose targets;
the counterpart of ``repro.kernels.ref``).

Deliberately simple O(S^2), unfused implementations: no tiling, no online
softmax.  Each lives in its kernel's own module and is re-exported here.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import decode_attention_ref
from repro_torch.kernels.flash_attention import flash_attention_ref

__all__ = ["decode_attention_ref", "flash_attention_ref"]
