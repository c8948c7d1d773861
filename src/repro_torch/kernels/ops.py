"""Public wrappers for the CUDA kernels (the counterpart of
``repro.kernels.ops``).

Each wrapper dispatches on where its tensors lie: a CUDA tensor launches
the hand-written kernel (built at first use by ``_build``) or raises; a
CPU tensor takes the plain PyTorch version.  There is no switch that
forces the plain version on the card.  ``<wrapper>.launches`` counts
kernel launches; :func:`launch_counts` and :func:`reset_launch_counts`
read and zero them all.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.moe_gemm import moe_gemm
from repro_torch.kernels.rwkv6_scan import rwkv6_scan

KERNELS = {
    "flash_attention": flash_attention,
    "decode_attention": decode_attention,
    "moe_gemm": moe_gemm,
    "rwkv6_scan": rwkv6_scan,
}

__all__ = ["KERNELS", "decode_attention", "flash_attention", "moe_gemm",
           "rwkv6_scan", "launch_counts", "reset_launch_counts"]


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0
