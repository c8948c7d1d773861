"""Public wrappers for the CUDA kernels (the counterpart of
``repro.kernels.ops``).

Each wrapper dispatches on where its tensors lie
(``_build.kernel_device``): a CUDA tensor launches the hand-written kernel
(built at first use by ``_build``) or raises; a CPU tensor takes the plain
PyTorch version; a meta tensor runs the wrapper's own checks, output and
scratch allocations and autograd function with no launch, which is what
the dry run (``launch/dryrun.py``) traces to price the card's memory.
There is no switch that forces the plain version on the card.  ``<wrapper>.launches`` counts
kernel launches; :func:`launch_counts` and :func:`reset_launch_counts`
read and zero them all.  A wrapper counts where it launches, so a call
made while a CUDA graph is captured counts a launch that did not run, and
a replay of the graph calls no wrapper: the graph's owner
(``serving/graphs.py``) takes a capture's counts back with
:func:`add_counts` and adds them again at every replay.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import (flash_attention,
                                                  flash_attention_bwd)
from repro_torch.kernels.mamba2_scan import mamba2_scan, mamba2_scan_bwd
from repro_torch.kernels.moe_gemm import moe_gemm, moe_gemm_dw, moe_gemm_dx
from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_bwd

KERNELS = {
    "flash_attention": flash_attention,
    "flash_attention_bwd": flash_attention_bwd,
    "decode_attention": decode_attention,
    "moe_gemm": moe_gemm,
    "moe_gemm_dx": moe_gemm_dx,
    "moe_gemm_dw": moe_gemm_dw,
    "mamba2_scan": mamba2_scan,
    "mamba2_scan_bwd": mamba2_scan_bwd,
    "rwkv6_scan": rwkv6_scan,
    "rwkv6_scan_bwd": rwkv6_scan_bwd,
}

__all__ = ["KERNELS", "decode_attention", "flash_attention",
           "flash_attention_bwd", "mamba2_scan", "mamba2_scan_bwd",
           "moe_gemm", "moe_gemm_dw",
           "moe_gemm_dx", "rwkv6_scan", "rwkv6_scan_bwd", "add_counts",
           "counts",
           "launch_counts", "reset_launch_counts"]


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0 (K3's count of 64-row tile
    launches, its gradients' counts of persistent-kernel launches and K1's
    backward's count of windowed calls too)."""
    for fn in KERNELS.values():
        fn.launches = 0
    moe_gemm.decode_tile_launches = 0
    moe_gemm_dx.tma_launches = moe_gemm_dw.tma_launches = 0
    flash_attention_bwd.window_launches = 0


def counts() -> dict[str, int]:
    """:func:`launch_counts` and K3's 64-row tile launches, as
    ``moe_gemm_decode_tile``."""
    return {**launch_counts(),
            "moe_gemm_decode_tile": moe_gemm.decode_tile_launches}


def add_counts(delta: dict[str, int]) -> None:
    """Add ``delta`` (keyed as :func:`counts`) to the counts."""
    for name, n in delta.items():
        if name == "moe_gemm_decode_tile":
            moe_gemm.decode_tile_launches += n
        else:
            KERNELS[name].launches += n
