"""Public wrappers for the CUDA kernels (the counterpart of
``repro.kernels.ops``).

Each wrapper dispatches on where its tensors lie
(``_build.kernel_device``): a CUDA tensor launches the hand-written kernel
(built at first use by ``_build``) or raises; a CPU tensor takes the plain
PyTorch version; a meta tensor runs the wrapper's own checks, output and
scratch allocations and autograd function with no launch, which is what
the dry run (``launch/dryrun.py``) traces to price the card's memory.
There is no switch that forces the plain version on the card.  ``<wrapper>.launches`` counts
kernel launches, and ``SUB_COUNTS`` names the counts of some of them that
a wrapper keeps beside it; :func:`counts` reads them all and
:func:`reset_launch_counts` zeroes them.  A wrapper counts where it
launches, so a call made while a CUDA graph is captured counts a launch
that did not run, and a replay of the graph calls no wrapper: the graph's
owner (``serving/graphs.py``, ``training/graphs.py``) takes a capture's
counts back with :func:`add_counts` and adds them again at every replay.
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
           "moe_gemm_dx", "rwkv6_scan", "rwkv6_scan_bwd", "SUB_COUNTS",
           "add_counts", "counts",
           "launch_counts", "reset_launch_counts"]


# counts a wrapper keeps of some of its launches, keyed as :func:`counts`
# gives them: (wrapper, attribute)
SUB_COUNTS = {
    # K3's launches on its 64-row tile
    "moe_gemm_decode_tile": (moe_gemm, "decode_tile_launches"),
    # K1's backward calls under a sliding window
    "flash_attention_bwd_window": (flash_attention_bwd, "window_launches"),
    # K3's gradients' launches of the persistent TMA kernel
    "moe_gemm_dx_tma": (moe_gemm_dx, "tma_launches"),
    "moe_gemm_dw_tma": (moe_gemm_dw, "tma_launches"),
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    """Set every count of :func:`counts` to 0."""
    for fn in KERNELS.values():
        fn.launches = 0
    for fn, attr in SUB_COUNTS.values():
        setattr(fn, attr, 0)


def counts() -> dict[str, int]:
    """:func:`launch_counts` and the ``SUB_COUNTS``."""
    return {**launch_counts(),
            **{name: getattr(fn, attr)
               for name, (fn, attr) in SUB_COUNTS.items()}}


def add_counts(delta: dict[str, int]) -> None:
    """Add ``delta`` (keyed as :func:`counts`) to the counts."""
    for name, n in delta.items():
        fn, attr = SUB_COUNTS.get(name) or (KERNELS[name], "launches")
        setattr(fn, attr, getattr(fn, attr) + n)
