"""PyTorch / CUDA port of the FATE reproduction (NVIDIA Hopper).

The package mirrors the layout of the JAX package ``repro`` module for
module, imports ``torch``, ``numpy``, ``scipy`` and the standard library
only, and runs on the GPU unless a caller asks for ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises if a CUDA device is
    asked for (the default everywhere in this package) and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions on the CPU")
    return dev
