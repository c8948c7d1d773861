"""Gradient compression with error feedback (the counterpart of
``repro.training.compression``).

int8 block quantisation (blocks of ``BLOCK`` values, one float32 scale
each) and a compressor that keeps the quantisation residual and adds it
back at the next call (Karimireddy et al., 2019).  ``torch.round`` rounds
half to even, as ``jnp.round`` does, so the roundtrip gives the
reference's bits.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.training.tree import tree_map, tree_unzip

BLOCK = 256


def _quantize_leaf(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    flat = g.float().reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-12)),
                    -127, 127).to(torch.int8)
    return q, scale


def _dequantize_leaf(q: torch.Tensor, scale: torch.Tensor,
                     shape: tuple) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    return (q.float() * scale).reshape(-1)[:n].reshape(shape)


def compress_roundtrip(g: torch.Tensor) -> torch.Tensor:
    """Quantise and dequantise one leaf (what the wire would carry)."""
    q, scale = _quantize_leaf(g)
    return _dequantize_leaf(q, scale, g.shape).to(g.dtype)


def make_error_feedback_compressor():
    """Returns (compress_fn, init_state): grads_hat, new_err =
    compress(grads, err), the roundtrip of grads + err and its residual."""

    def init_state(params: Any) -> Any:
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    def compress(grads: Any, err: Any) -> tuple[Any, Any]:
        def one(g, e):
            corrected = g.float() + e
            ghat = compress_roundtrip(corrected)
            return ghat.to(g.dtype), corrected - ghat

        return tree_unzip(tree_map(one, grads, err), 2)

    return compress, init_state
