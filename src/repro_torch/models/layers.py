"""Core PyTorch building blocks shared by every architecture.

Params are plain nested dicts of tensors, with the same keys and shapes
as the JAX package's trees (``repro.models.layers``), so a converted tree
lines up leaf for leaf.  Every parameter is declared once as a
:class:`ParamDef` carrying its shape, dtype and sharding spec.

The sharding atoms (``FSDP``, ``TP``) are kept so that ``ParamDef.spec``
reads as in the reference; on one card nothing acts on them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

FSDP = "data"      # weight in-feature sharding axis
TP = "model"       # tensor/expert-parallel axis

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype for a config's dtype string."""
    return DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    spec: tuple[Any, ...]            # sharding entries (FSDP, TP or None)
    dtype: str = "bfloat16"
    init: str = "normal"             # normal | zeros | ones | small
    fan_in_axes: tuple[int, ...] = (-2,)


ParamTree = Any     # nested dict of ParamDef / tensors


def tree_map_defs(fn: Callable[[ParamDef], Any], defs: ParamTree) -> ParamTree:
    """Map ``fn`` over the ParamDef leaves of a nested dict."""
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: tree_map_defs(fn, v) for k, v in defs.items()}


def init_params(defs: ParamTree, generator: torch.Generator,
                device) -> ParamTree:
    """Concrete parameters drawn from ``generator`` (which must live on
    ``device``), leaf by leaf in sorted-key order: normal / sqrt(fan_in),
    zeros or ones, as the ParamDef says."""
    def draw(d: ParamDef) -> torch.Tensor:
        dt = torch_dtype(d.dtype)
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=device)
        fan_in = 1
        for ax in d.fan_in_axes:
            fan_in *= d.shape[ax]
        scale = 1.0 / math.sqrt(max(fan_in, 1))
        if d.init == "small":
            scale *= 0.1
        x = torch.randn(d.shape, generator=generator, device=device,
                        dtype=torch.float32)
        return x.mul_(scale).to(dt)

    def walk(node):
        if isinstance(node, ParamDef):
            return draw(node)
        return {k: walk(node[k]) for k in sorted(node)}

    return walk(defs)


# ---------------------------------------------------------------------------
# Primitive ops
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32 with weight ``1 + gamma``, cast back."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + gamma.float())).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S].  Rotates
    the two halves of D (not interleaved pairs); angles in float32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # [D/2]
    angles = positions[..., None].float() * freqs          # [..., S, D/2]
    angles = angles[..., None, :]                          # [..., S, 1, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """``silu`` in float32, cast to ``x.dtype``, THEN times ``u``."""
    g = x @ w_gate
    u = x @ w_up
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return h @ w_down


def ffn_defs(d_model: int, d_ff: int, dtype: str) -> dict:
    return {
        "gate": ParamDef((d_model, d_ff), (FSDP, TP), dtype),
        "up": ParamDef((d_model, d_ff), (FSDP, TP), dtype),
        "down": ParamDef((d_ff, d_model), (TP, FSDP), dtype),
    }


def apply_ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    return swiglu(x, p["gate"], p["up"], p["down"])


def norm_defs(d_model: int, dtype: str = "float32") -> ParamDef:
    return ParamDef((d_model,), (None,), dtype, init="zeros")


def embed_defs(vocab: int, d_model: int, dtype: str) -> ParamDef:
    return ParamDef((vocab, d_model), (TP, FSDP), dtype, fan_in_axes=(-1,))


def unembed_logits(x: torch.Tensor, w_embed_or_head: torch.Tensor,
                   transpose: bool) -> torch.Tensor:
    if transpose:      # tied: w is [vocab, d]
        return x @ w_embed_or_head.T
    return x @ w_embed_or_head


def stack_defs(defs: ParamTree, n: int, axis_spec: Any = None) -> ParamTree:
    """Stack per-layer ParamDefs along a leading layer axis.  Fan-in axes
    keep pointing at the same dimensions of the per-layer shape (a
    non-negative axis moves up by one)."""
    def s(d: ParamDef) -> ParamDef:
        fan = tuple(a + 1 if a >= 0 else a for a in d.fan_in_axes)
        return ParamDef((n,) + d.shape, (axis_spec,) + d.spec, d.dtype,
                        d.init, fan)
    return tree_map_defs(s, defs)
