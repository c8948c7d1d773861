"""Core PyTorch building blocks shared by every architecture.

Params are plain nested dicts of tensors, with the same keys and shapes
as the JAX package's trees (``repro.models.layers``), so a converted tree
lines up leaf for leaf.  Every parameter is declared once as a
:class:`ParamDef` carrying its shape, dtype and sharding spec; the same
declaration tree gives concrete parameters (:func:`init_params`), meta
tensors that take no memory (:func:`abstract_params`, for the dry run)
or the spec tree (:func:`param_specs`).

Sharding convention (mesh axes named ``pod``/``data``/``model``), as in
the reference: batch and token dims on ``DP`` (``("pod", "data")`` on
the multi-pod mesh, ``("data",)`` on the single-pod one), weight
in-features on ``FSDP``, out-features, heads, experts and vocab on
``TP``.  ``launch.mesh`` turns a spec into ``torch.distributed``
placements over a ``DeviceMesh`` (:func:`spec_placements`); on one card,
with no axis environment set, nothing acts on the specs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

DP = "__dp__"      # data-parallel composite axis placeholder
FSDP = "data"      # weight in-feature sharding axis
TP = "model"       # tensor/expert-parallel axis

# Active mesh-axis environment: None (one card, the tests) or {"dp": the
# axes DP stands for, "mesh": the DeviceMesh}.  Set by
# ``repro_torch.launch.mesh.use_mesh``.
_AXIS_ENV: dict | None = None


def set_axis_env(env: dict | None) -> None:
    global _AXIS_ENV
    _AXIS_ENV = env


def get_axis_env() -> dict | None:
    return _AXIS_ENV


def resolve_spec(spec: tuple) -> tuple | None:
    """``spec`` with ``DP`` replaced by the active environment's data
    axes; None when no environment is set."""
    if _AXIS_ENV is None:
        return None
    return tuple(_AXIS_ENV.get("dp") if s == DP else s for s in spec)


def axis_names(mesh) -> tuple[str, ...]:
    """The axis names of a ``DeviceMesh`` (``mesh_dim_names``) or of any
    object with ``axis_names`` and a ``shape`` mapping (the reference's
    ``jax.sharding.Mesh``, or a stand-in with those two attributes)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_len(mesh, name: str) -> int:
    """The size of mesh axis ``name``."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return mesh.size(axis_names(mesh).index(name))
    return mesh.shape[name]


def spec_placements(mesh, entries: tuple) -> tuple:
    """The ``torch.distributed.tensor`` placements, one per mesh axis, of
    a resolved spec ``entries`` (one entry per tensor dim: None, an axis
    name or a tuple of them): ``Shard(dim)`` on each axis an entry names,
    ``Replicate()`` on the others.  Torch shards a dim split over several
    axes in mesh order, so a tuple entry must list its axes in that
    order; an entry it cannot express (an axis out of order, one that is
    not on the mesh, or one axis on two dims) raises ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    placements = [Replicate()] * len(names)
    for dim, entry in enumerate(entries):
        if entry is None:
            continue
        axes = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
        idx = [names.index(a) if a in names else -1 for a in axes]
        if -1 in idx or idx != sorted(idx) or any(
                not isinstance(placements[i], Replicate) for i in idx):
            raise ValueError(
                f"spec {entries}: dim {dim} on {axes} cannot be placed on a "
                f"mesh of axes {names} (each axis once, in mesh order)")
        for i in idx:
            placements[i] = Shard(dim)
    return tuple(placements)


def _divisible_entries(mesh, env: dict, shape, spec) -> tuple:
    """The reference's ``shard_activation`` rule: ``DP`` resolved, and an
    axis kept only where its size is above 1 and divides the dim."""
    out = []
    for dim, ax in zip(shape, spec):
        if ax == DP:
            ax = env.get("dp")
        axes = tuple(ax) if isinstance(ax, (tuple, list)) else (ax,)
        n = 1
        for a in axes:
            n *= 1 if a is None else axis_len(mesh, a)
        out.append(ax if ax is not None and n > 1 and dim % n == 0
                   else None)
    return tuple(out)


def _redistribute(x, entries: tuple):
    """A DTensor ``x`` moved to the placements of ``entries`` on its mesh
    (itself when they hold already); any other tensor as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    placements = spec_placements(x.device_mesh, entries)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def shard_activation(x, *spec):
    """The reference's sharding constraint with divisibility checks: with
    no axis environment, ``x`` itself (no copy, no launch); with one, a
    DTensor is redistributed to the placements of ``spec`` after an axis
    whose size does not divide its dim is dropped, and a plain tensor,
    which has no placement, is returned as it is."""
    env = _AXIS_ENV
    if env is None or env.get("mesh") is None:
        return x
    return _redistribute(x, _divisible_entries(env["mesh"], env, x.shape,
                                               spec))

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype for a config's dtype string."""
    return DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    spec: tuple[Any, ...]            # sharding entries (DP, FSDP, TP, None)
    dtype: str = "bfloat16"
    init: str = "normal"             # normal | zeros | ones | small
    fan_in_axes: tuple[int, ...] = (-2,)


ParamTree = Any     # nested dict of ParamDef / tensors


def tree_map_defs(fn: Callable[[ParamDef], Any], defs: ParamTree) -> ParamTree:
    """Map ``fn`` over the ParamDef leaves of a nested dict."""
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: tree_map_defs(fn, v) for k, v in defs.items()}


def abstract_params(defs: ParamTree) -> ParamTree:
    """Meta tensors of each ParamDef's shape and dtype (no memory), in
    the sorted-key order of :func:`init_params`' trees, so that a step
    traced on them walks the leaves in the order the card's step does."""
    if isinstance(defs, ParamDef):
        return torch.empty(defs.shape, dtype=torch_dtype(defs.dtype),
                           device="meta")
    return {k: abstract_params(defs[k]) for k in sorted(defs)}


def param_specs(defs: ParamTree) -> ParamTree:
    """Each ParamDef's spec, unchanged."""
    return tree_map_defs(lambda d: d.spec, defs)


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
