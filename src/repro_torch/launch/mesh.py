"""Production mesh construction and spec filtering over
``torch.distributed``'s ``DeviceMesh`` (the counterpart of
``repro.launch.mesh``).

A ``ParamDef`` / ``CacheLeaf`` spec names mesh axes per tensor dim
(``models/layers.py``).  :func:`filter_spec` resolves the ``DP``
placeholder and drops an axis that does not divide its dim, word for word
as the reference does; :func:`shardings_for` turns the filtered specs of a
tree into placements, one ``Shard(dim)`` or ``Replicate()`` per mesh
dimension, and :func:`device_bytes` prices a tree on one device of the
mesh from them.

The meshes are functions, not module constants: importing this module
touches no process group.  A ``DeviceMesh`` needs a default process group
of the mesh's size; with no cards, :func:`fake_world` makes one in this
process with PyTorch's fake backend (every collective a no-op), which is
how the dry run builds the 256- and 512-device meshes on one host.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any

import torch

from repro_torch.models.layers import (DP, axis_len, axis_names,
                                       get_axis_env, set_axis_env,
                                       spec_placements)


def make_production_mesh(*, multi_pod: bool = False, device_type="cpu"):
    """The reference's meshes: (16, 16) over (data, model), 256 devices,
    or (2, 16, 16) over (pod, data, model), 512.  Needs a default process
    group of that size (:func:`fake_world` on a host without cards)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_test_mesh(shape, axes, device_type)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device_type="cpu"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    process group's ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


@contextlib.contextmanager
def fake_world(world_size: int):
    """A default process group of ``world_size`` ranks on PyTorch's fake
    backend, this process rank 0, destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _dp_axes(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


@contextlib.contextmanager
def use_mesh(mesh):
    """Set the axis environment (``DP`` = (pod, data) or (data,)) that
    ``shard_activation`` and ``seq_parallel_degree`` read, restored on
    exit."""
    old = get_axis_env()
    set_axis_env({"dp": _dp_axes(mesh), "mesh": mesh})
    try:
        yield mesh
    finally:
        set_axis_env(old)


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        out = 1
        for a in axis:
            out *= _axis_size(mesh, a)
        return out
    return axis_len(mesh, axis)


def filter_spec(mesh, shape: tuple, spec: tuple) -> tuple:
    """Resolve DP placeholders and drop sharding on non-divisible dims:
    one entry per dim of ``shape`` (None, an axis, or a tuple of axes).

    Several configs have head/expert counts that do not divide the model
    axis (e.g. qwen1.5 20 heads, granite 40 experts on a 16-wide axis);
    those dims fall back to replication — the fallback is part of the
    documented sharding policy, not an error.
    """
    dp = _dp_axes(mesh)
    entries = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if ax == DP:
            ax = dp
        if ax is None:
            entries.append(None)
            continue
        size = _axis_size(mesh, ax)
        if dim % size == 0 and dim >= size:
            entries.append(tuple(ax) if isinstance(ax, (tuple, list)) else ax)
        else:
            # try partial composite: e.g. DP=(pod,data) but dim only
            # divides data
            if isinstance(ax, (tuple, list)):
                for sub in (ax[1:], ax[:1]):
                    ssize = _axis_size(mesh, tuple(sub))
                    if sub and dim % ssize == 0 and dim >= ssize:
                        entries.append(tuple(sub) if len(sub) > 1
                                       else sub[0])
                        break
                else:
                    entries.append(None)
            else:
                entries.append(None)
    return tuple(entries)


def _zip(abstract: Any, specs: Any, fn) -> Any:
    """``fn(leaf, spec)`` over a tree of tensors (dicts and named tuples)
    and the spec tree of the same structure, whose leaves are tuples."""
    if isinstance(abstract, torch.Tensor):
        return fn(abstract, specs)
    if isinstance(abstract, dict):
        return {k: _zip(v, specs[k], fn) for k, v in abstract.items()}
    items = [_zip(a, s, fn) for a, s in zip(abstract, specs)]
    return type(abstract)(*items) if hasattr(abstract, "_fields") else \
        tuple(items)


def shardings_for(mesh, abstract: Any, specs: Any) -> Any:
    """The placements of every leaf of ``abstract`` (meta tensors) under
    its spec in ``specs``: ``filter_spec`` then one placement per mesh
    dimension."""
    return _zip(abstract, specs, lambda leaf, sp: spec_placements(
        mesh, filter_spec(mesh, tuple(leaf.shape), tuple(sp))))


def replicated(mesh) -> tuple:
    """``Replicate()`` on every mesh dimension."""
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * len(axis_names(mesh))


def local_shape(mesh, shape, placements) -> tuple[int, ...]:
    """One device's shard of a tensor of ``shape`` under ``placements``
    (``filter_spec`` keeps only dims its axes divide, so every shard is
    the same size)."""
    from torch.distributed.tensor import Shard
    out = list(shape)
    for name, pl in zip(axis_names(mesh), placements):
        if isinstance(pl, Shard):
            n = axis_len(mesh, name)
            if out[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {tuple(shape)} does not "
                                 f"divide over {name} ({n})")
            out[pl.dim] //= n
    return tuple(out)


def device_bytes(mesh, abstract: Any, shardings: Any) -> int:
    """Bytes of ``abstract`` on one device of ``mesh`` under
    ``shardings`` (:func:`shardings_for`)."""
    total = []
    _zip(abstract, shardings, lambda leaf, pl: total.append(
        math.prod(local_shape(mesh, leaf.shape, pl)) * leaf.element_size()))
    return sum(total)
