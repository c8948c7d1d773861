"""Parameter conversion from the JAX package's trees.

The JAX side hands over its parameter tree as numpy arrays (bf16 leaves
widened to float32 first, which is exact); this module turns it into the
port's tree, leaf for leaf by the same nested keys, so that both packages
compute the same function.  It imports no ``jax``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.families import build_model
from repro_torch.models.layers import ParamDef, torch_dtype


def params_from_jax(np_tree: dict, cfg, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> dict:
    """The port's parameters for ``cfg`` from a tree of numpy arrays.

    Every leaf is checked against the port's own declaration
    (``build_model(cfg).param_defs()``): same keys, same shape.  A leaf
    goes to the dtype its ParamDef declares (norm weights stay float32);
    ``dtype``, if given, replaces ``cfg.dtype`` for the leaves declared in
    it.
    """
    device = resolve_device(device)
    defs = build_model(cfg, device).param_defs()
    model_dt = torch_dtype(cfg.dtype)

    def walk(node, d, path):
        if isinstance(d, ParamDef):
            arr = np.array(node)     # always a copy: owns its memory
            if tuple(arr.shape) != tuple(d.shape):
                raise ValueError(
                    f"{path}: shape {tuple(arr.shape)} does not match the "
                    f"declared {tuple(d.shape)}")
            dt = torch_dtype(d.dtype)
            if dtype is not None and dt == model_dt:
                dt = dtype
            return torch.from_numpy(arr).to(device=device, dtype=dt)
        if set(node) != set(d):
            raise ValueError(
                f"{path or 'params'}: keys {sorted(node)} do not match the "
                f"declared {sorted(d)}")
        return {k: walk(node[k], d[k], f"{path}/{k}") for k in d}

    return walk(np_tree, defs, "")
