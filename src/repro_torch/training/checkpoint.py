"""Checkpoints without msgpack (the counterpart of
``repro.training.checkpoint``).

Layout: one JSON manifest (every leaf's tree path, global shape and
dtype, and the step) and one ``.npy`` blob per leaf, bf16 leaves as their
``uint16`` bits.  The contract of the reference:

  * atomic write: a temporary directory, then a rename, so that a crash
    never corrupts the latest checkpoint;
  * ``latest_step`` scans for the newest complete manifest;
  * ``restore_checkpoint`` checks the structure and the shapes before it
    places anything on a device.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.training.tree import tree_paths, tree_unflatten

# dtypes a checkpoint stores, with the numpy type of their blob
_BLOB = {torch.float32: np.float32, torch.bfloat16: np.uint16,
         torch.int32: np.int32, torch.int64: np.int64}


def _name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu().contiguous()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def save_checkpoint(ckpt_dir: str | Path, step: int, tree: Any) -> Path:
    """Write ``tree`` (a dict / named-tuple tree of tensors) as
    ``step_<step>`` under ``ckpt_dir``; returns its directory."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves = tree_paths(tree)
    for path, x in leaves:
        if x.dtype not in _BLOB:
            raise TypeError(f"{path}: cannot store {x.dtype}")
    manifest = {
        "step": step,
        "leaves": [{"path": path, "shape": list(x.shape),
                    "dtype": _name(x.dtype)} for path, x in leaves],
        "format": 1,
    }
    for i, (_, x) in enumerate(leaves):
        np.save(tmp / f"leaf_{i:05d}.npy", _to_numpy(x))
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic publish
    return final


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    """The newest step under ``ckpt_dir`` with a complete manifest."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.iterdir()
             if p.name.startswith("step_") and (p / "manifest.json").exists()]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str | Path, step: int, like: Any,
                       device=None) -> Any:
    """The checkpoint of ``step`` in the structure of ``like`` (a tree of
    tensors), each leaf on ``device`` (default: the device of ``like``'s
    leaf).  Raises ``ValueError`` before placing anything if the paths,
    shapes or dtypes differ from ``like``'s."""
    path = Path(ckpt_dir) / f"step_{step:08d}"
    infos = json.loads((path / "manifest.json").read_text())["leaves"]
    want = tree_paths(like)
    if [i["path"] for i in infos] != [p for p, _ in want]:
        raise ValueError(
            f"checkpoint leaves {[i['path'] for i in infos]} do not match "
            f"the target's {[p for p, _ in want]}")
    for info, (p, x) in zip(infos, want):
        if tuple(info["shape"]) != tuple(x.shape) or \
                info["dtype"] != _name(x.dtype):
            raise ValueError(
                f"{p}: checkpoint {info['dtype']} {tuple(info['shape'])} vs "
                f"target {_name(x.dtype)} {tuple(x.shape)}")
    out = []
    for i, (info, (p, x)) in enumerate(zip(infos, want)):
        arr = np.load(path / f"leaf_{i:05d}.npy")
        if tuple(arr.shape) != tuple(info["shape"]) or \
                arr.dtype != _BLOB[x.dtype]:
            raise ValueError(f"{p}: blob {arr.dtype} {arr.shape} does not "
                             f"match its manifest")
        t = torch.from_numpy(arr)
        if x.dtype == torch.bfloat16:
            t = t.view(torch.int16).view(torch.bfloat16)
        out.append(t.to(device if device is not None else x.device))
    return tree_unflatten(like, out)
