"""Multi-pod dry run of the port on the meta device.

For every (architecture x input shape) cell of ``cells_for``, on the
reference's production meshes (torch ``DeviceMesh``es over PyTorch's fake
process group: no card, no memory)

    single-pod:  (16, 16)      axes (data, model)          256 GPUs
    multi-pod:   (2, 16, 16)   axes (pod, data, model)     512 GPUs

price one GPU's share of the cell: the port's own step for the rows one
device holds, run whole on the meta device under
``launch/analysis.MemoryTracker``, with the parameters, the optimizer
state and the inputs each weighted by the share of it one device holds
under the placements of the abstract trees (``launch/mesh.shardings_for``)
and what the step computes from them elementwise weighted as they are;
the peak of that weighted sum is the cell's total.  Record it, the
resident state, the activation peak within it, the cell's model FLOPs and
whether the total fits an 80 GB H100.  One JSON
file per cell under ``results/dryrun_torch``; the run is resumable:
cells already priced are skipped unless --force.  It runs on any host and
never touches a GPU.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun               # all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi  # multi-pod only
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import SHAPES, cells_for
from repro_torch.launch import analysis
from repro_torch.launch.mesh import (_axis_size, _zip, fake_world,
                                     filter_spec, local_shape,
                                     make_production_mesh, shardings_for)
from repro_torch.launch.steps import (abstract_serve_params,
                                      abstract_train_state,
                                      batch_specs_shardings, input_specs,
                                      make_decode_step, make_prefill_step,
                                      make_train_step, resolve_microbatch)
from repro_torch.models.layers import DP, axis_len, axis_names
from repro_torch.training.tree import tree_leaves, tree_map

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
HBM_BYTES = 80e9            # one H100 SXM (NVIDIA's data sheet)


def _dp_size(mesh) -> int:
    return _axis_size(mesh, tuple(a for a in ("pod", "data")
                                  if a in axis_names(mesh)))


def shard_rows(cfg, shape, mesh) -> tuple[int, int]:
    """(rows one device holds of the batch, rows a microbatch of it): for
    training the global batch over the data-parallel degree dp in the
    reference's microbatch over dp, ``resolve_microbatch(cfg,
    global_batch, dp) / dp``; for serving the batch over the axes
    ``filter_spec`` keeps on its dim (all of it where none divides it)."""
    dp = _dp_size(mesh)
    if shape.kind == "train":
        mb = resolve_microbatch(cfg, shape.global_batch, dp)
        return shape.global_batch // dp, mb // dp
    kept = filter_spec(mesh, (shape.global_batch,), (DP,))[0]
    rows = shape.global_batch // _axis_size(mesh, kept)
    return rows, rows


def _shares(mesh, full, placements, traced):
    """Per leaf, the elements one device of ``mesh`` holds of ``full``
    under ``placements`` over those of the ``traced`` leaf."""
    held = _zip(full, placements, lambda leaf, pl: math.prod(
        local_shape(mesh, leaf.shape, pl)))
    return tree_map(lambda n, t: n / max(t.numel(), 1), held, traced)


def trace_step(cfg, shape, mesh, top: int = 5):
    """(tracker, resident bytes): the port's step for one device's share
    of ``shape`` on ``mesh`` (:func:`shard_rows`), run on the meta device
    under a :class:`~repro_torch.launch.analysis.MemoryTracker` that
    counts the parameters, the optimizer state and the inputs (the cache
    among them) as live from the start, each weighted by the share of it
    that one device holds (the inputs' share of the device's whole
    batch).  Training: float32 masters and AdamW, the whole step (its
    first two microbatches, which reach the peak of any number, the
    accumulation, the update); prefill and decode: the served parameters
    and a cache of ``seq_len`` rows.  The resident bytes are those tracked
    storages' share: {"params", "optimizer", "inputs", "cache"}."""
    rows, mb_rows = shard_rows(cfg, shape, mesh)
    if shape.kind == "train":
        # from the second microbatch on, each starts from the same live
        # storages (the state, the inputs, the float32 sums) and makes
        # the same ones: two give the whole step's peak, to a few scalars
        rows = min(rows, 2 * mb_rows)
    traced = input_specs(cfg, dataclasses.replace(shape, global_batch=rows))
    if shape.kind == "train":
        cfg = dataclasses.replace(cfg, microbatch=mb_rows)
        step, _ = make_train_step(cfg, dp_size=1, global_batch=rows,
                                  device="meta")
        params, state, pspecs, sspecs = abstract_train_state(cfg)
        args = (params, state, traced)
        specs = (pspecs, sspecs)
    else:
        make = make_prefill_step if shape.kind == "prefill" \
            else make_decode_step
        step, _ = make(cfg, device="meta")
        params, pspecs = abstract_serve_params(cfg)
        args = (params, traced)
        specs = (pspecs,)
    weights = tuple(_shares(mesh, tree, shardings_for(mesh, tree, sp), tree)
                    for tree, sp in zip(args, specs))
    weights += (_shares(mesh, input_specs(cfg, shape),
                        batch_specs_shardings(mesh, cfg, shape), traced),)
    tracker = analysis.MemoryTracker(top)
    tracker.track(args[:-1], weights[:-1])
    tracker.track(args[-1], weights[-1], joins=False)
    held = tree_map(lambda t, w: t.numel() * t.element_size() * w, args,
                    weights)
    resident = {"params": _sum(held[0]),
                "optimizer": _sum(held[1]) if shape.kind == "train" else 0,
                "inputs": _sum({k: v for k, v in held[-1].items()
                                if k != "cache"}),
                "cache": _sum(held[-1].get("cache", {}))}
    grad = contextlib.nullcontext() if shape.kind == "train" \
        else torch.no_grad()
    with tracker, grad:
        step(*args)
    return tracker, resident


def _sum(tree) -> int:
    return int(round(sum(tree_leaves(tree))))


def price_cell(cfg, shape, mesh) -> dict:
    """One device's share of ``cfg`` at ``shape`` on ``mesh``: the
    weighted peak of the whole step traced on the meta device
    (:func:`trace_step`), the resident state within it, and the cell's
    model FLOPs."""
    n_dev = math.prod(axis_len(mesh, a) for a in axis_names(mesh))
    rows, mb_rows = shard_rows(cfg, shape, mesh)
    t0 = time.time()
    tracker, resident = trace_step(cfg, shape, mesh)
    trace = tracker.summary()
    total = trace["device_peak_bytes"]
    mf = analysis.model_flops(cfg, shape)
    return {
        "arch": cfg.name, "shape": shape.name, "kind": shape.kind,
        "mesh": dict(zip(axis_names(mesh),
                         (axis_len(mesh, a) for a in axis_names(mesh)))),
        "n_devices": n_dev, "dp": _dp_size(mesh),
        "rows_per_device": rows, "microbatch_rows_per_device": mb_rows,
        "params_dtype": ("float32 masters" if shape.kind == "train"
                         else cfg.dtype),
        "resident_bytes": resident,
        # the float32 gradient sums take the masters' placements; they
        # are inside the total, held from the first backward to the update
        "gradient_bytes": resident["params"] if shape.kind == "train" else 0,
        "activation_peak_bytes": trace["activation_peak_bytes"],
        "activation_note": (
            f"the storages joined to no parameter, optimizer state or "
            f"input, over the whole step of {rows} x {shape.seq_len} "
            f"tokens a device in microbatches of {mb_rows} rows, traced "
            f"on the meta device through the port's own step with no "
            f"mesh (one K1 call a layer, no sequence-parallel lanes); "
            f"not sharded over the model axis"),
        "trace": trace, "trace_s": time.time() - t0,
        "total_bytes": total, "hbm_bytes": HBM_BYTES,
        "fits_80gb": total <= HBM_BYTES,
        "model_flops_global": mf, "model_flops_per_device": mf / n_dev,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    """:func:`price_cell` of a registry cell on a production mesh (whose
    fake process group the caller holds: :func:`main`)."""
    rec = price_cell(ARCHS[arch], SHAPES[shape_name],
                     make_production_mesh(multi_pod=multi_pod))
    rec["mesh_name"] = "multi" if multi_pod else "single"
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", type=Path, default=RESULTS,
                    help="directory of the per-cell JSON files")
    args = ap.parse_args(argv)

    args.out.mkdir(parents=True, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = [(arch, shape_name, m == "multi") for m in meshes
             for arch, cfg in ARCHS.items()
             if not args.arch or arch == args.arch
             for _, shape_name in cells_for(cfg)
             if not args.shape or shape_name == args.shape]
    print(f"dry-run: {len(cells)} cells", flush=True)
    n_ok = n_fail = n_skip = 0
    for multi in (False, True):
        todo = []
        for arch, shape_name, m in cells:
            tag = f"{arch}__{shape_name}__{'multi' if m else 'single'}"
            out = args.out / f"{tag}.json"
            if m != multi:
                continue
            if out.exists() and not args.force and \
                    "error" not in json.loads(out.read_text()):
                n_skip += 1
                continue
            todo.append((arch, shape_name, tag, out))
        if not todo:
            continue
        with fake_world(512 if multi else 256):
            for arch, shape_name, tag, out in todo:
                try:
                    rec = run_cell(arch, shape_name, multi)
                    out.write_text(json.dumps(rec, indent=1))
                    n_ok += 1
                    d = rec["resident_bytes"]
                    print(f"OK   {tag:52s} held {sum(d.values()) / 1e9:9.3f}"
                          f" GB  peak {rec['total_bytes'] / 1e9:9.3f}"
                          f" GB  fits {rec['fits_80gb']!s:5s} "
                          f"trace {rec['trace_s']:6.1f} s", flush=True)
                except Exception as e:   # a cell's failure is its record
                    n_fail += 1
                    err = {"arch": arch, "shape": shape_name,
                           "mesh_name": "multi" if multi else "single",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    out.write_text(json.dumps(err, indent=1))
                    print(f"FAIL {tag:52s} {type(e).__name__}: "
                          f"{str(e)[:120]}", flush=True)
    print(f"done: ok={n_ok} fail={n_fail} skipped={n_skip}", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
