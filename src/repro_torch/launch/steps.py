"""Train, prefill and decode step builders (the counterpart of
``repro.launch.steps``).

``make_train_step`` follows the reference: the batch is cut into
``n_accum`` microbatches; for each, the gradients of the float32 master
parameters are taken through a loss that casts every leaf of more than
one dimension to the config's dtype, optionally compressed, and summed in
float32; their mean goes to AdamW.

``input_specs``, ``batch_specs_shardings``, ``abstract_train_state`` and
``abstract_serve_params`` give the dry run (``launch/dryrun.py``) every
tree of a cell as meta tensors, which take no memory, with their specs.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig
from repro_torch.launch.mesh import filter_spec, replicated, shardings_for
from repro_torch.models.families import build_model
from repro_torch.models.layers import (DP, abstract_params, param_specs,
                                       spec_placements, torch_dtype)
from repro_torch.models.transformer import cache_specs
from repro_torch.training import optimizer as opt
from repro_torch.training.tree import tree_leaves, tree_map, tree_unflatten


# ---------------------------------------------------------------------------
# Input specs (meta tensors; no allocation)
# ---------------------------------------------------------------------------


def _shape(shape) -> ShapeConfig:
    return SHAPES[shape] if isinstance(shape, str) else shape


def _token_budget(cfg: ArchConfig, shape: ShapeConfig) -> int:
    """Decoder token positions (VLM reserves the patch prefix)."""
    return shape.seq_len


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape_name) -> dict:
    """Abstract model inputs of one (arch, shape) cell as meta tensors:
    ``shape_name`` a key of ``SHAPES`` or a ``ShapeConfig``.  Tokens and
    labels are int64, as the port's data stream gives them
    (``SyntheticTokens.batch_at``; the reference's are int32); the
    frames (whisper) and image embeddings (llava) bf16; a prefill's and a
    decode step's cache of ``seq_len`` rows; a decode step's ``pos`` a 0-d
    int64, as the port's decode graphs pass it."""
    shape = _shape(shape_name)
    gb, s = shape.global_batch, shape.seq_len
    model = build_model(cfg, "meta")
    specs: dict[str, Any] = {}
    if shape.kind == "decode":
        specs["token"] = _meta((gb, 1), torch.int64)
        specs["cache"] = model.init_cache(gb, s, abstract=True)
        specs["pos"] = _meta((), torch.int64)
        return specs
    specs["tokens"] = _meta((gb, _token_budget(cfg, shape)), torch.int64)
    if shape.kind == "train":
        specs["labels"] = _meta((gb, s), torch.int64)
    else:
        specs["cache"] = model.init_cache(gb, s, abstract=True)
    if cfg.family == "audio":
        specs["extra_embeds"] = _meta((gb, cfg.encoder_frames, cfg.d_model),
                                      torch.bfloat16)
    elif cfg.family == "vlm":
        specs["extra_embeds"] = _meta((gb, cfg.num_patches, cfg.d_model),
                                      torch.bfloat16)
    return specs


def batch_specs_shardings(mesh, cfg: ArchConfig, shape_name) -> dict:
    """Placements for the :func:`input_specs` tree on ``mesh``: the
    cache's from its CacheLeaf specs, ``pos`` replicated, every other
    input's batch dim on DP, each through ``filter_spec``."""
    shape = _shape(shape_name)
    model = build_model(cfg, "meta")
    out = {}
    for k, v in input_specs(cfg, shape).items():
        if k == "cache":
            out[k] = shardings_for(mesh, v, cache_specs(
                model.cache_defs(shape.global_batch, shape.seq_len)))
        elif k == "pos":
            out[k] = replicated(mesh)
        else:
            out[k] = spec_placements(mesh, filter_spec(
                mesh, v.shape, (DP,) + (None,) * (v.dim() - 1)))
    return out


def resolve_microbatch(cfg: ArchConfig, global_batch: int,
                       dp_size: int) -> int:
    """The reference's microbatch: the first multiple of ``dp_size`` from
    ``max(cfg.microbatch, dp_size)`` up that divides ``global_batch``.
    Where there is none the reference loops forever; this raises
    ``ValueError`` instead (ROADMAP H26)."""
    mb = max(cfg.microbatch, dp_size)
    while global_batch % mb:
        if mb > global_batch:
            raise ValueError(
                f"no microbatch: no multiple of dp_size {dp_size} from "
                f"{max(cfg.microbatch, dp_size)} up divides global batch "
                f"{global_batch}")
        mb += dp_size
    return min(mb, global_batch)


def make_train_step(cfg: ArchConfig, *, dp_size: int, global_batch: int,
                    opt_cfg: Optional[opt.AdamWConfig] = None,
                    grad_compression: Optional[Callable] = None,
                    device="cuda"):
    """Returns (train_step, model): ``train_step(params_f32, opt_state,
    batch) -> (loss, params, opt_state)``, the loss the mean over the
    microbatches.  ``grad_compression`` maps a microbatch's gradient tree
    to the tree that is summed (for example the int8 roundtrip of
    ``training.compression``).  The step runs eagerly, one dispatch per
    operation; ``training.graphs.CapturedTrainStep(train_step)`` runs it
    as one CUDA graph with the parameters and state donated, as the
    reference jits it."""
    model = build_model(cfg, device)
    ocfg = opt_cfg or opt.AdamWConfig()
    mb = resolve_microbatch(cfg, global_batch, dp_size)
    n_accum = global_batch // mb
    dt = torch_dtype(cfg.dtype)

    def cast(p):
        if p.dtype == torch.float32 and p.dim() > 1:
            return p.to(dt)
        return p

    def grads_of(params, micro):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            loss = model.train_loss(
                tree_map(cast, tree_unflatten(params, leaves)), micro)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), tree_unflatten(params, grads)

    def train_step(params: Any, opt_state: opt.AdamWState, batch: dict):
        acc, loss_sum = None, None
        for i in range(n_accum):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, grads = grads_of(params, micro)
            if grad_compression is not None:
                grads = grad_compression(grads)
            leaves = [g.float() for g in tree_leaves(grads)]
            if acc is None:
                # 0 + g is g: the first microbatch's gradients are the
                # float32 sums, with no zeroed accumulator beside them
                acc, loss_sum = leaves, loss.float()
            else:
                for a, g in zip(acc, leaves):
                    a.add_(g)
                loss_sum = loss_sum + loss
            del grads, leaves
        grads = tree_unflatten(params, [a / n_accum for a in acc])
        del acc
        new_params, new_state = opt.apply_updates(ocfg, params, grads,
                                                  opt_state)
        return loss_sum / n_accum, new_params, new_state

    return train_step, model


def make_prefill_step(cfg: ArchConfig, device="cuda"):
    """Returns (prefill_step, model): ``prefill_step(params, batch)`` with
    ``batch = {"tokens", "cache"[, "extra_embeds"]}`` gives the last
    position's logits and the cache (filled in place)."""
    model = build_model(cfg, device)

    def prefill_step(params, batch):
        return model.prefill(params, batch["tokens"], batch["cache"],
                             batch.get("extra_embeds"))

    return prefill_step, model


def make_decode_step(cfg: ArchConfig, device="cuda"):
    """Returns (decode_step, model): ``decode_step(params, batch)`` with
    ``batch = {"token", "cache", "pos"}`` gives the logits and the cache
    (updated in place)."""
    model = build_model(cfg, device)

    def decode_step(params, batch):
        return model.decode_step(params, batch["token"], batch["cache"],
                                 batch["pos"])

    return decode_step, model


# ---------------------------------------------------------------------------
# Abstract params / optimizer state for the dry run
# ---------------------------------------------------------------------------


def abstract_train_state(cfg: ArchConfig):
    """(params, opt_state, param specs, state specs): float32 master
    parameters and the AdamW state as meta tensors, as the train step
    holds them (``make_train_step``)."""
    defs = build_model(cfg, "meta").param_defs()
    aparams = tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                             device="meta"),
                       abstract_params(defs))
    specs = param_specs(defs)
    return aparams, opt.abstract_state(aparams), specs, opt.state_specs(
        specs)


def abstract_serve_params(cfg: ArchConfig):
    """(params, specs): the served parameters in their own dtypes as meta
    tensors."""
    defs = build_model(cfg, "meta").param_defs()
    return abstract_params(defs), param_specs(defs)
