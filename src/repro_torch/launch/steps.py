"""Train, prefill and decode step builders (the counterpart of
``repro.launch.steps``).

``make_train_step`` follows the reference: the batch is cut into
``n_accum`` microbatches; for each, the gradients of the float32 master
parameters are taken through a loss that casts every leaf of more than
one dimension to the config's dtype, optionally compressed, and summed in
float32; their mean goes to AdamW.  The reference's ``input_specs`` and
``abstract_*`` helpers serve its multi-pod dry run (ROADMAP item 15).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.families import build_model
from repro_torch.models.layers import torch_dtype
from repro_torch.training import optimizer as opt
from repro_torch.training.tree import tree_leaves, tree_map, tree_unflatten


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
    ``training.compression``)."""
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
