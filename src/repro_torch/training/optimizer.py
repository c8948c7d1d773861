"""AdamW with bf16 moments (the counterpart of
``repro.training.optimizer``).

Master parameters are float32; the first and second moments are bf16, as
in the reference; the update is computed in float32 in the reference's
order: the global norm clip, bias correction, decoupled weight decay.
Every function returns new tensors and leaves its inputs as they were.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.training.tree import tree_leaves, tree_map, tree_unzip


class AdamWState(NamedTuple):
    step: torch.Tensor       # int32 scalar
    mu: Any                  # bf16 tree
    nu: Any                  # bf16 tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def init_state(params: Any) -> AdamWState:
    """Step 0 and zero bf16 moments, on the parameters' device."""
    dev = tree_leaves(params)[0].device
    z = lambda p: torch.zeros(p.shape, dtype=torch.bfloat16, device=dev)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(z, params), nu=tree_map(z, params))


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then a cosine decay to ``min_lr_ratio``; float32."""
    s = step.float()
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    decayed = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, decayed)


def global_norm(tree: Any) -> torch.Tensor:
    """The float32 L2 norm of every leaf together."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def apply_updates(cfg: AdamWConfig, params: Any, grads: Any,
                  state: AdamWState) -> tuple[Any, AdamWState]:
    """grads: float32 tree (already averaged over microbatches).  Returns
    the new parameters (in their dtype) and state."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * clip
        m32 = m.float() * b1 + (1 - b1) * g
        v32 = v.float() * b2 + (1 - b2) * torch.square(g)
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        p32 = p.float()
        p32 = p32 - lr * (delta + cfg.weight_decay * p32)
        return p32.to(p.dtype), m32.bfloat16(), v32.bfloat16()

    new_p, mu, nu = tree_unzip(
        tree_map(upd, params, grads, state.mu, state.nu), 3)
    return new_p, AdamWState(step=step, mu=mu, nu=nu)
