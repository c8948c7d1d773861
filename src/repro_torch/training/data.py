"""Deterministic synthetic token pipeline with skip-replay (the
counterpart of ``repro.training.data``).

Batches are a pure function of (seed, step), drawn with the reference's
own numpy calls, so that a restarted job resumes mid-stream exactly and
the tokens equal the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234


class SyntheticTokens:
    """Zipf-ish synthetic LM stream; labels are next-token shifted.
    ``device``: where iterating the stream puts its batches."""

    def __init__(self, cfg: DataConfig, device="cuda"):
        self.cfg = cfg
        self.device = device
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = 1.0 / ranks
        self._probs = probs / probs.sum()

    def batch_at(self, step: int, device=None) -> dict[str, torch.Tensor]:
        """``{"tokens", "labels"}``, int64 [global_batch, seq_len] on
        ``device`` (the stream's if None): the reference's int32 draw,
        widened."""
        cfg = self.cfg
        device = self.device if device is None else device
        rng = np.random.default_rng((cfg.seed, step))
        toks = rng.choice(cfg.vocab_size, p=self._probs,
                          size=(cfg.global_batch, cfg.seq_len + 1))
        toks = torch.from_numpy(toks.astype(np.int32)).to(
            resolve_device(device), torch.int64)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        """The batches of steps 0, 1, 2, ... on the stream's device."""
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
