"""Fault-tolerant training loop (the counterpart of
``repro.training.trainer``): periodic and emergency checkpoints, a
simulated node failure, restart from the latest checkpoint with the data
replayed from the exact step, and a straggler watchdog over step times.
"""
from __future__ import annotations

import dataclasses
import shutil
import time
from pathlib import Path
from typing import Any, Callable, Optional

import torch

from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt
from repro_torch.training.data import SyntheticTokens
from repro_torch.training.tree import tree_leaves


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = "checkpoints"
    straggler_factor: float = 3.0   # step slower than median x f: flag
    keep_last: int = 3


@dataclasses.dataclass
class TrainReport:
    losses: list[float]
    step_times: list[float]
    straggler_flags: list[int]
    restored_from: Optional[int]
    final_step: int


class Trainer:
    """Runs ``train_step(params, opt_state, batch) -> (loss, params,
    opt_state)`` over ``data``'s batches on the parameters' device."""

    def __init__(self, model_cfg, train_step: Callable, params: Any,
                 opt_state: opt.AdamWState, data: SyntheticTokens,
                 cfg: TrainConfig):
        self.model_cfg = model_cfg
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.data = data
        self.cfg = cfg
        self.device = tree_leaves(params)[0].device

    # -- fault tolerance hooks -------------------------------------------
    def save(self, step: int) -> None:
        ckpt.save_checkpoint(self.cfg.ckpt_dir, step,
                             {"params": self.params, "opt": self.opt_state})
        self._gc(step)

    def _gc(self, newest: int) -> None:
        """Keep the newest ``keep_last`` checkpoints."""
        root = Path(self.cfg.ckpt_dir)
        steps = sorted(int(p.name.split("_")[1]) for p in root.iterdir()
                       if p.name.startswith("step_"))
        for s in steps[: -self.cfg.keep_last]:
            shutil.rmtree(root / f"step_{s:08d}")

    def try_restore(self) -> Optional[int]:
        """Load the latest checkpoint, if any; its step."""
        last = ckpt.latest_step(self.cfg.ckpt_dir)
        if last is None:
            return None
        tree = ckpt.restore_checkpoint(
            self.cfg.ckpt_dir, last,
            {"params": self.params, "opt": self.opt_state}, self.device)
        self.params = tree["params"]
        self.opt_state = tree["opt"]
        return last

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- main loop ---------------------------------------------------------
    def run(self, start_step: int = 0,
            fail_at: Optional[int] = None) -> TrainReport:
        """``fail_at`` simulates a node failure (raises) at that step,
        after an emergency checkpoint of the step before; the caller is
        expected to restart and resume from the checkpoint."""
        losses, times, flags = [], [], []
        restored = self.try_restore()
        step = (restored + 1) if restored is not None else start_step
        while step < self.cfg.steps:
            if fail_at is not None and step == fail_at:
                self.save(step - 1)
                raise RuntimeError(f"simulated node failure at step {step}")
            batch = self.data.batch_at(step, device=self.device)
            self._sync()
            t0 = time.perf_counter()
            loss, self.params, self.opt_state = self.train_step(
                self.params, self.opt_state, batch)
            loss = float(loss)
            self._sync()
            dt = time.perf_counter() - t0
            losses.append(loss)
            times.append(dt)
            med = sorted(times)[len(times) // 2]
            if len(times) > 5 and dt > self.cfg.straggler_factor * med:
                flags.append(step)
            if step % self.cfg.ckpt_every == 0 and step > 0:
                self.save(step)
            step += 1
        self.save(self.cfg.steps - 1)
        return TrainReport(losses, times, flags, restored,
                           self.cfg.steps - 1)
