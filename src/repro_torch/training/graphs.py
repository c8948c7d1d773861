"""The train step as one captured CUDA graph: the port's counterpart of
the reference's jitted step, ``jax.jit(step_fn)`` in
``examples/train_small.py`` and ``donate_argnums=(0, 1)`` in its dry run
(``repro.launch.dryrun``).

:class:`CapturedTrainStep` wraps a ``train_step(params, opt_state, batch)
-> (loss, params, opt_state)`` (``launch/steps.make_train_step``'s) and is
called as it is.  Its first call adopts the caller's parameter and
optimizer-state tensors as the graph's static inputs, without copying
them: they are donated.  Every step writes the new parameters and state
back into those same tensors (``copy_``), so each call returns the
statics themselves, the same objects from call to call, and a tree a call
returned holds the state of the latest step, not of its own.  A later call
copies in every leaf it is handed that is not already the static tensor
(a tree ``Trainer.try_restore`` read from a checkpoint, say), and the
batch into one static buffer per leaf (an encoder-decoder model's frames
too).

On the card each batch signature (its keys, shapes and dtypes) gets one
CUDA graph, as ``jit`` traces once per shape; all share one memory pool
and the same static parameters and state.  A signature's first call runs
the step eagerly on the capture's own stream, which warms up cuBLAS,
autograd, the kernels' scratch and their host state (the entry point of
the tensor-map encoder, the shared-memory ceilings), then captures the next
step on that stream (``torch.cuda.graph`` releases the allocator's cached
blocks first, so the pool does not sit beside the eager step's).  The
capture runs nothing, so the next call's replay goes on from the state
the eager step left.  A capture that fails raises; there is no eager path
to fall back to on the card.  The kernels' host work is baked into the
graph: K1's backward and K3's gradients encode their tensor maps with the
operands' addresses, and the wrappers choose a plan by their alignment;
the statics and the pool keep those addresses fixed from replay to replay.

As in ``serving/graphs.py``, a capture's launch counts are taken back and
kept with its graph, and every replay adds them (``kernels.ops``): the
counts say what ran on the card.

On the CPU the same static buffers and the same copies run eagerly: there
are no graphs there.
"""
from __future__ import annotations

import time
from typing import Any, Callable

import torch

from repro_torch.kernels import ops
from repro_torch.training.tree import tree_paths


class _Capture:
    """The static batch of one signature and, once captured, its graph."""

    def __init__(self, batch: dict):
        self.batch = {k: torch.empty_like(v) for k, v in batch.items()}
        self.graph = None
        self.loss = None          # the graph's loss, after a replay
        self.counts: dict = {}    # kernel launches of one replay
        self.capture_s = None     # host seconds of the capture


class CapturedTrainStep:
    """``train_step`` with donated parameters and state, one CUDA graph per
    batch signature on the card.  ``captures``, ``replays`` and
    ``eager_steps`` count the graphs made and the steps run each way."""

    def __init__(self, train_step: Callable):
        self.train_step = train_step
        self.params = self.opt_state = None
        self._statics: list[tuple[str, torch.Tensor]] = []
        self.slots: dict[tuple, _Capture] = {}
        self.captures = self.replays = self.eager_steps = 0
        self._stream = self._pool = None

    def __call__(self, params: Any, opt_state: Any, batch: dict):
        """One step: ``(loss, params, opt_state)``, the trees the statics
        (see the module's docstring), the loss a tensor of its own."""
        self._adopt(params, opt_state)
        key = tuple((k, tuple(v.shape), v.dtype)
                    for k, v in sorted(batch.items()))
        slot = self.slots.get(key)
        if slot is None:
            slot = self.slots[key] = _Capture(batch)
        for k, v in batch.items():
            slot.batch[k].copy_(v)
        if self._statics[0][1].device.type != "cuda":
            loss = self._advance(slot.batch)
            self.eager_steps += 1
        elif slot.graph is None:
            loss = self._step_and_capture(slot)
        else:
            slot.graph.replay()
            ops.add_counts(slot.counts)
            self.replays += 1
            loss = slot.loss.clone()
        return loss, self.params, self.opt_state

    def _adopt(self, params: Any, opt_state: Any) -> None:
        """At the first call take ``params`` and ``opt_state`` as the
        statics; at a later one copy in each leaf that is not the static
        tensor itself, after checking that the trees match."""
        leaves = tree_paths({"params": params, "opt": opt_state})
        if self.params is None:
            self.params, self.opt_state = params, opt_state
            self._statics = leaves
            return
        if [p for p, _ in leaves] != [p for p, _ in self._statics]:
            raise ValueError("the parameter and state trees differ from "
                             "the ones the first call donated")
        for (path, src), (_, dst) in zip(leaves, self._statics):
            if src is dst:
                continue
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(
                    f"{path}: {tuple(src.shape)} {src.dtype}, the static "
                    f"leaf is {tuple(dst.shape)} {dst.dtype}")
            dst.copy_(src)

    def _advance(self, batch: dict) -> torch.Tensor:
        """One step on the statics (run eagerly, or recorded under a
        capture), its new parameters and state written back into them;
        returns its loss."""
        loss, params, state = self.train_step(self.params, self.opt_state,
                                              batch)
        new = tree_paths({"params": params, "opt": state})
        for (_, dst), (_, src) in zip(self._statics, new):
            dst.copy_(src)
        return loss

    def _step_and_capture(self, slot: _Capture) -> torch.Tensor:
        """The signature's first step, eagerly, then the capture of the
        next one, both on the capture's own stream; the eager step's
        loss."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self._statics[0][1].device)
            self._pool = torch.cuda.graph_pool_handle()
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream())
        # the outer context restores the caller's stream also where a
        # failed capture leaves the graph's own stream context open
        with torch.cuda.stream(stream):
            loss = self._advance(slot.batch)
            self.eager_steps += 1
            graph = torch.cuda.CUDAGraph()
            before = ops.counts()
            t = time.perf_counter()
            try:
                with torch.cuda.graph(graph, pool=self._pool, stream=stream):
                    slot.loss = self._advance(slot.batch)
                slot.capture_s = time.perf_counter() - t
            finally:
                # the wrappers counted launches that did not run
                after = ops.counts()
                slot.counts = {k: after[k] - before[k] for k in after}
                ops.add_counts({k: -n for k, n in slot.counts.items()})
        torch.cuda.current_stream().wait_stream(stream)
        slot.graph = graph
        self.captures += 1
        return loss
