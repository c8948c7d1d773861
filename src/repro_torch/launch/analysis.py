"""Model FLOPs and a memory tracker for meta-device traces (the
counterpart of the parts of ``repro.launch.analysis`` that the dry run
needs).

The reference prices a cell from XLA's compiled artifact: its HLO walker
counts FLOPs and bytes, ``memory_analysis`` the buffers.  The port has no
compiler in between.  Its dry run runs the port's own step on the
``meta`` device, where every tensor has a shape and a dtype and no
memory, and every kernel wrapper runs its own checks and allocations
without launching (``kernels/_build.kernel_device``).  :class:`MemoryTracker`
watches that run: the bytes of the live storages, their peak, and what
was live at the peak, each storage weighted by the share of it one
device of a mesh would hold.  What the reference's walker gives besides (FLOPs
from the trace, collective bytes from the placements, the roofline terms)
waits for ROADMAP item 15's part two.
"""
from __future__ import annotations

import heapq
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves

from repro_torch.models.families import build_model
from repro_torch.models.layers import abstract_params
from repro_torch.training.tree import tree_leaves, tree_paths


def _leaves(cfg) -> list[tuple[str, torch.Tensor]]:
    """(path, meta tensor) of every leaf of the model's tree."""
    return tree_paths(abstract_params(build_model(cfg, "meta").param_defs()))


def param_count(cfg) -> int:
    """Parameters of the model's tree (its ``param_defs``)."""
    return sum(p.numel() for _, p in _leaves(cfg))


def _routed(path: str) -> bool:
    """A routed expert's leaf: an MoE layer's ``w_gate``, ``w_up`` or
    ``w_down`` (not its router, not its shared experts)."""
    parts = path.split("/")
    return parts[-2:-1] == ["moe"] and parts[-1] in ("w_gate", "w_up",
                                                      "w_down")


def active_params(cfg, n_params: int | None = None) -> float:
    """The parameters a token goes through: all of the tree's
    (``n_params`` where given), but the routed experts' leaves only as
    top_k of num_experts (the capacity's padding is no model work).
    Counted from the model's tree, not from
    ``ArchConfig.active_param_count`` (ROADMAP H28)."""
    leaves = _leaves(cfg)
    n = sum(p.numel() for _, p in leaves) if n_params is None else n_params
    if cfg.moe is None:
        return float(n)
    routed = sum(p.numel() for path, p in leaves if _routed(path))
    return n - routed * (1.0 - cfg.moe.top_k / cfg.moe.num_experts)


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D (train) or 2·N·D (inference) over the active
    parameters N of the model's tree; D the tokens of the step (one a
    sequence for a decode step)."""
    n_active = active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def _describe(t: torch.Tensor, func) -> str:
    return f"{func} {tuple(t.shape)} {str(t.dtype).split('.')[-1]}"


def _whole(t: torch.Tensor) -> bool:
    """``t`` is all of its storage (not a slice or a broadcast of it)."""
    return t.storage_offset() == 0 and \
        t.numel() * t.element_size() == t.untyped_storage().nbytes()


aten = torch.ops.aten
# ops whose output is its same-shape inputs elementwise, as the pointwise
# ones (``torch.Tag.pointwise``): casts, copies and the ``*_like`` makers
_ELEMENTWISE = {aten._to_copy, aten.copy_, aten.zeros_like, aten.empty_like,
                aten.ones_like, aten.full_like}
# ops whose output is its inputs laid side by side
_GATHERS = {aten.stack, aten.cat}


class MemoryTracker(TorchDispatchMode):
    """The bytes of the live storages, and their peak, while tensor ops
    run under the mode (on any device: meta tensors count the bytes the
    card would hold).

    A storage counts from the op that made it (an op output whose storage
    is none of its inputs': views and in-place results add nothing) until
    it is freed, which a weakref finalizer on the storage reports; so
    autograd's saved tensors, remat's recomputation and the caching of
    nothing count as they do on the card.  Storages that exist before the
    run count only where :meth:`track` registers them (the parameters,
    the optimizer state, the inputs and cache the caller holds), each
    with a weight: the share of it that one device holds.

    :meth:`summary` replays the run with each storage weighted: one
    joined to a tracked parameter or state storage takes its weight, any
    other weighs 1.  An op joins its whole output, where that has the
    shape of a tracked parameter or state leaf, to its whole inputs of
    the same shape where it computes the one from the others elementwise
    (``torch.Tag.pointwise``, a cast, a copy, a ``*_like``; an in-place
    op's target counts as its output), or to all its whole inputs where
    it lays them side by side (``stack``, ``cat``).  So a parameter's
    cast, its gradient (stacked from the layers' slices, then joined
    where the optimizer combines it with the parameter's moments), the
    gradient's sum over microbatches and the optimizer's new tensors take
    the parameter's weight, while an activation, of another shape, joins
    none of them.  The inputs' storages join nothing.  ``live`` and
    ``peak`` count the bytes unweighted as the run goes."""

    def __init__(self, top: int = 5):
        super().__init__()
        self._top = top
        self._ids: dict[int, int] = {}      # live storage -> serial id
        self._made: list[tuple[int, str]] = []   # id -> (bytes, made by)
        self._log: list[int] = []           # id made, ~id freed, in order
        self._parent: list[int] = []        # union-find over ids
        self._weight: dict[int, float] = {}  # id of a tracked storage
        self._leaf_shapes: set[tuple] = set()   # of the joinable leaves
        self._fixed: set[int] = set()       # ids that join nothing
        self.live = 0
        self.peak = 0

    def track(self, tree: Any, weights: Any = None,
              joins: bool = True) -> None:
        """Count the storages of ``tree``'s tensors (dicts and tuples) as
        live, each weighing its leaf of ``weights`` (a tree of the same
        structure; 1 for all where None); with ``joins`` False (the
        inputs) they join no other storage."""
        leaves = tree_leaves(tree)
        ws = [1.0] * len(leaves) if weights is None else tree_leaves(weights)
        for t, w in zip(leaves, ws, strict=True):
            if isinstance(t, torch.Tensor):
                i = self._add(t, "entry")
                self._weight[i] = max(self._weight.get(i, 0.0), float(w))
                if not joins:
                    self._fixed.add(i)
                else:
                    self._leaf_shapes.add(tuple(t.shape))

    def _add(self, t: torch.Tensor, desc: str) -> int:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._ids:
            return self._ids[key]
        i = self._ids[key] = len(self._made)
        self._made.append((st.nbytes(), desc))
        self._parent.append(i)
        self._log.append(i)
        weakref.finalize(st, self._free, key)
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)
        return i

    def _free(self, key: int) -> None:
        i = self._ids.pop(key)
        self._log.append(~i)
        self.live -= self._made[i][0]

    def _find(self, i: int) -> int:
        while self._parent[i] != i:
            self._parent[i] = i = self._parent[self._parent[i]]
        return i

    def _root(self, t: torch.Tensor) -> int | None:
        """The group of ``t``'s storage where it may join one."""
        i = self._ids.get(t.untyped_storage()._cdata)
        if i is None or i in self._fixed or not _whole(t):
            return None
        return self._find(i)

    def _join(self, out: list, inputs: list, gather: bool) -> None:
        for o in out:
            ro = self._root(o)
            if ro is None or tuple(o.shape) not in self._leaf_shapes:
                continue
            for x in inputs:
                rx = self._root(x)
                if rx is not None and (gather or x.shape == o.shape):
                    self._parent[self._find(rx)] = self._find(ro)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        inputs = [x for x in _pytree_leaves((args, kwargs))
                  if isinstance(x, torch.Tensor)]
        keys = {x.untyped_storage()._cdata for x in inputs}
        outs = [t for t in _pytree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            if t.untyped_storage()._cdata not in keys:
                self._add(t, _describe(t, func))
        packet = func.overloadpacket
        if packet in _GATHERS:
            self._join(outs, inputs, gather=True)
        elif packet in _ELEMENTWISE or torch.Tag.pointwise in func.tags:
            self._join(outs, inputs, gather=False)
        return out

    def storages(self) -> list[tuple[int, float | None, str]]:
        """(bytes, weight, made by) of every storage the run held, in the
        order they were made; the weight None for a storage joined to no
        tracked one."""
        groups: dict[int, float] = {}
        for i, w in self._weight.items():
            r = self._find(i)
            groups[r] = max(groups.get(r, 0.0), w)
        return [(b, groups.get(self._find(i)), d)
                for i, (b, d) in enumerate(self._made)]

    def summary(self) -> dict:
        """The replay: ``peak_bytes`` unweighted (what one device holds
        where every weight is 1); ``device_peak_bytes``, the peak of the
        weighted sum; ``activation_peak_bytes``, the peak of the storages
        joined to no tracked one; and the ``top`` storages live at the
        weighted peak (their weighted bytes, weight and the op that made
        them)."""
        made = self.storages()
        live = act = peak = peak_act = 0
        dev = peak_dev = 0.0
        at = -1
        for n, e in enumerate(self._log):
            i, sign = (e, 1) if e >= 0 else (~e, -1)
            b, w, _ = made[i]
            live += sign * b
            dev += sign * b * (1.0 if w is None else w)
            act += sign * b * (w is None)
            peak, peak_act = max(peak, live), max(peak_act, act)
            if dev > peak_dev:
                peak_dev, at = dev, n
        held = set()
        for e in self._log[:at + 1]:
            if e >= 0:
                held.add(e)
            else:
                held.discard(~e)
        top = heapq.nlargest(self._top, (
            (b * (1.0 if w is None else w), 1.0 if w is None else w, d)
            for b, w, d in (made[i] for i in held)))
        return {"peak_bytes": peak,
                "device_peak_bytes": int(round(peak_dev)),
                "activation_peak_bytes": peak_act,
                "live_at_peak": [{"bytes": int(round(b)), "weight": w,
                                  "made_by": d} for b, w, d in top]}
