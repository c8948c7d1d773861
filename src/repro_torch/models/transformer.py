"""Model assembly: stacked-parameter blocks and a loop over layers.

:class:`DecoderLM` mirrors ``repro.models.transformer.DecoderLM``: GQA or
deepseek-v2's multi-head latent attention (MLA, a compressed cache), dense
or MoE (``models/moe.py``; with ``moe_layer_start > 0`` the first layers
are dense, stacked apart as ``dense_blocks``), and gemma3's interleave of
sliding-window (local) and global layers (``local_blocks`` and
``global_blocks``):

  * ``param_defs()``                      — ParamDef tree
  * ``init(generator)``                   — concrete params on the device
  * ``forward(params, tokens)``           — logits (prefill math)
  * ``train_loss(params, batch)``         — mean float32 cross-entropy
  * ``init_cache(batch, max_len)``        — zeroed KV cache
  * ``prefill(params, tokens, cache)``    — fills cache, returns logits
  * ``decode_step(params, token, cache, pos)`` — one-token step

Per-layer params stay stacked on a leading axis, so a tree converted from
the JAX package lines up key for key; a Python loop over the unbound
layers, in execution order, takes the place of ``lax.scan`` (and of the
reference's grouped ``_apply_interleaved``).  The KV cache is updated IN
PLACE: ``prefill`` and ``decode_step`` return the cache tree they were
given.  A decode step computes each cache's row and length once
(``attention.decode_index``) and hands them to every layer of that cache.

``forward(..., remat=True)`` with ``cfg.remat`` runs each block under
:func:`_remat` where autograd records (the reference's ``jax.checkpoint``
with ``nothing_saveable``): the backward recomputes the block from its
input, so K1's forward launches twice per layer and training step.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (FSDP, TP, ParamDef, apply_ffn,
                                       embed_defs, ffn_defs, init_params,
                                       norm_defs, rms_norm, stack_defs,
                                       torch_dtype, unembed_logits)

Cache = Any


def _unstack(tree):
    """A stacked param (or cache) tree as a list of per-layer trees of
    views: one ``unbind`` per leaf instead of one index per leaf per
    layer."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return tree.unbind(0)


def _remat(fn, enabled: bool):
    """``fn`` recomputed in the backward instead of keeping its
    activations (``torch.utils.checkpoint``, non-reentrant) when
    ``enabled`` and autograd records; else ``fn`` itself."""
    if not (enabled and torch.is_grad_enabled()):
        return fn
    return lambda *args: torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of ``logits`` [..., vocab] at integer ``labels``
    [...], in float32 as the reference computes it."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - picked)


def decode_position(pos, device):
    """The rope positions [1, 1] of a decode step at ``pos`` and the cache
    length its attention takes.  A 0-d int64 tensor on the device (the
    reference's traced ``pos``) is used as it is, through a view, so that a
    captured CUDA graph replays the step at every position; a Python int
    gives a position tensor and stays an int."""
    if isinstance(pos, torch.Tensor):
        return pos.view(1, 1), pos
    pos = int(pos)
    return torch.full((1, 1), pos, dtype=torch.int64, device=device), pos


class DecoderLM:
    """GQA or MLA decoder-only LM; optional MoE FFN; optional local:global
    sliding-window interleave (gemma3); optional VLM patch embeddings
    (llava) via ``extra_embeds``."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        if cfg.attention not in ("gqa", "mla"):
            raise ValueError(
                f"{cfg.name}: a DecoderLM attends by GQA or MLA, not "
                f"{cfg.attention!r}")
        self.cfg = cfg
        self.mla = cfg.attention == "mla"
        self.device = resolve_device(device)
        self.n_global, self.n_local = self._layer_split()

    # --- layer pattern -----------------------------------------------------
    def _layer_split(self) -> tuple[int, int]:
        """(global, local) layer counts: every ``local_global_pattern``-th
        layer is global."""
        cfg = self.cfg
        if not cfg.local_global_pattern:
            return cfg.num_layers, 0
        n_global = cfg.num_layers // cfg.local_global_pattern
        return n_global, cfg.num_layers - n_global

    def layer_kinds(self) -> list[str]:
        """Execution order of layer kinds ('L' local / 'G' global)."""
        cfg = self.cfg
        pat = cfg.local_global_pattern
        if not pat:
            return ["G"] * cfg.num_layers
        return ["G" if (i + 1) % pat == 0 else "L"
                for i in range(cfg.num_layers)]

    # --- params ------------------------------------------------------------
    def _block_defs(self, is_moe_layer: bool) -> dict:
        cfg = self.cfg
        d = {
            "ln_attn": norm_defs(cfg.d_model),
            "ln_ffn": norm_defs(cfg.d_model),
            "attn": attn.mla_defs(cfg) if self.mla else attn.gqa_defs(cfg),
        }
        if is_moe_layer:
            d["moe"] = moe_mod.moe_defs(cfg)
        else:
            d["ffn"] = ffn_defs(cfg.d_model, cfg.d_ff, cfg.dtype)
        return d

    def _stacks(self) -> list[tuple[str, str, int, int]]:
        """(param key, cache key, layers, window) of each stack:
        ``dense_blocks`` then ``blocks`` when an MoE config starts with
        dense layers, ``local_blocks`` (the sliding window) and
        ``global_blocks`` for gemma3's interleave, else ``blocks`` alone."""
        cfg = self.cfg
        if cfg.moe is not None and cfg.moe_layer_start > 0:
            return [("dense_blocks", "dense", cfg.moe_layer_start, 0),
                    ("blocks", "moe", cfg.num_layers - cfg.moe_layer_start,
                     0)]
        if cfg.local_global_pattern:
            return [("local_blocks", "local", self.n_local,
                     cfg.sliding_window),
                    ("global_blocks", "global", self.n_global, 0)]
        return [("blocks", "blocks", cfg.num_layers, 0)]

    def _schedule(self) -> list[tuple[str, str, int]]:
        """(param key, cache key, window) of every layer, in execution
        order: the stacks one after the other, or gemma3's kinds
        interleaved as :meth:`layer_kinds` says."""
        stacks = self._stacks()
        if not self.cfg.local_global_pattern:
            return [(key, ckey, w) for key, ckey, n, w in stacks
                    for _ in range(n)]
        (lkey, lckey, _, lw), (gkey, gckey, _, _) = stacks
        return [(lkey, lckey, lw) if kind == "L" else (gkey, gckey, 0)
                for kind in self.layer_kinds()]

    def param_defs(self) -> dict:
        cfg = self.cfg
        defs: dict[str, Any] = {
            "embed": embed_defs(cfg.vocab_size, cfg.d_model, cfg.dtype),
            "ln_f": norm_defs(cfg.d_model),
        }
        if not cfg.tie_embeddings:
            defs["head"] = ParamDef((cfg.d_model, cfg.vocab_size),
                                    (FSDP, TP), cfg.dtype)
        for key, _, n, _ in self._stacks():
            defs[key] = stack_defs(self._block_defs(
                cfg.moe is not None and key != "dense_blocks"), n)
        return defs

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters drawn from ``generator``, which must live on
        the model's device (``torch.Generator(device=...)``)."""
        return init_params(self.param_defs(), generator, self.device)

    # --- forward -----------------------------------------------------------
    def _block(self, p: dict, x, positions, *, window=0, cache=None,
               cache_len=0):
        cfg = self.cfg
        h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
        if self.mla:
            a, new_cache = attn.mla_attend(p["attn"], cfg, h, positions,
                                           cache=cache, cache_len=cache_len)
        else:
            a, new_cache = attn.gqa_attend(p["attn"], cfg, h, positions,
                                           window=window, cache=cache,
                                           cache_len=cache_len)
        x = x + a
        h = rms_norm(x, p["ln_ffn"], cfg.norm_eps)
        if "moe" in p:
            f = moe_mod.apply_moe(p["moe"], cfg, h)
        else:
            f = apply_ffn(p["ffn"], h)
        return x + f, new_cache

    def _apply_layers(self, params, x, positions, *, caches=None,
                      cache_len=0, remat_blocks=False):
        stacks = self._stacks()
        layers = {key: iter(_unstack(params[key])) for key, *_ in stacks}
        if caches is None:
            for key, _, window in self._schedule():
                block = _remat(
                    lambda p, xx, w=window: self._block(p, xx, positions,
                                                        window=w)[0],
                    remat_blocks)
                x = block(next(layers[key]), x)
            return x
        views = {ckey: iter(_unstack(caches[ckey])) for _, ckey, *_ in stacks}
        at = dict.fromkeys(views, cache_len)
        rows_leaf = "c" if self.mla else "k"
        if x.shape[1] == 1:
            # a decode step: each cache's row and length, once for all of
            # its layers (a ring's slot for the sliding window)
            at = {ckey: attn.decode_index(cache_len,
                                          caches[ckey][rows_leaf].shape[2],
                                          ring=window > 0)
                  for _, ckey, _, window in stacks}
        for key, ckey, window in self._schedule():
            c = next(views[ckey])
            x, _ = self._block(next(layers[key]), x, positions,
                               window=window,
                               cache=c["c"] if self.mla else (c["k"], c["v"]),
                               cache_len=at[ckey])
        return x, caches      # the per-layer views wrote into ``caches``

    def _embed_tokens(self, params, tokens, extra_embeds=None):
        cfg = self.cfg
        x = params["embed"][tokens]          # [B, S, d]
        if cfg.tie_embeddings:
            # the scale is rounded to the activation dtype first, as the
            # reference multiplies by an array of x.dtype
            scale = torch.tensor(cfg.d_model ** 0.5).to(x.dtype).item()
            x = x * scale
        if extra_embeds is not None:
            # VLM: first P positions come from the (stub) vision frontend
            pnum = extra_embeds.shape[1]
            x = torch.cat([extra_embeds.to(x.dtype), x[:, pnum:]], dim=1)
        return x

    def forward(self, params: dict, tokens: torch.Tensor,
                extra_embeds: Optional[torch.Tensor] = None,
                remat: bool = True) -> torch.Tensor:
        cfg = self.cfg
        x = self._embed_tokens(params, tokens, extra_embeds)
        positions = torch.arange(tokens.shape[1],
                                 device=tokens.device)[None, :]
        x = self._apply_layers(params, x, positions,
                               remat_blocks=remat and cfg.remat)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return self._logits(params, x)

    def train_loss(self, params: dict, batch: dict) -> torch.Tensor:
        """Mean cross-entropy of ``batch["tokens"]`` (and its
        ``extra_embeds``) at ``batch["labels"]``.  An MoE config adds no
        auxiliary term, as in the reference."""
        logits = self.forward(params, batch["tokens"],
                              batch.get("extra_embeds"))
        return softmax_xent(logits, batch["labels"])

    def _logits(self, params, x):
        cfg = self.cfg
        w = params["embed"] if cfg.tie_embeddings else params["head"]
        return unembed_logits(x, w, cfg.tie_embeddings)

    # --- caches ------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> dict:
        """Zeroed static cache ``{"blocks": {"k", "v"}}`` (``{"dense":
        ..., "moe": ...}`` when an MoE config starts with dense layers,
        ``{"local": ..., "global": ...}`` for gemma3's interleave), each
        leaf [layers, batch, rows, KV, head_dim] in the config's dtype:
        ``max_len`` rows, and ``min(sliding_window, max_len)`` for the
        local layers' rings, as the reference sizes them.  MLA keeps one
        compressed leaf per stack instead, ``{"c": [layers, batch,
        max_len, kv_lora_rank + qk_rope_head_dim]}``."""
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        out = {}
        for _, ckey, n, window in self._stacks():
            rows = min(window, max_len) if window else max_len
            if self.mla:
                m = cfg.mla
                out[ckey] = {"c": torch.zeros(
                    (n, batch, rows, m.kv_lora_rank + m.qk_rope_head_dim),
                    dtype=dt, device=self.device)}
                continue
            shape = (n, batch, rows, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
            out[ckey] = {
                "k": torch.zeros(shape, dtype=dt, device=self.device),
                "v": torch.zeros(shape, dtype=dt, device=self.device)}
        return out

    # prefill / decode ------------------------------------------------------
    def prefill(self, params: dict, tokens: torch.Tensor, cache,
                extra_embeds: Optional[torch.Tensor] = None):
        """Logits of the last position, [B, 1, vocab], and the cache
        (filled in place at positions [0, S))."""
        cfg = self.cfg
        x = self._embed_tokens(params, tokens, extra_embeds)
        positions = torch.arange(tokens.shape[1],
                                 device=tokens.device)[None, :]
        x, cache = self._apply_layers(params, x, positions, caches=cache,
                                      cache_len=0)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return self._logits(params, x[:, -1:]), cache

    def decode_step(self, params: dict, token: torch.Tensor, cache, pos):
        """token: [B, 1]; pos: the current cache length, a Python int or a
        0-d int64 tensor on the model's device (see :func:`decode_position`).
        Returns logits [B, 1, vocab] and the cache (row ``pos`` written in
        place)."""
        cfg = self.cfg
        x = self._embed_tokens(params, token)
        positions, pos = decode_position(pos, token.device)
        x, cache = self._apply_layers(params, x, positions, caches=cache,
                                      cache_len=pos)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return self._logits(params, x), cache
