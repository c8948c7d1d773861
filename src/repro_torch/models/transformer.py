"""Model assembly: stacked-parameter blocks and a loop over layers.

:class:`DecoderLM` mirrors ``repro.models.transformer.DecoderLM`` for the
non-interleaved GQA configurations, dense or MoE (``models/moe.py``; with
``moe_layer_start > 0`` the first layers are dense, stacked apart as
``dense_blocks``):

  * ``param_defs()``                      — ParamDef tree
  * ``init(generator)``                   — concrete params on the device
  * ``forward(params, tokens)``           — logits (prefill math)
  * ``init_cache(batch, max_len)``        — zeroed KV cache
  * ``prefill(params, tokens, cache)``    — fills cache, returns logits
  * ``decode_step(params, token, cache, pos)`` — one-token step

Per-layer params stay stacked on a leading axis, so a tree converted from
the JAX package lines up key for key; a Python loop over the unbound
layers takes the place of ``lax.scan``.  The KV cache is updated IN PLACE:
``prefill`` and ``decode_step`` return the cache tree they were given.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

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


class DecoderLM:
    """GQA decoder-only LM; optional MoE FFN; optional VLM patch
    embeddings (llava) via ``extra_embeds``.  MLA and the local:global
    sliding-window interleave (gemma3) are not ported yet and raise
    ``NotImplementedError`` at construction."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        if cfg.attention != "gqa":
            raise NotImplementedError(
                f"{cfg.name}: attention={cfg.attention!r} is not ported "
                f"yet (ROADMAP queue 1: MLA)")
        if cfg.local_global_pattern or cfg.sliding_window:
            raise NotImplementedError(
                f"{cfg.name}: local/global sliding-window layers are not "
                f"ported yet (ROADMAP queue 1: gemma3 local/global)")
        self.cfg = cfg
        self.device = resolve_device(device)

    # --- params ------------------------------------------------------------
    def _block_defs(self, is_moe_layer: bool) -> dict:
        cfg = self.cfg
        d = {
            "ln_attn": norm_defs(cfg.d_model),
            "ln_ffn": norm_defs(cfg.d_model),
            "attn": attn.gqa_defs(cfg),
        }
        if is_moe_layer:
            d["moe"] = moe_mod.moe_defs(cfg)
        else:
            d["ffn"] = ffn_defs(cfg.d_model, cfg.d_ff, cfg.dtype)
        return d

    def _stacks(self) -> list[tuple[str, str, int]]:
        """(param key, cache key, layers) of each stack, in execution
        order: ``dense_blocks`` then ``blocks`` when an MoE config starts
        with dense layers, else ``blocks`` alone."""
        cfg = self.cfg
        if cfg.moe is not None and cfg.moe_layer_start > 0:
            return [("dense_blocks", "dense", cfg.moe_layer_start),
                    ("blocks", "moe", cfg.num_layers - cfg.moe_layer_start)]
        return [("blocks", "blocks", cfg.num_layers)]

    def param_defs(self) -> dict:
        cfg = self.cfg
        defs: dict[str, Any] = {
            "embed": embed_defs(cfg.vocab_size, cfg.d_model, cfg.dtype),
            "ln_f": norm_defs(cfg.d_model),
        }
        if not cfg.tie_embeddings:
            defs["head"] = ParamDef((cfg.d_model, cfg.vocab_size),
                                    (FSDP, TP), cfg.dtype)
        for key, _, n in self._stacks():
            defs[key] = stack_defs(
                self._block_defs(cfg.moe is not None and key == "blocks"), n)
        return defs

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters drawn from ``generator``, which must live on
        the model's device (``torch.Generator(device=...)``)."""
        return init_params(self.param_defs(), generator, self.device)

    # --- forward -----------------------------------------------------------
    def _block(self, p: dict, x, positions, *, cache=None, cache_len=0):
        cfg = self.cfg
        h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
        a, new_cache = attn.gqa_attend(p["attn"], cfg, h, positions,
                                       cache=cache, cache_len=cache_len)
        x = x + a
        h = rms_norm(x, p["ln_ffn"], cfg.norm_eps)
        if "moe" in p:
            f = moe_mod.apply_moe(p["moe"], cfg, h)
        else:
            f = apply_ffn(p["ffn"], h)
        return x + f, new_cache

    def _apply_layers(self, params, x, positions, *, caches=None,
                      cache_len=0):
        for key, ckey, _ in self._stacks():
            layers = _unstack(params[key])
            if caches is None:
                for p in layers:
                    x, _ = self._block(p, x, positions)
                continue
            for p, c in zip(layers, _unstack(caches[ckey])):
                x, _ = self._block(p, x, positions, cache=(c["k"], c["v"]),
                                   cache_len=cache_len)
        if caches is None:
            return x
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
                extra_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        x = self._embed_tokens(params, tokens, extra_embeds)
        positions = torch.arange(tokens.shape[1],
                                 device=tokens.device)[None, :]
        x = self._apply_layers(params, x, positions)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return self._logits(params, x)

    def _logits(self, params, x):
        cfg = self.cfg
        w = params["embed"] if cfg.tie_embeddings else params["head"]
        return unembed_logits(x, w, cfg.tie_embeddings)

    # --- caches ------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> dict:
        """Zeroed static cache ``{"blocks": {"k", "v"}}`` (``{"dense":
        ..., "moe": ...}`` when an MoE config starts with dense layers),
        each leaf [layers, batch, max_len, KV, head_dim] in the config's
        dtype."""
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        out = {}
        for _, ckey, n in self._stacks():
            shape = (n, batch, max_len, cfg.num_kv_heads,
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

    def decode_step(self, params: dict, token: torch.Tensor, cache,
                    pos: int):
        """token: [B, 1]; pos: Python int, the current cache length.
        Returns logits [B, 1, vocab] and the cache (row ``pos`` written in
        place)."""
        cfg = self.cfg
        pos = int(pos)
        x = self._embed_tokens(params, token)
        positions = torch.full((1, 1), pos, dtype=torch.int64,
                               device=token.device)
        x, cache = self._apply_layers(params, x, positions, caches=cache,
                                      cache_len=pos)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return self._logits(params, x), cache
