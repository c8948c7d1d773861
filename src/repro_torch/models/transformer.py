"""Model assembly: stacked-parameter blocks and a loop over layers.

:class:`DecoderLM` mirrors ``repro.models.transformer.DecoderLM`` for the
dense, non-interleaved, non-MoE GQA configurations:

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
    """GQA decoder-only LM; optional VLM patch embeddings (llava) via
    ``extra_embeds``.  MoE FFNs, MLA and the local:global sliding-window
    interleave (gemma3) are not ported yet and raise
    ``NotImplementedError`` at construction."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        if cfg.attention != "gqa":
            raise NotImplementedError(
                f"{cfg.name}: attention={cfg.attention!r} is not ported "
                f"yet (ROADMAP queue 1: MLA)")
        if cfg.moe is not None:
            raise NotImplementedError(
                f"{cfg.name}: MoE FFNs are not ported yet (ROADMAP queue "
                f"1: moe.py + moe_gemm kernel)")
        if cfg.local_global_pattern or cfg.sliding_window:
            raise NotImplementedError(
                f"{cfg.name}: local/global sliding-window layers are not "
                f"ported yet (ROADMAP queue 1: gemma3 local/global)")
        self.cfg = cfg
        self.device = resolve_device(device)

    # --- params ------------------------------------------------------------
    def _block_defs(self) -> dict:
        cfg = self.cfg
        return {
            "ln_attn": norm_defs(cfg.d_model),
            "ln_ffn": norm_defs(cfg.d_model),
            "attn": attn.gqa_defs(cfg),
            "ffn": ffn_defs(cfg.d_model, cfg.d_ff, cfg.dtype),
        }

    def param_defs(self) -> dict:
        cfg = self.cfg
        defs: dict[str, Any] = {
            "embed": embed_defs(cfg.vocab_size, cfg.d_model, cfg.dtype),
            "ln_f": norm_defs(cfg.d_model),
        }
        if not cfg.tie_embeddings:
            defs["head"] = ParamDef((cfg.d_model, cfg.vocab_size),
                                    (FSDP, TP), cfg.dtype)
        defs["blocks"] = stack_defs(self._block_defs(), cfg.num_layers)
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
        return x + apply_ffn(p["ffn"], h), new_cache

    def _apply_layers(self, params, x, positions, *, caches=None,
                      cache_len=0):
        layers = _unstack(params["blocks"])
        if caches is None:
            for p in layers:
                x, _ = self._block(p, x, positions)
            return x
        layer_caches = _unstack(caches["blocks"])
        for p, c in zip(layers, layer_caches):
            x, _ = self._block(p, x, positions, cache=(c["k"], c["v"]),
                               cache_len=cache_len)
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
        """Zeroed static cache ``{"blocks": {"k", "v"}}``, each leaf
        [layers, batch, max_len, KV, head_dim] in the config's dtype."""
        cfg = self.cfg
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        dt = torch_dtype(cfg.dtype)
        return {"blocks": {
            "k": torch.zeros(shape, dtype=dt, device=self.device),
            "v": torch.zeros(shape, dtype=dt, device=self.device)}}

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
