"""Model registry of the port (the counterpart of
``repro.models.families``).

Ported: the GQA decoder family (``DecoderLM``, dense and MoE) and
:class:`RWKVLM`.  ``Mamba2Hybrid`` and ``EncDecLM`` raise
``NotImplementedError`` naming the ROADMAP item they wait for.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.layers import (FSDP, TP, ParamDef, embed_defs,
                                       init_params, norm_defs, rms_norm,
                                       stack_defs, torch_dtype,
                                       unembed_logits)
from repro_torch.models.transformer import DecoderLM, _unstack


class RWKVLM:
    """rwkv6-3b: attention-free, with a fixed-size recurrent state as its
    cache.  The facade of :class:`DecoderLM`: ``param_defs``, ``init``,
    ``forward``, ``init_cache``, ``prefill``, ``decode_step``; the cache
    (``shift``, ``wkv``, ``cshift`` per layer) is updated IN PLACE."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    def _block_defs(self) -> dict:
        cfg = self.cfg
        d = rwkv_mod.rwkv6_defs(cfg)
        d["ln_time"] = norm_defs(cfg.d_model)
        d["ln_channel"] = norm_defs(cfg.d_model)
        return d

    def param_defs(self) -> dict:
        cfg = self.cfg
        return {
            "embed": embed_defs(cfg.vocab_size, cfg.d_model, cfg.dtype),
            "ln_in": norm_defs(cfg.d_model),
            "ln_f": norm_defs(cfg.d_model),
            "head": ParamDef((cfg.d_model, cfg.vocab_size), (FSDP, TP),
                             cfg.dtype),
            "blocks": stack_defs(self._block_defs(), cfg.num_layers),
        }

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters drawn from ``generator``, which must live on
        the model's device."""
        return init_params(self.param_defs(), generator, self.device)

    def _block(self, p, x, state):
        cfg = self.cfg
        h = rms_norm(x, p["ln_time"], cfg.norm_eps)
        t_out, t_state = rwkv_mod.rwkv6_time_mix(p, cfg, h, state)
        x = x + t_out
        h = rms_norm(x, p["ln_channel"], cfg.norm_eps)
        c_out, c_state = rwkv_mod.rwkv6_channel_mix(p, cfg, h, state)
        return x + c_out, {**t_state, **c_state}

    def _run(self, params, x, cache=None):
        """The layer loop; with a cache, each layer starts from its state
        there and writes its new state back into it."""
        layers = _unstack(params["blocks"])
        if cache is None:
            for p in layers:
                x, _ = self._block(p, x, {})
            return x
        for p, st in zip(layers, _unstack(cache)):
            x, new = self._block(p, x, st)
            for key, view in st.items():
                view.copy_(new[key])
        return x

    def _embed(self, params, tokens):
        return rms_norm(params["embed"][tokens], params["ln_in"],
                        self.cfg.norm_eps)

    def _logits(self, params, x):
        x = rms_norm(x, params["ln_f"], self.cfg.norm_eps)
        return unembed_logits(x, params["head"], False)

    def forward(self, params: dict, tokens: torch.Tensor,
                extra_embeds=None) -> torch.Tensor:
        return self._logits(params, self._run(params,
                                              self._embed(params, tokens)))

    def init_cache(self, batch: int, max_len: int) -> dict:
        """Zeroed recurrent states, each leaf [layers, batch, ...]
        (``max_len`` is not used: the state does not grow)."""
        cfg = self.cfg
        return {k: torch.zeros((cfg.num_layers,) + shape,
                               dtype=torch_dtype(dt), device=self.device)
                for k, (shape, dt) in
                rwkv_mod.rwkv6_state_defs(cfg, batch).items()}

    def prefill(self, params: dict, tokens: torch.Tensor, cache,
                extra_embeds=None):
        """Logits of the last position, [B, 1, vocab], and the cache
        (every layer's state written in place)."""
        x = self._run(params, self._embed(params, tokens), cache)
        return self._logits(params, x[:, -1:]), cache

    def decode_step(self, params: dict, token: torch.Tensor, cache,
                    pos: int):
        """token: [B, 1]; ``pos`` is not used (the state carries the
        position).  Returns logits [B, 1, vocab] and the cache."""
        x = self._run(params, self._embed(params, token), cache)
        return self._logits(params, x), cache


class Mamba2Hybrid:
    def __init__(self, cfg: ArchConfig, device="cuda"):
        raise NotImplementedError(
            f"{cfg.name}: Mamba2 hybrid models are not ported yet (ROADMAP "
            f"queue 1: ssm.py + mamba2_scan kernel)")


class EncDecLM:
    def __init__(self, cfg: ArchConfig, device="cuda"):
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet "
            f"(ROADMAP queue 1: EncDecLM)")


def build_model(cfg: ArchConfig, device="cuda"):
    """The model class for ``cfg`` on ``device`` (default: the GPU; raises
    when there is none)."""
    if cfg.family == "ssm" and cfg.rwkv is not None:
        return RWKVLM(cfg, device)
    if cfg.family == "hybrid":
        return Mamba2Hybrid(cfg, device)
    if cfg.family == "audio":
        return EncDecLM(cfg, device)
    return DecoderLM(cfg, device)
