"""Model registry of the port (the counterpart of
``repro.models.families``).

Every family of the reference: the decoder family (``DecoderLM``: GQA
or deepseek-v2's latent attention, dense and MoE, gemma3's local/global
layers, llava's image embeddings), :class:`RWKVLM`,
:class:`Mamba2Hybrid` and the encoder-decoder :class:`EncDecLM`
(whisper).

Each has ``train_loss(params, batch)``, the mean float32 cross-entropy of
its ``forward``, whose ``remat`` recomputes each block in the backward
where ``cfg.remat`` is set, as the reference's ``_remat`` does: every
RWKV6 block, every Mamba2 block (not the hybrid's shared attention
block), and every encoder and decoder block of whisper.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (FSDP, TP, ParamDef, apply_ffn,
                                       embed_defs, ffn_defs, init_params,
                                       norm_defs, rms_norm, stack_defs,
                                       torch_dtype, unembed_logits)
from repro_torch.models.transformer import (DecoderLM, _remat, _unstack,
                                            decode_position, softmax_xent)


def _head_logits(params: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Final norm and the untied head of RWKVLM and Mamba2Hybrid."""
    return unembed_logits(rms_norm(x, params["ln_f"], eps), params["head"],
                          False)


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

    def _run(self, params, x, cache=None, remat_blocks=False):
        """The layer loop; with a cache, each layer starts from its state
        there and writes its new state back into it."""
        layers = _unstack(params["blocks"])
        if cache is None:
            block = _remat(lambda p, xx: self._block(p, xx, {})[0],
                           remat_blocks)
            for p in layers:
                x = block(p, x)
            return x
        for p, st in zip(layers, _unstack(cache)):
            x, new = self._block(p, x, st)
            for key, view in st.items():
                view.copy_(new[key])
        return x

    def _embed(self, params, tokens):
        return rms_norm(params["embed"][tokens], params["ln_in"],
                        self.cfg.norm_eps)

    def forward(self, params: dict, tokens: torch.Tensor,
                extra_embeds=None, remat: bool = True) -> torch.Tensor:
        x = self._run(params, self._embed(params, tokens),
                      remat_blocks=remat and self.cfg.remat)
        return _head_logits(params, x, self.cfg.norm_eps)

    def train_loss(self, params: dict, batch: dict) -> torch.Tensor:
        return softmax_xent(self.forward(params, batch["tokens"]),
                            batch["labels"])

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
        return _head_logits(params, x[:, -1:], self.cfg.norm_eps), cache

    def decode_step(self, params: dict, token: torch.Tensor, cache, pos):
        """token: [B, 1]; ``pos`` is not used (the state carries the
        position).  Returns logits [B, 1, vocab] and the cache."""
        x = self._run(params, self._embed(params, token), cache)
        return _head_logits(params, x, self.cfg.norm_eps), cache


class Mamba2Hybrid:
    """zamba2-2.7b: a stack of Mamba2 blocks with ONE shared attention
    block applied after every ``attn_every``-th of them (same parameters,
    a KV cache per site).  The facade of :class:`RWKVLM`; the cache
    ``{"ssm": {"ssm", "conv"}, "kv": {"k", "v"}}`` (leaves [layers or
    sites, batch, ...]) is updated IN PLACE, and ``cache_len`` / ``pos``
    are Python ints or, at a decode step, ``pos`` a 0-d int64 tensor on the
    device."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        if cfg.ssm is None:
            raise ValueError(f"{cfg.name}: a Mamba2 hybrid needs cfg.ssm")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_attn = (cfg.num_layers // cfg.attn_every
                       if cfg.attn_every else 0)

    def _ssm_block_defs(self) -> dict:
        cfg = self.cfg
        return {"ln": norm_defs(cfg.d_model),
                "ssm": ssm_mod.mamba2_defs(cfg)}

    def _attn_block_defs(self) -> dict:
        cfg = self.cfg
        return {"ln_attn": norm_defs(cfg.d_model),
                "ln_ffn": norm_defs(cfg.d_model),
                "attn": attn.gqa_defs(cfg),
                "ffn": ffn_defs(cfg.d_model, cfg.d_ff, cfg.dtype)}

    def param_defs(self) -> dict:
        cfg = self.cfg
        return {
            "embed": embed_defs(cfg.vocab_size, cfg.d_model, cfg.dtype),
            "ln_f": norm_defs(cfg.d_model),
            "head": ParamDef((cfg.d_model, cfg.vocab_size), (FSDP, TP),
                             cfg.dtype),
            "blocks": stack_defs(self._ssm_block_defs(), cfg.num_layers),
            "shared_attn": self._attn_block_defs(),    # ONE shared block
        }

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters drawn from ``generator``, which must live on
        the model's device."""
        return init_params(self.param_defs(), generator, self.device)

    def _ssm_block(self, p, x, state, decode: bool):
        h = rms_norm(x, p["ln"], self.cfg.norm_eps)
        if decode:
            out, new = ssm_mod.mamba2_decode(p["ssm"], self.cfg, h, state)
        else:
            out, new = ssm_mod.mamba2_forward(p["ssm"], self.cfg, h,
                                              state=state)
        return x + out, new

    def _attn_block(self, p, x, positions, cache, cache_len):
        cfg = self.cfg
        h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
        a, _ = attn.gqa_attend(p["attn"], cfg, h, positions, cache=cache,
                               cache_len=cache_len)
        x = x + a
        h = rms_norm(x, p["ln_ffn"], cfg.norm_eps)
        return x + apply_ffn(p["ffn"], h)

    def _run(self, params, x, positions, cache=None, cache_len=0,
             decode=False, remat_blocks=False):
        """Layer i is a Mamba2 block; after every ``attn_every``-th comes
        the shared attention block with its site's KV cache, and the last
        ``num_layers % attn_every`` layers form the tail.  With a cache,
        each layer starts from its state there and writes its new state
        back into it."""
        k = self.cfg.attn_every
        layers = _unstack(params["blocks"])
        states = (_unstack(cache["ssm"]) if cache is not None
                  else [None] * len(layers))
        kvs = (_unstack(cache["kv"]) if cache is not None
               else [None] * self.n_attn)
        fresh = _remat(
            lambda p, xx: self._ssm_block(p, xx, None, False)[0],
            remat_blocks)
        for i, (p, st) in enumerate(zip(layers, states)):
            if st is None:
                x = fresh(p, x)
            else:
                x, new = self._ssm_block(p, x, st, decode)
                for key, view in st.items():
                    view.copy_(new[key])
            if k and (i + 1) % k == 0:
                kv = kvs[(i + 1) // k - 1]
                x = self._attn_block(
                    params["shared_attn"], x, positions,
                    (kv["k"], kv["v"]) if kv is not None else None,
                    cache_len)
        return x

    def forward(self, params: dict, tokens: torch.Tensor,
                extra_embeds=None, remat: bool = True) -> torch.Tensor:
        positions = torch.arange(tokens.shape[1],
                                 device=tokens.device)[None, :]
        x = self._run(params, params["embed"][tokens], positions,
                      remat_blocks=remat and self.cfg.remat)
        return _head_logits(params, x, self.cfg.norm_eps)

    def train_loss(self, params: dict, batch: dict) -> torch.Tensor:
        return softmax_xent(self.forward(params, batch["tokens"]),
                            batch["labels"])

    def init_cache(self, batch: int, max_len: int) -> dict:
        """Zeroed states ``{"ssm": {"ssm", "conv"}}``, each leaf
        [layers, batch, ...], and a KV cache ``{"kv": {"k", "v"}}``, each
        leaf [sites, batch, max_len, KV, head_dim] in the config's dtype."""
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        kv_shape = (self.n_attn, batch, max_len, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
        return {
            "ssm": {k: torch.zeros((cfg.num_layers,) + shape,
                                   dtype=torch_dtype(sdt), device=self.device)
                    for k, (shape, sdt) in
                    ssm_mod.mamba2_state_defs(cfg, batch).items()},
            "kv": {"k": torch.zeros(kv_shape, dtype=dt, device=self.device),
                   "v": torch.zeros(kv_shape, dtype=dt, device=self.device)},
        }

    def prefill(self, params: dict, tokens: torch.Tensor, cache,
                extra_embeds=None):
        """Logits of the last position, [B, 1, vocab], and the cache
        (states written in place, KV rows [0, S) filled)."""
        positions = torch.arange(tokens.shape[1],
                                 device=tokens.device)[None, :]
        x = self._run(params, params["embed"][tokens], positions, cache,
                      cache_len=0)
        return _head_logits(params, x[:, -1:], self.cfg.norm_eps), cache

    def decode_step(self, params: dict, token: torch.Tensor, cache, pos):
        """token: [B, 1]; pos: the current cache length, a Python int or a
        0-d int64 tensor on the model's device (see
        :func:`~repro_torch.models.transformer.decode_position`).  Returns
        logits [B, 1, vocab] and the cache (updated in place)."""
        positions, pos = decode_position(pos, token.device)
        x = self._run(params, params["embed"][token], positions, cache,
                      cache_len=pos, decode=True)
        return _head_logits(params, x, self.cfg.norm_eps), cache


class EncDecLM:
    """whisper-small: a bidirectional encoder over (stub) frame embeddings
    and a decoder of causal self-attention, cross-attention to the
    encoder's output and a SwiGLU FFN.  The facade of :class:`RWKVLM`,
    with the frames as ``extra_embeds``; the cache ``{"self": {"k", "v"},
    "enc_out"}`` (self K/V [layers, batch, max_len, KV, head_dim], the
    encoder's output [batch, encoder_frames, d]) is updated IN PLACE, and
    ``pos`` is a Python int or a 0-d int64 tensor on the device.

    As in the reference, a decode step projects the cross-attention's keys
    and values from ``enc_out`` again in every layer
    (``repro.models.families.EncDecLM._cross_attend``)."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    def _enc_block_defs(self) -> dict:
        cfg = self.cfg
        return {"ln_attn": norm_defs(cfg.d_model),
                "ln_ffn": norm_defs(cfg.d_model),
                "attn": attn.gqa_defs(cfg),
                "ffn": ffn_defs(cfg.d_model, cfg.d_ff, cfg.dtype)}

    def _dec_block_defs(self) -> dict:
        d = self._enc_block_defs()
        d["ln_cross"] = norm_defs(self.cfg.d_model)
        d["cross"] = attn.gqa_defs(self.cfg)
        return d

    def param_defs(self) -> dict:
        cfg = self.cfg
        return {
            "embed": embed_defs(cfg.vocab_size, cfg.d_model, cfg.dtype),
            "pos_enc": ParamDef((cfg.encoder_frames, cfg.d_model),
                                (None, FSDP), cfg.dtype, init="small"),
            "ln_f": norm_defs(cfg.d_model),
            "ln_enc": norm_defs(cfg.d_model),
            "head": ParamDef((cfg.d_model, cfg.vocab_size), (FSDP, TP),
                             cfg.dtype),
            "encoder": stack_defs(self._enc_block_defs(),
                                  cfg.encoder_layers),
            "decoder": stack_defs(self._dec_block_defs(), cfg.num_layers),
        }

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters drawn from ``generator``, which must live on
        the model's device."""
        return init_params(self.param_defs(), generator, self.device)

    def encode(self, params: dict, frames: torch.Tensor,
               remat: bool = False) -> torch.Tensor:
        """frames: [B, T, d] precomputed conv-frontend embeddings (stub);
        self-attention through K1 with ``causal=False`` and rope at
        ``arange(T)``, as the reference does."""
        cfg = self.cfg
        if frames is None:
            raise ValueError(
                f"{cfg.name}: an encoder-decoder model needs its encoder "
                f"frames, extra_embeds [B, {cfg.encoder_frames}, "
                f"{cfg.d_model}]")
        x = frames.to(torch_dtype(cfg.dtype))
        x = x + params["pos_enc"][None, : x.shape[1]]
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        block = _remat(lambda p, xx: self._enc_block(p, xx, positions),
                       remat and cfg.remat)
        for p in _unstack(params["encoder"]):
            x = block(p, x)
        return rms_norm(x, params["ln_enc"], cfg.norm_eps)

    def _enc_block(self, p, x, positions):
        cfg = self.cfg
        h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
        a, _ = attn.gqa_attend(p["attn"], cfg, h, positions, causal=False)
        x = x + a
        h = rms_norm(x, p["ln_ffn"], cfg.norm_eps)
        return x + apply_ffn(p["ffn"], h)

    def _cross_attend(self, p, x, enc_out):
        """Queries from the decoder state, keys and values from
        ``enc_out`` (no rope), all rows valid.  Several queries go through
        K1 with ``causal=False``; one query (a decode step) through K2 at
        the int length Sk, which is the same function as the reference's
        ``flash_attention(q, k, v, causal=False)`` with one query row and
        does not launch a 64-row K1 tile that holds one valid row."""
        q = attn._project(x, p["wq"])
        k = attn._project(enc_out, p["wk"])
        v = attn._project(enc_out, p["wv"])
        if x.shape[1] == 1:
            out = ops.decode_attention(q, k, v, k.shape[1])
        else:
            out = ops.flash_attention(q, k, v, causal=False)
        return attn._proj_out(p, out)

    def _dec_block(self, p, x, positions, enc_out, cache, cache_len):
        cfg = self.cfg
        h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
        a, _ = attn.gqa_attend(p["attn"], cfg, h, positions, cache=cache,
                               cache_len=cache_len)
        x = x + a
        h = rms_norm(x, p["ln_cross"], cfg.norm_eps)
        x = x + self._cross_attend(p["cross"], h, enc_out)
        h = rms_norm(x, p["ln_ffn"], cfg.norm_eps)
        return x + apply_ffn(p["ffn"], h)

    def decode(self, params: dict, tokens: torch.Tensor,
               enc_out: torch.Tensor, caches=None, cache_len=0,
               remat: bool = False):
        """The decoder over ``tokens`` [B, S] attending ``enc_out``: the
        logits [B, S, vocab].  With ``caches`` (the ``"self"`` part of the
        cache) a prefill (S > 1, ``cache_len`` an int) writes rows
        [cache_len, cache_len + S) and a decode step (S == 1) row
        ``cache_len``, an int or a 0-d int64 tensor on the device."""
        cfg = self.cfg
        x = params["embed"][tokens]
        layers = _unstack(params["decoder"])
        if tokens.shape[1] > 1:
            positions = torch.arange(tokens.shape[1],
                                     device=tokens.device)[None, :] \
                + cache_len
        else:
            positions, cache_len = decode_position(cache_len, tokens.device)
        if caches is None:
            block = _remat(lambda p, xx: self._dec_block(p, xx, positions,
                                                         enc_out, None, 0),
                           remat and cfg.remat)
            for p in layers:
                x = block(p, x)
        else:
            if tokens.shape[1] == 1:
                # the row and length once, for every layer of the step
                cache_len = attn.decode_index(cache_len,
                                              caches["k"].shape[2])
            for p, c in zip(layers, _unstack(caches)):
                x = self._dec_block(p, x, positions, enc_out,
                                    (c["k"], c["v"]), cache_len)
        return _head_logits(params, x, cfg.norm_eps)

    def forward(self, params: dict, tokens: torch.Tensor,
                extra_embeds=None, remat: bool = True) -> torch.Tensor:
        """extra_embeds = encoder frames [B, T, d]."""
        return self.decode(params, tokens,
                           self.encode(params, extra_embeds, remat=remat),
                           remat=remat)

    def train_loss(self, params: dict, batch: dict) -> torch.Tensor:
        """The decoder's cross-entropy over the frames
        ``batch["extra_embeds"]``, as the reference's."""
        logits = self.forward(params, batch["tokens"], batch["extra_embeds"])
        return softmax_xent(logits, batch["labels"])

    def cache_defs(self, batch: int, max_len: int) -> dict:
        """(shape, dtype) of each cache leaf, as the reference's
        ``cache_defs``."""
        cfg = self.cfg
        kv = ((cfg.num_layers, batch, max_len, cfg.num_kv_heads,
               cfg.resolved_head_dim), cfg.dtype)
        return {"self": {"k": kv, "v": kv},
                "enc_out": ((batch, cfg.encoder_frames, cfg.d_model),
                            cfg.dtype)}

    def init_cache(self, batch: int, max_len: int) -> dict:
        """Zeroed leaves of :meth:`cache_defs` on the model's device."""
        def make(node):
            if isinstance(node, dict):
                return {k: make(v) for k, v in node.items()}
            shape, dt = node
            return torch.zeros(shape, dtype=torch_dtype(dt),
                               device=self.device)
        return make(self.cache_defs(batch, max_len))

    def prefill(self, params: dict, tokens: torch.Tensor, cache,
                extra_embeds=None):
        """Encode the frames ``extra_embeds`` [B, encoder_frames, d] into
        the cache's ``enc_out`` (copied in place, so that a captured decode
        step reads them) and prefill the decoder over ``tokens``: logits
        of the last position, [B, 1, vocab], and the cache."""
        enc = self.encode(params, extra_embeds)
        if enc.shape != cache["enc_out"].shape:
            raise ValueError(
                f"{self.cfg.name}: frames {tuple(extra_embeds.shape)} do "
                f"not fill the cache's enc_out "
                f"{tuple(cache['enc_out'].shape)}")
        cache["enc_out"].copy_(enc)
        logits = self.decode(params, tokens, cache["enc_out"],
                             caches=cache["self"], cache_len=0)
        return logits[:, -1:], cache

    def decode_step(self, params: dict, token: torch.Tensor, cache, pos):
        """token: [B, 1]; pos: the current cache length, a Python int or a
        0-d int64 tensor on the model's device.  Returns logits [B, 1,
        vocab] and the cache (row ``pos`` written in place)."""
        logits = self.decode(params, token, cache["enc_out"],
                             caches=cache["self"], cache_len=pos)
        return logits, cache


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
