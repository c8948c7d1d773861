"""GQA attention block of the port.

Unlike the JAX models, which run XLA twins of the TPU kernels, this block
goes through the hand-written kernels: the prefill branch of
:func:`gqa_attend` calls ``kernels.ops.flash_attention`` and its decode
branch ``kernels.ops.decode_attention``.  The projections around them are
plain matrix products, as they are einsums outside any kernel in the
reference.

Waiting for later slices (each raises ``NotImplementedError``): sliding
windows and the rolling window cache (ROADMAP queue 1, "gemma3
local/global"), sequence-parallel prefill (``flash_attention_sp``; ROADMAP
queue 1, "Launch / analysis") and MLA (ROADMAP queue 1, "MLA").
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import (FSDP, TP, ParamDef, apply_rope)


def gqa_defs(cfg) -> dict:
    d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    dt = cfg.dtype
    defs = {
        "wq": ParamDef((d, h, hd), (FSDP, TP, None), dt),
        "wk": ParamDef((d, kv, hd), (FSDP, TP, None), dt),
        "wv": ParamDef((d, kv, hd), (FSDP, TP, None), dt),
        "wo": ParamDef((h, hd, d), (TP, None, FSDP), dt,
                       fan_in_axes=(0, 1)),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((h, hd), (TP, None), dt, init="zeros")
        defs["bk"] = ParamDef((kv, hd), (TP, None), dt, init="zeros")
        defs["bv"] = ParamDef((kv, hd), (TP, None), dt, init="zeros")
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), (None,), "float32", init="zeros")
        defs["k_norm"] = ParamDef((hd,), (None,), "float32", init="zeros")
    return defs


def _qk_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + gamma.float())).to(dt)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, S, d] times w [d, heads, hd] -> [B, S, heads, hd]."""
    d, heads, hd = w.shape
    return (x @ w.reshape(d, heads * hd)).view(*x.shape[:-1], heads, hd)


def gqa_project_qkv(p: dict, cfg, x: torch.Tensor,
                    positions: torch.Tensor):
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = _qk_norm(q, p["q_norm"], cfg.norm_eps)
        k = _qk_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attend(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor, *,
               causal: bool = True, window: int = 0,
               cache: Optional[tuple] = None, cache_len: int = 0):
    """Full-sequence (prefill) or decode attention.

    Returns (out, new_cache).  cache = (k_cache, v_cache) of static shape
    [B, S_max, KV, D]; prefill writes positions [0, Sq); decode writes at
    ``cache_len`` and attends over ``cache_len + 1`` rows.  The cache is
    updated IN PLACE and the same tensors are returned.  ``cache_len`` is
    a Python int.
    """
    if window:
        raise NotImplementedError(
            "sliding-window attention and the rolling window cache are "
            "not ported yet (ROADMAP queue 1: gemma3 local/global)")
    b, sq, _ = x.shape
    q, k, v = gqa_project_qkv(p, cfg, x, positions)
    new_cache = None
    if cache is not None:
        k_cache, v_cache = cache
        if sq > k_cache.shape[1] - cache_len:
            raise NotImplementedError(
                f"{sq} new positions do not fit a cache of "
                f"{k_cache.shape[1]} rows filled to {cache_len}; keeping "
                f"only the tail belongs to the windowed cache (ROADMAP "
                f"queue 1: gemma3 local/global)")
        k_cache[:, cache_len: cache_len + sq] = k
        v_cache[:, cache_len: cache_len + sq] = v
        new_cache = (k_cache, v_cache)
        if sq == 1:   # decode against the full-length cache
            out = ops.decode_attention(q, k_cache, v_cache, cache_len + 1)
            return _proj_out(p, out), new_cache
        # prefill attends over freshly computed k/v (cache == prefix here)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    return _proj_out(p, out), new_cache


def _proj_out(p: dict, out: torch.Tensor) -> torch.Tensor:
    """out [B, S, H, hd] times wo [H, hd, d] -> [B, S, d]."""
    h, hd, d = p["wo"].shape
    return out.reshape(*out.shape[:2], h * hd) @ p["wo"].reshape(h * hd, d)


def flash_attention_sp(*args, **kwargs):
    raise NotImplementedError(
        "sequence-parallel prefill needs a device mesh and is not ported "
        "yet (ROADMAP queue 1: Launch / analysis)")


def mla_defs(cfg):
    raise NotImplementedError(
        "multi-head latent attention is not ported yet (ROADMAP queue 1: "
        "MLA)")


def mla_attend(*args, **kwargs):
    raise NotImplementedError(
        "multi-head latent attention is not ported yet (ROADMAP queue 1: "
        "MLA)")
