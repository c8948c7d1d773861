"""Attention blocks of the port: GQA, and deepseek-v2's multi-head latent
attention (MLA).

Unlike the JAX models, which run XLA twins of the TPU kernels, these
blocks go through the hand-written kernels: the prefill branches of
:func:`gqa_attend` and :func:`mla_attend` call
``kernels.ops.flash_attention`` (MLA's with a value head dim unlike its
query/key dim), and the decode branch of :func:`gqa_attend`
``kernels.ops.decode_attention``.  The projections around them, and MLA's
absorbed decode step, are plain matrix products, as they are einsums
outside any kernel in the reference.

Sliding windows (gemma3's local layers) keep their cache as a ring of
``L = min(window, max_len)`` rows, position ``p`` in slot ``p mod L``
(:func:`decode_index`); see :func:`gqa_attend` for how that differs from
the reference's rolling cache.

A prefill goes through :func:`flash_attention_sp`, which splits the
queries into lanes where a mesh's model axis does not divide the head
count (:func:`seq_parallel_degree`); with no mesh, as on one card, it is
one K1 call.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import NEG_INF
from repro_torch.models.layers import (DP, FSDP, TP, ParamDef, apply_rope,
                                       axis_len, axis_names, get_axis_env,
                                       rms_norm, shard_activation)


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


@dataclasses.dataclass(frozen=True)
class DecodeIndex:
    """Where a decode step at position ``pos`` writes its row in a cache of
    ``rows`` rows, and how many rows K2 then attends: Python ints, or (for
    a 0-d int64 ``pos`` on the device) a one-element int64 ``row`` and a
    0-d int32 ``length`` on the device."""
    row: Union[int, torch.Tensor]
    length: Union[int, torch.Tensor]


def decode_index(pos, rows: int, ring: bool = False) -> DecodeIndex:
    """The :class:`DecodeIndex` of position ``pos`` in a cache of ``rows``
    rows: row ``pos`` and length ``pos + 1`` in a linear cache, which
    must hold the position; slot ``pos mod rows`` and length
    ``min(pos + 1, rows)`` in a ring (a sliding window's cache).  A model
    computes it once per step and cache shape, so that the layers add no
    kernels for it to a captured step."""
    if isinstance(pos, torch.Tensor):
        if ring:
            return DecodeIndex(torch.remainder(pos, rows).view(1),
                               torch.clamp(pos + 1, max=rows)
                               .to(torch.int32))
        return DecodeIndex(pos.view(1), (pos + 1).to(torch.int32))
    pos = int(pos)
    if ring:
        return DecodeIndex(pos % rows, min(pos + 1, rows))
    if pos >= rows:
        raise NotImplementedError(
            f"position {pos} does not fit a cache of {rows} rows; only a "
            f"sliding window's cache keeps a tail")
    return DecodeIndex(pos, pos + 1)


def gqa_attend(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor, *,
               causal: bool = True, window: int = 0,
               cache: Optional[tuple] = None, cache_len=0):
    """Full-sequence (prefill) or decode attention.

    Returns (out, new_cache).  cache = (k_cache, v_cache) of static shape
    [B, S_cache, KV, D]; prefill writes positions [cache_len, cache_len +
    Sq); a decode step (Sq == 1) writes position ``cache_len`` and attends
    over every position written so far.  The cache is updated IN PLACE and
    the same tensors are returned.  ``cache_len`` is a Python int or, for a
    decode step, a 0-d int64 tensor on the device (the reference's traced
    ``pos``) or a :class:`DecodeIndex` computed from one: the row is then
    written by ``index_copy_`` and K2 reads its length on the device, so
    that a captured CUDA graph replays the step at every position.

    With ``window > 0`` (a local layer) the cache is a ring of S_cache rows
    (``min(window, max_len)``, as the reference sizes it): position ``p``
    lives in slot ``p mod S_cache``, a prefill longer than the ring keeps
    its last S_cache positions, and a decode step attends the ring's
    ``min(pos + 1, S_cache)`` valid rows.  The reference instead shifts its
    rolling cache left and appends at the end (a copy of the whole cache
    per step); both hold the same set of rows, in another order, so the
    attention is the same.  Where S_cache = max_len < window the ring never
    wraps and is the reference's layout.  Where the prompt is shorter than
    a window that fits max_len, the reference attends zero rows at the end
    of its rolling cache and the port the rows the prompt wrote (ROADMAP
    H23).  A linear (global) cache must hold every position: a longer
    prefill or a later decode step raises ``NotImplementedError``.
    """
    b, sq, _ = x.shape
    q, k, v = gqa_project_qkv(p, cfg, x, positions)
    new_cache = None
    if cache is not None:
        k_cache, v_cache = cache
        rows = k_cache.shape[1]
        if window and rows > window:
            raise ValueError(
                f"a sliding window of {window} keeps a cache of at most "
                f"{window} rows, got {rows}")
        if sq == 1:             # a decode step
            idx = cache_len if isinstance(cache_len, DecodeIndex) else \
                decode_index(cache_len, rows, ring=window > 0)
            if isinstance(idx.row, torch.Tensor):
                k_cache.index_copy_(1, idx.row, k)
                v_cache.index_copy_(1, idx.row, v)
            else:
                k_cache[:, idx.row: idx.row + 1] = k
                v_cache[:, idx.row: idx.row + 1] = v
            out = ops.decode_attention(q, k_cache, v_cache, idx.length)
            return _proj_out(p, out), cache
        if not isinstance(cache_len, int):
            raise ValueError(
                f"a prefill of {sq} positions takes an int cache_len, got "
                f"{type(cache_len).__name__}")
        if window and cache_len + sq > rows:
            # the ring keeps the last `rows` positions, each in its slot
            n = min(sq, rows)
            slots = torch.arange(cache_len + sq - n, cache_len + sq,
                                 device=k.device) % rows
            k_cache.index_copy_(1, slots, k[:, sq - n:])
            v_cache.index_copy_(1, slots, v[:, sq - n:])
        elif cache_len + sq > rows:
            raise NotImplementedError(
                f"{sq} new positions do not fit a cache of {rows} rows "
                f"filled to {cache_len}; only a sliding window's cache "
                f"keeps a tail")
        else:
            k_cache[:, cache_len: cache_len + sq] = k
            v_cache[:, cache_len: cache_len + sq] = v
        new_cache = (k_cache, v_cache)
        # prefill attends over freshly computed k/v (cache == prefix here)
    out = flash_attention_sp(q, k, v, causal=causal, window=window,
                             n_sp=seq_parallel_degree(cfg.num_heads))
    return _proj_out(p, out), new_cache


def _proj_out(p: dict, out: torch.Tensor) -> torch.Tensor:
    """out [B, S, H, hd] times wo [H, hd, d] -> [B, S, d]."""
    h, hd, d = p["wo"].shape
    return out.reshape(*out.shape[:2], h * hd) @ p["wo"].reshape(h * hd, d)


def seq_parallel_degree(num_heads: int) -> int:
    """The reference's sequence-parallel degree: with a mesh whose
    ``model`` axis does not divide the head count, that axis's size (the
    queries are split into that many lanes instead of the heads); else,
    and with no mesh, 1."""
    env = get_axis_env()
    mesh = None if env is None else env.get("mesh")
    if mesh is None or "model" not in axis_names(mesh):
        return 1
    tp = axis_len(mesh, "model")
    return 1 if num_heads % tp == 0 else tp


def flash_attention_sp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, causal: bool = True, window: int = 0,
                       n_sp: int = 1) -> torch.Tensor:
    """Sequence-parallel prefill attention: q [B, Sq, H, D] cut into
    ``n_sp`` lanes of Sq / n_sp queries (the lane dim placed on the model
    axis where a mesh is set, ``shard_activation``), each one K1 call
    over the whole k and v with ``q_offset = lane * Sq / n_sp``, so its
    causal and window tests see the lane's own positions.  Returns
    [B, Sq, H, Dv].  With ``n_sp <= 1``, or Sq not a multiple of it,
    exactly one ``ops.flash_attention`` call, as on one card.  On one
    device the lanes run one after the other, each a counted launch."""
    b, sq, h, d = q.shape
    if n_sp <= 1 or sq % n_sp:
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    lane = sq // n_sp
    qs = shard_activation(q.reshape(b, n_sp, lane, h, d),
                          DP, TP, None, None, None)
    return torch.cat([ops.flash_attention(qs[:, i], k, v, causal=causal,
                                          window=window, q_offset=i * lane)
                      for i in range(n_sp)], dim=1)


# ---------------------------------------------------------------------------
# Multi-head latent attention (DeepSeek-V2)
# ---------------------------------------------------------------------------


def mla_defs(cfg) -> dict:
    m, d, h = cfg.mla, cfg.d_model, cfg.num_heads
    dt = cfg.dtype
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    defs = {
        "w_dkv": ParamDef((d, m.kv_lora_rank + m.qk_rope_head_dim),
                          (FSDP, None), dt),
        "w_uk": ParamDef((m.kv_lora_rank, h, m.qk_nope_head_dim),
                         (None, TP, None), dt, fan_in_axes=(0,)),
        "w_uv": ParamDef((m.kv_lora_rank, h, m.v_head_dim),
                         (None, TP, None), dt, fan_in_axes=(0,)),
        "wo": ParamDef((h, m.v_head_dim, d), (TP, None, FSDP), dt,
                       fan_in_axes=(0, 1)),
        "kv_norm": ParamDef((m.kv_lora_rank,), (None,), "float32",
                            init="zeros"),
    }
    if m.q_lora_rank:
        defs["w_dq"] = ParamDef((d, m.q_lora_rank), (FSDP, None), dt)
        defs["w_uq"] = ParamDef((m.q_lora_rank, h, qd), (None, TP, None), dt,
                                fan_in_axes=(0,))
        defs["q_norm"] = ParamDef((m.q_lora_rank,), (None,), "float32",
                                  init="zeros")
    else:
        defs["wq"] = ParamDef((d, h, qd), (FSDP, TP, None), dt)
    return defs


def _mla_queries(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor):
    m = cfg.mla
    if m.q_lora_rank:
        cq = rms_norm(x @ p["w_dq"], p["q_norm"], cfg.norm_eps)
        q = _project(cq, p["w_uq"])
    else:
        q = _project(x, p["wq"])
    q_nope = q[..., : m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                        cfg.rope_theta)
    return q_nope, q_rope


def mla_attend(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor, *,
               cache: Optional[torch.Tensor] = None, cache_len=0):
    """MLA with a compressed cache [B, S_cache, kv_lora + rope_dim].

    Returns (out, new_cache).  A prefill (Sq > 1) writes its latent rows
    [0, Sq) into the cache IN PLACE, reads them back (in the cache's
    dtype, as the reference does), expands per head keys of dim
    ``qk_nope + qk_rope`` and values of ``v_head_dim`` through ``w_uk`` /
    ``w_uv``, and attends through K1 with ``Dv != D``; it starts at an
    empty cache (``cache_len`` 0, as the reference's prefill, which reads
    rows [0, Sq) back, assumes) and must fit it.  A decode step (Sq == 1)
    writes row ``cache_len`` and runs the reference's absorbed form: the
    query projected into the latent space, the scores against every cached
    row summed in the cache dtype, masked to the rows below the step's
    length, and the output projected out through ``w_uv``; plain matrix
    products, as in the reference.  ``cache_len`` takes the forms
    :func:`gqa_attend` takes: an int, a 0-d int64 position on the device,
    or a :class:`DecodeIndex`.  Without a cache it is the training /
    forward path: the prefill's attention over the fresh latents.
    """
    m = cfg.mla
    r = m.kv_lora_rank
    b, sq, _ = x.shape
    ckv = x @ p["w_dkv"]
    c, k_rope = ckv[..., :r], ckv[..., r:]
    c = rms_norm(c, p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    q_nope, q_rope = _mla_queries(p, cfg, x, positions)

    new_cache = None
    if cache is not None:
        rows = cache.shape[1]
        packed = torch.cat([c, k_rope], dim=-1).to(cache.dtype)
        if sq == 1:             # a decode step: the absorbed form
            idx = cache_len if isinstance(cache_len, DecodeIndex) else \
                decode_index(cache_len, rows)
            if isinstance(idx.row, torch.Tensor):
                cache.index_copy_(1, idx.row, packed)
            else:
                cache[:, idx.row: idx.row + 1] = packed
            return _mla_absorbed(p, cfg, q_nope, q_rope, cache,
                                 idx.length), cache
        if not isinstance(cache_len, int) or cache_len:
            raise ValueError(
                f"an MLA prefill starts at an empty cache (cache_len 0), "
                f"got {cache_len!r}")
        if sq > rows:
            raise NotImplementedError(
                f"{sq} new positions do not fit a cache of {rows} rows")
        cache[:, :sq] = packed
        new_cache = cache
        c, k_rope = cache[:, :sq, :r], cache[:, :sq, r:]

    # train / prefill: keys and values expanded per position and head
    h = cfg.num_heads
    k_nope = _project(c, p["w_uk"])
    v = _project(c, p["w_uv"])
    k_rope_b = k_rope[:, :, None, :].expand(b, sq, h, m.qk_rope_head_dim)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope_b], dim=-1)
    out = ops.flash_attention(q_full, k_full, v, causal=True)
    return _proj_out(p, out), new_cache


def _mla_absorbed(p: dict, cfg, q_nope: torch.Tensor, q_rope: torch.Tensor,
                  cache: torch.Tensor, length) -> torch.Tensor:
    """One decode step of MLA against every row of ``cache``, the rows at
    and beyond ``length`` (an int, or a 0-d int32 on the device) masked:
    the reference's dtypes and order, the two score terms summed in the
    cache dtype and cast to float32 only then."""
    m = cfg.mla
    c_all = cache[..., : m.kv_lora_rank]
    kr_all = cache[..., m.kv_lora_rank:]
    qa = torch.einsum("bshe,rhe->bshr", q_nope, p["w_uk"])     # latent q
    s_lat = torch.einsum("bshr,btr->bhst", qa, c_all)
    s_rope = torch.einsum("bshe,bte->bhst", q_rope, kr_all)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    scores = (s_lat + s_rope).float() * scale
    valid = torch.arange(c_all.shape[1], device=cache.device) < length
    scores = torch.where(valid, scores, NEG_INF)
    pr = torch.softmax(scores, dim=-1)
    lat = torch.einsum("bhst,btr->bshr", pr.to(c_all.dtype), c_all)
    out = torch.einsum("bshr,rhe->bshe", lat, p["w_uv"])
    return _proj_out(p, out)
