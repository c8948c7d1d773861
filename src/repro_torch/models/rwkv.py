"""RWKV-6 ("Finch") blocks: data-dependent-decay linear attention (the
counterpart of ``repro.models.rwkv``).

Time-mix state: the ``[B, H, D, D]`` float32 ``wkv`` state plus the
previous token (``shift``); channel-mix state: its previous token
(``cshift``).  Prefill runs the chunked scan through the hand-written
kernel (``kernels.ops.rwkv6_scan``, K5) where the reference wrote the
chunked form in jnp (``_wkv_chunked``); decode (one token) is the plain
recurrence, as in the reference, since no TPU kernel exists for it.

Two clips (ROADMAP queue 3, H4): the model clamps ``w`` to
``[1e-6, 1 - 1e-6]`` as the reference's ``_wkv_chunked`` does, after the
state-neutral padding with ``w = 1``, and only then calls K5, whose own
``[1e-8, 1]`` clip is then a no-op.  The scan's output comes back in
float32, as the reference keeps it into ``_ln``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import FSDP, TP, ParamDef


def rwkv6_defs(cfg) -> dict:
    d, dt = cfg.d_model, cfg.dtype
    hd = cfg.rwkv.head_dim
    nh = d // hd
    return {
        "time": {
            "mix": ParamDef((5, d), (None, None), "float32", init="small"),
            "wr": ParamDef((d, d), (FSDP, TP), dt),
            "wk": ParamDef((d, d), (FSDP, TP), dt),
            "wv": ParamDef((d, d), (FSDP, TP), dt),
            "wg": ParamDef((d, d), (FSDP, TP), dt),
            # data-dependent decay: low-rank ddlerp
            "w_decay_a": ParamDef((d, 64), (FSDP, None), dt),
            "w_decay_b": ParamDef((64, d), (None, TP), dt, fan_in_axes=(0,)),
            "decay_base": ParamDef((d,), (None,), "float32", init="zeros"),
            "bonus": ParamDef((nh, hd), (TP, None), "float32", init="small"),
            "wo": ParamDef((d, d), (TP, FSDP), dt),
            "ln": ParamDef((d,), (None,), "float32", init="zeros"),
        },
        "channel": {
            "mix": ParamDef((2, d), (None, None), "float32", init="small"),
            "wk": ParamDef((d, cfg.d_ff), (FSDP, TP), dt),
            "wv": ParamDef((cfg.d_ff, d), (TP, FSDP), dt),
            "wr": ParamDef((d, d), (FSDP, TP), dt),
        },
    }


def _token_shift(x: torch.Tensor, x_prev: Optional[torch.Tensor]):
    """Shifted sequence (previous token), and the last token as state."""
    if x.shape[1] == 1:
        prev = x_prev if x_prev is not None else torch.zeros_like(x)
        return prev, x
    first = x_prev if x_prev is not None else torch.zeros_like(x[:, :1])
    return torch.cat([first.to(x.dtype), x[:, :-1]], dim=1), x[:, -1:]


def _wkv_prefill(r, k, v, w, bonus, chunk: int, state0):
    """The chunked scan of the reference's prefill branch through K5:
    state-neutral padding to a chunk multiple (``k = v = 0``, ``w = 1``),
    the model's clamp, the kernel with a float32 output, the padding cut
    off again.  Returns (out [B, S, H, D] float32, final state)."""
    s = r.shape[1]
    pad = (-s) % chunk
    if pad:
        zp = lambda a: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
        r, k, v = zp(r), zp(k), zp(v)
        w = torch.nn.functional.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    w = w.clamp(1e-6, 1 - 1e-6)
    y, st = ops.rwkv6_scan(r, k, v, w, bonus, chunk=chunk, state0=state0,
                           out_dtype=torch.float32)
    return y[:, :s], st


def rwkv6_time_mix(p: dict, cfg, x: torch.Tensor, state: dict):
    """Returns (out, new_state); state: {"shift": [B,1,d] or None,
    "wkv": [B,H,D,D] or None}."""
    t = p["time"]
    hd = cfg.rwkv.head_dim
    nh = cfg.d_model // hd
    b, s, d = x.shape
    shifted, last = _token_shift(x, state.get("shift"))
    mix = t["mix"].to(x.dtype)                                   # [5, d]
    xs = [x + (shifted - x) * mix[i] for i in range(5)]
    r = (xs[0] @ t["wr"]).view(b, s, nh, hd)
    k = (xs[1] @ t["wk"]).view(b, s, nh, hd)
    v = (xs[2] @ t["wv"]).view(b, s, nh, hd)
    gate = torch.nn.functional.silu((xs[3] @ t["wg"]).float())
    dec = xs[4] @ t["w_decay_a"]
    dec = torch.tanh(dec.float()).to(x.dtype) @ t["w_decay_b"]
    # w in (0, 1): exp(-exp(base + dec))
    w = torch.exp(-torch.exp(t["decay_base"] + dec.float()))
    w = w.view(b, s, nh, hd)

    if s == 1:
        st = state["wkv"]
        rf, kf, vf = (a[:, 0].float() for a in (r, k, v))
        out = torch.einsum("bhk,bhkv->bhv", rf, st)
        out = out + (rf * t["bonus"] * kf).sum(-1, keepdim=True) * vf
        st = st * w[:, 0][..., None] + kf[..., :, None] * vf[..., None, :]
        y = out.reshape(b, 1, d)
    else:
        y, st = _wkv_prefill(r, k, v, w, t["bonus"], cfg.rwkv.chunk,
                             state.get("wkv"))
        y = y.reshape(b, s, d)
    y = _ln(y, t["ln"], cfg.norm_eps) * gate
    return y.to(x.dtype) @ t["wo"], {"shift": last, "wkv": st}


def rwkv6_channel_mix(p: dict, cfg, x: torch.Tensor, state: dict):
    c = p["channel"]
    shifted, last = _token_shift(x, state.get("cshift"))
    mix = c["mix"].to(x.dtype)
    xk = x + (shifted - x) * mix[0]
    xr = x + (shifted - x) * mix[1]
    k = xk @ c["wk"]
    k = torch.square(torch.relu(k.float())).to(x.dtype)
    kv = k @ c["wv"]
    r = torch.sigmoid((xr @ c["wr"]).float()).to(x.dtype)
    return r * kv, {"cshift": last}


def _ln(y: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    yf = y.float()
    mu = yf.mean(dim=-1, keepdim=True)
    var = yf.var(dim=-1, keepdim=True, unbiased=False)
    return (yf - mu) * torch.rsqrt(var + eps) * (1.0 + gamma.float())


def rwkv6_state_defs(cfg, batch: int) -> dict:
    hd = cfg.rwkv.head_dim
    nh = cfg.d_model // hd
    return {
        "shift": ((batch, 1, cfg.d_model), cfg.dtype),
        "wkv": ((batch, nh, hd, hd), "float32"),
        "cshift": ((batch, 1, cfg.d_model), cfg.dtype),
    }
