"""Mamba2 (SSD) blocks (the counterpart of ``repro.models.ssm``): a
chunked scan for prefill, the one-step recurrence for decode.

Per layer the recurrent state is ``ssm [B, H, P, N]`` (float32) and the
causal conv's history ``conv [B, W-1, d_inner + 2N]``.  Prefill runs the
chunked scan through the hand-written kernel (``kernels.ops.mamba2_scan``,
K4), starting from the carried state, where the reference wrote the
chunked form in jnp (``_ssd_chunked``; ROADMAP queue 3, H1); decode (one
token) is the plain recurrence, as in the reference, since no TPU kernel
exists for it.  The scan's output comes back in float32, as the
reference keeps it into the ``d_skip`` sum.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import FSDP, TP, ParamDef, rms_norm


def mamba2_defs(cfg) -> dict:
    s, d, dt = cfg.ssm, cfg.d_model, cfg.dtype
    d_in = s.expand * d
    nh = d_in // s.head_dim
    return {
        "w_in": ParamDef((d, 2 * d_in + 2 * s.state_dim + nh),
                         (FSDP, TP), dt),
        "conv": ParamDef((s.conv_width, d_in + 2 * s.state_dim),
                         (None, TP), dt, init="small", fan_in_axes=(0,)),
        "a_log": ParamDef((nh,), (TP,), "float32", init="zeros"),
        "d_skip": ParamDef((nh,), (TP,), "float32", init="ones"),
        "dt_bias": ParamDef((nh,), (TP,), "float32", init="zeros"),
        "norm": ParamDef((d_in,), (TP,), "float32", init="zeros"),
        "w_out": ParamDef((d_in, d), (TP, FSDP), dt),
    }


def _split_proj(p: dict, cfg, x: torch.Tensor):
    """The input projection cut into z, the conv input and dt_raw (views
    of one product)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    zxbcdt = x @ p["w_in"]
    z, xbc, dt_raw = torch.split(
        zxbcdt, [d_in, d_in + 2 * s.state_dim, nh], dim=-1)
    return z, xbc, dt_raw, d_in, nh


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv of width W, history ``state`` [B, W-1, C]
    (zeros if None): products summed tap by tap in the reference's order,
    then silu, all in float32, rounded once to the model dtype.  Returns
    (out, new history in the model dtype).

    The reference writes the taps in the model dtype, but XLA, allowed
    excess precision, keeps that chain in float32 up to the silu; so does
    the port (ROADMAP queue 3, H18).  In float32 the two are the same."""
    wdt = xbc.dtype
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((xbc.shape[0], width - 1, xbc.shape[2]),
                          dtype=wdt, device=xbc.device)
    else:
        pad = state.to(wdt)
    xp = torch.cat([pad, xbc], dim=1)
    xf, wf = xp.float(), w.float()
    seq = xbc.shape[1]
    out = xf[:, :seq] * wf[0]
    for i in range(1, width):
        out = out + xf[:, i: i + seq] * wf[i]
    new_state = xp[:, -(width - 1):] if width > 1 else pad
    return torch.nn.functional.silu(out).to(wdt), new_state


def _ssd_prefill(xh, b, c, dt, a_log, chunk: int, state0):
    """The chunked scan of the reference's ``_ssd_chunked`` through K4:
    state-neutral padding to a chunk multiple (``dt = 0``: no decay, no
    state update), the kernel with a float32 output, the padding cut off
    again.  Returns (y [B, S, H, P] float32, final state)."""
    seq = xh.shape[1]
    pad = (-seq) % chunk
    if pad:
        zp = lambda a: torch.nn.functional.pad(
            a, (0, 0) * (a.dim() - 2) + (0, pad))
        xh, b, c, dt = zp(xh), zp(b), zp(c), zp(dt)
    y, fin = ops.mamba2_scan(xh, b, c, dt, a_log, chunk=chunk,
                             state0=state0, out_dtype=torch.float32)
    return y[:, :seq], fin


def mamba2_forward(p: dict, cfg, x: torch.Tensor, *,
                   state: Optional[dict] = None):
    """Full-sequence forward.  ``state`` {"ssm": [B,H,P,N], "conv":
    [B,W-1,C]} or None (zeros).  Returns (out, new_state)."""
    s = cfg.ssm
    bsz, seq, _ = x.shape
    z, xbc, dt_raw, d_in, nh = _split_proj(p, cfg, x)
    xbc, new_conv = _causal_conv(xbc, p["conv"],
                                 state["conv"] if state is not None else None)
    xs, b, c = torch.split(xbc, [d_in, s.state_dim, s.state_dim], dim=-1)
    dt = torch.nn.functional.softplus(dt_raw.float() + p["dt_bias"])
    xh = xs.view(bsz, seq, nh, s.head_dim)        # column slices, read in place
    y, fin = _ssd_prefill(xh, b, c, dt, p["a_log"], s.chunk,
                          state["ssm"] if state is not None else None)
    y = y + xh.float() * p["d_skip"][None, None, :, None]
    y = y.reshape(bsz, seq, d_in).to(x.dtype)
    y = y * torch.nn.functional.silu(z.float()).to(x.dtype)
    # the reference's _group_norm: one group over all of d_inner
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    return y @ p["w_out"], {"ssm": fin, "conv": new_conv}


def mamba2_decode(p: dict, cfg, x: torch.Tensor, state: dict):
    """Single-token recurrent step, plain PyTorch.  x: [B, 1, d]."""
    s = cfg.ssm
    bsz = x.shape[0]
    z, xbc, dt_raw, d_in, nh = _split_proj(p, cfg, x)
    xbc, new_conv = _causal_conv(xbc, p["conv"], state["conv"])
    xs, b, c = torch.split(xbc, [d_in, s.state_dim, s.state_dim], dim=-1)
    dt = torch.nn.functional.softplus(dt_raw.float() + p["dt_bias"])[:, 0]
    xh = xs.reshape(bsz, nh, s.head_dim).float()
    a = -torch.exp(p["a_log"])
    ssm = state["ssm"] * torch.exp(dt * a)[:, :, None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt, xh, b[:, 0].float())
    y = torch.einsum("bhpn,bn->bhp", ssm, c[:, 0].float())
    y = y + xh * p["d_skip"][None, :, None]
    y = y.reshape(bsz, 1, d_in).to(x.dtype)
    y = y * torch.nn.functional.silu(z.float()).to(x.dtype)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    return y @ p["w_out"], {"ssm": ssm, "conv": new_conv}


def mamba2_state_defs(cfg, batch: int) -> dict:
    """Per-layer state shapes and dtypes (for cache construction)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    return {
        "ssm": ((batch, nh, s.head_dim, s.state_dim), "float32"),
        "conv": ((batch, s.conv_width - 1, d_in + 2 * s.state_dim),
                 cfg.dtype),
    }
