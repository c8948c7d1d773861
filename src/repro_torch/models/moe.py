"""Mixture-of-experts FFN with sort-based capacity dispatch (the
counterpart of ``repro.models.moe``).

Per sample, tokens are routed to their top-k experts, sorted by expert,
placed into a dense capacity-padded ``[B, E, C, d]`` block and run through
the three expert GEMMs, which go through the hand-written grouped GEMM
(``kernels.ops.moe_gemm``, K3) where the reference wrote einsums.  The
router and the shared experts stay plain matrix products, as they are
outside any kernel in the reference.

The reference's combine step scatter-adds each token's contributions;
on the card ``index_add_`` adds in an order that changes from run to run.
Here the contributions are gathered back into token order (the inverse of
the sort) and summed over ``top_k``, which gives the same sum in a fixed
order (ROADMAP queue 3).  The dispatch's scatter-set is deterministic as
it is: only zeros land in the shared dropped-token slot.  The expert
weights' sharding constraints of the reference act on a mesh and have no
counterpart on one card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import FSDP, TP, ParamDef, apply_ffn


def moe_defs(cfg) -> dict:
    m, d, dt = cfg.moe, cfg.d_model, cfg.dtype
    e = m.num_experts
    defs = {
        "router": ParamDef((d, e), (FSDP, None), "float32"),
        "w_gate": ParamDef((e, d, m.d_expert), (TP, FSDP, None), dt),
        "w_up": ParamDef((e, d, m.d_expert), (TP, FSDP, None), dt),
        "w_down": ParamDef((e, m.d_expert, d), (TP, None, FSDP), dt,
                           fan_in_axes=(1,)),
    }
    if m.num_shared_experts:
        ds = m.d_shared * m.num_shared_experts
        defs["shared"] = {
            "gate": ParamDef((d, ds), (FSDP, TP), dt),
            "up": ParamDef((d, ds), (FSDP, TP), dt),
            "down": ParamDef((ds, d), (TP, FSDP), dt),
        }
    return defs


def _capacity(tokens: int, cfg) -> int:
    m = cfg.moe
    c = int(tokens * m.top_k / m.num_experts * m.capacity_factor)
    return max(8, (c + 7) // 8 * 8)


def route(p: dict, cfg, x: torch.Tensor,
          experts: Optional[torch.Tensor] = None):
    """The float32 softmax router: (gates, experts), both [B, S, top_k],
    the gates renormalised over the chosen experts.  ``experts``, if
    given, replaces the top-k choice (a measurement holds two runs to one
    routing with it; the model never passes it)."""
    logits = x.float() @ p["router"].float()                     # [B,S,E]
    gates = torch.softmax(logits, dim=-1)
    if experts is None:
        top_g, experts = torch.topk(gates, cfg.moe.top_k, dim=-1)
    else:
        top_g = torch.gather(gates, -1, experts)
    top_g = top_g / torch.clamp(top_g.sum(-1, keepdim=True), min=1e-9)
    return top_g, experts


def apply_moe(p: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d].  Dispatch is per sample: capacity, sort
    and placement are batched over B, as in the reference."""
    m = cfg.moe
    b, s, d = x.shape
    e, top_k = m.num_experts, m.top_k
    cap = _capacity(s, cfg)
    dev = x.device

    top_g, top_e = route(p, cfg, x)                              # [B,S,K]

    # (token, k) pairs of each sample, token-major; sort them by expert
    flat_e = top_e.reshape(b, s * top_k)
    flat_t = torch.arange(s, device=dev).repeat_interleave(top_k)
    flat_t = flat_t.expand(b, -1)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    st = torch.gather(flat_t, 1, order)
    # position within expert = running index - first index of the expert
    first = torch.searchsorted(
        se, torch.arange(e, device=dev).expand(b, e).contiguous())
    pos = (torch.arange(s * top_k, device=dev)[None]
           - torch.gather(first, 1, se))
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, torch.full_like(pos, e * cap))

    xt = torch.gather(x, 1, st[..., None].expand(-1, -1, d))     # [B,SK,d]
    gathered = torch.zeros((b, e * cap + 1, d), dtype=x.dtype, device=dev)
    gathered.scatter_(1, slot[..., None].expand(-1, -1, d),
                      xt * keep[..., None].to(x.dtype))
    # a strided view without the dropped slot: K3 reads it in place
    xe = gathered[:, :-1].view(b, e, cap, d)

    g = ops.moe_gemm(xe, p["w_gate"])                            # [B,E,C,F]
    u = ops.moe_gemm(xe, p["w_up"])
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    ye = ops.moe_gemm(h, p["w_down"])                            # [B,E,C,d]

    # combine in token order: undo the sort, then sum the top_k picks
    inv = torch.argsort(order, dim=-1)
    yf = ye.reshape(b, e * cap, d)
    slot_t = torch.gather(slot, 1, inv)
    keep_t = torch.gather(keep, 1, inv)
    picked = torch.gather(
        yf, 1, torch.clamp(slot_t, max=e * cap - 1)[..., None]
        .expand(-1, -1, d))
    gate_t = torch.where(keep_t, top_g.reshape(b, s * top_k),
                         torch.zeros((), device=dev)).to(yf.dtype)
    contrib = picked * gate_t[..., None] * keep_t[..., None].to(yf.dtype)
    y = contrib.view(b, s, top_k, d).sum(dim=2)

    if m.num_shared_experts:
        y = y + apply_ffn(p["shared"], x)
    return y
