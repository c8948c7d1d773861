"""Chunked RWKV6 scan with per-channel data-dependent decay: CUDA kernel
wrapper and plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/rwkv6_scan.py :: rwkv6_scan``.
The kernel is ``csrc/rwkv6_scan.cu``: one block per (batch, head) walks
the chunks in order with the ``[D, D]`` float32 state in shared memory,
keeps the intra-chunk decay exponents in log space and reduces the
pairwise scores over the channel axis in registers, so the ``[L, L, D]``
tensor of the TPU kernel is never formed.  Unlike the TPU kernel it takes
an initial state (the model's carried ``wkv`` state).  Its arithmetic is
float32 whatever the input dtype, and operations bound it on this card
(see the source note).

``w`` is clipped to ``[1e-8, 1]`` here, as in the TPU kernel; the RWKV
model clips to its own ``[1e-6, 1 - 1e-6]`` before calling (ROADMAP
queue 3, H4).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

MAX_CHUNK = 64
HEAD_DIMS = (16, 32, 64, 128)    # D the kernel is instantiated for
SMEM_LIMIT = 232448          # shared memory one block may use on sm_90


def rwkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, bonus: torch.Tensor, *,
                   chunk: int = 32,
                   state0: Optional[torch.Tensor] = None):
    """Plain version: the sequential recurrence, step by step (``chunk``
    is accepted for the wrapper's signature and not used).

    ``out_t = r_t S + (r_t . (bonus * k_t)) v_t``, then ``S = diag(w_t) S
    + k_t v_t^T``, with ``w`` clipped to ``[1e-8, 1]`` and ``S`` starting
    at ``state0`` (zeros if None).  r, k, v, w: [B, S, H, D]; bonus
    [H, D]; state0 [B, H, D, D].  Returns (out [B, S, H, D] in ``r.dtype``,
    final state [B, H, D, D] float32)."""
    b, s, h, d = r.shape
    wf = w.float().clamp(1e-8, 1.0)
    bon = bonus.float()
    st = (torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
          if state0 is None else state0.float())
    outs = []
    for t in range(s):
        rt, kt, vt = r[:, t].float(), k[:, t].float(), v[:, t].float()
        o = torch.einsum("bhk,bhkv->bhv", rt, st)
        o = o + (rt * bon * kt).sum(-1, keepdim=True) * vt
        st = st * wf[:, t][..., None] + kt[..., :, None] * vt[..., None, :]
        outs.append(o)
    return torch.stack(outs, dim=1).to(r.dtype), st


def smem_bytes(d: int, chunk: int) -> int:
    """Shared memory of one block: state, five [L, D+1] tiles, the
    [L, L] scores and the bonus row (as ``csrc/rwkv6_scan.cu`` lays
    them out)."""
    return 4 * (d * d + 5 * chunk * (d + 1) + chunk * chunk + d)


def _check(r, k, v, w, bonus, state0):
    if r.dim() != 4 or not (r.shape == k.shape == v.shape == w.shape):
        raise ValueError(
            f"expected r, k, v, w [B,S,H,D] of one shape, got "
            f"{tuple(r.shape)}, {tuple(k.shape)}, {tuple(v.shape)}, "
            f"{tuple(w.shape)}")
    b, _, h, d = r.shape
    if tuple(bonus.shape) != (h, d):
        raise ValueError(f"bonus {tuple(bonus.shape)} is not [H, D] = "
                         f"{(h, d)}")
    if state0 is not None and tuple(state0.shape) != (b, h, d, d):
        raise ValueError(f"state0 {tuple(state0.shape)} is not "
                         f"[B, H, D, D] = {(b, h, d, d)}")
    if not (r.dtype == k.dtype == v.dtype) or r.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"r, k, v must share float32 or bfloat16, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    for name, x in (("w", w), ("bonus", bonus), ("state0", state0)):
        if x is not None and x.dtype not in _build.DTYPE_CODE:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{x.dtype}")
    devs = {x.device for x in (r, k, v, w, bonus, state0) if x is not None}
    if len(devs) != 1:
        raise ValueError("r, k, v, w, bonus and state0 must lie on one "
                         "device")


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, bonus: torch.Tensor, *, chunk: int = 32,
               state0: Optional[torch.Tensor] = None):
    """r, k, v, w: [B, S, H, D]; bonus: [H, D]; state0: [B, H, D, D] or
    None (zeros).  Returns (out [B, S, H, D] in ``r.dtype``, final state
    [B, H, D, D] float32).  ``S`` must be a multiple of ``min(chunk, S)``.

    A CUDA tensor goes through the kernel (which is built at first use)
    or raises; the plain version is taken only for tensors that lie on
    the CPU.  ``rwkv6_scan.launches`` counts kernel launches.
    """
    _check(r, k, v, w, bonus, state0)
    b, s, h, d = r.shape
    chunk = min(int(chunk), s)
    if chunk < 1 or s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {chunk}: pad it first")
    if r.device.type == "cpu":
        return rwkv6_scan_ref(r, k, v, w, bonus, chunk=chunk, state0=state0)
    if r.device.type != "cuda":
        raise RuntimeError(f"no rwkv6_scan kernel for {r.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if chunk > MAX_CHUNK or smem_bytes(d, chunk) > SMEM_LIMIT:
        raise ValueError(f"chunk {chunk} at head dim {d} exceeds the "
                         f"kernel's shared memory")
    r, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (r, k, v))
    w = w.float()
    w = w if w.stride(-1) == 1 else w.contiguous()
    bonus = bonus.float().contiguous()
    state0 = (torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
              if state0 is None else state0.float().contiguous())
    out = torch.empty((b, s, h, d), dtype=r.dtype, device=r.device)
    fin = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    lib = _build.load()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fate_rwkv6_scan(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            bonus.data_ptr(), state0.data_ptr(), out.data_ptr(),
            fin.data_ptr(), b, s, h, d, chunk,
            *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *w.stride()[:3], *out.stride()[:3],
            _build.DTYPE_CODE[r.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"rwkv6_scan kernel launch failed (code {rc}) for r "
            f"{tuple(r.shape)}, chunk {chunk}, {r.dtype}")
    rwkv6_scan.launches += 1
    return out, fin


rwkv6_scan.launches = 0
