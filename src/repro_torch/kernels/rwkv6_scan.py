"""Chunked RWKV6 scan with per-channel data-dependent decay: CUDA kernel
wrapper and plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/rwkv6_scan.py :: rwkv6_scan``.
The kernels are in ``csrc/rwkv6_scan.cu``: one block per (batch, head)
walks the chunks in order with the ``[D, D]`` float32 state, and no
exponent formed is positive.  Unlike the TPU kernel they take an initial
state (the model's carried ``wkv`` state) and an output dtype (the model
asks for float32, as its reference keeps the scan's output).

bf16 r, k, v (the served type) go to the mma.sync kernel: the chunk
products on the tensor cores, r, k, v loaded by a two-stage ring of
16-byte ``cp.async`` copies, the scores below the diagonal 8 x 8 blocks
factored through a boundary row, the diagonal blocks pair by pair in
float32, every float32 factor of a product as two bf16 terms (ROADMAP
H21).  At rwkv6-3b's prefill bytes bound it (about 157 MB, 0.047 ms at
3.35 TB/s).  float32 r, k, v keep the FMA kernel of the first port for the
5e-4 bar, bound there by float32 operations (see the source note).
:func:`smem_bytes` gives each kernel's shared memory.

``w`` is clipped to ``[1e-8, 1]`` here, as in the TPU kernel; the RWKV
model clips to its own ``[1e-6, 1 - 1e-6]`` before calling (ROADMAP
queue 3, H4).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

MAX_CHUNK = 64
HEAD_DIMS = (16, 32, 64, 128)    # D the kernels are instantiated for
SMEM_LIMIT = 232448          # shared memory one block may use on sm_90


def rwkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, bonus: torch.Tensor, *,
                   chunk: int = 32,
                   state0: Optional[torch.Tensor] = None,
                   out_dtype: Optional[torch.dtype] = None):
    """Plain version: the sequential recurrence, step by step (``chunk``
    is accepted for the wrapper's signature and not used).

    ``out_t = r_t S + (r_t . (bonus * k_t)) v_t``, then ``S = diag(w_t) S
    + k_t v_t^T``, with ``w`` clipped to ``[1e-8, 1]`` and ``S`` starting
    at ``state0`` (zeros if None).  r, k, v, w: [B, S, H, D]; bonus
    [H, D]; state0 [B, H, D, D].  Returns (out [B, S, H, D] in
    ``out_dtype``, ``r.dtype`` if None, final state [B, H, D, D]
    float32)."""
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
    return torch.stack(outs, dim=1).to(out_dtype or r.dtype), st


def smem_bytes(d: int, chunk: int, dtype: torch.dtype = torch.float32) -> int:
    """Shared memory of one block of the kernel that ``dtype`` (of r, k,
    v) launches, as ``csrc/rwkv6_scan.cu`` lays it out.

    float32, the FMA kernel: the state, five [L, D+1] float tiles, the
    [L, L] scores and the bonus row.  bfloat16, the mma.sync kernel, with
    Lp = L rounded up to 16: r, k, v as bf16 [Lp, D+8] tiles in
    :func:`mma_stages` stages, the state's two bf16 terms [D, D+8], w
    [Lp, D], the cumulative log decays [Lp+1, D+8], the scores
    [Lp, Lp+4] and the bonus row."""
    if dtype != torch.bfloat16:
        return 4 * (d * d + 5 * chunk * (d + 1) + chunk * chunk + d)
    return _mma_smem(d, chunk, mma_stages(d, chunk))


def _mma_smem(d: int, chunk: int, stages: int) -> int:
    lp = -(-chunk // 16) * 16
    return (2 * (stages * 3 * lp * (d + 8) + 2 * d * (d + 8))
            + 4 * (lp * d + (lp + 1) * (d + 8) + lp * (lp + 4) + d))


def mma_stages(d: int, chunk: int) -> int:
    """Stages of the mma.sync kernel's r, k, v ring: 2 (chunk t + 1 loads
    while chunk t computes) where they fit in the block's shared memory,
    else 1 (only D = 128 at chunks above 48)."""
    return 2 if _mma_smem(d, chunk, 2) <= SMEM_LIMIT else 1


def _check(r, k, v, w, bonus, state0, out_dtype):
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
    if out_dtype is not None and out_dtype not in _build.DTYPE_CODE:
        raise TypeError(f"out_dtype must be float32, bfloat16 or None, got "
                        f"{out_dtype}")
    devs = {x.device for x in (r, k, v, w, bonus, state0) if x is not None}
    if len(devs) != 1:
        raise ValueError("r, k, v, w, bonus and state0 must lie on one "
                         "device")


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, bonus: torch.Tensor, *, chunk: int = 32,
               state0: Optional[torch.Tensor] = None,
               out_dtype: Optional[torch.dtype] = None):
    """r, k, v, w: [B, S, H, D]; bonus: [H, D]; state0: [B, H, D, D] or
    None (zeros).  Returns (out [B, S, H, D] in ``out_dtype``, final state
    [B, H, D, D] float32).  ``out_dtype`` None keeps the Pallas kernel's
    contract, out in ``r.dtype``; the model asks for float32, as its
    reference keeps the scan's output.  ``S`` must be a multiple of
    ``min(chunk, S)``.

    A CUDA tensor goes through a kernel (which is built at first use) or
    raises; the plain version is taken only for tensors that lie on the
    CPU.  With grad enabled and an input that requires it, a CUDA call
    raises ``NotImplementedError``: there is no backward kernel (autograd
    runs through the plain version on the CPU).  bf16 r, k, v go to the
    mma.sync kernel, float32 ones to the FMA kernel; a shape outside the
    kernel's reach raises ``ValueError``. ``rwkv6_scan.launches`` counts
    kernel launches.
    """
    _check(r, k, v, w, bonus, state0, out_dtype)
    out_dtype = out_dtype or r.dtype
    b, s, h, d = r.shape
    chunk = min(int(chunk), s)
    if chunk < 1 or s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {chunk}: pad it first")
    if r.device.type == "cpu":
        return rwkv6_scan_ref(r, k, v, w, bonus, chunk=chunk, state0=state0,
                              out_dtype=out_dtype)
    if r.device.type != "cuda":
        raise RuntimeError(f"no rwkv6_scan kernel for {r.device}")
    _build.refuse_grad("rwkv6_scan; RWKV6 training (a K5 backward scan) is "
                       "ROADMAP item 14d", r, k, v, w, bonus, state0)
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"chunk {chunk} exceeds the kernels' {MAX_CHUNK}")
    if smem_bytes(d, chunk, r.dtype) > SMEM_LIMIT:
        raise ValueError(f"chunk {chunk} at head dim {d} needs "
                         f"{smem_bytes(d, chunk, r.dtype)} bytes of shared "
                         f"memory, above {SMEM_LIMIT}")
    w = w.float()
    if r.dtype == torch.bfloat16:      # the 16-byte copies' rule
        r, k, v, w = (_build.kernel_operand(x) for x in (r, k, v, w))
    else:
        r, k, v, w = (x if x.stride(-1) == 1 else x.contiguous()
                      for x in (r, k, v, w))
    bonus = bonus.float().contiguous()
    state0 = (torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
              if state0 is None else state0.float().contiguous())
    out = torch.empty((b, s, h, d), dtype=out_dtype, device=r.device)
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
            _build.DTYPE_CODE[r.dtype], _build.DTYPE_CODE[out_dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"rwkv6_scan kernel launch failed (code {rc}) for r "
            f"{tuple(r.shape)}, chunk {chunk}, {r.dtype}")
    rwkv6_scan.launches += 1
    return out, fin


rwkv6_scan.launches = 0
