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

The backward, K5b (``csrc/rwkv6_scan_bwd.cu``, no TPU counterpart: the
reference differentiates ``_wkv_chunked``), is :func:`rwkv6_scan_bwd`;
under grad :func:`rwkv6_scan` goes through ``_RWKV6Scan``, on the card and
on the CPU.  Its chunk-end states and cotangents are chunk-parallel: one
launch takes every chunk's contribution to its end state (and cotangent)
and its decay factors, a second joins them by an elementwise scan over the
chunks; then every chunk's gradients in parallel, for bf16 r, k, v on the
tensor cores (mma.sync, float32 factors as two bf16 terms), for float32
on the CUDA cores; the decay's gradient is taken chunk by chunk, term by
term (see the source note).  At rwkv6-3b's training microbatch
``[2, 4096, 40, 64]`` the function's bytes bound it at 0.1506 ms (about
503 MB at 3.35 TB/s); its times on an NVIDIA H100 are in ``PERF.md``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

MAX_CHUNK = 64
HEAD_DIMS = (16, 32, 64, 128)    # D the kernels are instantiated for
SMEM_LIMIT = 232448          # shared memory one block may use on sm_90
# K5b's passes, a mask of the C entry's ``passes`` (csrc/rwkv6_scan_bwd.cu):
# the chunk-end states, the chunk-end cotangents (and dstate0), the
# per-chunk gradients, the ordered sum of dbonus.  The two state passes
# share two launches (the chunks' contributions, then the scan that joins
# them); the others are one launch each
PASS_STATES, PASS_COTANGENTS, PASS_CHUNKS, PASS_BONUS = 1, 2, 4, 8


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


def rwkv6_scan_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       w: torch.Tensor, bonus: torch.Tensor,
                       dout: torch.Tensor, *, chunk: int = 32,
                       state0: Optional[torch.Tensor] = None,
                       dstate: Optional[torch.Tensor] = None):
    """Plain backward of :func:`rwkv6_scan_ref`: the reverse recurrence,
    step by step in float32 (``chunk`` is accepted for the wrapper's
    signature and not used).  With ``dS`` the gradient of the state after
    step t (``dstate``, the final state's cotangent, or zeros at the end)
    and ``S_{t-1}`` the state before it, kept from a forward pass:

        dr_t = S_{t-1} do_t + u k_t (do_t . v_t)
        dk_t = dS v_t + u r_t (do_t . v_t)
        dv_t = dS^T k_t + (r_t . (u k_t)) do_t
        dw_t = rowsum(dS * S_{t-1}) where w_t lies in [1e-8, 1], else 0
        dbonus += sum over the batch of r_t k_t (do_t . v_t)
        dS <- diag(w_t) dS + r_t do_t^T

    and dstate0 the last ``dS``.  Returns (dr, dk, dv in ``r.dtype``; dw
    [B, S, H, D], dbonus [H, D], dstate0 [B, H, D, D] in float32)."""
    b, s, h, d = r.shape
    wf = w.float()
    wc = wf.clamp(1e-8, 1.0)
    inside = ((wf >= 1e-8) & (wf <= 1.0)).float()
    bon = bonus.float()
    st = (torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
          if state0 is None else state0.float())
    before = []                          # S_{t-1} of every step
    for t in range(s):
        before.append(st)
        kt, vt = k[:, t].float(), v[:, t].float()
        st = st * wc[:, t][..., None] + kt[..., :, None] * vt[..., None, :]
    ds = (torch.zeros_like(st) if dstate is None else dstate.float())
    dr, dk, dv, dw = ([None] * s for _ in range(4))
    dbonus = torch.zeros((h, d), dtype=torch.float32, device=r.device)
    for t in reversed(range(s)):
        rt, kt, vt = r[:, t].float(), k[:, t].float(), v[:, t].float()
        dot = dout[:, t].float()
        pv = (dot * vt).sum(-1, keepdim=True)             # do_t . v_t
        dr[t] = torch.einsum("bhkc,bhc->bhk", before[t], dot) + bon * kt * pv
        dk[t] = torch.einsum("bhkc,bhc->bhk", ds, vt) + bon * rt * pv
        dv[t] = (torch.einsum("bhkc,bhk->bhc", ds, kt)
                 + (rt * bon * kt).sum(-1, keepdim=True) * dot)
        dw[t] = (ds * before[t]).sum(-1) * inside[:, t]
        dbonus += (rt * kt * pv).sum(0)
        ds = ds * wc[:, t][..., None] + rt[..., :, None] * dot[..., None, :]
    grads = [torch.stack(g, dim=1) for g in (dr, dk, dv, dw)]
    return (*(g.to(r.dtype) for g in grads[:3]), grads[3], dbonus, ds)


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


def _chunk(s: int, chunk: int) -> int:
    chunk = min(int(chunk), s)
    if chunk < 1 or s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {chunk}: pad it first")
    return chunk


def _reach(d: int, chunk: int, smem: int) -> None:
    """Raise ``ValueError`` for a head dim, chunk or shared memory beyond
    the kernels."""
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"chunk {chunk} exceeds the kernels' {MAX_CHUNK}")
    if smem > SMEM_LIMIT:
        raise ValueError(f"chunk {chunk} at head dim {d} needs {smem} bytes "
                         f"of shared memory, above {SMEM_LIMIT}")


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
    CPU.  Where grad is enabled and an input requires it, the call is
    differentiable: its backward is :func:`rwkv6_scan_bwd` (K5b on the
    card, the plain reverse recurrence on the CPU).  bf16 r, k, v go to
    the mma.sync kernel, float32 ones to the FMA kernel; a shape outside
    the kernel's reach raises ``ValueError``. ``rwkv6_scan.launches``
    counts kernel launches of the forward.
    """
    return _scan(r, k, v, w, bonus, chunk, state0, out_dtype, plain=False)


def rwkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, bonus: torch.Tensor, *,
                     chunk: int = 32, state0: Optional[torch.Tensor] = None,
                     out_dtype: Optional[torch.dtype] = None):
    """:func:`rwkv6_scan` with the plain versions on any device: the
    forward :func:`rwkv6_scan_ref` and, under grad, the backward
    :func:`rwkv6_scan_bwd_ref` (not autograd through the forward's steps).
    What a parity run on the card holds K5 and K5b to."""
    return _scan(r, k, v, w, bonus, chunk, state0, out_dtype, plain=True)


def _scan(r, k, v, w, bonus, chunk, state0, out_dtype, plain):
    """The arguments checked, then the autograd function where grad is
    enabled and an input requires it, else the forward alone."""
    _check(r, k, v, w, bonus, state0, out_dtype)
    out_dtype = out_dtype or r.dtype
    chunk = _chunk(r.shape[1], chunk)
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad
            for x in (r, k, v, w, bonus, state0)):
        return _RWKV6Scan.apply(r, k, v, w, bonus, state0, chunk, out_dtype,
                                plain)
    return _scan_fwd(r, k, v, w, bonus, chunk, state0, out_dtype, plain)


def _scan_fwd(r, k, v, w, bonus, chunk, state0, out_dtype, plain):
    """The forward on checked arguments: the plain version where
    ``plain`` or on the CPU, else a kernel on the card."""
    b, s, h, d = r.shape
    dev = _build.kernel_device(r, "rwkv6_scan")
    if plain or dev == "cpu":
        return rwkv6_scan_ref(r, k, v, w, bonus, chunk=chunk, state0=state0,
                              out_dtype=out_dtype)
    _reach(d, chunk, smem_bytes(d, chunk, r.dtype))
    w = w.float()
    if r.dtype == torch.bfloat16:      # the 16-byte copies' rule
        r, k, v, w = (_build.kernel_operand(x) for x in (r, k, v, w))
    else:
        r, k, v, w = (_unit_last(x) for x in (r, k, v, w))
    bonus = bonus.float().contiguous()
    state0 = (torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
              if state0 is None else state0.float().contiguous())
    out = torch.empty((b, s, h, d), dtype=out_dtype, device=r.device)
    fin = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    if dev == "meta":
        return out, fin
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


def _unit_last(x: torch.Tensor) -> torch.Tensor:
    return x if x.stride(-1) == 1 else x.contiguous()


def bwd_smem_bytes(d: int, chunk: int,
                   dtype: torch.dtype = torch.bfloat16) -> int:
    """Shared memory of one block of K5b's per-chunk kernel for r, k, v of
    ``dtype``, as ``csrc/rwkv6_scan_bwd.cu`` lays it out.

    bfloat16, the mma.sync kernel (``bwd_layout``), with Lp = L rounded up
    to 16 and rows of D+8: r, k, v and d out's two bf16 terms as [Lp, D+8]
    bf16 tiles, S0's (then dE's) two terms [D, D+8] bf16, the cumulative
    log decays [Lp+1, D+8], P and the scores [Lp, Lp+4], four [Lp, D+8]
    float sums (dr's and dk's state terms, X, Y), the bonus and the
    rowsums [D], per 8-row block and group of 32 channels 40 partial sums,
    and three sums of each of the block's 256 threads.  float32, the FMA
    kernel (``chunk_smem``): six [L, D+4] float tiles (r, k, v, d out, dr,
    dk), the cumulative log decays [L+1, D+4], S0 / dE [D, D+4], P and the
    scores [L, L+1] each, the bonus and the rowsums [D] each."""
    if dtype != torch.bfloat16:
        dp = d + 4
        return 4 * (6 * chunk * dp + (chunk + 1) * dp + d * dp
                    + 2 * chunk * (chunk + 1) + 2 * d)
    lp = -(-chunk // 16) * 16
    rs = d + 8
    groups = max(1, d // 32)
    return (2 * (3 * lp * rs + 2 * lp * rs + 2 * d * rs)
            + 4 * ((lp + 1) * rs + 2 * lp * (lp + 4) + 4 * lp * rs + 2 * d
                   + (lp // 8) * groups * 40 + 3 * 256))


def bwd_passes(needs) -> int:
    """The mask of K5b's passes that the gradients ``needs`` (of r, k, v,
    w, bonus, state0) call for: the per-chunk pass (with both state
    passes) for any of the first five, the ordered sum for bonus, the
    cotangents alone for state0 alone."""
    passes = 0
    if any(needs[:5]):
        passes |= PASS_STATES | PASS_COTANGENTS | PASS_CHUNKS
    if needs[4]:
        passes |= PASS_BONUS
    if needs[5]:
        passes |= PASS_COTANGENTS
    return passes


def bwd_launches(passes: int) -> int:
    """Kernel launches of one K5b call with ``passes``: the two state
    passes share two (the chunks' contributions, then the scan)."""
    return (2 * bool(passes & (PASS_STATES | PASS_COTANGENTS))
            + bool(passes & PASS_CHUNKS) + bool(passes & PASS_BONUS))


def rwkv6_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, bonus: torch.Tensor, dout: torch.Tensor,
                   *, chunk: int = 32,
                   state0: Optional[torch.Tensor] = None,
                   dstate: Optional[torch.Tensor] = None,
                   needs=(True,) * 6):
    """K5b: the gradients of :func:`rwkv6_scan` (same arguments) from
    ``dout`` [B, S, H, D] and ``dstate``, the final state's cotangent
    [B, H, D, D] (None: zeros).  Returns (dr, dk, dv, dw, dbonus,
    dstate0), None where ``needs`` (flags for r, k, v, w, bonus, state0)
    is false; dr, dk, dv in ``r.dtype``, the others float32.

    A CUDA tensor goes through the kernels (``csrc/rwkv6_scan_bwd.cu``,
    built at first use), launching only the passes ``needs`` calls for
    (:func:`bwd_passes`), or raises; the plain version is taken only for
    tensors that lie on the CPU.  Sums run in a fixed order: two calls
    give the same bits.  A shape outside the kernels' reach raises
    ``ValueError``. ``rwkv6_scan_bwd.launches`` counts every kernel it
    starts."""
    _check(r, k, v, w, bonus, state0, None)
    b, s, h, d = r.shape
    if tuple(dout.shape) != (b, s, h, d) or dout.device != r.device:
        raise ValueError(f"dout {tuple(dout.shape)} on {dout.device} is not "
                         f"[B, S, H, D] = {(b, s, h, d)} on {r.device}")
    if dstate is not None and (tuple(dstate.shape) != (b, h, d, d)
                               or dstate.device != r.device):
        raise ValueError(f"dstate {tuple(dstate.shape)} is not [B, H, D, D]"
                         f" = {(b, h, d, d)} on {r.device}")
    chunk = _chunk(s, chunk)
    needs = tuple(bool(n) for n in needs)
    if _build.kernel_device(r, "rwkv6_scan_bwd") == "cpu":
        grads = rwkv6_scan_bwd_ref(r, k, v, w, bonus, dout, chunk=chunk,
                                   state0=state0, dstate=dstate)
        return tuple(g if n else None for g, n in zip(grads, needs))
    _reach(d, chunk, bwd_smem_bytes(d, chunk, r.dtype))
    passes = bwd_passes(needs)
    if not passes:
        return (None,) * 6
    bufs = bwd_buffers(r, chunk, passes, needs[5])
    launch_bwd(r, k, v, w, bonus, dout, chunk, state0, dstate, bufs, passes)
    grads = (bufs["dr"], bufs["dk"], bufs["dv"], bufs["dw"], bufs["dbonus"],
             bufs["dstate0"])
    return tuple(g if n else None for g, n in zip(grads, needs))


def bwd_buffers(r: torch.Tensor, chunk: int, passes: int,
                dstate0: bool) -> dict:
    """K5b's outputs and scratch for ``passes`` (None where a pass does
    not need it): dr, dk, dv in ``r.dtype`` and dw float32 [B, S, H, D];
    the chunk-end states and cotangents [B, H, S / L, D, D] float32; the
    chunks' decay factors [B, H, S / L, D] float32, which the state passes
    write and read; the partial dbonus [B, S / L, H, D]; dbonus [H, D];
    dstate0 [B, H, D, D] where ``dstate0``."""
    b, s, h, d = r.shape
    nc = s // chunk
    f32 = dict(dtype=torch.float32, device=r.device)
    chunks = bool(passes & PASS_CHUNKS)
    grid = lambda: torch.empty((b, h, nc, d, d), **f32)
    return {
        "states": grid() if passes & (PASS_STATES | PASS_CHUNKS) else None,
        "dstates": (grid() if passes & (PASS_COTANGENTS | PASS_CHUNKS)
                    else None),
        "factors": (torch.empty((b, h, nc, d), **f32)
                    if passes & (PASS_STATES | PASS_COTANGENTS) else None),
        **{g: (torch.empty((b, s, h, d), dtype=r.dtype, device=r.device)
               if chunks else None) for g in ("dr", "dk", "dv")},
        "dw": torch.empty((b, s, h, d), **f32) if chunks else None,
        "dbonus_part": (torch.empty((b, nc, h, d), **f32)
                        if passes & (PASS_CHUNKS | PASS_BONUS) else None),
        "dbonus": (torch.empty((h, d), **f32) if passes & PASS_BONUS
                   else None),
        "dstate0": torch.empty((b, h, d, d), **f32) if dstate0 else None,
    }


def launch_bwd(r, k, v, w, bonus, dout, chunk, state0, dstate, bufs,
               passes, lib=None) -> None:
    """Launch K5b's ``passes`` on checked CUDA arguments into ``bufs``
    (:func:`bwd_buffers`); raises on a failed launch.  A pass reads what
    an earlier one wrote into ``bufs``.  ``lib``: the library whose entry
    to call (the built one if None; a probe passes a variant's)."""
    b, s, h, d = r.shape
    # the 16-byte loads of the state passes and of the mma kernel
    r, k, v, w, dout = (_build.kernel_operand(x) for x in
                        (r, k, v, w.float(), dout.float()))
    bonus = bonus.float().contiguous()
    state0, dstate = (None if x is None else
                      _build.kernel_operand(x.float().contiguous())
                      for x in (state0, dstate))
    # a meta tensor: the operands above, no launch
    if _build.kernel_device(r, "rwkv6_scan_bwd") == "meta":
        return
    ptr = lambda x: None if x is None else x.data_ptr()
    lib = lib or _build.load()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fate_rwkv6_scan_bwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            bonus.data_ptr(), ptr(state0), dout.data_ptr(), ptr(dstate),
            *(ptr(bufs[n]) for n in ("states", "dstates", "factors", "dr",
                                      "dk", "dv", "dw", "dbonus_part",
                                      "dbonus", "dstate0")),
            b, s, h, d, chunk,
            *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *w.stride()[:3], *dout.stride()[:3],
            _build.DTYPE_CODE[r.dtype], passes, stream)
    if rc != 0:
        raise RuntimeError(
            f"rwkv6_scan_bwd kernel launch failed (code {rc}) for r "
            f"{tuple(r.shape)}, chunk {chunk}, {r.dtype}, passes {passes}")
    rwkv6_scan_bwd.launches += bwd_launches(passes)


class _RWKV6Scan(torch.autograd.Function):
    """K5 with a gradient: the forward saves its inputs; the backward
    calls :func:`rwkv6_scan_bwd` for the gradients autograd needs, with
    the final state's cotangent where the caller used that state (None
    skips its term: the grads are not materialised).  ``plain``: the
    plain forward and backward on any device (:func:`rwkv6_scan_plain`)."""

    @staticmethod
    def forward(ctx, r, k, v, w, bonus, state0, chunk, out_dtype, plain):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, bonus, state0)
        ctx.chunk, ctx.plain = chunk, plain
        return _scan_fwd(r, k, v, w, bonus, chunk, state0, out_dtype, plain)

    @staticmethod
    def backward(ctx, dout, dstate):
        r, k, v, w, bonus, state0 = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        needs = ctx.needs_input_grad[:6]
        if ctx.plain:
            grads = [g if n else None for g, n in zip(rwkv6_scan_bwd_ref(
                r, k, v, w, bonus, dout, state0=state0, dstate=dstate),
                needs)]
        else:
            grads = rwkv6_scan_bwd(r, k, v, w, bonus, dout, chunk=ctx.chunk,
                                   state0=state0, dstate=dstate, needs=needs)
        like = (r, k, v, w, bonus, state0)
        return (*(None if g is None else g.to(x.dtype)
                  for g, x in zip(grads, like)), None, None, None)


rwkv6_scan.launches = 0
rwkv6_scan_bwd.launches = 0
