"""Chunked Mamba2 (SSD) scan with a carried ``[P, N]`` state: CUDA kernel
wrapper and plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/mamba2_scan.py ::
mamba2_scan``.  The kernel is ``csrc/mamba2_scan.cu``: one block per
(batch, head) walks the chunks in order with the float32 state, scans
``dt * a`` in float64, forms ``exp(cum_i - cum_j)`` only for ``j <= i``
(the TPU body exponentiates the whole ``[L, L]`` tile and masks after,
where the upper half can overflow), and reads ``b, c [B, S, N]`` through
their strides for every head instead of broadcasting them to
``[B*H, S, N]``.  Unlike the TPU kernel it takes an initial state (the
model's carried ``ssm`` state) and an output dtype (the model asks for
float32, as its reference keeps the scan's output), and forms ``dt * a``
itself.

bf16 (the served type) runs the chunk products on the tensor cores
(``mma.sync``), with x, b, c kept bf16 in shared memory and loaded by a
two-stage ring of 16-byte ``cp.async`` copies straight from the conv
output's column slices; every float32 factor (the decay-weighted scores
G, ``w * x``, the state read for y) enters a product as two bf16 terms,
and the state stays float32 (ROADMAP H21).  At zamba2's prefill bytes
bound it (about 107 MB, 0.032 ms at 3.35 TB/s).  float32 keeps the FMA
kernel of the first port for the 5e-4 bar, bound there by float32
operations (see the source note).

The backward, K4b (``csrc/mamba2_scan_bwd.cu``, no TPU counterpart: the
reference differentiates ``_ssd_chunked``), is :func:`mamba2_scan_bwd`;
under grad :func:`mamba2_scan` goes through ``_Mamba2Scan``, on the card
and on the CPU.  Its chunk-end states and cotangents are chunk-parallel:
one launch takes every chunk's contribution to its end state (and
cotangent) and its decay factor, a second joins them by an elementwise
scan over the chunks; then every chunk's gradients in parallel, a block
per (batch, chunk, group of heads) with the scores ``C B^T`` formed once
for its heads, the decay's gradient term by term; last, the groups'
partial ``db``, ``dc`` and the chunks' partial ``da_log`` summed in a
fixed order (see the source note).  bf16 xh, b, c at zamba2's (P, N) =
(64, 64) run the contributions and the per-chunk products on the tensor
cores (mma.sync, float32 factors as two bf16 terms); float32 and SMOKE's
(16, 8) on the CUDA cores.  It works in sub-chunks of :func:`bwd_chunk`
steps.  At zamba2-2.7b's training microbatch
``[2, 4096, 80, 64]`` the function's bytes bound it at about 0.103 ms;
its times on an NVIDIA H100 are in ``PERF.md``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

MAX_CHUNK = 128
# (P, N) pairs the kernel is instantiated for: the sweep's and zamba2's
DIMS = ((16, 8), (64, 64))
# the longest sub-chunk K4b's kernels take (csrc/mamba2_scan_bwd.cu)
BWD_MAX_CHUNK = 64
# K4b's passes, a mask of the C entry's ``passes``
# (csrc/mamba2_scan_bwd.cu): the chunk-end states, the chunk-end
# cotangents (and dstate0), the per-chunk gradients, the ordered sums of
# db, dc over the head groups and of da_log over the batch and the chunks.
# The two state passes share two launches (the chunks' contributions,
# then the scan that joins them); the others are one launch each
PASS_STATES, PASS_COTANGENTS, PASS_CHUNKS, PASS_SUMS = 1, 2, 4, 8
# heads a block of the per-chunk pass takes (they share the scores C B^T)
HEAD_GROUP = 8


def mamba2_scan_ref(xh: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    dt: torch.Tensor, a_log: torch.Tensor, *,
                    chunk: int = 128,
                    state0: Optional[torch.Tensor] = None,
                    out_dtype: Optional[torch.dtype] = None):
    """Plain version: the sequential SSD recurrence, step by step, in
    float32 (``chunk`` is accepted for the wrapper's signature and not
    used).

    ``S_t = exp(dt_t a) S_{t-1} + dt_t x_t b_t^T`` and ``y_t = S_t c_t``
    with ``a = -exp(a_log)`` and ``S`` starting at ``state0`` (zeros if
    None).  xh: [B, S, H, P]; b, c: [B, S, N]; dt: [B, S, H] (softplus'd);
    a_log: [H]; state0: [B, H, P, N].  Returns (y [B, S, H, P] in
    ``out_dtype``, ``xh.dtype`` if None, final state [B, H, P, N]
    float32)."""
    bsz, s, h, p = xh.shape
    n = b.shape[-1]
    a = -torch.exp(a_log.float())
    st = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=xh.device)
          if state0 is None else state0.float())
    ys = []
    for t in range(s):
        dt_t = dt[:, t].float()                                   # [B, H]
        st = st * torch.exp(dt_t * a)[..., None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dt_t, xh[:, t].float(), b[:, t].float())
        ys.append(torch.einsum("bhpn,bn->bhp", st, c[:, t].float()))
    return torch.stack(ys, dim=1).to(out_dtype or xh.dtype), st


def mamba2_scan_bwd_ref(xh: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                        dt: torch.Tensor, a_log: torch.Tensor,
                        dy: torch.Tensor, *,
                        state0: Optional[torch.Tensor] = None,
                        dstate: Optional[torch.Tensor] = None):
    """Plain backward of :func:`mamba2_scan_ref`: the reverse recurrence,
    step by step in float32.  With ``S_{t-1}`` the state before step t,
    kept from a forward pass, ``G`` the cotangent of ``S_t`` (``dstate``,
    the final state's cotangent, or zeros at the end), ``a = -exp(a_log)``
    and ``alpha_t = exp(dt_t a)``:

        G      += dy_t c_t^T
        dc_t    = sum_h S_t^T dy_t           dx_t = dt_t G b_t
        db_t    = sum_h dt_t G^T x_t         ddt_t = x_t^T G b_t + a alpha_t <G, S_{t-1}>
        da_log += a sum_{b, t} dt_t alpha_t <G, S_{t-1}>
        G       = alpha_t G

    and dstate0 the last ``G``.  The two recurrences (S forward, G
    backward) run step by step; every step's gradients are then formed at
    once from the kept ``S_t`` and ``G``.  Returns (dxh [B, S, H, P], db,
    dc [B, S, N] in ``xh.dtype``; ddt [B, S, H], da_log [H], dstate0
    [B, H, P, N] in float32)."""
    bsz, s, h, p = xh.shape
    n = b.shape[-1]
    a = -torch.exp(a_log.float())
    x, bf, cf = xh.float(), b.float(), c.float()
    dtf, dyf = dt.float(), dy.float()
    alpha = torch.exp(dtf * a)                                  # [B, S, H]
    w = dtf[..., None] * x                                      # dt_t x_t
    st = torch.empty((bsz, s + 1, h, p, n), dtype=torch.float32,
                     device=xh.device)                          # S_0 .. S_s
    st[:, 0] = 0.0 if state0 is None else state0.float()
    for t in range(s):
        torch.addcmul(st[:, t] * alpha[:, t, :, None, None],
                      w[:, t, :, :, None], bf[:, t, None, None, :],
                      out=st[:, t + 1])
    gt = torch.empty((bsz, s, h, p, n), dtype=torch.float32,
                     device=xh.device)           # G at step t, dy_t added
    g = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=xh.device)
         if dstate is None else dstate.float())
    for t in reversed(range(s)):
        torch.addcmul(g, dyf[:, t, :, :, None], cf[:, t, None, None, :],
                      out=gt[:, t])
        g = gt[:, t] * alpha[:, t, :, None, None]
    dc = torch.einsum("bshpn,bshp->bsn", st[:, 1:], dyf)
    gb = torch.einsum("bshpn,bsn->bshp", gt, bf)                # G b_t
    db = torch.einsum("bshpn,bshp->bsn", gt, w)
    gs = torch.einsum("bshpn,bshpn->bsh", gt, st[:, :-1])       # <G, S_{t-1}>
    ddt = (x * gb).sum(-1) + a * alpha * gs
    da = a * (dtf * alpha * gs).sum((0, 1))
    return ((dtf[..., None] * gb).to(xh.dtype), db.to(xh.dtype),
            dc.to(xh.dtype), ddt, da, g)


def _check(xh, b, c, dt, a_log, state0, out_dtype):
    if xh.dim() != 4 or b.dim() != 3 or b.shape != c.shape:
        raise ValueError(
            f"expected xh [B,S,H,P] and b, c [B,S,N], got "
            f"{tuple(xh.shape)}, {tuple(b.shape)}, {tuple(c.shape)}")
    bsz, s, h, p = xh.shape
    n = b.shape[-1]
    if tuple(b.shape[:2]) != (bsz, s):
        raise ValueError(f"b {tuple(b.shape)} is not [B, S, N] for xh "
                         f"{tuple(xh.shape)}")
    if tuple(dt.shape) != (bsz, s, h) or tuple(a_log.shape) != (h,):
        raise ValueError(f"dt {tuple(dt.shape)} and a_log "
                         f"{tuple(a_log.shape)} are not [B, S, H] and [H] "
                         f"= {(bsz, s, h)}, {(h,)}")
    if state0 is not None and tuple(state0.shape) != (bsz, h, p, n):
        raise ValueError(f"state0 {tuple(state0.shape)} is not "
                         f"[B, H, P, N] = {(bsz, h, p, n)}")
    if not (xh.dtype == b.dtype == c.dtype) or xh.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"xh, b, c must share float32 or bfloat16, got "
                        f"{xh.dtype}, {b.dtype}, {c.dtype}")
    for name, x in (("dt", dt), ("a_log", a_log), ("state0", state0)):
        if x is not None and x.dtype not in _build.DTYPE_CODE:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{x.dtype}")
    if out_dtype is not None and out_dtype not in _build.DTYPE_CODE:
        raise TypeError(f"out_dtype must be float32, bfloat16 or None, got "
                        f"{out_dtype}")
    devs = {x.device for x in (xh, b, c, dt, a_log, state0) if x is not None}
    if len(devs) != 1:
        raise ValueError("xh, b, c, dt, a_log and state0 must lie on one "
                         "device")


def _chunk(s: int, chunk: int) -> int:
    chunk = min(int(chunk), s)
    if chunk < 1 or s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {chunk}: pad it first")
    return chunk


def mamba2_scan(xh: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                dt: torch.Tensor, a_log: torch.Tensor, *, chunk: int = 128,
                state0: Optional[torch.Tensor] = None,
                out_dtype: Optional[torch.dtype] = None):
    """xh: [B, S, H, P]; b, c: [B, S, N]; dt: [B, S, H] (softplus'd);
    a_log: [H]; state0: [B, H, P, N] or None (zeros).  Returns (y
    [B, S, H, P] in ``out_dtype``, final state [B, H, P, N] float32).
    ``out_dtype`` None keeps the Pallas kernel's contract, y in
    ``xh.dtype``; the model asks for float32, as its reference keeps the
    scan's output.  ``S`` must be a multiple of ``min(chunk, S)``.

    A CUDA tensor goes through the kernel (which is built at first use) or
    raises; the plain version is taken only for tensors that lie on the
    CPU.  Where grad is enabled and an input requires it, the call is
    differentiable: its backward is :func:`mamba2_scan_bwd` (K4b on the
    card, the plain reverse recurrence on the CPU).
    ``mamba2_scan.launches`` counts kernel launches of the forward.
    """
    return _scan(xh, b, c, dt, a_log, chunk, state0, out_dtype, plain=False)


def mamba2_scan_plain(xh: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                      dt: torch.Tensor, a_log: torch.Tensor, *,
                      chunk: int = 128,
                      state0: Optional[torch.Tensor] = None,
                      out_dtype: Optional[torch.dtype] = None):
    """:func:`mamba2_scan` with the plain versions on any device: the
    forward :func:`mamba2_scan_ref` and, under grad, the backward
    :func:`mamba2_scan_bwd_ref` (not autograd through the forward's
    steps).  What a parity run on the card holds K4 and K4b to."""
    return _scan(xh, b, c, dt, a_log, chunk, state0, out_dtype, plain=True)


def _scan(xh, b, c, dt, a_log, chunk, state0, out_dtype, plain):
    """The arguments checked, then the autograd function where grad is
    enabled and an input requires it, else the forward alone."""
    _check(xh, b, c, dt, a_log, state0, out_dtype)
    out_dtype = out_dtype or xh.dtype
    chunk = _chunk(xh.shape[1], chunk)
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad
            for x in (xh, b, c, dt, a_log, state0)):
        return _Mamba2Scan.apply(xh, b, c, dt, a_log, state0, chunk,
                                 out_dtype, plain)
    return _scan_fwd(xh, b, c, dt, a_log, chunk, state0, out_dtype, plain)


def _scan_fwd(xh, b, c, dt, a_log, chunk, state0, out_dtype, plain):
    """The forward on checked arguments: the plain version where
    ``plain`` or on the CPU, else the kernel on the card."""
    bsz, s, h, p = xh.shape
    n = b.shape[-1]
    if plain or xh.device.type == "cpu":
        return mamba2_scan_ref(xh, b, c, dt, a_log, chunk=chunk,
                               state0=state0, out_dtype=out_dtype)
    if xh.device.type != "cuda":
        raise RuntimeError(f"no mamba2_scan kernel for {xh.device}")
    if (p, n) not in DIMS:
        raise ValueError(f"(head dim, state dim) {(p, n)} not in {DIMS}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"chunk {chunk} exceeds the kernel's {MAX_CHUNK}")
    if xh.dtype == torch.bfloat16:     # the 16-byte copies' rule
        xh, b, c = (_build.kernel_operand(x) for x in (xh, b, c))
    else:
        xh, b, c = (x if x.stride(-1) == 1 else x.contiguous()
                    for x in (xh, b, c))
    dt = dt.float()
    a_log = a_log.float().contiguous()
    state0 = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                          device=xh.device)
              if state0 is None else state0.float().contiguous())
    y = torch.empty((bsz, s, h, p), dtype=out_dtype, device=xh.device)
    fin = torch.empty((bsz, h, p, n), dtype=torch.float32, device=xh.device)
    lib = _build.load()
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fate_mamba2_scan(
            xh.data_ptr(), b.data_ptr(), c.data_ptr(), dt.data_ptr(),
            a_log.data_ptr(), state0.data_ptr(), y.data_ptr(),
            fin.data_ptr(), bsz, s, h, p, n, chunk,
            *xh.stride()[:3], *b.stride()[:2], *c.stride()[:2],
            *dt.stride(), *y.stride()[:3],
            _build.DTYPE_CODE[xh.dtype], _build.DTYPE_CODE[out_dtype],
            stream)
    if rc != 0:
        raise RuntimeError(
            f"mamba2_scan kernel launch failed (code {rc}) for xh "
            f"{tuple(xh.shape)}, N {n}, chunk {chunk}, {xh.dtype}")
    mamba2_scan.launches += 1
    return y, fin


def bwd_chunk(chunk: int) -> int:
    """The sub-chunk K4b works in: the largest divisor of ``chunk`` up to
    BWD_MAX_CHUNK (64 at the model's 128).  Any divisor of the chunk
    divides the sequence, and the chunked backward is exact at any chunk
    length: the sub-chunks' boundary states come from its own state
    passes."""
    return next(d for d in range(min(chunk, BWD_MAX_CHUNK), 0, -1)
                if chunk % d == 0)


def bwd_smem_bytes(p: int, n: int,
                   dtype: torch.dtype = torch.bfloat16) -> int:
    """Shared memory of one block of K4b's per-chunk kernel at (P, N) for
    xh, b, c of ``dtype``, as ``csrc/mamba2_scan_bwd.cu`` lays it out for
    the longest sub-chunk Lm = BWD_MAX_CHUNK.

    bfloat16 at (64, 64), the mma.sync kernel (``MmaTile``): cum in
    float64 [Lm + 2]; in floats twelve [Lm] vectors and the block's
    partial sums [256 + 4], the scores and R [Lm, Lm+1]; thirteen bf16
    tiles [Lm, 72] (b, c, x, and two terms each of dy, S0, dE, M, E).
    Otherwise the FMA kernel (``ChunkTile``): cum in float64 [Lm + 2]; in
    floats seven [Lm] vectors, the partial column sums [16, Lm], the
    block's partial sums [256 + 4]; b and c [Lm, N+1], the scores and the
    pair matrix [Lm, Lm+1], x and dy [Lm, P+1], S0 and dE [P, N+1]."""
    lm = BWD_MAX_CHUNK
    if dtype == torch.bfloat16 and (p, n) == (64, 64):
        return (8 * (lm + 2) + 4 * (12 * lm + 256 + 4 + 2 * lm * (lm + 1))
                + 2 * 13 * lm * 72)
    return 8 * (lm + 2) + 4 * (7 * lm + 16 * lm + 256 + 4
                               + 2 * lm * (n + 1) + 2 * lm * (lm + 1)
                               + 2 * lm * (p + 1) + 2 * p * (n + 1))


def bwd_passes(needs) -> int:
    """The mask of K4b's passes that the gradients ``needs`` (of xh, b, c,
    dt, a_log, state0) call for: the per-chunk pass (with both state
    passes) for any of the first five, the ordered sums for b, c or a_log,
    the cotangents alone for state0 alone."""
    passes = 0
    if any(needs[:5]):
        passes |= PASS_STATES | PASS_COTANGENTS | PASS_CHUNKS
    if needs[1] or needs[2] or needs[4]:
        passes |= PASS_SUMS
    if needs[5]:
        passes |= PASS_COTANGENTS
    return passes


def bwd_launches(passes: int) -> int:
    """Kernel launches of one K4b call with ``passes``: the two state
    passes share two (the chunks' contributions, then the scan)."""
    return (2 * bool(passes & (PASS_STATES | PASS_COTANGENTS))
            + bool(passes & PASS_CHUNKS) + bool(passes & PASS_SUMS))


def mamba2_scan_bwd(xh: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    dt: torch.Tensor, a_log: torch.Tensor, dy: torch.Tensor,
                    *, chunk: int = 128,
                    state0: Optional[torch.Tensor] = None,
                    dstate: Optional[torch.Tensor] = None,
                    needs=(True,) * 6):
    """K4b: the gradients of :func:`mamba2_scan` (same arguments) from
    ``dy`` [B, S, H, P] and ``dstate``, the final state's cotangent
    [B, H, P, N] (None: zeros).  Returns (dxh, db, dc, ddt, da_log,
    dstate0), None where ``needs`` (flags for xh, b, c, dt, a_log, state0)
    is false; dxh, db, dc in ``xh.dtype``, the others float32.

    A CUDA tensor goes through the kernels (``csrc/mamba2_scan_bwd.cu``,
    built at first use), launching only the passes ``needs`` calls for
    (:func:`bwd_passes`), or raises; the plain version is taken only for
    tensors that lie on the CPU.  Sums run in a fixed order: two calls
    give the same bits.  A shape outside the kernels' reach raises
    ``ValueError``.  ``mamba2_scan_bwd.launches`` counts every kernel it
    starts."""
    _check(xh, b, c, dt, a_log, state0, None)
    bsz, s, h, p = xh.shape
    n = b.shape[-1]
    if tuple(dy.shape) != (bsz, s, h, p) or dy.device != xh.device:
        raise ValueError(f"dy {tuple(dy.shape)} on {dy.device} is not "
                         f"[B, S, H, P] = {(bsz, s, h, p)} on {xh.device}")
    if dstate is not None and (tuple(dstate.shape) != (bsz, h, p, n)
                               or dstate.device != xh.device):
        raise ValueError(f"dstate {tuple(dstate.shape)} is not "
                         f"[B, H, P, N] = {(bsz, h, p, n)} on {xh.device}")
    chunk = _chunk(s, chunk)
    needs = tuple(bool(x) for x in needs)
    if xh.device.type == "cpu":
        grads = mamba2_scan_bwd_ref(xh, b, c, dt, a_log, dy, state0=state0,
                                    dstate=dstate)
        return tuple(g if x else None for g, x in zip(grads, needs))
    if xh.device.type != "cuda":
        raise RuntimeError(f"no mamba2_scan_bwd kernel for {xh.device}")
    if (p, n) not in DIMS:
        raise ValueError(f"(head dim, state dim) {(p, n)} not in {DIMS}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"chunk {chunk} exceeds the kernel's {MAX_CHUNK}")
    passes = bwd_passes(needs)
    if not passes:
        return (None,) * 6
    sub = bwd_chunk(chunk)
    bufs = bwd_buffers(xh, b, sub, passes, needs[5])
    launch_bwd(xh, b, c, dt, a_log, dy, sub, state0, dstate, bufs, passes)
    grads = (bufs["dx"], bufs["db"], bufs["dc"], bufs["ddt"],
             bufs["da_log"], bufs["dstate0"])
    return tuple(g if x else None for g, x in zip(grads, needs))


def bwd_buffers(xh: torch.Tensor, b: torch.Tensor, sub: int, passes: int,
                dstate0: bool) -> dict:
    """K4b's outputs and scratch for ``passes`` at sub-chunks of ``sub``
    steps (None where a pass does not need it): the chunk-end states and
    cotangents [B, H, S / sub, P, N] float32; the chunks' decay factors
    [B, H, S / sub] float32, which the state passes write and read; dxh
    [B, S, H, P] in ``xh.dtype`` and ddt [B, S, H] float32; the head
    groups' partial db and dc [B, ceil(H / HEAD_GROUP), S, N] float32 and
    the chunks' partial da_log [B, S / sub, H] float32; db, dc [B, S, N]
    in ``xh.dtype`` and da_log [H] float32; dstate0 [B, H, P, N] where
    ``dstate0``."""
    bsz, s, h, p = xh.shape
    n = b.shape[-1]
    nc, groups = s // sub, -(-h // HEAD_GROUP)
    f32 = dict(dtype=torch.float32, device=xh.device)
    chunks, sums = bool(passes & PASS_CHUNKS), bool(passes & PASS_SUMS)
    grid = lambda: torch.empty((bsz, h, nc, p, n), **f32)
    part = lambda: (torch.empty((bsz, groups, s, n), **f32)
                    if passes & (PASS_CHUNKS | PASS_SUMS) else None)
    return {
        "states": grid() if passes & (PASS_STATES | PASS_CHUNKS) else None,
        "dstates": (grid() if passes & (PASS_COTANGENTS | PASS_CHUNKS)
                    else None),
        "factors": (torch.empty((bsz, h, nc), **f32)
                    if passes & (PASS_STATES | PASS_COTANGENTS) else None),
        "dx": (torch.empty((bsz, s, h, p), dtype=xh.dtype, device=xh.device)
               if chunks else None),
        "ddt": torch.empty((bsz, s, h), **f32) if chunks else None,
        "db_part": part(), "dc_part": part(),
        "da_part": (torch.empty((bsz, nc, h), **f32)
                    if passes & (PASS_CHUNKS | PASS_SUMS) else None),
        **{g: (torch.empty((bsz, s, n), dtype=xh.dtype, device=xh.device)
               if sums else None) for g in ("db", "dc")},
        "da_log": torch.empty((h,), **f32) if sums else None,
        "dstate0": torch.empty((bsz, h, p, n), **f32) if dstate0 else None,
    }


def launch_bwd(xh, b, c, dt, a_log, dy, sub, state0, dstate, bufs, passes,
               lib=None) -> None:
    """Launch K4b's ``passes`` on checked CUDA arguments into ``bufs``
    (:func:`bwd_buffers`) at sub-chunks of ``sub`` steps; raises on a
    failed launch.  A pass reads what an earlier one wrote into ``bufs``.
    ``lib``: the library whose entry to call (the built one if None; a
    probe passes a variant's)."""
    bsz, s, h, p = xh.shape
    n = b.shape[-1]
    # the 4-element loads of x, b, c and dy
    xh, b, c, dy = (_build.kernel_operand(x) for x in (xh, b, c, dy.float()))
    dt = dt.float()
    a_log = a_log.float().contiguous()
    state0, dstate = (None if x is None else x.float().contiguous()
                      for x in (state0, dstate))
    ptr = lambda x: None if x is None else x.data_ptr()
    lib = lib or _build.load()
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fate_mamba2_scan_bwd(
            xh.data_ptr(), b.data_ptr(), c.data_ptr(), dt.data_ptr(),
            a_log.data_ptr(), ptr(state0), dy.data_ptr(), ptr(dstate),
            *(ptr(bufs[k]) for k in ("states", "dstates", "factors", "dx",
                                     "ddt", "db_part", "dc_part", "da_part",
                                     "db", "dc", "da_log", "dstate0")),
            bsz, s, h, p, n, sub,
            *xh.stride()[:3], *b.stride()[:2], *c.stride()[:2],
            *dt.stride(), *dy.stride()[:3],
            _build.DTYPE_CODE[xh.dtype], passes, stream)
    if rc != 0:
        raise RuntimeError(
            f"mamba2_scan_bwd kernel launch failed (code {rc}) for xh "
            f"{tuple(xh.shape)}, N {n}, sub-chunk {sub}, {xh.dtype}, "
            f"passes {passes}")
    mamba2_scan_bwd.launches += bwd_launches(passes)


class _Mamba2Scan(torch.autograd.Function):
    """K4 with a gradient: the forward saves its inputs (the conv output's
    column slices as the views they are); the backward calls
    :func:`mamba2_scan_bwd` for the gradients autograd needs, with the
    final state's cotangent where the caller used that state (None skips
    its term: the grads are not materialised).  ``plain``: the plain
    forward and backward on any device (:func:`mamba2_scan_plain`)."""

    @staticmethod
    def forward(ctx, xh, b, c, dt, a_log, state0, chunk, out_dtype, plain):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(xh, b, c, dt, a_log, state0)
        ctx.chunk, ctx.plain = chunk, plain
        return _scan_fwd(xh, b, c, dt, a_log, chunk, state0, out_dtype,
                         plain)

    @staticmethod
    def backward(ctx, dy, dstate):
        xh, b, c, dt, a_log, state0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(xh.shape, dtype=torch.float32, device=xh.device)
        needs = ctx.needs_input_grad[:6]
        if ctx.plain:
            grads = [g if x else None for g, x in zip(mamba2_scan_bwd_ref(
                xh, b, c, dt, a_log, dy, state0=state0, dstate=dstate),
                needs)]
        else:
            grads = mamba2_scan_bwd(xh, b, c, dt, a_log, dy,
                                    chunk=ctx.chunk, state0=state0,
                                    dstate=dstate, needs=needs)
        like = (xh, b, c, dt, a_log, state0)
        return (*(None if g is None else g.to(x.dtype)
                  for g, x in zip(grads, like)), None, None, None)


mamba2_scan.launches = 0
mamba2_scan_bwd.launches = 0
