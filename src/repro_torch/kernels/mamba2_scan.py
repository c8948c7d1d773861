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
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

MAX_CHUNK = 128
# (P, N) pairs the kernel is instantiated for: the sweep's and zamba2's
DIMS = ((16, 8), (64, 64))


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
    CPU.  With grad enabled and an input that requires it, a CUDA call
    raises ``NotImplementedError``: there is no backward kernel (autograd
    runs through the plain version on the CPU).  ``mamba2_scan.launches``
    counts kernel launches.
    """
    _check(xh, b, c, dt, a_log, state0, out_dtype)
    out_dtype = out_dtype or xh.dtype
    bsz, s, h, p = xh.shape
    n = b.shape[-1]
    chunk = min(int(chunk), s)
    if chunk < 1 or s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {chunk}: pad it first")
    if xh.device.type == "cpu":
        return mamba2_scan_ref(xh, b, c, dt, a_log, chunk=chunk,
                               state0=state0, out_dtype=out_dtype)
    if xh.device.type != "cuda":
        raise RuntimeError(f"no mamba2_scan kernel for {xh.device}")
    _build.refuse_grad("mamba2_scan; Mamba2 training (a K4 backward scan) "
                       "is ROADMAP item 14e", xh, b, c, dt, a_log, state0)
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


mamba2_scan.launches = 0
