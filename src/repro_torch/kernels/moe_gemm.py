"""Grouped per-expert GEMM of the MoE FFN: CUDA kernel wrapper and plain
PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/moe_gemm.py :: moe_gemm``
(``x [E, C, D] @ w [E, D, F] -> [E, C, F]``, float32 accumulation, cast to
``x.dtype``).  The kernel is ``csrc/moe_gemm.cu``.  Besides that form it
takes the MoE layer's batched operand ``x [B, E, C, D]`` directly: the
``(b, c)`` rows of one expert form one row range read through the batch
stride, so each block loads its slice of the expert's weights once for
all samples, and strided views (the layer's dispatch buffer minus its
dropped-token slot) are read in place.  At decode the function is bound by
the bytes of the expert weights, at prefill it sits near the card's bf16
ridge.  bf16 runs on Hopper's warpgroup tensor cores (``wgmma``) fed by a
ring of ``cp.async`` copies; float32 keeps the FMA kernel of the first
port for its 1e-5 bar (see the source note and ``PERF.md``).
:func:`gemm_plan` chooses the bf16 kernel's tile shape and loader.

Training: where grad is enabled and an input requires it,
:func:`moe_gemm` goes through a ``torch.autograd.Function`` whose backward
launches only the gradients autograd asks for: :func:`moe_gemm_dx`
(``dy @ w^T``) and :func:`moe_gemm_dw` (``x^T @ dy`` per expert, summed
over the batch).  Neither replaces a TPU kernel: the reference
differentiates the einsums of ``src/repro/models/moe.py:104-109``.  In
bf16 both run on one persistent, warp-specialised wgmma GEMM fed by TMA
loads (``csrc/moe_gemm_grad.cu``); :func:`grad_plan` sends operands a
tensor map cannot describe (unaligned rows, odd widths) to their first
design, K3's kernel reading ``w`` K-major for dX and
``csrc/moe_gemm_bwd.cu`` for dW.  Every route sums in a fixed order (no
split over the contraction, no atomics), so two calls give the same bits.
On the CPU all three take their plain versions.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Iterator

import torch

from repro_torch.kernels import _build

BLOCK_N = 128            # output columns per block: the wgmma's N
PREFILL_ROWS = 128       # rows per block of the prefill tile (2 warpgroups)
DECODE_ROWS = 64         # rows per block of the decode tile (1 warpgroup)
PREFILL_MIN_ROWS = 256   # rows per expert from which the prefill tile pays
MAX_ROW_TILES = 65535    # the grid's y extent
# the gradients' persistent kernel (csrc/moe_gemm_grad.cu): output tiles of
# GRAD_BM rows (two consumer warpgroups) x GRAD_BN columns, depth in stages
# of GRAD_BK
GRAD_BM, GRAD_BN, GRAD_BK = 128, 256, 64
GRAD_LAYOUT = {"dx": 0, "dw": 1, "fwd": 2}   # the C entry's layout codes


@dataclass(frozen=True)
class GemmPlan:
    """How the bf16 kernel runs one call: ``block_rows`` x ``BLOCK_N``
    output tiles on a ``grid`` of (column tiles, row tiles, experts), its
    operands read by 16-byte ``cp.async`` copies (``vector``) or element
    by element, ``w`` MN-major (the forward) or K-major (``kmajor``, the
    input gradient)."""
    block_rows: int
    vector: bool
    grid: tuple[int, int, int]
    kmajor: bool = False

    @property
    def code(self) -> int:
        """The ``plan`` argument of ``fate_moe_gemm``: bit 0 the 128-row
        tile, bit 1 the element-wise loader, bit 2 ``w`` K-major."""
        return (int(self.block_rows == PREFILL_ROWS)
                | (0 if self.vector else 2) | (4 if self.kmajor else 0))


def gemm_plan(b: int, e: int, c: int, d: int, f: int, x_strides, w_strides,
              x_ptr: int, w_ptr: int, itemsize: int = 2,
              kmajor: bool = False) -> GemmPlan:
    """Tile shape and loader for ``x [b, e, c, d] @ w -> [b, e, c, f]``
    with these element strides and base addresses, ``w`` lying as
    ``[e, d, f]`` or, with ``kmajor``, as ``[e, f, d]`` (the weight whose
    transpose the input gradient multiplies).  The 128-row tile (two
    warpgroups) once an expert has ``PREFILL_MIN_ROWS`` rows (``b * c``),
    else the 64-row tile; the vector loader where both operands, as they
    lie, pass :func:`_build.aligned16`, else the element-wise one."""
    rows = b * c
    block_rows = PREFILL_ROWS if rows >= PREFILL_MIN_ROWS else DECODE_ROWS
    row_tiles = -(-rows // block_rows)
    if row_tiles > MAX_ROW_TILES:
        raise ValueError(f"{rows} rows per expert exceed the kernel's grid")
    w_sizes = (e, f, d) if kmajor else (e, d, f)
    vector = (_build.aligned16((b, e, c, d), x_strides, x_ptr, itemsize)
              and _build.aligned16(w_sizes, w_strides, w_ptr, itemsize))
    return GemmPlan(block_rows, vector, (-(-f // BLOCK_N), row_tiles, e),
                    kmajor)


@dataclass(frozen=True)
class GradPlan:
    """How a bf16 gradient call runs.  ``route`` "tma": the persistent
    kernel of ``csrc/moe_gemm_grad.cu``, ``grid`` blocks walking
    ``tiles`` output tiles of ``GRAD_BM`` x ``GRAD_BN`` (``row_tiles`` x
    ``col_tiles`` an expert, expert-major), each summing ``k_stages``
    depth stages of ``GRAD_BK``; "cp_async": the first design (for dX
    K3's kernel reading ``w`` K-major, for dW ``csrc/moe_gemm_bwd.cu``),
    whose tiles the other fields do not describe.  ``c_tiles``: for dX
    the row tiles of one sample (a row tile never crosses one), for dW the
    depth stages of one sample (a stage never crosses one)."""
    layout: str
    route: str
    grid: int
    experts: int
    row_tiles: int
    col_tiles: int
    k_stages: int
    c_tiles: int

    @property
    def tiles(self) -> int:
        return self.experts * self.row_tiles * self.col_tiles

    def walk(self, block: int) -> Iterator[tuple[int, int, int, int]]:
        """The output tiles block ``block`` takes, in its order, as the
        kernel decodes them: (expert, sample, first row, first column);
        the sample is 0 for dW, whose rows are D's."""
        per_expert = self.row_tiles * self.col_tiles
        for t in range(block, self.tiles, self.grid):
            e, r = divmod(t, per_expert)
            rt, ct = divmod(r, self.col_tiles)
            if self.layout == "dw":
                yield e, 0, rt * GRAD_BM, ct * GRAD_BN
            else:
                b, c = divmod(rt, self.c_tiles)
                yield e, b, c * GRAD_BM, ct * GRAD_BN


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def grad_plan(layout: str, b: int, e: int, c: int, d: int, f: int,
              a_sizes, a_strides, a_ptr: int, b_sizes, b_strides,
              b_ptr: int, sms: int) -> GradPlan:
    """The route and walk of a bf16 gradient call (``layout`` "dx": a =
    dy [b, e, c, f], b = w [e, d, f]; "dw": a = x [b, e, c, d], b = dy;
    "fwd", K3's forward on the same kernel, a = x, b = w, which only
    ``tools/kernel_probe.py`` runs) on a card of ``sms`` SMs.  The
    persistent kernel where D and F are multiples of 8 (the outputs' rows
    whole 16 bytes) and both operands, as they lie, pass
    :func:`_build.aligned16` (what a tensor map needs: unit stride along
    the last dim, 16-byte strides and bases); its grid is one block per SM,
    at most one per tile.  Anything else takes the first design."""
    if layout == "dw":
        c_tiles = -(-c // GRAD_BK)
        rows, k_stages = -(-d // GRAD_BM), b * c_tiles
    else:
        c_tiles = -(-c // GRAD_BM)
        rows, k_stages = b * c_tiles, -(-(f if layout == "dx" else d)
                                         // GRAD_BK)
    cols = -(-(d if layout == "dx" else f) // GRAD_BN)
    tma = (d % 8 == 0 and f % 8 == 0
           and _build.aligned16(a_sizes, a_strides, a_ptr, 2)
           and _build.aligned16(b_sizes, b_strides, b_ptr, 2)
           and e * rows * cols < 2 ** 31)
    grid = min(sms, e * rows * cols)
    return GradPlan(layout, "tma" if tma else "cp_async", grid, e, rows,
                    cols, k_stages, c_tiles)


def _grad_launch(plan: GradPlan, a4, b, out, d: int, f: int,
                 b_strides) -> None:
    """``fate_moe_gemm_grad`` on a4 [B, E, C, .] and b (dy [B, E, C, F],
    or w [E, D, F] with ``b_strides`` (0, expert, row)) into out."""
    bb, e, c = a4.shape[:3]
    lib = _build.load()
    with torch.cuda.device(a4.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fate_moe_gemm_grad(
            a4.data_ptr(), b.data_ptr(), out.data_ptr(), bb, e, c, d, f,
            *a4.stride()[:3], *b_strides, GRAD_LAYOUT[plan.layout],
            plan.grid, plan.row_tiles, plan.col_tiles, plan.k_stages,
            stream)
    if rc != 0:
        raise RuntimeError(
            f"moe_gemm_grad kernel launch failed (code {rc}) for "
            f"{plan.layout}: {tuple(a4.shape)}, {tuple(b.shape)}")


def moe_gemm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: the float32 einsum of the reference.  x: [E, C, D]
    or [B, E, C, D]; w: [E, D, F]; returns [..., E, C, F] in ``x.dtype``."""
    return torch.einsum("...ecd,edf->...ecf", x.float(),
                        w.float()).to(x.dtype)


def moe_gemm_dx_ref(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of the input gradient: dy [..., E, C, F] @ w[e]^T for
    w [E, D, F] -> [..., E, C, D], a float32 einsum rounded to
    ``dy.dtype``."""
    return torch.einsum("...ecf,edf->...ecd", dy.float(),
                        w.float()).to(dy.dtype)


def moe_gemm_dw_ref(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain version of the weight gradient: x [..., E, C, D]^T @ dy
    [..., E, C, F] per expert, summed over the batch -> [E, D, F], a
    float32 einsum rounded to ``x.dtype``."""
    return torch.einsum("...ecd,...ecf->edf", x.float(),
                        dy.float()).to(x.dtype)


def _check(x, w):
    if x.dim() not in (3, 4) or w.dim() != 3:
        raise ValueError(
            f"expected x [E,C,D] or [B,E,C,D] and w [E,D,F], got "
            f"{tuple(x.shape)}, {tuple(w.shape)}")
    if x.shape[-3] != w.shape[0] or x.shape[-1] != w.shape[1]:
        raise ValueError(
            f"x {tuple(x.shape)} and w {tuple(w.shape)} do not agree on the "
            f"expert count or the contraction dim")
    _check_pair(x, w)


def _check_pair(a, b):
    if a.dtype != b.dtype or a.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"operands must share float32 or bfloat16, got "
                        f"{a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError("operands must lie on one device")
    if min(a.shape) < 1 or min(b.shape) < 1:
        raise ValueError(f"empty operand: {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")


def _gemm_launch(x4, w, out, d: int, f: int, w_strides, plan) -> None:
    """``fate_moe_gemm`` on x4 [B, E, C, d] and a weight with (expert,
    contraction, output) strides ``w_strides`` into out [B, E, C, f]."""
    b, e, c, _ = x4.shape
    if b * c >= 2 ** 31 or e > 65535:
        raise ValueError(f"x {tuple(x4.shape)} exceeds the kernel's grid")
    lib = _build.load()
    with torch.cuda.device(x4.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fate_moe_gemm(
            x4.data_ptr(), w.data_ptr(), out.data_ptr(), b, e, c, d, f,
            *x4.stride(), *w_strides, *out.stride()[:3],
            _build.DTYPE_CODE[x4.dtype], plan.code if plan is not None else 0,
            stream)
    if rc != 0:
        raise RuntimeError(
            f"moe_gemm kernel launch failed (code {rc}) for x "
            f"{tuple(x4.shape)}, w {tuple(w.shape)}, {x4.dtype}")


def _moe_gemm_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    dev = _build.kernel_device(x, "moe_gemm")
    if dev == "cpu":
        return moe_gemm_ref(x, w)
    x4 = x if x.dim() == 4 else x.unsqueeze(0)
    b, e, c, d = x4.shape
    f = w.shape[2]
    plan = None
    if x.dtype == torch.bfloat16:
        plan = gemm_plan(b, e, c, d, f, x4.stride(), w.stride(),
                         x4.data_ptr(), w.data_ptr())
    out = torch.empty((b, e, c, f), dtype=x.dtype, device=x.device)
    if dev == "meta":
        return out if x.dim() == 4 else out[0]
    _gemm_launch(x4, w, out, d, f, w.stride(), plan)
    moe_gemm.launches += 1
    if plan is not None and plan.block_rows == DECODE_ROWS:
        moe_gemm.decode_tile_launches += 1
    return out if x.dim() == 4 else out[0]


def moe_gemm_dx(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K3's input gradient: dy [E, C, F] or [B, E, C, F]; w [E, D, F] ->
    [..., E, C, D] in ``dy.dtype``.  On the card, bf16: the persistent
    kernel where :func:`grad_plan` allows (both operands' rows along F,
    ``w`` read K-major as it lies), else K3's wgmma kernel reading ``w``
    K-major; float32: the FMA kernel through w's transposed strides.  A
    CUDA tensor goes through a kernel or raises; the plain version is
    taken only for tensors that lie on the CPU.  ``moe_gemm_dx.launches``
    counts kernel launches, ``.tma_launches`` those of the persistent
    kernel."""
    if dy.dim() not in (3, 4) or w.dim() != 3 or \
            dy.shape[-3] != w.shape[0] or dy.shape[-1] != w.shape[2]:
        raise ValueError(f"expected dy [..., E, C, F] and w [E, D, F], got "
                         f"{tuple(dy.shape)}, {tuple(w.shape)}")
    _check_pair(dy, w)
    dev = _build.kernel_device(dy, "moe_gemm_dx")
    if dev == "cpu":
        return moe_gemm_dx_ref(dy, w)
    dy4 = dy if dy.dim() == 4 else dy.unsqueeze(0)
    b, e, c, f = dy4.shape
    d = w.shape[1]
    out = torch.empty((b, e, c, d), dtype=dy.dtype, device=dy.device)
    if dev == "meta":
        return out if dy.dim() == 4 else out[0]
    grad = None
    if dy.dtype == torch.bfloat16:
        grad = grad_plan("dx", b, e, c, d, f, dy4.shape, dy4.stride(),
                         dy4.data_ptr(), w.shape, w.stride(), w.data_ptr(),
                         _sm_count(dy.device.index))
    if grad is not None and grad.route == "tma":
        _grad_launch(grad, dy4, w, out, d, f, (0,) + w.stride()[:2])
        moe_gemm_dx.tma_launches += 1
    else:
        plan = None if grad is None else gemm_plan(
            b, e, c, f, d, dy4.stride(), w.stride(), dy4.data_ptr(),
            w.data_ptr(), kmajor=True)
        # w^T [E, F, D]: the contraction F, the output columns D
        _gemm_launch(dy4, w, out, f, d, w.transpose(1, 2).stride(), plan)
    moe_gemm_dx.launches += 1
    return out if dy.dim() == 4 else out[0]


def moe_gemm_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """K3's weight gradient: x [E, C, D] or [B, E, C, D] and dy [..., E, C,
    F] of the same leading shape -> [E, D, F] in ``x.dtype``, summed over
    the batch and the rows in increasing order: in bf16 the persistent
    kernel where :func:`grad_plan` allows, else ``csrc/moe_gemm_bwd.cu``
    (also float32's FMA kernel).  A CUDA tensor goes through a kernel or
    raises; the plain version is taken only for tensors that lie on the
    CPU.  ``moe_gemm_dw.launches`` counts kernel launches,
    ``.tma_launches`` those of the persistent kernel."""
    if x.dim() not in (3, 4) or dy.dim() != x.dim() or \
            x.shape[:-1] != dy.shape[:-1]:
        raise ValueError(f"expected x [..., E, C, D] and dy [..., E, C, F], "
                         f"got {tuple(x.shape)}, {tuple(dy.shape)}")
    _check_pair(x, dy)
    dev = _build.kernel_device(x, "moe_gemm_dw")
    if dev == "cpu":
        return moe_gemm_dw_ref(x, dy)
    x4 = x if x.dim() == 4 else x.unsqueeze(0)
    dy4 = dy if dy.dim() == 4 else dy.unsqueeze(0)
    b, e, c, d = x4.shape
    f = dy4.shape[3]
    if b * c >= 2 ** 31 or e > 65535:
        raise ValueError(f"x {tuple(x.shape)} exceeds the kernel's grid")
    out = torch.empty((e, d, f), dtype=x.dtype, device=x.device)
    if dev == "meta":
        return out
    grad = None
    if x.dtype == torch.bfloat16:
        grad = grad_plan("dw", b, e, c, d, f, x4.shape, x4.stride(),
                         x4.data_ptr(), dy4.shape, dy4.stride(),
                         dy4.data_ptr(), _sm_count(x.device.index))
    if grad is not None and grad.route == "tma":
        _grad_launch(grad, x4, dy4, out, d, f, dy4.stride()[:3])
        moe_gemm_dw.tma_launches += 1
    else:
        item = x.element_size()
        vector = grad is not None and \
            _build.aligned16(x4.shape, x4.stride(), x4.data_ptr(), item) and \
            _build.aligned16(dy4.shape, dy4.stride(), dy4.data_ptr(), item)
        lib = _build.load()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.fate_moe_gemm_dw(
                x4.data_ptr(), dy4.data_ptr(), out.data_ptr(), b, e, c, d,
                f, *x4.stride(), *dy4.stride(), _build.DTYPE_CODE[x.dtype],
                int(vector), stream)
        if rc != 0:
            raise RuntimeError(
                f"moe_gemm_dw kernel launch failed (code {rc}) for x "
                f"{tuple(x.shape)}, dy {tuple(dy.shape)}, {x.dtype}")
    moe_gemm_dw.launches += 1
    return out


class _MoeGemm(torch.autograd.Function):
    """K3 with a gradient: the forward saves x and w; the backward
    launches :func:`moe_gemm_dx` and :func:`moe_gemm_dw` where autograd
    needs them."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _moe_gemm_fwd(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = moe_gemm_dx(dy, w) if ctx.needs_input_grad[0] else None
        dw = moe_gemm_dw(x, dy) if ctx.needs_input_grad[1] else None
        return dx, dw


def moe_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [E, C, D] or [B, E, C, D]; w: [E, D, F] -> [..., E, C, F].

    A CUDA tensor goes through the kernel (which is built at first use) or
    raises; the plain version is taken only for tensors that lie on the
    CPU.  Where grad is enabled and an input requires it, the call is
    differentiable: its backward is :func:`moe_gemm_dx` and
    :func:`moe_gemm_dw` (their kernels on the card, their plain versions
    on the CPU).  ``moe_gemm.launches`` counts kernel launches of the
    forward, and ``moe_gemm.decode_tile_launches`` those of them that took
    the 64-row tile (the decode steps of the serving path).
    """
    _check(x, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _MoeGemm.apply(x, w)
    return _moe_gemm_fwd(x, w)


moe_gemm.launches = 0
moe_gemm.decode_tile_launches = 0
moe_gemm_dx.launches = 0
moe_gemm_dw.launches = 0
moe_gemm_dx.tma_launches = 0
moe_gemm_dw.tma_launches = 0
