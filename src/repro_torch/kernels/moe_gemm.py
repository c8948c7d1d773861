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
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels import _build

BLOCK_N = 128            # output columns per block: the wgmma's N
PREFILL_ROWS = 128       # rows per block of the prefill tile (2 warpgroups)
DECODE_ROWS = 64         # rows per block of the decode tile (1 warpgroup)
PREFILL_MIN_ROWS = 256   # rows per expert from which the prefill tile pays
MAX_ROW_TILES = 65535    # the grid's y extent


@dataclass(frozen=True)
class GemmPlan:
    """How the bf16 kernel runs one call: ``block_rows`` x ``BLOCK_N``
    output tiles on a ``grid`` of (column tiles, row tiles, experts), its
    operands read by 16-byte ``cp.async`` copies (``vector``) or element
    by element."""
    block_rows: int
    vector: bool
    grid: tuple[int, int, int]

    @property
    def code(self) -> int:
        """The ``plan`` argument of ``fate_moe_gemm``: bit 0 the 128-row
        tile, bit 1 the element-wise loader."""
        return int(self.block_rows == PREFILL_ROWS) | (0 if self.vector
                                                       else 2)


def gemm_plan(b: int, e: int, c: int, d: int, f: int, x_strides, w_strides,
              x_ptr: int, w_ptr: int, itemsize: int = 2) -> GemmPlan:
    """Tile shape and loader for ``x [b, e, c, d] @ w [e, d, f]`` with these
    element strides and base addresses.  The 128-row tile (two warpgroups)
    once an expert has ``PREFILL_MIN_ROWS`` rows (``b * c``), else the
    64-row tile; the vector loader where both operands pass
    :func:`_build.aligned16`, else the element-wise one."""
    rows = b * c
    block_rows = PREFILL_ROWS if rows >= PREFILL_MIN_ROWS else DECODE_ROWS
    row_tiles = -(-rows // block_rows)
    if row_tiles > MAX_ROW_TILES:
        raise ValueError(f"{rows} rows per expert exceed the kernel's grid")
    vector = (_build.aligned16((b, e, c, d), x_strides, x_ptr, itemsize)
              and _build.aligned16((e, d, f), w_strides, w_ptr, itemsize))
    return GemmPlan(block_rows, vector, (-(-f // BLOCK_N), row_tiles, e))


def moe_gemm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: the float32 einsum of the reference.  x: [E, C, D]
    or [B, E, C, D]; w: [E, D, F]; returns [..., E, C, F] in ``x.dtype``."""
    return torch.einsum("...ecd,edf->...ecf", x.float(),
                        w.float()).to(x.dtype)


def _check(x, w):
    if x.dim() not in (3, 4) or w.dim() != 3:
        raise ValueError(
            f"expected x [E,C,D] or [B,E,C,D] and w [E,D,F], got "
            f"{tuple(x.shape)}, {tuple(w.shape)}")
    if x.shape[-3] != w.shape[0] or x.shape[-1] != w.shape[1]:
        raise ValueError(
            f"x {tuple(x.shape)} and w {tuple(w.shape)} do not agree on the "
            f"expert count or the contraction dim")
    if x.dtype != w.dtype or x.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"x and w must share float32 or bfloat16, got "
                        f"{x.dtype}, {w.dtype}")
    if x.device != w.device:
        raise ValueError("x and w must lie on one device")
    if min(x.shape) < 1 or min(w.shape) < 1:
        raise ValueError(f"empty operand: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")


def moe_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [E, C, D] or [B, E, C, D]; w: [E, D, F] -> [..., E, C, F].

    A CUDA tensor goes through the kernel (which is built at first use) or
    raises; the plain version is taken only for tensors that lie on the
    CPU.  With grad enabled and an input that requires it, a CUDA call
    raises ``NotImplementedError``: there is no backward kernel (autograd
    runs through the plain version on the CPU).  ``moe_gemm.launches``
    counts kernel launches, and ``moe_gemm.decode_tile_launches`` those of
    them that took the 64-row tile (the decode steps of the serving path).
    """
    _check(x, w)
    if x.device.type == "cpu":
        return moe_gemm_ref(x, w)
    if x.device.type != "cuda":
        raise RuntimeError(f"no moe_gemm kernel for {x.device}")
    _build.refuse_grad("moe_gemm; MoE training (K3's dX / dW kernels) is "
                       "ROADMAP item 14a", x, w)
    x4 = x if x.dim() == 4 else x.unsqueeze(0)
    b, e, c, d = x4.shape
    f = w.shape[2]
    if b * c >= 2 ** 31 or e > 65535:
        raise ValueError(f"x {tuple(x.shape)} exceeds the kernel's grid")
    plan = None
    if x.dtype == torch.bfloat16:
        plan = gemm_plan(b, e, c, d, f, x4.stride(), w.stride(),
                         x4.data_ptr(), w.data_ptr())
    out = torch.empty((b, e, c, f), dtype=x.dtype, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fate_moe_gemm(
            x4.data_ptr(), w.data_ptr(), out.data_ptr(), b, e, c, d, f,
            *x4.stride(), *w.stride(), *out.stride()[:3],
            _build.DTYPE_CODE[x.dtype], plan.code if plan is not None else 0,
            stream)
    if rc != 0:
        raise RuntimeError(
            f"moe_gemm kernel launch failed (code {rc}) for x "
            f"{tuple(x.shape)}, w {tuple(w.shape)}, {x.dtype}")
    moe_gemm.launches += 1
    if plan is not None and plan.block_rows == DECODE_ROWS:
        moe_gemm.decode_tile_launches += 1
    return out if x.dim() == 4 else out[0]


moe_gemm.launches = 0
moe_gemm.decode_tile_launches = 0
