"""The plan of K3's gradients on the card (``kernels/moe_gemm.py ::
grad_plan``), on the CPU: which operands the persistent kernel of
``csrc/moe_gemm_grad.cu`` takes and which go to the first design, and the
walk of its output tiles, enumerated in Python as the kernel decodes it.
No kernel runs here (``tests/test_torch_cuda.py`` runs them on the card);
the addresses are made up, 16-byte aligned unless a case says otherwise.
"""
import itertools
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import moe_gemm as mg_mod

BASE = 1 << 32
SMS = 132                # an H100 SXM's SMs
GRANITE = [("dx", 1536, 512), ("dx", 512, 1536),     # gate / up, down
           ("dw", 1536, 512), ("dw", 512, 1536)]


def _strides(shape):
    return torch.empty(shape, device="meta").stride()


def _dispatch_strides(b, e, c, d):
    """The MoE layer's dispatch view, ``gathered[:, :-1].view(b, e, c, d)``
    of a [b, e * c + 1, d] buffer."""
    return ((e * c + 1) * d, c * d, d, 1)


def _plan(layout, b, e, c, d, f, a_strides=None, b_strides=None,
          a_ptr=BASE, b_ptr=BASE, sms=SMS):
    """The plan of one call: a = dy [b, e, c, f] (dX) or x [b, e, c, d]
    (dW); b = w [e, d, f] (dX) or dy (dW), contiguous unless strides are
    given."""
    a_shape = (b, e, c, f if layout == "dx" else d)
    b_shape = (e, d, f) if layout == "dx" else (b, e, c, f)
    return mg_mod.grad_plan(layout, b, e, c, d, f, a_shape,
                            a_strides or _strides(a_shape), a_ptr, b_shape,
                            b_strides or _strides(b_shape), b_ptr, sms)


@pytest.mark.parametrize("dispatch", [False, True])
@pytest.mark.parametrize("layout,d,f", GRANITE)
def test_granite_training_shapes_take_the_persistent_kernel(layout, d, f,
                                                             dispatch):
    """granite-moe's four training shapes (microbatch 2 at capacity 1024,
    40 experts), with a (dy for dX, x for dW) contiguous and as the
    dispatch view, go to the persistent kernel, one block per SM, with the
    tile counts the source note gives."""
    b, e, c = 2, 40, 1024
    width = f if layout == "dx" else d
    a_strides = _dispatch_strides(b, e, c, width) if dispatch else None
    plan = _plan(layout, b, e, c, d, f, a_strides)
    assert plan.route == "tma" and plan.layout == layout
    assert plan.grid == SMS
    tiles = {("dx", 1536): 3840, ("dx", 512): 1280,
             ("dw", 1536): 960, ("dw", 512): 960}[layout, d]
    assert plan.tiles == tiles
    assert plan.k_stages == {"dx": -(-f // 64), "dw": 2 * 16}[layout]


@pytest.mark.parametrize("case", [
    "odd_d", "odd_f", "d_not_8", "f_not_8", "base_2", "b_base_2",
    "row_stride", "transposed_w", "column_stride"])
@pytest.mark.parametrize("layout", ["dx", "dw"])
def test_unaligned_operands_take_the_first_design(layout, case):
    """Widths that are not a multiple of 8, a base off 16 bytes, a row
    stride that is not a whole 16 bytes, or a last dim without unit stride
    (a transposed weight for dX, a column-strided dy for dW) go to the
    first design."""
    b, e, c, d, f = 2, 8, 40, 128, 64
    a_strides = b_strides = None
    a_ptr = b_ptr = BASE
    if case == "odd_d":
        d = 127
    elif case == "odd_f":
        f = 65
    elif case == "d_not_8":
        d = 100
    elif case == "f_not_8":
        f = 70
    elif case == "base_2":
        a_ptr = BASE + 2
    elif case == "b_base_2":
        b_ptr = BASE + 2
    elif case == "row_stride":
        # a as a slice of rows 4 elements wider: 8-byte row stride excess
        width = f if layout == "dx" else d
        a_strides = (e * c * (width + 4), c * (width + 4), width + 4, 1)
    elif case == "transposed_w" or case == "column_stride":
        # dX: w [e, d, f] as a view of [e, f, d]; dW: dy every other column
        b_strides = ((f * d, 1, d) if layout == "dx"
                     else (e * c * 2 * f, c * 2 * f, 2 * f, 2))
    assert _plan(layout, b, e, c, d, f, a_strides, b_strides, a_ptr,
                 b_ptr).route == "cp_async"
    # the same call with every operand aligned takes the persistent kernel
    assert _plan(layout, 2, 8, 40, 128, 64).route == "tma"


def test_aligned16_is_the_maps_rule():
    """The plan's rule is ``_build.aligned16`` on each operand: a dim of
    size 1 never moves the address, so its stride does not count (the C
    entry replaces it by a packed one when it builds the map)."""
    plan = _plan("dw", 1, 1, 64, 64, 64, a_strides=(3, 5, 64, 1),
                 b_strides=(7, 9, 64, 1))
    assert plan.route == "tma"
    assert not _build.aligned16((2, 1, 64, 64), (3, 5, 64, 1), BASE, 2)


WALK_SHAPES = [(2, 40, 1024, 1536, 512), (1, 3, 100, 200, 64),
               (2, 3, 63, 64, 1536), (2, 5, 1, 128, 200),
               (3, 2, 300, 512, 264), (1, 1, 129, 8, 8)]


@pytest.mark.parametrize("grid", [1, 3, 7, SMS])
@pytest.mark.parametrize("shape", WALK_SHAPES)
@pytest.mark.parametrize("layout", ["dx", "dw"])
def test_walk_covers_every_tile_once_in_expert_major_order(layout, shape,
                                                           grid):
    """The blocks of the persistent grid, each walking its tiles as the
    kernel decodes them, cover every (expert, row tile, column tile) once;
    each block's tiles come in expert-major, then row, then column order;
    a dX row tile lies inside one sample, starting at a multiple of 128
    below C (so C that is not a multiple of the tile never makes a tile
    span two samples), and a dW row tile inside D."""
    b, e, c, d, f = shape
    plan = _plan(layout, b, e, c, d, f, sms=grid)
    assert plan.grid == min(grid, plan.tiles)
    rows = b * -(-c // mg_mod.GRAD_BM) if layout == "dx" \
        else -(-d // mg_mod.GRAD_BM)
    cols = -(-(d if layout == "dx" else f) // mg_mod.GRAD_BN)
    assert (plan.row_tiles, plan.col_tiles) == (rows, cols)
    seen = []
    for block in range(plan.grid):
        mine = list(plan.walk(block))
        assert mine == sorted(mine)           # expert, sample, row, column
        seen += mine
    assert len(seen) == len(set(seen)) == plan.tiles == e * rows * cols
    for ex, sample, row0, col0 in seen:
        assert 0 <= ex < e and col0 % mg_mod.GRAD_BN == 0
        assert row0 % mg_mod.GRAD_BM == 0
        if layout == "dx":
            assert 0 <= sample < b and row0 < c and col0 < d
        else:
            assert sample == 0 and row0 < d and col0 < f
    want = {(ex, s, r * mg_mod.GRAD_BM, n * mg_mod.GRAD_BN)
            for ex, s, r, n in itertools.product(
                range(e), range(b if layout == "dx" else 1),
                range(-(-(c if layout == "dx" else d) // mg_mod.GRAD_BM)),
                range(cols))}
    assert set(seen) == want


@pytest.mark.parametrize("c", [1, 63, 64, 100, 1024])
def test_weight_gradient_stages_never_cross_a_sample(c):
    """dW's contraction walks each sample's C slots in stages of 64 (the
    last zero-filled past C): B * ceil(C / 64) stages, so no stage mixes
    two samples' rows."""
    plan = _plan("dw", 2, 3, c, 64, 64)
    assert plan.c_tiles == -(-c // mg_mod.GRAD_BK)
    assert plan.k_stages == 2 * plan.c_tiles


def test_persistent_source_adds_nothing_into_device_memory():
    """The kernel writes each output once: no atomics, no reductions, no
    bulk reduce (cp.reduce.async.bulk) in its source."""
    src = (Path(_build.CSRC) / "moe_gemm_grad.cu").read_text()
    code = re.sub(r"//[^\n]*", "", src)
    for word in (r"\batomic", r"\bred\.", r"cp\.reduce", r"\breduce"):
        assert not re.search(word, code), word
    assert "setmaxnreg" in code and "cp.async.bulk.tensor" in code


def test_entry_point_is_declared():
    """The C entry's argument types (ctypes would pass pointers as 32-bit
    ints without them): three pointers, the five dims, six strides, the
    layout, the grid and the plan's three counts, the stream."""
    types = _build.ARGTYPES["fate_moe_gemm_grad"]
    assert len(types) == 3 + 5 + 6 + 5 + 1
    assert mg_mod.GRAD_LAYOUT == {"dx": 0, "dw": 1, "fwd": 2}
