"""``chip_smoke.py``'s device-time windows, on records made by hand.

``chip_smoke.device_time`` runs one profiler session of fenced one-call
windows on the card; ``fenced_windows`` splits its records by correlation
id and keeps a window only where every launch, copy or memset the host
queued between its fences has its device record.  Here the records are
built as torch.profiler gives them: (correlation id, name, on the device,
microseconds).
"""
import importlib
import sys
from pathlib import Path

import pytest


def _chip_smoke():
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


cs = _chip_smoke()
FENCE = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
KERNEL = "void (anonymous namespace)::decode_mma_kernel<128>(args)"
OTHER = "void at::native::elementwise_kernel<128, 4>(args)"


def _session(calls, lost=(), host_lost=(), late=()):
    """Records of a fence, then each call (a list of device names, or of
    (host call, device name) for a copy) and a fence, ids counting up
    from 101; ``lost`` / ``host_lost``: ids whose device / host record the
    trace dropped; ``late``: device records of an earlier session
    delivered into this one."""
    recs, i = [], 100

    def queue(item, us):
        nonlocal i
        i += 1
        host, name = (item if isinstance(item, tuple)
                      else ("cudaLaunchKernel", item))
        if i not in host_lost:
            recs.append((i, host, False, 2.0))
        if i not in lost:
            recs.append((i, name, True, us))

    queue(FENCE, 5.0)
    for items in calls:
        for item in items:
            queue(item, 10.0)
        queue(FENCE, 5.0)
    recs += [(j, KERNEL, True, 99.0) for j in late]
    return recs


def test_whole_windows_hold_their_calls_kernels():
    recs = _session([[KERNEL], [KERNEL], [KERNEL]])
    assert cs.fenced_windows(recs, ("decode_",)) == [[(KERNEL, 10.0)]] * 3


@pytest.mark.parametrize("lost_id, broken", [(102, 0), (104, 1), (106, 2)])
def test_a_lost_kernel_record_breaks_its_window_only(lost_id, broken):
    # ids: 101 fence, 102 call, 103 fence, 104 call, 105 fence, 106 call,
    # 107 fence
    got = cs.fenced_windows(_session([[KERNEL]] * 3, lost={lost_id}),
                            ("decode_",))
    assert got[broken] is None
    assert [w for k, w in enumerate(got) if k != broken] == \
        [[(KERNEL, 10.0)]] * 2


def test_a_lost_fence_breaks_the_merged_window():
    got = cs.fenced_windows(_session([[KERNEL]] * 3, lost={103}),
                            ("decode_",))
    # the fence's host record lies in the merged window, unanswered
    assert got == [None, [(KERNEL, 10.0)]]


def test_late_records_of_an_earlier_session_fall_outside():
    recs = _session([[KERNEL]] * 2, late=(7, 42))
    assert cs.fenced_windows(recs, ("decode_",)) == [[(KERNEL, 10.0)]] * 2


def test_fences_without_host_records_give_no_window():
    recs = _session([[KERNEL]] * 2, host_lost={101, 103, 105})
    assert cs.fenced_windows(recs, ("decode_",)) == [None, None]


COPY = ("cudaMemcpyAsync", "Memcpy DtoD (Device -> Device)")


def test_a_library_window_holds_every_record_and_copy():
    got = cs.fenced_windows(_session([[OTHER, KERNEL, COPY]]))
    assert got == [[(OTHER, 10.0), (KERNEL, 10.0), (COPY[1], 10.0)]]


@pytest.mark.parametrize("lost_id", [102, 103, 104])
def test_a_lost_record_breaks_a_library_window(lost_id):
    # ids: 101 fence, 102 kernel, 103 kernel, 104 copy, 105 fence
    recs = _session([[OTHER, KERNEL, COPY]], lost={lost_id})
    assert cs.fenced_windows(recs) == [None]


def test_host_calls_that_queue_nothing_are_not_awaited():
    recs = _session([[KERNEL]]) + [(102, "cudaStreamIsCapturing", False,
                                    1.0)]
    assert cs.fenced_windows(recs, ("decode_",)) == [[(KERNEL, 10.0)]]


@pytest.mark.parametrize("mangled, short", [
    ("void (anonymous namespace)::mamba2_bwd_mma_kernel<64, 64>(BwdArgs)",
     "mamba2_bwd_mma_kernel<64, 64>"),
    ("void flash_bwd_wgmma_kernel<128>(CUtensorMap, WgArgs)",
     "flash_bwd_wgmma_kernel<128>"),
    ("Memcpy DtoD (Device -> Device)", "Memcpy DtoD"),
])
def test_short_name(mangled, short):
    assert cs.short_name(mangled) == short


@pytest.mark.parametrize("kernels, backend", [
    (["pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits>"], "flash"),
    (["cudnn_generated_fort_native_sdpa_sm90_flash_bprop_wgmma_f16",
      "cudnn::fusion::fmha_reduce_head<true>"], "cudnn"),
    (["fmha_cutlassF_bf16_aligned_64x128_rf_sm80"], "efficient"),
    (["at::native::vectorized_elementwise_kernel<4>", "sm90_xmma_gemm"],
     "math"),
    ([], None),
])
def test_sdpa_backend(kernels, backend):
    assert cs.sdpa_backend(kernels) == backend
