#!/usr/bin/env python3
"""Probe two of the port's bf16 kernels on one NVIDIA GPU.

    python3 tools/kernel_probe.py decode-splits   # K2 over split_plan's block target
    python3 tools/kernel_probe.py mamba2-phases   # K4 with one phase removed at a time

``decode-splits`` times decode attention (``csrc/decode_attention.cu``) at
the four served layouts (B 8, a cache of 544 rows, all valid) for several
values of ``decode_attention.TARGET_BLOCKS``, the block count the split
plan aims at: device milliseconds per call from torch.profiler, and the
splits each target gives.

``mamba2-phases`` builds variants of ``csrc/mamba2_scan.cu`` in which one
phase of the bf16 kernel's chunk loop is cut out by editing the source
(the y products, the decay weights G, the state's share of y, the next
chunk's scan, the state update), each into its own library under
``build/probe/``, and times each at zamba2-2.7b's prefill (B 8, S 512,
80 heads, P = N = 64, chunk 128, column slices, a carried state) with
CUDA events, the full kernel first and last.  A variant computes wrong
numbers; only its time is read.  The difference to the full kernel is
what the phase costs on the critical path.

Each prints JSON lines, and the card's name and power limit first.  No
CPU mode: without a CUDA device it exits with code 1.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# phase -> [(text in mamba2_scan.cu, its replacement), ...]
MAMBA2_CUTS = {
    "y": [("if (head_ok && 16 * rb < L) {", "if (false) {")],
    "decay_weights": [
        ("s[j][r] *= u[r >> 1] * vdc[16 * tb + 8 * j + col0 + (r & 1)];",
         ";"),
        ("? s[j][r] * __expf(fminf((ci.x - c.x) + (ci.y - c.y), 0.f)) * c.z",
         "? s[j][r]")],
    "state_in_y": [("for (int term = 0; term < 2; ++term)\n#pragma unroll\n"
                    "          for (int pt = 0;",
                    "for (int term = 0; term < 0; ++term)\n#pragma unroll\n"
                    "          for (int pt = 0;")],
    "next_scan": [("    if (scanner && t0 + L < S) {", "    if (false) {")],
    "state_update": [("    if (owner) {\n      const float decay",
                      "    if (false) {\n      const float decay")],
}


def device_ms(fn, marker: str, iters: int = 20):
    """Mean device milliseconds per call in kernels whose name holds
    ``marker`` (torch.profiler; up to three traces, as one now and then
    comes back without device activity)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", 0.0)
                 for e in prof.key_averages() if marker in e.key)
        if us:
            return us / 1e3 / iters
    return None


def decode_splits() -> None:
    from repro_torch.kernels import decode_attention as mod
    layouts = {"qwen3": (16, 8, 128), "glm4": (32, 2, 128),
               "granite": (24, 8, 64), "zamba2": (32, 32, 80)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    default = mod.TARGET_BLOCKS
    for name, (h, kv, d) in layouts.items():
        q = torch.randn(8, 1, h, d, device="cuda", generator=gen).bfloat16()
        kc = torch.randn(8, 544, kv, d, device="cuda",
                         generator=gen).bfloat16()
        vc = torch.randn(8, 544, kv, d, device="cuda",
                         generator=gen).bfloat16()
        rows = []
        for target in (33, 66, 132, 264, 528):
            mod.TARGET_BLOCKS = target
            _, nsplit = mod.split_plan(544, 8 * kv)
            if nsplit > 132:
                continue
            rows.append({"target_blocks": target, "nsplit": nsplit,
                         "device_ms": device_ms(
                             lambda: mod.decode_attention(q, kc, vc, 544),
                             "decode_")})
        mod.TARGET_BLOCKS = default
        print(json.dumps({"probe": "decode-splits", "layout": name,
                          "q": [8, 1, h, d], "cache": [8, 544, kv, d],
                          "rows": rows}), flush=True)


def build_variant(name: str, source: str, out: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    cu = out / f"mamba2_{name}.cu"
    lib = out / f"mamba2_{name}.so"
    cu.write_text(source)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared",
                    "-I", str(_build.CSRC), "-o", str(lib), str(cu)],
                   check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.fate_mamba2_scan.restype = i32
    dll.fate_mamba2_scan.argtypes = (
        [ptr] * 8 + [i32] * 6 + [i64] * 13 + [i32] + [ptr])
    return dll


def mamba2_phases() -> None:
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import _build
    src = (_build.CSRC / "mamba2_scan.cu").read_text()
    out = _build.build_root().parent / "probe"
    out.mkdir(parents=True, exist_ok=True)
    sources = {"full": src}
    for name, cuts in MAMBA2_CUTS.items():
        variant = src
        for old, new in cuts:
            if variant.count(old) != 1:
                sys.exit(f"kernel_probe: a text cut for {name!r} is not "
                         f"found once in mamba2_scan.cu: update MAMBA2_CUTS")
            variant = variant.replace(old, new)
        sources[name] = variant
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(
            lambda kv: build_variant(kv[0], kv[1], out), sources.items())))

    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s, h, p, n, chunk = 8, 512, 80, 64, 64, 128
    xbc = torch.randn(b, s, h * p + 2 * n, device="cuda",
                      generator=gen).bfloat16()
    xh = xbc[..., :h * p].view(b, s, h, p)
    bm, cm = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, h, device="cuda", generator=gen))
    a_log = torch.randn(h, device="cuda", generator=gen) * 0.5
    st0 = torch.randn(b, h, p, n, device="cuda", generator=gen)
    y = torch.empty(b, s, h, p, device="cuda", dtype=torch.bfloat16)
    fin = torch.empty(b, h, p, n, device="cuda")

    def call(lib):
        rc = lib.fate_mamba2_scan(
            xh.data_ptr(), bm.data_ptr(), cm.data_ptr(), dt.data_ptr(),
            a_log.data_ptr(), st0.data_ptr(), y.data_ptr(), fin.data_ptr(),
            b, s, h, p, n, chunk, *xh.stride()[:3], *bm.stride()[:2],
            *cm.stride()[:2], *dt.stride(), *y.stride()[:3], 1,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            sys.exit(f"kernel_probe: launch failed with code {rc}")

    def events_ms(lib, iters=30):
        for _ in range(3):
            call(lib)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            call(lib)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / iters

    order = list(libs) + list(reversed(list(libs)))
    times: dict = {}
    for name in order:
        times.setdefault(name, []).append(events_ms(libs[name]))
    full = sum(times["full"]) / 2
    print(json.dumps({
        "probe": "mamba2-phases", "shape": [[b, s, h, p], [b, s, n]],
        "chunk": chunk, "ms": times,
        "phase_cost_ms": {k: full - sum(v) / 2 for k, v in times.items()
                          if k != "full"}}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("probe", choices=["decode-splits", "mamba2-phases"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout else "nvidia-smi: none",
          flush=True)
    if args.probe == "decode-splits":
        decode_splits()
    else:
        mamba2_phases()


if __name__ == "__main__":
    main()
