#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
sm_90a), then runs these phases, each printing one JSON line; any failure
ends the run with a non-zero exit code and no result line:

1. ``device``  – card name and power limit (nvidia-smi), torch / CUDA /
   nvcc versions, seconds the kernels took to build.
2. ``kernels`` – every kernel against its plain PyTorch version ON THE
   CARD: flash_attention and decode_attention over the sweep of
   tests/test_kernels.py (2e-5 float32, 2e-2 bfloat16), moe_gemm over its
   sweep (1e-5 / 3e-2 relative) plus a strided [B, E, C, D] case,
   rwkv6_scan over its sweep (5e-4, finite under strong decay) plus an
   initial state and bf16 inputs; and each at the serving paths' own
   shapes, where it is also timed beside its plain version, one PyTorch
   call computing the same function where there is one (yardstick only;
   the port never calls it) and the least time the card could take.
3. ``serve``   – the retrieve -> work_a, work_b -> merge workflow of
   examples/serve_workflow_torch.py: 8 queries, 2 virtual devices, FATE
   placements, qwen3-1.7b (28 layers) and glm4-9b (40 layers) at full
   width and depth, prompt 512, 32 generated tokens, random weights
   from a seeded generator.  The kernels' launch counts are zeroed just
   before and must equal what the recorded placements predict after.
4. ``parity``  – the first shard of the first stage again with the plain
   versions swapped in for the kernels, on the card: max logit
   difference and greedy-token agreement.
5. ``serve_moe_rwkv`` – the same workflow with granite-moe-3b-a800m as
   "qwen-7b" and rwkv6-3b as "llama-8b", both at full width and depth
   with their published vocabularies, after the first phase's weights
   are freed: attention (K1, K2) launches only for granite, the grouped
   GEMM (K3) for its MoE layers, the RWKV6 scan (K5) for rwkv6's
   prefills.
6. ``parity_moe_rwkv`` – per new model, its first served shard
   teacher-forced with the kernels and with the plain versions: in bf16
   at full depth (the kernel path must reproduce the served tokens) and
   in float32 at full width with 4 layers (logits within 1e-3 of their
   largest magnitude, every greedy token equal).

Then one line ``{"kernels": [...]}`` with every kernel's numbers, the
nvidia-smi line, and last ``{"ok": true, "device": {...}}``.  There is no
CPU mode: without a CUDA device the script exits with code 1.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# bf16 logits of magnitude ~4 resolve to 2**-6; two runs whose attention
# outputs round differently drift by a few such steps over the layers.
# About twice the 0.047 measured on an H100 at these shapes.
PARITY_LOGIT_TOL = 0.1
PROMPT_LEN, GEN_LEN, NUM_QUERIES, N_DEVICES = 512, 32, 8, 2
MOE_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}      # relative
RWKV_TOL = 5e-4          # absolute, float32 outputs
RWKV_BF16_REL = 1e-2     # bf16 outputs: one rounding of the output
# float32 parity at full width, cut to this many layers
PARITY_F32_LAYERS, PARITY_F32_REL = 4, 1e-3

FLASH_SWEEP = [(1, 128, 128, 4, 2, 64), (2, 256, 256, 4, 4, 32),
               (1, 64, 64, 8, 2, 128), (2, 100, 100, 4, 2, 64)]
FLASH_MODES = [(True, 0), (False, 0), (True, 64)]
DECODE_SWEEP = [512, 300, 17, 1]
MOE_SWEEP = [(4, 96, 160, 192), (2, 128, 64, 64), (8, 40, 100, 70)]
RWKV_SWEEP = [(64, 16), (96, 32)]
REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:70",
    "decode_attention": "src/repro/kernels/decode_attention.py:58",
    "moe_gemm": "src/repro/kernels/moe_gemm.py:39",
    "rwkv6_scan": "src/repro/kernels/rwkv6_scan.py:66",
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str, code: int = 1) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def randn(rng, shape, dtype):
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    return x.to("cuda", dtype)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` launches (CUDA events;
    inputs stay warm in L2, as the serving path finds them)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(byte_count: float, flops: float, dtype) -> tuple[float, str]:
    """Least milliseconds the card could take, and which limit sets it."""
    t_bytes = byte_count / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------


def phase_device(build_mod) -> tuple[dict, str]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    nvcc = build_mod.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    t0 = time.perf_counter()
    build_mod.load()                       # raises if the build fails
    info = {
        "phase": "device", "nvidia_smi": smi_line,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "nvcc": ver[-2] if len(ver) >= 2 else " ".join(ver),
        "python": sys.version.split()[0],
        "build_seconds": round(build_mod.build_seconds, 2),
        "load_seconds": round(time.perf_counter() - t0, 2),
        "kernel_sources": [str(p.relative_to(Path(__file__).parent))
                           for p in build_mod.sources()],
    }
    emit(info)
    return info, smi_line


# ---------------------------------------------------------------------------
# phase 2: kernels
# ---------------------------------------------------------------------------


def sdpa(q, k, v, causal):
    """One library call computing the same function on the same inputs
    (yardstick only): heads-first views, grouped-query mode."""
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, is_causal=causal, enable_gqa=True)


def flash_case(ops, ref, rng, shape, dtype, causal, window, timed=False):
    b, sq, sk, h, kv, d = shape
    q = randn(rng, (b, sq, h, d), dtype)
    k = randn(rng, (b, sk, kv, d), dtype)
    v = randn(rng, (b, sk, kv, d), dtype)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    err = max_abs_err(out, want)
    rec = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
           "causal": causal, "window": window, "max_abs_err": err,
           "tol": TOL[dtype], "ok": bool(err < TOL[dtype])
           and bool(torch.isfinite(out.float()).all())}
    if timed:
        pairs = sq * (sq + 1) // 2 if causal else sq * sk
        b_ms, by = bound(nbytes(q, k, v, out), 4.0 * b * h * d * pairs, dtype)
        rec.update(
            ms=time_ms(lambda: ops.flash_attention(
                q, k, v, causal=causal, window=window)),
            plain_ms=time_ms(lambda: ref.flash_attention_ref(
                q, k, v, causal=causal, window=window), iters=5, warmup=1),
            library_ms=time_ms(sdpa(q, k, v, causal)),
            bound_ms=b_ms, bound_by=by)
    return rec


def decode_case(ops, ref, rng, shape, dtype, cache_len, timed=False):
    b, s, h, kv, d = shape
    q = randn(rng, (b, 1, h, d), dtype)
    kc = randn(rng, (b, s, kv, d), dtype)
    vc = randn(rng, (b, s, kv, d), dtype)
    out = ops.decode_attention(q, kc, vc, cache_len)
    torch.cuda.synchronize()
    want = ref.decode_attention_ref(q, kc, vc, cache_len)
    err = max_abs_err(out, want)
    rec = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
           "cache_len": cache_len, "max_abs_err": err, "tol": TOL[dtype],
           "ok": bool(err < TOL[dtype])
           and bool(torch.isfinite(out.float()).all())}
    if timed:
        valid = 2 * b * cache_len * kv * d * q.element_size()
        b_ms, by = bound(nbytes(q, out) + valid,
                         4.0 * b * h * d * cache_len, dtype)
        rec.update(
            ms=time_ms(lambda: ops.decode_attention(q, kc, vc, cache_len),
                       iters=50),
            plain_ms=time_ms(lambda: ref.decode_attention_ref(
                q, kc, vc, cache_len), iters=20),
            library_ms=time_ms(sdpa(q, kc[:, :cache_len], vc[:, :cache_len],
                                    False), iters=50),
            bound_ms=b_ms, bound_by=by)
    return rec


def dispatch_view(rng, b, e, c, d, dtype):
    """x [B, E, C, D] as the MoE layer hands it to the grouped GEMM: a
    view of a [B, E*C + 1, D] dispatch buffer without its last
    (dropped-token) row, which is poisoned with NaN."""
    buf = randn(rng, (b, e * c + 1, d), dtype)
    buf[:, -1] = float("nan")
    return buf[:, :-1].view(b, e, c, d)


def moe_case(ops, ref, x, w, timed=False):
    out = ops.moe_gemm(x, w)
    torch.cuda.synchronize()
    want = ref.moe_gemm_ref(x, w)
    err = max_abs_err(out, want)
    rel = err / max(1e-6, float(want.float().abs().max()))
    dt = x.dtype
    rec = {"shape": [list(x.shape), list(w.shape)],
           "dtype": str(dt).split(".")[-1], "max_abs_err": err,
           "rel_err": rel, "tol": MOE_TOL[dt],
           "ok": bool(rel < MOE_TOL[dt])
           and bool(torch.isfinite(out.float()).all())}
    if timed:
        e, d = w.shape[0], w.shape[1]
        rows = x.numel() // (e * d)            # B * C rows per expert
        b_ms, by = bound(nbytes(x, w, out), 2.0 * e * rows * d * w.shape[2],
                         dt)
        # the library call takes the per-expert rows in one block, as
        # torch.bmm wants them (laid out before timing)
        xt = x.transpose(0, 1).reshape(e, rows, d).contiguous() \
            if x.dim() == 4 else x
        rec.update(
            ms=time_ms(lambda: ops.moe_gemm(x, w)),
            plain_ms=time_ms(lambda: ref.moe_gemm_ref(x, w), iters=5,
                             warmup=1),
            library_ms=time_ms(lambda: torch.bmm(xt, w)),
            bound_ms=b_ms, bound_by=by)
    return rec


def rwkv_flops(b, s, h, d, chunk) -> float:
    """Float32 operations of the chunked scan (exp counted as one):
    inter-chunk product, pairwise scores with their exp, diagonal,
    intra-chunk product, state update."""
    pairs = chunk * (chunk - 1) / 2
    per_chunk = (2 * chunk * d * d + 5 * pairs * d + 3 * chunk * d
                 + 2 * (pairs + chunk) * d + 2 * chunk * d * d + 2 * d * d)
    return b * h * (s // chunk) * per_chunk


def rwkv_case(ops, ref, rng, shape, chunk, dtype, *, strong_decay=False,
              state=False, timed=False):
    b, s, h, d = shape
    r = randn(rng, shape, dtype) * 0.5
    k = randn(rng, shape, dtype) * 0.5
    v = randn(rng, shape, dtype)
    w = (torch.full(shape, 1e-6, device="cuda") if strong_decay
         else torch.sigmoid(randn(rng, shape, torch.float32)))
    bonus = randn(rng, (h, d), torch.float32) * 0.1
    st0 = (randn(rng, (b, h, d, d), torch.float32) if state
           else torch.zeros((b, h, d, d), device="cuda"))
    out, fin = ops.rwkv6_scan(r, k, v, w, bonus, chunk=chunk, state0=st0)
    torch.cuda.synchronize()
    want, wfin = ref.rwkv6_scan_ref(r, k, v, w, bonus, state0=st0)
    err, fin_err = max_abs_err(out, want), max_abs_err(fin, wfin)
    if dtype == torch.float32:
        tol, fin_tol = RWKV_TOL, RWKV_TOL
    else:
        tol = RWKV_BF16_REL * float(want.float().abs().max())
        fin_tol = RWKV_TOL * max(1.0, float(wfin.abs().max()))
    rec = {"shape": list(shape), "chunk": chunk,
           "dtype": str(dtype).split(".")[-1], "strong_decay": strong_decay,
           "initial_state": state, "max_abs_err": err,
           "state_max_abs_err": fin_err, "tol": tol,
           "ok": bool(err < tol) and bool(fin_err < fin_tol)
           and bool(torch.isfinite(out.float()).all())}
    if timed:
        b_ms, by = bound(nbytes(r, k, v, w, bonus, st0, out, fin),
                         rwkv_flops(b, s, h, d, chunk), torch.float32)
        rec.update(
            ms=time_ms(lambda: ops.rwkv6_scan(r, k, v, w, bonus,
                                              chunk=chunk, state0=st0)),
            plain_ms=time_ms(lambda: ref.rwkv6_scan_ref(
                r, k, v, w, bonus, state0=st0), iters=2, warmup=1),
            library_ms=None, bound_ms=b_ms, bound_by=by)
    return rec


def sweep_err(cases, field="max_abs_err"):
    return {dt: max(c[field] for c in cases if c["dtype"] == dt)
            for dt in sorted({c["dtype"] for c in cases})}


def phase_kernels(ops, ref, cfgs, moe_cfg, rwkv_cfg, seed: int) -> dict:
    from repro_torch.models.moe import _capacity
    rng = np.random.default_rng(seed)
    flash_sweep, decode_sweep = [], []
    for shape in FLASH_SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            for causal, window in FLASH_MODES:
                flash_sweep.append(flash_case(ops, ref, rng, shape, dtype,
                                              causal, window))
    for clen in DECODE_SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            decode_sweep.append(decode_case(ops, ref, rng, (2, 512, 8, 4, 64),
                                            dtype, clen))
    # the serving path's own shapes: a whole-batch stage and a 2-way shard
    flash_main, decode_main = {}, {}
    s_max = PROMPT_LEN + GEN_LEN
    for name, cfg in cfgs.items():
        h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        dt = getattr(torch, cfg.dtype)
        for nq in (NUM_QUERIES, NUM_QUERIES // N_DEVICES):
            timed = nq == NUM_QUERIES
            flash_main[f"{name}/nq{nq}"] = flash_case(
                ops, ref, rng, (nq, PROMPT_LEN, PROMPT_LEN, h, kv, d), dt,
                True, 0, timed=timed)
            for clen in (PROMPT_LEN + 1, s_max):
                decode_main[f"{name}/nq{nq}/len{clen}"] = decode_case(
                    ops, ref, rng, (nq, s_max, h, kv, d), dt, clen,
                    timed=timed and clen == s_max)
    # K3: the sweep, a strided batched case, the serving shapes
    moe_sweep = []
    for e, c, d, f in MOE_SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            moe_sweep.append(moe_case(ops, ref, randn(rng, (e, c, d), dtype),
                                      randn(rng, (e, d, f), dtype)))
    for dtype in (torch.float32, torch.bfloat16):
        w_t = randn(rng, (5, 40, 72), dtype).transpose(1, 2)   # strided w
        moe_sweep.append(moe_case(ops, ref, dispatch_view(rng, 3, 5, 24, 72,
                                                          dtype), w_t))
    m, dm = moe_cfg.moe, moe_cfg.d_model
    dt = getattr(torch, moe_cfg.dtype)
    moe_main = {}
    for nq in (NUM_QUERIES, NUM_QUERIES // N_DEVICES):
        timed = nq == NUM_QUERIES
        cap = _capacity(PROMPT_LEN, moe_cfg)     # 128 for granite
        w_up = randn(rng, (m.num_experts, dm, m.d_expert), dt)
        w_down = randn(rng, (m.num_experts, m.d_expert, dm), dt)
        moe_main[f"prefill_up/nq{nq}"] = moe_case(
            ops, ref, dispatch_view(rng, nq, m.num_experts, cap, dm, dt),
            w_up, timed=timed)
        moe_main[f"prefill_down/nq{nq}"] = moe_case(
            ops, ref, randn(rng, (nq, m.num_experts, cap, m.d_expert), dt),
            w_down, timed=timed)
        moe_main[f"decode_up/nq{nq}"] = moe_case(
            ops, ref, dispatch_view(rng, nq, m.num_experts, 8, dm, dt),
            w_up, timed=timed)
        del w_up, w_down
    # K5: the sweep, an initial state, bf16 inputs, the serving shape
    rwkv_sweep = []
    for s_len, chunk in RWKV_SWEEP:
        for strong in (False, True):
            rwkv_sweep.append(rwkv_case(ops, ref, rng, (2, s_len, 2, 16),
                                        chunk, torch.float32,
                                        strong_decay=strong))
    rwkv_sweep.append(rwkv_case(ops, ref, rng, (2, 96, 3, 64), 32,
                                torch.float32, state=True))
    rwkv_sweep.append(rwkv_case(ops, ref, rng, (2, 96, 3, 64), 32,
                                torch.bfloat16, state=True))
    hd = rwkv_cfg.rwkv.head_dim
    rshape = (NUM_QUERIES, PROMPT_LEN, rwkv_cfg.d_model // hd, hd)
    rwkv_main = {f"prefill/nq{NUM_QUERIES}": rwkv_case(
        ops, ref, rng, rshape, rwkv_cfg.rwkv.chunk,
        getattr(torch, rwkv_cfg.dtype), timed=True)}

    cases = (flash_sweep + decode_sweep + list(flash_main.values())
             + list(decode_main.values()) + moe_sweep
             + list(moe_main.values()) + rwkv_sweep
             + list(rwkv_main.values()))
    bad = [c for c in cases if not c["ok"]]
    out = {
        "phase": "kernels", "ok": not bad, "n_cases": len(cases),
        "flash_attention": {
            "sweep_cases": len(flash_sweep),
            "sweep_max_abs_err": sweep_err(flash_sweep),
            "main_path": flash_main},
        "decode_attention": {
            "sweep_cases": len(decode_sweep),
            "sweep_max_abs_err": sweep_err(decode_sweep),
            "main_path": decode_main},
        "moe_gemm": {
            "sweep_cases": len(moe_sweep),
            "sweep_rel_err": sweep_err(moe_sweep, "rel_err"),
            "main_path": moe_main},
        "rwkv6_scan": {
            "sweep_cases": len(rwkv_sweep),
            "sweep_max_abs_err": sweep_err(rwkv_sweep),
            "main_path": rwkv_main},
        "failed": bad,
    }
    emit(out)
    if bad:
        fail(f"{len(bad)} kernel case(s) disagree with the plain version")
    return out


# ---------------------------------------------------------------------------
# phase 3: serve
# ---------------------------------------------------------------------------


class RecordingPolicy:
    """Passes ``plan`` through and keeps the placements it returned."""

    def __init__(self, policy):
        self.policy = policy
        self.placements = []

    def plan(self, wf, state, ready):
        out = self.policy.plan(wf, state, ready)
        self.placements.extend(out)
        return out


def load_example():
    """The example module whose ``make_workflow`` defines the served DAG
    (one definition for the example and for this script)."""
    import importlib.util
    path = Path(__file__).resolve().parent / "examples" / \
        "serve_workflow_torch.py"
    spec = importlib.util.spec_from_file_location("serve_workflow_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def expected_launches(bundles, wf, placements) -> dict:
    """Kernel launches the recorded placements call for: per shard run, a
    model that attends launches K1 once per layer at prefill and K2 once
    per layer at each of the GEN_LEN - 1 decode steps; an MoE model K3
    three times per MoE layer at prefill and at every decode step; an
    RWKV6 model K5 once per layer at prefill (its decode step is plain)."""
    exp = {"flash_attention": 0, "decode_attention": 0, "moe_gemm": 0,
           "rwkv6_scan": 0}
    for p in placements:
        cfg = bundles[wf.stages[p.sid].model].cfg
        runs = sum(1 for n in p.shard_sizes if n)
        if cfg.rwkv is not None:
            exp["rwkv6_scan"] += cfg.num_layers * runs
            continue
        exp["flash_attention"] += cfg.num_layers * runs
        exp["decode_attention"] += cfg.num_layers * runs * (GEN_LEN - 1)
        if cfg.moe is not None:
            exp["moe_gemm"] += (3 * (cfg.num_layers - cfg.moe_layer_start)
                                * runs * GEN_LEN)
    return exp


def phase_serve(mods, models: dict, seed: int, phase: str = "serve"):
    """Serve the example's workflow with ``models`` = {served name:
    (config, weight seed)}; the launch counts must be what the placements
    call for, every kernel the models use launched at least once."""
    ops = mods["ops"]
    t0 = time.perf_counter()
    bundles = {name: mods["ModelBundle"].create(name, cfg, seed=wseed)
               for name, (cfg, wseed) in models.items()}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # prompts drawn below the smallest vocabulary, so every model reads
    # them; each model's tokens are checked against its own vocabulary
    vocab = min(b.cfg.vocab_size for b in bundles.values())
    prompts = torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, (NUM_QUERIES, PROMPT_LEN)))
    wf = mods["make_workflow"](NUM_QUERIES)

    def run_once():
        engine = mods["ServingEngine"](bundles, n_devices=N_DEVICES,
                                       gen_len=GEN_LEN,
                                       prompt_len=PROMPT_LEN)
        state = mods["fresh_state"](mods["homogeneous_cluster"](N_DEVICES))
        policy = RecordingPolicy(mods["make_policy"]("FATE"))
        t = time.perf_counter()
        results = engine.run_workflow(wf, policy, state, prompts)
        torch.cuda.synchronize()
        return engine, policy, results, time.perf_counter() - t

    run_once()                             # warm-up: cuBLAS, allocator
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    engine, policy, results, wall = run_once()
    counts = ops.launch_counts()

    expect = expected_launches(bundles, wf, policy.placements)
    stages, problems = [], []
    for sid in wf.topo_order:
        r = results[sid]
        toks = r.tokens_out
        v = bundles[r.model].cfg.vocab_size
        if tuple(toks.shape) != (NUM_QUERIES, GEN_LEN):
            problems.append(f"{sid}: tokens {tuple(toks.shape)}")
        elif int(toks.min()) < 0 or int(toks.max()) >= v:
            problems.append(f"{sid}: token ids outside [0, {v})")
        stages.append({"sid": sid, "model": r.model,
                       "arch": bundles[r.model].cfg.name,
                       "devices": list(r.device_ids),
                       "shards": [n for n in next(
                           p.shard_sizes for p in policy.placements
                           if p.sid == sid) if n],
                       "wall_s": r.wall_s,
                       "switched": r.switched, "prefix_hit": r.prefix_hit})
    if set(results) != set(wf.stages):
        problems.append(f"stages served: {sorted(results)}")
    for name, n in counts.items():
        if n != expect[name] or (expect[name] > 0 and n <= 0):
            problems.append(f"{name}: {n} launches, expected {expect[name]}")
    gen_tokens = len(wf.stages) * NUM_QUERIES * GEN_LEN
    out = {
        "phase": phase, "ok": not problems, "policy": "FATE",
        "models": {name: {"arch": b.cfg.name, "layers": b.cfg.num_layers,
                          "d_model": b.cfg.d_model, "dtype": b.cfg.dtype,
                          "vocab": b.cfg.vocab_size,
                          "params": b.cfg.param_count()}
                   for name, b in bundles.items()},
        "queries": NUM_QUERIES, "virtual_devices": N_DEVICES,
        "prompt_len": PROMPT_LEN, "gen_len": GEN_LEN,
        "init_seconds": init_s, "stages": stages,
        "workflow_wall_s": wall,
        "generated_tokens_per_s": gen_tokens / wall,
        "launches": counts, "launches_expected": expect,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "problems": problems,
    }
    emit(out)
    if problems:
        fail(f"{phase} phase failed: " + "; ".join(problems))
    return out, bundles, prompts, policy, results


# ---------------------------------------------------------------------------
# phase 4: parity
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_versions(ops, ref, names=None):
    """Swap the plain versions in for the kernels' wrappers (all of them,
    or those ``names``)."""
    saved = {name: getattr(ops, name) for name in (names or ops.KERNELS)}
    for name in saved:
        setattr(ops, name, getattr(ref, name + "_ref"))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def teacher_forced(bundle, shard, served) -> torch.Tensor:
    """Logits of prefill and GEN_LEN - 1 decode steps fed the served
    tokens, so that two runs see the same inputs at every step."""
    model = bundle._model
    nq = shard.shape[0]
    cache = model.init_cache(nq, PROMPT_LEN + GEN_LEN)
    logits, cache = model.prefill(bundle.params, shard, cache)
    all_logits = [logits]
    for step in range(GEN_LEN - 1):
        logits, cache = model.decode_step(
            bundle.params, served[:, step: step + 1], cache,
            PROMPT_LEN + step)
        all_logits.append(logits)
    return torch.cat(all_logits, dim=1).float()


@contextlib.contextmanager
def held_routing(moe_mod, log: list, stats=None):
    """With ``stats`` None, record every MoE layer's expert choice into
    ``log``; else replay them in order, counting in ``stats`` the routing
    decisions (token, layer) whose own top-k differs from the held one."""
    route = moe_mod.route
    held = iter(log)

    def recording(p, cfg, x, experts=None):
        gates, chosen = route(p, cfg, x)
        log.append(chosen)
        return gates, chosen

    def replaying(p, cfg, x, experts=None):
        chosen = next(held)
        own = route(p, cfg, x)[1]
        stats["decisions"] += own.numel() // own.shape[-1]
        stats["flipped"] += int((torch.sort(own, -1).values
                                 != torch.sort(chosen, -1).values)
                                .any(-1).sum())
        return route(p, cfg, x, experts=chosen)

    moe_mod.route = recording if stats is None else replaying
    try:
        yield
    finally:
        moe_mod.route = route


def agreement(kernel_logits, plain_logits) -> dict:
    k_tok, p_tok = kernel_logits.argmax(-1), plain_logits.argmax(-1)
    return {
        "max_logit_diff": float((kernel_logits - plain_logits).abs().max()),
        "greedy_tokens_agree": bool((k_tok == p_tok).all()),
        "greedy_token_agreement": float((k_tok == p_tok).float().mean()),
    }


def kernel_vs_plain(ops, ref, bundle, shard, served, moe_mod=None) -> dict:
    """Teacher-forced logits with the kernels, then with the plain
    versions.  For an MoE model (``moe_mod`` given) also a second plain
    run held to the kernel run's routing: a top-k choice flips under
    differences far below the kernels' tolerances, and one flip changes
    a token's FFN, so only the held run compares the kernels' arithmetic
    alone; the flips are counted."""
    log = []
    with (held_routing(moe_mod, log) if moe_mod is not None
          else contextlib.nullcontext()):
        kernel_logits = teacher_forced(bundle, shard, served)
    with plain_versions(ops, ref):
        plain_logits = teacher_forced(bundle, shard, served)
        if moe_mod is not None:
            stats = {"decisions": 0, "flipped": 0}
            with held_routing(moe_mod, log, stats):
                held_logits = teacher_forced(bundle, shard, served)
    torch.cuda.synchronize()
    out = {
        "arch": bundle.cfg.name, "layers": bundle.cfg.num_layers,
        "dtype": bundle.cfg.dtype, "queries": int(shard.shape[0]),
        "steps": GEN_LEN,
        **agreement(kernel_logits, plain_logits),
        "logit_abs_max": float(kernel_logits.abs().max()),
        "finite": bool(torch.isfinite(kernel_logits).all()),
        "kernel_path_reproduces_served_tokens":
            bool((kernel_logits.argmax(-1) == served).all()),
    }
    if moe_mod is not None:
        out["routing_held"] = {**agreement(kernel_logits, held_logits),
                               "routing_decisions": stats["decisions"],
                               "flipped_when_free": stats["flipped"]}
    return out


def swapped_alone(ops, ref, moe_mod, bundle, shard, served) -> dict:
    """Max logit difference, routing held, when only one kernel at a time
    is replaced by its plain version: where a whole-model difference
    comes from."""
    log = []
    with held_routing(moe_mod, log):
        kernel_logits = teacher_forced(bundle, shard, served)
    out = {}
    for name in ("flash_attention", "decode_attention", "moe_gemm"):
        stats = {"decisions": 0, "flipped": 0}
        with plain_versions(ops, ref, [name]), \
                held_routing(moe_mod, log, stats):
            logits = teacher_forced(bundle, shard, served)
        out[name] = float((logits - kernel_logits).abs().max())
    return out


def layerwise(ops, ref, moe_mod, bundle, shard, served) -> dict:
    """Every layer of a DecoderLM run twice on the same input: with the
    kernels, and with the plain versions under the same routing.  The
    largest difference of the layer's update (its output less its input)
    relative to that update's largest magnitude, over the layers, the
    prefill and every decode step.  The plain call writes the same cache
    rows again: the projections that fill them use no kernel."""
    model = bundle._model
    block = model._block
    worst = {"max_rel_update_diff": 0.0, "layer_calls": 0}

    def checked(p, x, positions, *, cache=None, cache_len=0):
        log = []
        with held_routing(moe_mod, log):
            out, new_cache = block(p, x, positions, cache=cache,
                                   cache_len=cache_len)
        stats = {"decisions": 0, "flipped": 0}
        with plain_versions(ops, ref), held_routing(moe_mod, log, stats):
            plain, _ = block(p, x, positions, cache=cache,
                             cache_len=cache_len)
        upd = (out - x).float()
        rel = float((plain.float() - out.float()).abs().max()) / max(
            1e-30, float(upd.abs().max()))
        worst["max_rel_update_diff"] = max(worst["max_rel_update_diff"],
                                           rel)
        worst["layer_calls"] += 1
        return out, new_cache

    model._block = checked
    try:
        teacher_forced(bundle, shard, served)
    finally:
        del model._block
    return worst


def first_shard(placements, wf, prompts, results, model: str):
    """The sid, prompts and served tokens of the first shard ``model``
    served (a stage's first non-empty shard takes its first queries)."""
    p = next(p for p in placements if wf.stages[p.sid].model == model)
    nq = next(n for n in p.shard_sizes if n)
    return p.sid, prompts[:nq].to("cuda"), results[p.sid].tokens_out[:nq]


@torch.inference_mode()
def phase_parity(mods, bundles, prompts, policy, results, wf) -> dict:
    ops, ref = mods["ops"], mods["ref"]
    first = policy.placements[0]
    model = wf.stages[first.sid].model
    sid, shard, served = first_shard(policy.placements, wf, prompts,
                                     results, model)
    out = {"phase": "parity", "stage": sid,
           **kernel_vs_plain(ops, ref, bundles[model], shard, served),
           "tol": PARITY_LOGIT_TOL}
    # the second check is deterministic: the same kernels on the same
    # inputs as the serve phase must give the tokens it served
    out["ok"] = (out["finite"] and out["max_logit_diff"] < PARITY_LOGIT_TOL
                 and out["kernel_path_reproduces_served_tokens"])
    emit(out)
    if not out["ok"]:
        fail("parity phase failed: kernels and plain versions disagree, "
             "or the kernel path does not reproduce the served tokens")
    return out


@torch.inference_mode()
def phase_parity_moe_rwkv(mods, bundles, prompts, policy, results, wf,
                          seed: int) -> dict:
    """Per model: bf16 at full depth (gates: finite logits, the served
    tokens reproduced; the logit difference and greedy agreement are
    reported: one flipped top-8 routing choice changes a token's FFN),
    then float32 at full width and PARITY_F32_LAYERS layers (gates:
    logits within PARITY_F32_REL of their largest magnitude and every
    greedy token equal; for an MoE model, whose random weights amplify
    any difference several-fold per layer, every layer's update within
    PARITY_F32_REL of its magnitude on the same input and every greedy
    token equal under the kernel run's routing, with the whole-model
    numbers reported beside them)."""
    ops, ref = mods["ops"], mods["ref"]
    out, problems = {"phase": "parity_moe_rwkv"}, []
    for name, bundle in bundles.items():
        sid, shard, served = first_shard(policy.placements, wf, prompts,
                                         results, name)
        moe_mod = mods["moe"] if bundle.cfg.moe is not None else None
        bf16 = kernel_vs_plain(ops, ref, bundle, shard, served, moe_mod)
        if not (bf16["finite"]
                and bf16["kernel_path_reproduces_served_tokens"]):
            problems.append(f"{bundle.cfg.name} bf16: logits not finite or "
                            f"served tokens not reproduced")
        cfg32 = dataclasses.replace(bundle.cfg, dtype="float32",
                                    num_layers=PARITY_F32_LAYERS)
        b32 = mods["ModelBundle"].create(name, cfg32, seed=seed + 7)
        f32 = kernel_vs_plain(ops, ref, b32, shard, served, moe_mod)
        if moe_mod is None:
            f32["tol"] = PARITY_F32_REL * f32["logit_abs_max"]
            ok = (f32["max_logit_diff"] <= f32["tol"]
                  and f32["greedy_tokens_agree"])
        else:
            # the model amplifies any difference several-fold per layer,
            # so the kernels are held to each layer's own update; the
            # greedy tokens to the end, under the kernel run's routing
            f32["swapped_alone_max_logit_diff"] = swapped_alone(
                ops, ref, moe_mod, b32, shard, served)
            f32["layerwise"] = layerwise(ops, ref, moe_mod, b32, shard,
                                         served)
            f32["tol"] = PARITY_F32_REL
            ok = (f32["layerwise"]["max_rel_update_diff"] <= f32["tol"]
                  and f32["routing_held"]["greedy_tokens_agree"])
        del b32
        if not (f32["finite"] and ok):
            problems.append(f"{cfg32.name} float32: kernels and plain "
                            f"versions differ beyond {f32['tol']} "
                            f"or greedy tokens differ")
        out[name] = {"stage": sid, "bf16_full_depth": bf16,
                     "float32_cut_depth": f32}
    out["ok"] = not problems
    out["problems"] = problems
    emit(out)
    if problems:
        fail("parity_moe_rwkv phase failed: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# optional: where one stage's time goes (--profile)
# ---------------------------------------------------------------------------


@torch.inference_mode()
def phase_profile(bundles, prompts, name: str) -> dict:
    """One stage of model ``name`` (8 queries, one shard) split into
    prefill and decode on the host clock, then traced with torch.profiler:
    the share of the wall time in which the card was busy, the launches
    per layer and decode step, and the kernels that took most of the
    device time."""
    from torch.profiler import ProfilerActivity, profile

    bundle = bundles[name]
    model = bundle._model
    shard = prompts.to("cuda")

    def run_stage():
        cache = model.init_cache(NUM_QUERIES, PROMPT_LEN + GEN_LEN)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(bundle.params, shard, cache)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for step in range(GEN_LEN - 1):
            logits, cache = model.decode_step(bundle.params, tok, cache,
                                              PROMPT_LEN + step)
            tok = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1

    run_stage()
    prefill_s, decode_s = run_stage()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_prefill_s, traced_decode_s = run_stage()
    rows = []
    for e in prof.key_averages():
        # kernel rows only: an operator's row repeats its kernels' time
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof_step:
        cache = model.init_cache(NUM_QUERIES, PROMPT_LEN + GEN_LEN)
        torch.cuda.synchronize()
        model.decode_step(bundle.params, shard[:, :1], cache, PROMPT_LEN)
        torch.cuda.synchronize()
    step_launches = sum(e.count for e in prof_step.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA)
    device_s = sum(r[0] for r in rows) / 1e6
    traced_s = traced_prefill_s + traced_decode_s
    out = {
        "phase": "profile",
        "stage": f"{bundle.cfg.name}, 8 queries, one shard",
        "decode_step_launches": step_launches,
        "decode_step_launches_per_layer":
            step_launches / bundle.cfg.num_layers,
        "prefill_s": prefill_s, "decode_s": decode_s,
        "decode_ms_per_step": decode_s / (GEN_LEN - 1) * 1e3,
        "traced_wall_s": traced_s, "device_busy_s": device_s,
        "device_busy_share_traced": device_s / traced_s,
        "device_busy_share_untraced": device_s / (prefill_s + decode_s),
        "device_kernels": len(rows),
        "device_launches": sum(r[1] for r in rows),
        "top_device_time": [
            {"name": name[:80], "calls": n, "ms": us / 1e3,
             "share": us / 1e6 / max(device_s, 1e-12)}
            for us, n, name in rows[:14]],
    }
    emit(out)
    return out


# ---------------------------------------------------------------------------


def kernel_summary(kernels_out, serve_outs) -> dict:
    """One row per kernel: its time at the main shape (the first timed
    one: qwen3's for K1 and K2, the gate/up projection at prefill for K3,
    rwkv6's prefill for K5) and its launches summed over the serve
    phases, with the other timed shapes and the launches per phase."""
    main_key = {"flash_attention": "qwen3-1.7b",
                "decode_attention": "qwen3-1.7b",
                "moe_gemm": "prefill_up", "rwkv6_scan": "prefill"}
    rows = []
    for name in REPLACES:
        main = kernels_out[name]["main_path"]
        timed = {k: c for k, c in main.items() if "ms" in c}
        key = next(k for k in timed if k.startswith(main_key[name]))
        c = timed[key]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": sum(o["launches"][name] for o in serve_outs),
            "launches_by_phase": {o["phase"]: o["launches"][name]
                                  for o in serve_outs},
            "max_abs_err": max(x["max_abs_err"] for x in main.values()),
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"],
            "shape": c["shape"], "dtype": c["dtype"],
            "other_shapes": {k: {f: x[f] for f in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")} for k, x in timed.items() if k != key},
        })
    return {"kernels": rows}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="after each serve phase, also split one stage "
                         "of each model into prefill and decode and "
                         "trace it with torch.profiler")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs one "
             "NVIDIA GPU and has no CPU mode")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    try:
        from repro_torch.configs.archs import ARCHS
        from repro_torch.core.devices import homogeneous_cluster
        from repro_torch.core.executor import fresh_state
        from repro_torch.core.policies import make_policy
        from repro_torch.kernels import _build, ops, ref
        from repro_torch.models import moe
        from repro_torch.serving.engine import ModelBundle, ServingEngine
        make_workflow = load_example().make_workflow
    except (ImportError, OSError) as e:
        fail(f"cannot import the port from {Path(__file__).parent}: {e}")
    mods = dict(ops=ops, ref=ref, ModelBundle=ModelBundle,
                ServingEngine=ServingEngine, make_workflow=make_workflow,
                fresh_state=fresh_state, make_policy=make_policy,
                homogeneous_cluster=homogeneous_cluster, moe=moe)

    qwen = ARCHS["qwen3-1.7b"]
    glm = dataclasses.replace(ARCHS["glm4-9b"], vocab_size=qwen.vocab_size)
    granite, rwkv = ARCHS["granite-moe-3b-a800m"], ARCHS["rwkv6-3b"]
    attn_cfgs = {"qwen3-1.7b": qwen, "glm4-9b": glm,
                 "granite-moe-3b-a800m": granite}
    wf = make_workflow(NUM_QUERIES)

    t_all = time.perf_counter()
    _, smi_line = phase_device(_build)
    kernels_out = phase_kernels(ops, ref, attn_cfgs, granite, rwkv,
                                args.seed)
    serve_out, bundles, prompts, policy, results = phase_serve(
        mods, {"qwen-7b": (qwen, args.seed), "llama-8b": (glm, args.seed + 1)},
        args.seed)
    if args.profile:
        phase_profile(bundles, prompts, "qwen-7b")
    phase_parity(mods, bundles, prompts, policy, results, wf)
    # free the first pair's weights: peak memory below is the second's
    del bundles, policy, results
    gc.collect()
    torch.cuda.empty_cache()
    serve2_out, bundles, prompts, policy, results = phase_serve(
        mods, {"qwen-7b": (granite, args.seed),
               "llama-8b": (rwkv, args.seed + 1)},
        args.seed, phase="serve_moe_rwkv")
    if args.profile:
        for name in bundles:
            phase_profile(bundles, prompts, name)
    phase_parity_moe_rwkv(mods, bundles, prompts, policy, results, wf,
                          args.seed)
    emit(kernel_summary(kernels_out, [serve_out, serve2_out]))
    emit({"phase": "total", "seconds": time.perf_counter() - t_all})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
