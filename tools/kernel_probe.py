#!/usr/bin/env python3
"""Probe the port's kernels on one NVIDIA GPU.

    python3 tools/kernel_probe.py decode-splits   # K2 over split_plan's block target
    python3 tools/kernel_probe.py mamba2-phases   # K4 with one phase removed at a time
    python3 tools/kernel_probe.py rwkv6-phases    # K5 the same, and split over columns
    python3 tools/kernel_probe.py flash-bits --against DIR   # K1 against another tree's
    python3 tools/kernel_probe.py flash-bwd --against DIR    # K1's backward, the same
    python3 tools/kernel_probe.py flash-bwd-phases # K1's backward with one step removed
    python3 tools/kernel_probe.py moe-dw-phases    # K3's weight gradient, the same
    python3 tools/kernel_probe.py moe-grad-phases  # K3's gradients' persistent kernel
    python3 tools/kernel_probe.py rwkv6-bwd-phases # K5's backward, launch by launch
    python3 tools/kernel_probe.py rwkv6-parity-split  # rwkv6's train parity, K5 / K5b apart
    python3 tools/kernel_probe.py mamba2-bwd-phases # K4's backward, launch by launch
    python3 tools/kernel_probe.py mamba2-parity-split # zamba2's train parity, K4 / K4b apart
    python3 tools/kernel_probe.py train-rwkv-turns --against DIR  # train_rwkv, this tree and another

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

``rwkv6-phases`` does the same for ``csrc/rwkv6_scan.cu`` at rwkv6-3b's
prefill (B 8, S 512, 40 heads, D 64, chunk 32, bf16 r, k, v, float32 w,
a carried state, float32 output): the loads, the cumulative sums, the
diagonal 8 x 8 blocks' pairwise scores, the factored scores, scores . v, the
inter-chunk product and the state update.  Its ``split_columns`` variant
is the other layout: two blocks per (batch, head), each with half of the
output units and half of the state's tiles (the scores computed by both),
640 blocks where the one-block layout has 320.

``flash-bits`` builds ``csrc/flash_attention.cu`` of another checkout of the
repository (``--against DIR``, for example a ``git archive`` of the parent
commit) into its own library and runs it beside this tree's K1 on the same
inputs: every (D, Dv) pair both instantiate, float32 and bf16, causal,
windowed and bidirectional, a ragged length and G = 4; this tree's K1 runs
twice, as served and writing the rows' log-sum-exp for a backward.  It
exits 1 unless every output is bitwise equal, which shows that a change
to K1 left the existing instantiations' results alone.  It then times
both in bf16 in turns (this tree, the other, the other, this tree; CUDA
events) at qwen3's
prefill (``q [8,512,16,128]``, ``k, v [8,512,8,128]``) and gemma3's global
layer (``q [8,2048,8,256]``, ``k, v [8,2048,4,256]``), causal.

``flash-bwd`` builds ``csrc/flash_attention_bwd.cu`` of another checkout
(``--against DIR``) into its own library and times it against this tree's
K1 backward in turns (this tree, the other, the other, this tree; CUDA
events, back to back) in bf16 at qwen3-1.7b's training shape
(``q [2,4096,16,128]``, ``k, v [2,4096,8,128]``, causal) and its served
prefill (``q [8,512,16,128]``), gemma3's and, where the other tree
instantiates it, deepseek-v2's (``q, k [2,4096,128,192]``,
``v [2,4096,128,128]``), on the same inputs and K1's own output and
log-sum-exp; it prints both times and the largest difference of each
gradient between the two, relative to its largest magnitude (the two
designs need not give the same bits).  It reads the other tree's C entry
point from its source: the one of the first backward (one scratch, delta
[B, H, Sq]), the one with one head dim, or this one (D and Dv).

``flash-bwd-phases`` builds variants of ``csrc/flash_attention_bwd.cu`` with
one step of the bf16 wgmma kernel cut out (``FLASH_BWD_CUTS``: the counter
waits that order each query tile's dq sums; the dq sums themselves; the
mask test; the exponentials; the stores of ds; the dk / dv products; the
dq products; the dq hand-off) and times each at qwen3's training shape in
turns with the full kernel, as ``mamba2-phases`` does; then the same for
the column-split kernel of D = 256 (``FLASH_BWD_COLS_CUTS``, the score
products among them) at gemma3-4b's global training shape (``q [2, 4096,
8, 256]``, ``k, v [2, 4096, 4, 256]``, causal), and for the kv-split
kernel of (D, Dv) = (192, 128) (``FLASH_BWD_KV_CUTS``: each warpgroup's
dk / dv products and dq blocks apart, which shows their imbalance, and
other sizes of the groups of heads whose work tiles it takes together,
priced whole) at deepseek-v2's training shape (``q, k [2, 4096, 128,
192]``, ``v [2, 4096, 128, 128]``, causal).  A variant computes wrong
numbers; only its time is read.

``moe-dw-phases`` does the same for K3's weight gradient
(``csrc/moe_gemm_bwd.cu``, the bf16 wgmma kernel on its vector loader;
``MOE_DW_CUTS``: the copies, the wgmma products, and the transpose bit
of A cleared; and one variant that adds work: the division per row and
stage that maps a loaded row to its (sample, slot) pair, which the first
version of the kernel made) at granite-moe's training shape (x the dispatch view [2, 40,
1024, 1536], dy [2, 40, 1024, 512]), in turns with the full kernel, and
times K3's forward on the same bytes (``x [2, 40, 1024, 1536] @ w [40,
1536, 512]``) beside them.

``moe-grad-phases`` prices the persistent kernel of K3's gradients
(``csrc/moe_gemm_grad.cu``) at granite-moe's four training shapes (dX and
dW of the gate / up and the down projection; x the dispatch view) by
cuts, ``MOE_GRAD_CUTS``: the TMA loads (the producer arrives on each
stage's barrier without loading), the wgmma products, the epilogue (no
store), and within it the TMA stores, the stmatrix writes and the waits
for a store buffer; and, priced whole, a ring of 3 stages with 2 or 4
store buffers a warpgroup.  Each in turns with the full kernel (CUDA
events, back to back), beside the first design of the same gradient (K3's
kernel reading w K-major, ``csrc/moe_gemm_bwd.cu``) and the batched
``torch.matmul`` on contiguous ``[E, B*C, .]`` operands; then the card's
SM clock and power draw (nvidia-smi samples) while the full kernel, the
epilogue cut and the library call each run for 1.5 s.  For information it also times the
kernel's forward layout (layout 2, which the port does not call) at
granite's training forward shapes (``[2,40,1024,1536] @ [40,1536,512]``
and ``[2,40,1024,512] @ [40,512,1536]``) beside K3's own forward and
``torch.bmm`` (each also in device time, torch.profiler) and K3's plain
version.

``rwkv6-bwd-phases`` times K5's backward (K5b, ``csrc/rwkv6_scan_bwd.cu``)
launch by launch, through the C entry's ``passes`` mask on buffers a full
call filled: the chunk-end states, the chunk-end cotangents, both (the two
launches a call makes for them), and within those two launches the
chunks' contributions alone and the scan alone (variants of the source
with the other launch cut out, ``RWKV6_BWD_CUTS``, built as
``mamba2-phases`` builds its variants), the per-chunk gradients, whole
and with one step of the bf16 kernel cut out at a time
(``RWKV6_BWD_MMA_CUTS``: the products with S0, X and Y, the diagonal
blocks' pairs, dv, and the last step: dr, dk, dw and dbonus's partial),
the ordered sum of dbonus, and the full call, at rwkv6-3b's training
microbatch (``[2, 4096, 40, 64]``, chunk 32, bf16 r, k, v, float32 w and d
out) and its served prefill (``[8, 512, 40, 64]``), CUDA events; with K5's
forward at the same shapes beside them, and the full call's device time
by kernel (torch.profiler).

``rwkv6-parity-split`` splits ``chip_smoke.py``'s ``parity_train_rwkv``
reading between the two kernels: rwkv6-3b at full width on one microbatch
of 2 x 1024 tokens, bf16 over float32 masters at 2, 8 and 32 layers and
float32 at 32, the loss and gradients of the plain forward with the
plain backward against three runs: the kernels (K5, K5b), K5 with the
plain backward, and the plain forward with K5b; for each the loss's and
the gradient norm's relative difference and the worst leaf's (relative
to its largest magnitude).

``mamba2-bwd-phases`` times K4's backward (K4b, ``csrc/mamba2_scan_bwd.cu``)
as ``rwkv6-bwd-phases`` times K5b: launch by launch through the C entry's
``passes`` mask (the chunk-end states, the cotangents, both, within those
two launches the contributions alone and the scan alone,
``MAMBA2_BWD_CUTS``; the per-chunk gradients, whole and with one step cut
out at a time, ``MAMBA2_BWD_CHUNK_CUTS``, in the bf16 tensor-core kernel:
the state terms, the pairs' dy . x, dx's pair sum, db's and dc's pair
sums, the gradient of dt a; the
ordered sums; the full call) at zamba2-2.7b's training microbatch
(``[2, 4096, 80, 64]``, chunk 128, bf16 column slices, float32 dt and dy)
and its served prefill (``[8, 512, 80, 64]``), CUDA events; with K4's
forward at the same shapes, and the full call's device time by kernel.

``mamba2-parity-split`` splits ``chip_smoke.py``'s ``parity_train_zamba2``
reading at its bf16 gate depth (``ZAMBA2_BF16_GATE_LAYERS``, 6 layers, the
first attention site) between the kernels: zamba2-2.7b at full width on
the phase's microbatch (seed 0, 2 x ``ZAMBA2_PARITY_SEQ`` tokens), bf16 over
float32 masters and float32 at the reference init, and bf16 with the
attention projections at 1 / sqrt(d); the loss and gradients of the plain
versions (the scan's plain forward with its plain backward, autograd
through the plain attention) against four runs: every kernel (K4, K4b,
K1, K1b), K4 alone, K4b alone, and K1 with K1b alone; for each the loss's
and the gradient norm's relative difference and the worst leaf's
(relative to its largest magnitude).

``train-rwkv-turns`` runs ``chip_smoke.py``'s ``train_rwkv`` phase (rwkv6-3b
at full width and depth, 8 x 4096 tokens a step, one warm-up and four
measured steps, one more traced) in turns from this tree and from another
checkout (``--against DIR``): the other, this, this, the other, each in a
process of its own that builds its tree's kernels; per run the step
seconds, tokens per second, peak memory, launches and the traced step's
device seconds by kind, K5b's among them.

Each prints JSON lines, and the card's name and power limit first.  No
CPU mode: without a CUDA device it exits with code 1.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
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

# phase -> [(text in rwkv6_scan.cu, its replacement), ...]
RWKV6_CUTS = {
    "loads": [("for (int i = tid / DC; i < LP; i += NTH / DC) {",
               "for (int i = tid / DC; i < 0; i += NTH / DC) {"),
              ("for (int i = tid / WC; i < LP; i += NTH / WC) {",
               "for (int i = tid / WC; i < 0; i += NTH / WC) {")],
    "cumsum": [("    if (tid < D) {\n      float run = 0.f;",
                "    if (false) {\n      float run = 0.f;")],
    "diag_scores": [("for (int p = NTH - 1 - tid; p < NSUB * 72; p += NTH) {",
                     "for (int p = NTH - 1 - tid; p < 0; p += NTH) {")],
    "factored_scores": [("for (int u = warp; u < n_off + NSUB; u += NW) {",
                         "for (int u = warp; u < 0; u += NW) {")],
    "scores_v": [("for (int cb = 0; cb <= a; ++cb) {",
                  "for (int cb = 0; cb < 0; ++cb) {")],
    "inter_chunk": [("for (int kk = 0; kk < D / 16; ++kk) {   // (r * exp(ce)) S",
                     "for (int kk = 0; kk < 0; ++kk) {")],
    "state_update": [("    if (owner) {\n      float tot[2], dec[2];",
                      "    if (false) {\n      float tot[2], dec[2];")],
    # the other layout, priced whole: two blocks per (b, h), each with half
    # of the output units and of the state's tiles
    "split_columns": [
        ("static constexpr int PER = (TILES + NW - 1) / NW;",
         "static constexpr int PER = (TILES / 2 + NW - 1) / NW;"),
        ("const bool owner = tile0 < Tile::TILES;",
         "const bool owner = tile0 < Tile::TILES / 2;"),
        ("for (int u = warp; u < NSUB * Tile::CSPLIT; u += NW) {",
         "for (int u = warp; u < (NSUB * Tile::CSPLIT + 1) / 2; u += NW) {"),
        ("  const int b = blockIdx.x / H;\n  const int h = blockIdx.x % H;\n\n"
         "  const MmaLayout",
         "  const int b = (blockIdx.x >> 1) / H;\n"
         "  const int h = (blockIdx.x >> 1) % H;\n\n  const MmaLayout"),
        ("const int64_t st_off = (int64_t)blockIdx.x * D * D;   // [B, H, D, D]\n\n"
         "  // scores above",
         "const int64_t st_off = (int64_t)(blockIdx.x >> 1) * D * D;\n\n"
         "  // scores above"),
        ("kern<<<a.B * a.H, 32 * MmaTile<D>::NW",
         "kern<<<2 * a.B * a.H, 32 * MmaTile<D>::NW")],
}


# step of the wgmma backward -> [(text in flash_attention_bwd.cu, its
# replacement), ...]
FLASH_BWD_CUTS = {
    "admission": [
        ("      wait_counter(a.counters + tile[next], want[next]);\n", ""),
        ("ld_acquire(a.counters + tile[b]) == want[b])", "true)")],
    "dq_sum": [("        sums.state[hb] = DqSums::PENDING;\n"
                "        sums.want[hb] = kt - first_key_tile<WG_BC>(a, qt);",
                "        sums.state[hb] = DqSums::FREE;\n"
                "        sums.want[hb] = kt - first_key_tile<WG_BC>(a, qt);")],
    "mask": [("      const bool edge =\n", "      const bool edge = false &&\n")],
    "exp2": [("ok ? fast_exp2(s[i] * a.scale_log2 - ((r & 1) ? l2.y : l2.x))",
              "ok ? s[i]")],
    "ds_store": [("            *reinterpret_cast<uint32_t*>(\n                ds_s +",
                  "            if (false) *reinterpret_cast<uint32_t*>(\n"
                  "                ds_s +")],
    "dkdv_mma": [("          wgmma_rs<DP, 1>(dv, pa[t],",
                  "          if (false) wgmma_rs<DP, 1>(dv, pa[t],"),
                 ("          wgmma_rs<DP, 1>(dk, da[t],",
                  "          if (false) wgmma_rs<DP, 1>(dk, da[t],")],
    "dq_mma": [("          wgmma_ss<64, 1, 1>(\n              dq,",
                "          if (false) wgmma_ss<64, 1, 1>(\n              dq,")],
    "handoff": [("          mine[(i >> 1) * 128 + ct] = make_float2(dq[i], dq[i + 1]);",
                 "          ;")],
}

# lines that the column-split and the kv-split kernels share, which make
# a cut of one of them unique
_SCORE_OFFSETS = ("        const uint32_t ko = (kk >> 2) * Tl::KV_BLOCK + (kk & 3) * 32;\n"
                  "        const uint32_t qo = (kk >> 2) * Tl::Q_BLOCK + (kk & 3) * 32;\n")
_DQ_TAIL = ("                             desc_plus(km, t * 16 * LINE), t > 0);\n"
            "        wgmma_commit();\n        wgmma_wait<0>();\n        fence_acc(dq);\n")
_HANDOFF_END = ("[(i >> 1) * 128 + ct] = make_float2(dq[i], dq[i + 1]);\n      }\n"
                "      fence_proxy_async();\n      bar_sync(1, WG_THREADS);\n"
                "      if (leader) {\n")

# step of the column-split kernel of D = 256 -> [(text in
# flash_attention_bwd.cu, its replacement), ...]: the same steps, with the
# shared p^T / ds^T stores and the score products (s^T, dp^T) beside them
FLASH_BWD_COLS_CUTS = {
    "admission": FLASH_BWD_CUTS["admission"],
    "dq_sum": [(f"blk{_HANDOFF_END}        sums.state[0] = DqSums::PENDING;",
                f"blk{_HANDOFF_END}        sums.state[0] = DqSums::FREE;")],
    "mask": [("      const bool masked =\n",
              "      const bool masked = false &&\n")],
    "exp2": [("keep ? fast_exp2(s[i] * a.scale_log2 - row_lse) : 0.f;\n"
              "          s[i] = p;",
              "keep ? s[i] : 0.f;\n          s[i] = p;")],
    "pds_store": [("          *reinterpret_cast<uint32_t*>(p_s + at) =",
                   "          if (false) *reinterpret_cast<uint32_t*>(p_s + at) ="),
                  ("          *reinterpret_cast<uint32_t*>(ds_s + at) =",
                   "          if (false) *reinterpret_cast<uint32_t*>(ds_s + at) =")],
    "score_mma": [(f"kk < DP / 16; ++kk) {{\n{_SCORE_OFFSETS}"
                   "        wgmma_ss<32, 0, 0>(s, desc_plus(kd, ko),",
                   f"kk < DP / 16; ++kk) {{\n{_SCORE_OFFSETS}"
                   "        if (false) wgmma_ss<32, 0, 0>(s, desc_plus(kd, ko),"),
                  (f"kk < DP / 16; ++kk) {{\n{_SCORE_OFFSETS}"
                   "        wgmma_ss<32, 0, 0>(dp, desc_plus(vd, ko),",
                   f"kk < DP / 16; ++kk) {{\n{_SCORE_OFFSETS}"
                   "        if (false) wgmma_ss<32, 0, 0>(dp, desc_plus(vd, ko),")],
    "dkdv_mma": [("        wgmma_m64n128k16<0, 1>(dv, desc_plus(pd, t * 32),",
                  "        if (false) wgmma_m64n128k16<0, 1>(dv, desc_plus(pd, t * 32),"),
                 ("        wgmma_m64n128k16<0, 1>(dk, desc_plus(sd, t * 32),",
                  "        if (false) wgmma_m64n128k16<0, 1>(dk, desc_plus(sd, t * 32),")],
    "dq_mma": [("          wgmma_ss<64, 1, 1>(dq, desc_plus(am, t * 16 * LINE),\n"
                f"{_DQ_TAIL}        if (j == 0) bar_sync(1, WG_THREADS);     // the buffer",
                "          if (false) wgmma_ss<64, 1, 1>(dq, desc_plus(am, t * 16 * LINE),\n"
                f"{_DQ_TAIL}        if (j == 0) bar_sync(1, WG_THREADS);     // the buffer")],
    "handoff": [("          blk[(i >> 1) * 128 + ct] = make_float2(dq[i], dq[i + 1]);",
                 "          ;")],
}


# step of the kv-split kernel of (192, 128) -> [(text in
# flash_attention_bwd.cu, its replacement), ...]: the steps of the
# column-split kernel, with each warpgroup's products cut apart (warpgroup
# 0 keeps dk and one dq block, warpgroup 1 dv and two), and other sizes
# of its groups of heads built whole
FLASH_BWD_KV_CUTS = {
    "admission": FLASH_BWD_CUTS["admission"],
    "dq_sum": [(f"hand{_HANDOFF_END}        sums.state[0] = DqSums::PENDING;",
                f"hand{_HANDOFF_END}        sums.state[0] = DqSums::FREE;")],
    "mask": [("      const bool crossed =\n",
              "      const bool crossed = false &&\n")],
    "exp2": [("keep ? fast_exp2(s[i] * a.scale_log2 - row_lse) : 0.f;\n"
              "          s[i] = pv;",
              "keep ? s[i] : 0.f;\n          s[i] = pv;")],
    "pds_store": [("          *reinterpret_cast<uint32_t*>(pt_s + at) =",
                   "          if (false) *reinterpret_cast<uint32_t*>(pt_s + at) ="),
                  ("          *reinterpret_cast<uint32_t*>(dst_s + at) =",
                   "          if (false) *reinterpret_cast<uint32_t*>(dst_s + at) =")],
    "score_mma": [("for (int kk = 0; kk < D / 16; ++kk) {",
                   "for (int kk = 0; kk < 0; ++kk) {"),
                  ("for (int kk = 0; kk < DV / 16; ++kk) {",
                   "for (int kk = 0; kk < 0; ++kk) {")],
    "dk_mma_wg0": [("        wgmma_m64n128k16<0, 1>(acc, desc_plus(ad, t * 32),",
                    "        if (cw != 0) wgmma_m64n128k16<0, 1>(acc, desc_plus(ad, t * 32),"),
                   ("      if (cw == 0) {\n#pragma unroll\n        for (int t = 0; t < 4; ++t)\n"
                    "          wgmma_ss<64, 0, 1>(acc2,",
                    "      if (false) {\n#pragma unroll\n        for (int t = 0; t < 4; ++t)\n"
                    "          wgmma_ss<64, 0, 1>(acc2,")],
    "dv_mma_wg1": [("        wgmma_m64n128k16<0, 1>(acc, desc_plus(ad, t * 32),",
                    "        if (cw == 0) wgmma_m64n128k16<0, 1>(acc, desc_plus(ad, t * 32),")],
    "dq_mma_wg0": [("        if (cw == 0 && j == 1) break;\n",
                    "        if (cw == 0 && j == 1) break;\n"
                    "        const bool skip = cw == 0;\n"),
                   ("          wgmma_ss<64, 1, 1>(dq, desc_plus(am, t * 16 * LINE),\n"
                    "                             desc_plus(km, t * 16 * LINE), t > 0);\n"
                    "        wgmma_commit();\n        wgmma_wait<0>();\n        fence_acc(dq);\n"
                    "        if (j == 0) bar_sync(1, WG_THREADS);     // the hand-off",
                    "          if (!skip) wgmma_ss<64, 1, 1>(dq, desc_plus(am, t * 16 * LINE),\n"
                    "                             desc_plus(km, t * 16 * LINE), t > 0);\n"
                    "        wgmma_commit();\n        wgmma_wait<0>();\n        fence_acc(dq);\n"
                    "        if (j == 0) bar_sync(1, WG_THREADS);     // the hand-off")],
    "dq_mma_wg1": [("        if (cw == 0 && j == 1) break;\n",
                    "        if (cw == 0 && j == 1) break;\n"
                    "        const bool skip = cw == 1;\n"),
                   ("          wgmma_ss<64, 1, 1>(dq, desc_plus(am, t * 16 * LINE),\n"
                    "                             desc_plus(km, t * 16 * LINE), t > 0);\n"
                    "        wgmma_commit();\n        wgmma_wait<0>();\n        fence_acc(dq);\n"
                    "        if (j == 0) bar_sync(1, WG_THREADS);     // the hand-off",
                    "          if (!skip) wgmma_ss<64, 1, 1>(dq, desc_plus(am, t * 16 * LINE),\n"
                    "                             desc_plus(km, t * 16 * LINE), t > 0);\n"
                    "        wgmma_commit();\n        wgmma_wait<0>();\n        fence_acc(dq);\n"
                    "        if (j == 0) bar_sync(1, WG_THREADS);     // the hand-off")],
    "handoff": [("          hand[(i >> 1) * 128 + ct] = make_float2(dq[i], dq[i + 1]);",
                 "          ;")],
    # not cuts: other sizes of the groups of heads whose work tiles are
    # taken together (one head; all of them, key tile major, as the other
    # kernels take them), each priced whole
    "head_group_1": [("constexpr int KS_HEAD_GROUP = 8;",
                      "constexpr int KS_HEAD_GROUP = 1;")],
    "head_group_4": [("constexpr int KS_HEAD_GROUP = 8;",
                      "constexpr int KS_HEAD_GROUP = 4;")],
    "head_group_16": [("constexpr int KS_HEAD_GROUP = 8;",
                       "constexpr int KS_HEAD_GROUP = 16;")],
    "key_tile_major": [("constexpr int KS_HEAD_GROUP = 8;",
                        "constexpr int KS_HEAD_GROUP = 4096;")],
}


# step of K3's weight-gradient kernel -> [(text in moe_gemm_bwd.cu, its
# replacement), ...]
MOE_DW_CUTS = {
    # not a cut: the vector loader's row offsets computed by a division per
    # row and stage again, as the kernel's first version did (a negative
    # saving is what the division costs)
    "row_division": [("        const bool ok = row[i] < rows;\n",
                      "        const bool ok = row[i] < rows;\n"
                      "        if (ok) {\n"
                      "          const int64_t b = row[i] / C, c = row[i] % C;\n"
                      "          ox[i] = b * x_sb + c * x_sc;\n"
                      "          oy[i] = b * y_sb + c * y_sc;\n"
                      "        }\n")],
    "loads": [("      for (int i = 0; i < PT; ++i) {",
               "      for (int i = 0; i < 0; ++i) {")],
    "wgmma": [("      wgmma_m64n128k16<1, 1>(",
               "      if (false) wgmma_m64n128k16<1, 1>(")],
    "a_transpose": [("      wgmma_m64n128k16<1, 1>(",
                     "      wgmma_m64n128k16<0, 1>(")],
}


# step of the gradients' persistent kernel -> [(text in moe_gemm_grad.cu,
# its replacement), ...]
# K5b's state launches apart: the chunks' contributions alone (the scan's
# launch cut), the scan alone (the contributions' launch cut)
RWKV6_BWD_CUTS = {
    "local_only": [("  rwkv6_bwd_scan_kernel<D><<<",
                    "  if (false) rwkv6_bwd_scan_kernel<D><<<")],
    "scan_only": [("  local<<<dim3(nc, a.B * a.H)",
                   "  if (false) local<<<dim3(nc, a.B * a.H)")],
}
# K4b's two state launches with the other cut out
MAMBA2_BWD_CUTS = {
    "local_only": [("  mamba2_bwd_scan_kernel<P, N>\n      <<<",
                    "  if (false) mamba2_bwd_scan_kernel<P, N>\n      <<<")],
    "scan_only": [("    const int rc = launch_states_mma<64, 64>(a);",
                   "    const int rc = 0;")],
}
# K4b's bf16 per-chunk kernel (mma.sync) with one step cut out: the state
# terms S0^T dy, dE^T x and dE b (1); the pairs' dy . x (2); dx's pair
# sum (3); db's and dc's pair sums (4); R's suffix scans and F's sums (5, 6)
MAMBA2_BWD_CHUNK_CUTS = {
    "no_state_terms": [
        ("      for (int kk = 0; kk < P / 16; ++kk) {\n        uint32_t ah[4], "
         "al[4];",
         "      for (int kk = 0; kk < 0; ++kk) {\n        uint32_t ah[4], "
         "al[4];"),
        ("      for (int kk = 0; kk < P / 16; ++kk) {\n        uint32_t ax[4];",
         "      for (int kk = 0; kk < 0; ++kk) {\n        uint32_t ax[4];"),
        ("      for (int kk = 0; kk < N / 16; ++kk) {\n        uint32_t ab[4];",
         "      for (int kk = 0; kk < 0; ++kk) {\n        uint32_t ab[4];")],
    "no_pairs": [("      const bool any = n0 <= r0 + 15;",
                  "      const bool any = false;")],
    "no_dx_pairs": [("      if (kk < rb) continue;                 // M_ij",
                     "      continue;                 // M_ij")],
    "no_dbdc_pairs": [
        ("      if (kk <= rb) {                        // E_ij",
         "      if (false) {                        // E_ij"),
        ("      if (kk >= rb) {\n        uint32_t ah[4], al[4];\n        "
         "frag_a_t(ah, xh",
         "      if (false) {\n        uint32_t ah[4], al[4];\n        "
         "frag_a_t(ah, xh")],
    "no_g": [
        ("      warp_suffix_sums(hi, lane);\n      warp_suffix_sums(lo, lane);",
         ""),
        ("          fr[c] += __shfl_xor_sync(0xffffffffu, fr[c], off);",
         "          ;")],
}
# the bf16 per-chunk kernel with one step cut out: the products with S0,
# P and the scores (2); X and Y (4); the diagonal blocks' pairs (5); dv
# (7); dr, dk, dw and dbonus (8)
RWKV6_BWD_MMA_CUTS = {
    "no_s0_products": [("    for (int u = warp; u < nDR + nP + nSF + NSUB; u += MW) {",
                        "    for (int u = warp; u < 0; u += MW) {")],
    "no_xy": [("      const bool is_x = kind == 1;",
               "      if (kind) continue;\n      const bool is_x = kind == 1;")],
    "no_pairs": [("  for (int base = 32 * warp; base < NB8 * D; base += MT) {",
                  "  for (int base = 32 * warp; base < 0; base += MT) {")],
    "no_dv": [("  for (int u = warp; u < NSUB * CU; u += MW) {",
               "  for (int u = warp; u < 0; u += MW) {")],
    "no_step8": [("    constexpr int NP = MT / D;",
                  "    return;\n    constexpr int NP = MT / D;")],
}

MOE_GRAD_CUTS = {
    "loads": [("          mbar_expect_tx(&full[stage], STAGE_BYTES);\n"
               "          load_stage<L>(",
               "          mbar_arrive(&full[stage]);\n"
               "          if (false) load_stage<L>(")],
    "wgmma": [("        mma_stage<L>(acc, base + stage * STAGE_BYTES, wg);",
               "        if (false) mma_stage<L>(acc, base + stage * "
               "STAGE_BYTES, wg);")],
    "epilogue": [("      store_tile<L>(acc, &tout, bufs, w, x, wg, warp, "
                  "lane, n_st);",
                  "      if (false) store_tile<L>(acc, &tout, bufs, w, x, "
                  "wg, warp, lane, n_st);")],
    "tma_store": [("    if (leader) {\n      if (L == DW)",
                   "    if (false) {\n      if (L == DW)")],
    "stmatrix": [("      stsm_x4(buf + line * 128", "      if (false) "
                  "stsm_x4(buf + line * 128")],
    "store_waits": [("    if (leader) bulk_wait_read<EPI_BUFS - 1>();",
                     "    if (false) bulk_wait_read<EPI_BUFS - 1>();")],
    # not cuts: other ring and store-buffer sizes, priced whole
    "stages3": [("constexpr int STAGES = 4;", "constexpr int STAGES = 3;")],
    "stages3_bufs4": [("constexpr int STAGES = 4;",
                       "constexpr int STAGES = 3;"),
                      ("constexpr int EPI_BUFS = 2;",
                       "constexpr int EPI_BUFS = 4;")],
}


def device_ms(fn, marker: str, iters: int = 20):
    """Mean device milliseconds per call in kernels whose name holds
    ``marker`` ("" for every kernel of the call; torch.profiler; up to
    three traces, as one now and then comes back without device
    activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", 0.0)
                 for e in prof.key_averages() if marker in e.key
                 and getattr(e, "device_type", DeviceType.CUDA)
                 == DeviceType.CUDA)
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


def build_variant(kernel: str, name: str, source: str, out: Path,
                  entry: str = "") -> ctypes.CDLL:
    """Compile one variant of ``csrc/<kernel>.cu`` into its own library
    and declare its C entry point (``entry``, else ``fate_<kernel>``)."""
    from repro_torch.kernels import _build
    cu = out / f"{kernel}_{name}.cu"
    lib = out / f"{kernel}_{name}.so"
    cu.write_text(source)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared",
                    "-I", str(_build.CSRC), "-o", str(lib), str(cu)],
                   check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    _build.declare(dll, [entry or f"fate_{kernel}"])
    return dll


def build_variants(kernel: str, cuts_by_name: dict, entry: str = "",
                   tag: str = "") -> dict:
    """The full source and one variant per entry of ``cuts_by_name``,
    each built in parallel (its files named with ``tag``); exits naming a
    cut that is not found once."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import _build
    src = (_build.CSRC / f"{kernel}.cu").read_text()
    out = _build.build_root().parent / "probe"
    out.mkdir(parents=True, exist_ok=True)
    sources = {"full": src}
    for name, cuts in cuts_by_name.items():
        variant = src
        for old, new in cuts:
            if variant.count(old) != 1:
                sys.exit(f"kernel_probe: a text cut for {name!r} is not "
                         f"found once in {kernel}.cu: update its cuts")
            variant = variant.replace(old, new)
        sources[name] = variant
    with ThreadPoolExecutor(len(sources)) as pool:
        return dict(zip(sources, pool.map(
            lambda kv: build_variant(kernel, tag + kv[0], kv[1], out, entry),
            sources.items())))


def events_ms(call, lib, iters: int = 30) -> float:
    """Mean milliseconds per call of ``call(lib)`` on CUDA events."""
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


def in_turns(call, libs: dict) -> dict:
    """Each library timed twice, in the order full .. last, last .. full."""
    order = list(libs) + list(reversed(list(libs)))
    times: dict = {}
    for name in order:
        times.setdefault(name, []).append(events_ms(call, libs[name]))
    return times


def mamba2_phases() -> None:
    libs = build_variants("mamba2_scan", MAMBA2_CUTS)

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
            *cm.stride()[:2], *dt.stride(), *y.stride()[:3], 1, 1,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            sys.exit(f"kernel_probe: launch failed with code {rc}")

    times = in_turns(call, libs)
    full = sum(times["full"]) / 2
    print(json.dumps({
        "probe": "mamba2-phases", "shape": [[b, s, h, p], [b, s, n]],
        "chunk": chunk, "ms": times,
        "phase_cost_ms": {k: full - sum(v) / 2 for k, v in times.items()
                          if k != "full"}}), flush=True)


def rwkv6_phases() -> None:
    libs = build_variants("rwkv6_scan", RWKV6_CUTS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s, h, d, chunk = 8, 512, 40, 64, 32
    r, k, v = (torch.randn(b, s, h, d, device="cuda",
                           generator=gen).bfloat16() for _ in range(3))
    w = torch.sigmoid(torch.randn(b, s, h, d, device="cuda", generator=gen))
    bonus = torch.randn(h, d, device="cuda", generator=gen) * 0.1
    st0 = torch.randn(b, h, d, d, device="cuda", generator=gen)
    out = torch.empty(b, s, h, d, device="cuda")
    fin = torch.empty(b, h, d, d, device="cuda")

    def call(lib):
        rc = lib.fate_rwkv6_scan(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            bonus.data_ptr(), st0.data_ptr(), out.data_ptr(), fin.data_ptr(),
            b, s, h, d, chunk, *r.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *w.stride()[:3], *out.stride()[:3], 1, 0,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            sys.exit(f"kernel_probe: launch failed with code {rc}")

    times = in_turns(call, libs)
    full = sum(times["full"]) / 2
    print(json.dumps({
        "probe": "rwkv6-phases", "shape": [b, s, h, d], "chunk": chunk,
        "ms": times,
        "phase_cost_ms": {k: full - sum(v) / 2 for k, v in times.items()
                          if k not in ("full", "split_columns")},
        "split_columns_ms": sum(times["split_columns"]) / 2,
        "one_block_ms": full}), flush=True)


def flash_bits(against: Path) -> None:
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    csrc = against / "src" / "repro_torch" / "kernels" / "csrc"
    src = (csrc / "flash_attention.cu").read_text()
    out = _build.build_root().parent / "probe"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "flash_attention_against.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                    str(csrc), "-o", str(lib), str(csrc / "flash_attention.cu")],
                   check=True, capture_output=True, text=True)
    other = ctypes.CDLL(str(lib)).fate_flash_attention
    other.restype = ctypes.c_int
    # the other tree's entry takes a value head dim after D, and a
    # log-sum-exp pointer after out, only if its source says so
    with_dv = "int D, int Dv," in src
    with_lse = "void* out, float* lse," in src
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    other.argtypes = [p] * (5 if with_lse else 4) \
        + [i32] * (7 if with_dv else 6) + [i64] * 12 + [i32] * 3 + [p]
    dims = [(d, dv) for d, dv in _build.FLASH_HEAD_DIMS
            if f"launch_flash_mma<{d}, {dv}>(a)" in src
            or (d == dv and f"launch_flash_mma<{d}>(a)" in src)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    differ = 0
    for d, dv in dims:
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            for causal, window in ((True, 0), (False, 0), (True, 64)):
                b, s, h, kv = 2, 200, 8, 2
                q, k = (torch.randn(b, s, n, d, device="cuda",
                                    generator=gen).to(dtype)
                        for n in (h, kv))
                v = torch.randn(b, s, kv, dv, device="cuda",
                                generator=gen).to(dtype)
                mine = ops.flash_attention(q, k, v, causal=causal,
                                           window=window)
                # this tree's K1 also writing the rows' log-sum-exp
                mine_lse, _ = flash_attention_fwd(
                    q, k, v, causal=causal, window=window, return_lse=True)
                theirs = torch.empty_like(mine)
                rc = other(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           theirs.data_ptr(), *((None,) if with_lse else ()),
                           b, s, s, h, kv, d, *((dv,) if with_dv else ()),
                           *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                           *theirs.stride()[:3], int(causal), window, code,
                           torch.cuda.current_stream().cuda_stream)
                same = rc == 0 and torch.equal(mine, theirs)
                same_lse = rc == 0 and torch.equal(mine_lse, theirs)
                differ += not (same and same_lse)
                print(json.dumps({"probe": "flash-bits", "d": d, "dv": dv,
                                  "dtype": str(dtype).split(".")[-1],
                                  "causal": causal, "window": window,
                                  "rc": rc, "bitwise_equal": same,
                                  "with_lse_bitwise_equal": same_lse}),
                      flush=True)
    print(json.dumps({"probe": "flash-bits", "against": str(against),
                      "dims": dims, "cases": 6 * len(dims),
                      "differ": differ}), flush=True)
    if differ or not dims:
        sys.exit(1)
    for name, (s, h, kv, d) in {"qwen3": (512, 16, 8, 128),
                                "gemma3_global": (2048, 8, 4, 256)}.items():
        q, k, v = (torch.randn(8, s, n, d, device="cuda",
                               generator=gen).bfloat16() for n in (h, kv, kv))
        theirs = torch.empty_like(q)

        def call(lib):
            if lib == "this":
                return ops.flash_attention(q, k, v)
            return other(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         theirs.data_ptr(), *((None,) if with_lse else ()),
                         8, s, s, h, kv, d,
                         *((d,) if with_dv else ()), *q.stride()[:3],
                         *k.stride()[:3], *v.stride()[:3],
                         *theirs.stride()[:3], 1, 0, 1,
                         torch.cuda.current_stream().cuda_stream)
        times = in_turns(call, {"this": "this", "against": "against"})
        print(json.dumps({"probe": "flash-bits", "timed": name,
                          "q": [8, s, h, d], "kv": [8, s, kv, d],
                          "this_ms": times["this"],
                          "against_ms": times["against"]}), flush=True)


def bwd_inputs(b: int, s: int, h: int, kv: int, d: int, gen, dv: int = 0):
    """bf16 q, k at ``[b, s, h | kv, d]``, v, dO at ``dv`` (0: ``d``) and
    K1's causal output and log-sum-exp on them."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    dv = dv or d
    q = torch.randn(b, s, h, d, device="cuda", generator=gen).bfloat16()
    do = torch.randn(b, s, h, dv, device="cuda", generator=gen).bfloat16()
    k = torch.randn(b, s, kv, d, device="cuda", generator=gen).bfloat16()
    v = torch.randn(b, s, kv, dv, device="cuda", generator=gen).bfloat16()
    o, lse = flash_attention_fwd(q, k, v, causal=True, return_lse=True)
    return q, k, v, o, do, lse


def bwd_call(fn, entry: str, q, k, v, o, do, lse, outs=None):
    """One call of a library's ``fate_flash_attention_bwd`` (causal, bf16)
    with the scratch and head dims its ``entry`` point takes: ``"pair"``
    (D and Dv, this tree's), ``"scratch"`` (one head dim and the wgmma
    kernel's scratch, PR 22-24) or ``"first"`` (delta [B, H, Sq] alone);
    returns (dq, dk, dv)."""
    from repro_torch.kernels.flash_attention import bwd_scratch
    b, sq, h, d = q.shape
    sk, kv, d_v = k.shape[1], k.shape[2], v.shape[3]
    dq, dk, dv = outs or (torch.empty_like(x) for x in (q, k, v))
    stream = torch.cuda.current_stream().cuda_stream
    if entry != "first":
        delta, acc, cnt = bwd_scratch(b, h, sq, d, d_v, q.dtype, q.device)
        dims = (d, d_v) if entry == "pair" else (d,)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                acc.data_ptr(), cnt.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), b, sq, sk, h, kv, *dims, 1, 0, 1, stream)
    else:
        delta = torch.empty((b, h, sq), dtype=torch.float32, device="cuda")
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, sk, h,
                kv, d, 1, 0, 1, stream)
    if rc != 0:
        sys.exit(f"kernel_probe: flash_attention_bwd returned {rc}")
    return dq, dk, dv


# (B, S, H, KV, D, Dv)
BWD_SHAPES = {"qwen3_train": (2, 4096, 16, 8, 128, 128),
              "qwen3_served": (8, 512, 16, 8, 128, 128),
              "gemma3_train": (2, 4096, 8, 4, 256, 256),
              "deepseek_train": (2, 4096, 128, 128, 192, 128)}


def flash_bwd(against: Path) -> None:
    from repro_torch.kernels import _build, ops
    csrc = against / "src" / "repro_torch" / "kernels" / "csrc"
    src = (csrc / "flash_attention_bwd.cu").read_text()
    out = _build.build_root().parent / "probe"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "flash_attention_bwd_against.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                    str(csrc), "-o", str(lib),
                    str(csrc / "flash_attention_bwd.cu")],
                   check=True, capture_output=True, text=True)
    other = ctypes.CDLL(str(lib)).fate_flash_attention_bwd
    entry = ("pair" if "int D, int Dv" in src else
             "scratch" if "float* dq_accum" in src else "first")
    p, i32 = ctypes.c_void_p, ctypes.c_int
    other.restype = i32
    other.argtypes = [p] * (10 if entry == "first" else 12) + \
        [i32] * (10 if entry == "pair" else 9) + [p]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, (b, s, h, kv, d, dv) in BWD_SHAPES.items():
        if dv != d and entry != "pair":
            continue            # the other tree has no such instantiation
        args = bwd_inputs(b, s, h, kv, d, gen, dv)
        mine = ops.flash_attention_bwd(*args)
        theirs = bwd_call(other, entry, *args)
        rel = [float((x.float() - y.float()).abs().max()
                     / y.float().abs().max()) for x, y in zip(mine, theirs)]
        outs = [torch.empty_like(x) for x in mine]

        def call(which):
            if which == "this":
                return ops.flash_attention_bwd(*args)
            return bwd_call(other, entry, *args, outs=outs)
        times = in_turns(call, {"this": "this", "against": "against"})
        print(json.dumps({"probe": "flash-bwd", "against": str(against),
                          "shape": name, "q": [b, s, h, d],
                          "kv": [b, s, kv, d], "v_head_dim": dv,
                          "causal": True,
                          "this_ms": times["this"],
                          "against_ms": times["against"],
                          "rel_diff_dq_dk_dv": rel}), flush=True)


def flash_bwd_phases() -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, cuts, tag in (("qwen3_train", FLASH_BWD_CUTS, ""),
                             ("gemma3_train", FLASH_BWD_COLS_CUTS, "cols_"),
                             ("deepseek_train", FLASH_BWD_KV_CUTS, "kv_")):
        libs = build_variants("flash_attention_bwd", cuts, tag=tag)
        b, s, h, kv, d, dv = BWD_SHAPES[shape]
        args = bwd_inputs(b, s, h, kv, d, gen, dv)
        outs = [torch.empty_like(x) for x in args[:3]]

        def call(lib):
            return bwd_call(lib.fate_flash_attention_bwd, "pair", *args,
                            outs=outs)
        times = in_turns(call, libs)
        full = sum(times["full"]) / 2
        print(json.dumps({"probe": "flash-bwd-phases", "shape_name": shape,
                          "shape": list(BWD_SHAPES[shape]),
                          "ms": times, "full_ms": full,
                          "saved_ms": {k: full - sum(t) / 2
                                       for k, t in times.items()
                                       if k != "full"}}), flush=True)
        del args, outs, libs
        torch.cuda.empty_cache()


def moe_dw_phases() -> None:
    from repro_torch.kernels import moe_gemm as mg
    libs = build_variants("moe_gemm_bwd", MOE_DW_CUTS, "fate_moe_gemm_dw")
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, e, c, d, f = 2, 40, 1024, 1536, 512
    buf = torch.randn(b, e * c + 1, d, device="cuda", generator=gen)
    x = buf.bfloat16()[:, :-1].view(b, e, c, d)
    dy = torch.randn(b, e, c, f, device="cuda", generator=gen).bfloat16()
    w = torch.randn(e, d, f, device="cuda", generator=gen).bfloat16()
    dw = torch.empty(e, d, f, device="cuda", dtype=torch.bfloat16)

    def call(lib):
        rc = lib.fate_moe_gemm_dw(
            x.data_ptr(), dy.data_ptr(), dw.data_ptr(), b, e, c, d, f,
            *x.stride(), *dy.stride(), 1, 1,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            sys.exit(f"kernel_probe: launch failed with code {rc}")
    times = in_turns(call, libs)
    full = sum(times["full"]) / 2
    fwd = events_ms(lambda _: mg.moe_gemm(x, w), None)
    print(json.dumps({"probe": "moe-dw-phases",
                      "shape": [[b, e, c, d], [b, e, c, f]],
                      "ms": times, "full_ms": full,
                      "saved_ms": {k: full - sum(t) / 2
                                   for k, t in times.items()
                                   if k != "full"},
                      "forward_same_bytes_ms": fwd}), flush=True)


def grad_call(lib, layout: str, a, b, out):
    """The persistent kernel of ``lib`` on a [B, E, C, .] and b (dy, or w
    [E, D, F]) into out, planned as the wrapper plans it."""
    from repro_torch.kernels import moe_gemm as mg
    bb, e, c = a.shape[:3]
    if layout == "dx":
        d, f = b.shape[1], a.shape[3]
    else:
        d, f = a.shape[3], b.shape[-1]
    plan = mg.grad_plan(layout, bb, e, c, d, f, a.shape, a.stride(),
                        a.data_ptr(), b.shape, b.stride(), b.data_ptr(),
                        mg._sm_count(a.device.index))
    b_strides = b.stride()[:3] if layout == "dw" else (0,) + b.stride()[:2]
    rc = lib.fate_moe_gemm_grad(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), bb, e, c, d, f,
        *a.stride()[:3], *b_strides, mg.GRAD_LAYOUT[layout], plan.grid,
        plan.row_tiles, plan.col_tiles, plan.k_stages,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        sys.exit(f"kernel_probe: launch failed with code {rc}")


def first_design(mg, kind: str, a, b):
    """The first design of a gradient (the route ``grad_plan`` keeps for
    operands a tensor map cannot take), through the wrapper."""
    real = mg.grad_plan
    mg.grad_plan = lambda *args: dataclasses.replace(real(*args),
                                                     route="cp_async")
    try:
        return getattr(mg, "moe_gemm_" + kind)(a, b)
    finally:
        mg.grad_plan = real


def clocks_under(call, lib, seconds: float = 1.5) -> dict:
    """The card's SM clock (MHz) and power draw (W), medians of
    nvidia-smi samples every 100 ms while ``call(lib)`` runs back to back
    for ``seconds``."""
    import time
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    t = time.perf_counter()
    while time.perf_counter() - t < seconds:
        for _ in range(20):
            call(lib)
        torch.cuda.synchronize()
    smi.terminate()
    rows = [line.split(",") for line in smi.communicate()[0].splitlines()
            if line.count(",") == 1]
    mid = lambda xs: sorted(xs)[len(xs) // 2] if xs else None
    return {"sm_mhz": mid([float(a) for a, _ in rows[2:]]),
            "power_w": mid([float(b) for _, b in rows[2:]])}


def moe_grad_phases() -> None:
    from repro_torch.kernels import moe_gemm as mg
    libs = build_variants("moe_gemm_grad", MOE_GRAD_CUTS,
                          "fate_moe_gemm_grad", tag="grad_")
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, e, c = 2, 40, 1024
    for proj, d, f in (("gate_up", 1536, 512), ("down", 512, 1536)):
        buf = torch.randn(b, e * c + 1, d, device="cuda", generator=gen)
        x = buf.bfloat16()[:, :-1].view(b, e, c, d)
        del buf
        w = (torch.randn(e, d, f, device="cuda", generator=gen)
             * d ** -0.5).bfloat16()
        dy = torch.randn(b, e, c, f, device="cuda", generator=gen).bfloat16()
        flat = lambda t: t.transpose(0, 1).reshape(e, b * c,
                                                   t.shape[-1]).contiguous()
        xc, dyc = flat(x), flat(dy)
        for kind, a, bb, shape, lib_fn, first in (
                ("dx", dy, w, (b, e, c, d),
                 lambda _: torch.matmul(dyc, w.transpose(1, 2)),
                 lambda _: first_design(mg, "dx", dy, w)),
                ("dw", x, dy, (e, d, f),
                 lambda _: torch.matmul(xc.transpose(1, 2), dyc),
                 lambda _: first_design(mg, "dw", x, dy))):
            out = torch.empty(shape, device="cuda", dtype=torch.bfloat16)

            def call(lib):
                grad_call(lib, kind, a, bb, out)
            times = in_turns(call, libs)
            full = sum(times["full"]) / 2
            print(json.dumps({
                "probe": "moe-grad-phases", "kind": kind, "projection": proj,
                "shape": [list(a.shape), list(bb.shape)], "ms": times,
                "full_ms": full,
                "saved_ms": {k: full - sum(t) / 2 for k, t in times.items()
                             if k != "full"},
                "first_design_ms": events_ms(first, None),
                "library_ms": events_ms(lib_fn, None),
                "clocks": {"full": clocks_under(call, libs["full"]),
                           "epilogue_cut": clocks_under(call,
                                                        libs["epilogue"]),
                           "library": clocks_under(lib_fn, None)}}),
                flush=True)
        # for information: the forward layout beside K3's forward
        out = torch.empty(b, e, c, f, device="cuda", dtype=torch.bfloat16)
        print(json.dumps({
            "probe": "moe-grad-phases", "kind": "forward_layout",
            "projection": proj, "shape": [list(x.shape), list(w.shape)],
            "persistent_ms": events_ms(
                lambda lib: grad_call(lib, "fwd", x, w, out), libs["full"]),
            "k3_forward_ms": events_ms(lambda _: mg.moe_gemm(x, w), None),
            "k3_forward_device_ms": device_ms(lambda: mg.moe_gemm(x, w),
                                              "moe_gemm_wgmma_kernel"),
            "plain_ms": events_ms(lambda _: mg.moe_gemm_ref(x, w), None,
                                  iters=5),
            "bmm_ms": events_ms(lambda _: torch.bmm(xc, w), None),
            "bmm_device_ms": device_ms(lambda: torch.bmm(xc, w), "")}),
            flush=True)
        del x, w, dy, xc, dyc, out
        torch.cuda.empty_cache()


def rwkv6_bwd_phases() -> None:
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6_scan as rs
    libs = build_variants("rwkv6_scan_bwd",
                          {**RWKV6_BWD_CUTS, **RWKV6_BWD_MMA_CUTS})
    gen = torch.Generator(device="cuda").manual_seed(0)
    both = rs.PASS_STATES | rs.PASS_COTANGENTS
    passes = {"states": rs.PASS_STATES, "cotangents": rs.PASS_COTANGENTS,
              "state_passes": both, "chunks": rs.PASS_CHUNKS,
              "bonus_sum": rs.PASS_BONUS,
              "full": rs.bwd_passes((True,) * 5 + (False,))}
    for tag, b, s in (("train", 2, 4096), ("prefill", 8, 512)):
        shape = (b, s, 40, 64)
        rand = lambda *sh: torch.randn(sh, device="cuda", generator=gen)
        r, k, v = (rand(*shape).mul_(0.5).bfloat16() for _ in range(3))
        w, dout = torch.sigmoid(rand(*shape)), rand(*shape)
        bonus = rand(40, 64) * 0.1
        bufs = rs.bwd_buffers(r, 32, passes["full"], False)
        call = lambda p, lib: rs.launch_bwd(r, k, v, w, bonus, dout, 32,
                                            None, None, bufs, p, lib=lib)
        call(passes["full"], libs["full"])
        times = {name: events_ms(lambda lib, p=p: call(p, lib),
                                 libs["full"])
                 for name, p in passes.items()}
        for name in RWKV6_BWD_CUTS:      # within the two state launches
            times[name] = events_ms(lambda lib: call(both, lib), libs[name])
        for name in RWKV6_BWD_MMA_CUTS:  # the per-chunk pass, a step cut
            times["chunks_" + name] = events_ms(
                lambda lib: call(rs.PASS_CHUNKS, lib), libs[name])
        fwd = events_ms(lambda _: ops.rwkv6_scan(
            r, k, v, w, bonus, chunk=32, out_dtype=torch.float32), None)
        by_kernel = {}
        for kern in ("rwkv6_bwd_local", "rwkv6_bwd_scan", "rwkv6_bwd_mma",
                     "rwkv6_bwd_bonus"):
            by_kernel[kern] = device_ms(
                lambda: call(passes["full"], libs["full"]),
                kern)
        print(json.dumps({"probe": "rwkv6-bwd-phases", "shape": list(shape),
                          "chunk": 32, "ms": times,
                          "share_of_full": {n: t / times["full"]
                                            for n, t in times.items()},
                          "device_ms_by_kernel": by_kernel,
                          "forward_ms": fwd}), flush=True)
        del r, k, v, w, dout, bufs
        torch.cuda.empty_cache()


def mamba2_bwd_phases() -> None:
    from repro_torch.kernels import ops
    from repro_torch.kernels import mamba2_scan as ms
    libs = build_variants("mamba2_scan_bwd",
                          {**MAMBA2_BWD_CUTS, **MAMBA2_BWD_CHUNK_CUTS})
    gen = torch.Generator(device="cuda").manual_seed(0)
    both = ms.PASS_STATES | ms.PASS_COTANGENTS
    passes = {"states": ms.PASS_STATES, "cotangents": ms.PASS_COTANGENTS,
              "state_passes": both, "chunks": ms.PASS_CHUNKS,
              "sums": ms.PASS_SUMS,
              "full": ms.bwd_passes((True,) * 5 + (False,))}
    h, p, n, chunk = 80, 64, 64, 128
    sub = ms.bwd_chunk(chunk)
    for b, s in ((2, 4096), (8, 512)):
        rand = lambda *sh: torch.randn(sh, device="cuda", generator=gen)
        xbc = rand(b, s, h * p + 2 * n).bfloat16()
        xh = xbc[..., :h * p].view(b, s, h, p)
        bm, cm = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
        dt = torch.nn.functional.softplus(rand(b, s, h))
        a_log, dy = rand(h) * 0.5, rand(b, s, h, p)
        bufs = ms.bwd_buffers(xh, bm, sub, passes["full"], False)
        call = lambda q, lib: ms.launch_bwd(xh, bm, cm, dt, a_log, dy, sub,
                                            None, None, bufs, q, lib=lib)
        call(passes["full"], libs["full"])
        times = {name: events_ms(lambda lib, q=q: call(q, lib),
                                 libs["full"])
                 for name, q in passes.items()}
        for name in MAMBA2_BWD_CUTS:        # within the two state launches
            times[name] = events_ms(lambda lib: call(both, lib), libs[name])
        for name in MAMBA2_BWD_CHUNK_CUTS:  # the per-chunk pass, a step cut
            times["chunks_" + name] = events_ms(
                lambda lib: call(ms.PASS_CHUNKS, lib), libs[name])
        fwd = events_ms(lambda _: ops.mamba2_scan(
            xh, bm, cm, dt, a_log, chunk=chunk, out_dtype=torch.float32),
            None)
        by_kernel = {kern: device_ms(
            lambda: call(passes["full"], libs["full"]), kern)
            for kern in ("mamba2_bwd_local", "mamba2_bwd_scan",
                         "mamba2_bwd_mma", "mamba2_bwd_sum")}
        print(json.dumps({"probe": "mamba2-bwd-phases",
                          "shape": [b, s, h, p], "state_dim": n,
                          "chunk": chunk, "sub_chunk": sub, "ms": times,
                          "share_of_full": {k: t / times["full"]
                                            for k, t in times.items()},
                          "device_ms_by_kernel": by_kernel,
                          "forward_ms": fwd}), flush=True)
        del xbc, xh, bm, cm, dt, dy, bufs
        torch.cuda.empty_cache()


def rwkv6_parity_split() -> None:
    import dataclasses
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs.archs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6_scan as rs
    from repro_torch.models.families import build_model
    from repro_torch.training.data import DataConfig, SyntheticTokens
    from repro_torch.training.tree import tree_paths

    class Mixed(torch.autograd.Function):
        """K5's forward or the plain one, K5b or the plain backward."""

        @staticmethod
        def forward(ctx, r, k, v, w, bonus, chunk, out_dtype, fwd_plain,
                    bwd_plain):
            ctx.save_for_backward(r, k, v, w, bonus)
            ctx.chunk, ctx.bwd_plain = chunk, bwd_plain
            return rs._scan_fwd(r, k, v, w, bonus, chunk, None, out_dtype,
                                fwd_plain)

        @staticmethod
        def backward(ctx, dout, _):
            r, k, v, w, bonus = ctx.saved_tensors
            g = (rs.rwkv6_scan_bwd_ref(r, k, v, w, bonus, dout)
                 if ctx.bwd_plain else
                 rs.rwkv6_scan_bwd(r, k, v, w, bonus, dout, chunk=ctx.chunk))
            return (*(x.to(y.dtype) for x, y in zip(g, (r, k, v, w, bonus))),
                    None, None, None, None)

    def scan(fwd_plain, bwd_plain):
        return lambda r, k, v, w, bonus, *, chunk, state0=None, \
            out_dtype=None: Mixed.apply(r, k, v, w, bonus, chunk, out_dtype,
                                        fwd_plain, bwd_plain)

    rwkv = ARCHS["rwkv6-3b"]
    batch = SyntheticTokens(DataConfig(rwkv.vocab_size, 1024, 8)).batch_at(1)
    micro = {k: v[:2] for k, v in batch.items()}
    kernel_scan = ops.rwkv6_scan
    runs = {"kernels": (False, False), "k5_forward_only": (False, True),
            "k5b_backward_only": (True, False)}
    with cs.expandable_segments():
        for layers, dtype in ((2, torch.bfloat16), (8, torch.bfloat16),
                              (32, torch.bfloat16), (32, torch.float32)):
            cfg = dataclasses.replace(rwkv, num_layers=layers, dtype=str(
                dtype).split(".")[-1])
            model = build_model(cfg, "cuda")
            masters = cs.master_params(model, 0)
            paths = [p for p, _ in tree_paths(masters)]
            out = {}
            try:
                ops.rwkv6_scan = scan(True, True)
                lp, gp = cs.loss_and_grads(model, masters, micro, dtype)
                norm = lambda gs: float(torch.sqrt(sum(
                    (g.float() ** 2).sum() for g in gs)))
                for name, (fp, bp) in runs.items():
                    ops.rwkv6_scan = scan(fp, bp)
                    lk, gk = cs.loss_and_grads(model, masters, micro, dtype)
                    rel = {p: cs.rel_err(a, b)
                           for p, a, b in zip(paths, gk, gp)}
                    worst = max(rel, key=rel.get)
                    out[name] = {
                        "loss_rel_diff": float(abs(lk - lp) / abs(lp)),
                        "grad_norm_rel_diff": abs(norm(gk) - norm(gp))
                        / norm(gp),
                        "grad_rel_diff_max": rel[worst],
                        "worst_leaf": worst}
                    del gk
            finally:
                ops.rwkv6_scan = kernel_scan
            print(json.dumps({"probe": "rwkv6-parity-split",
                              "layers": layers, "dtype": str(dtype),
                              "microbatch": [2, 1024], **out}), flush=True)
            del model, masters, gp
            torch.cuda.empty_cache()


def mamba2_parity_split() -> None:
    import dataclasses
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs.archs import ARCHS
    from repro_torch.kernels import mamba2_scan as ms
    from repro_torch.kernels import ops, ref
    from repro_torch.models.families import build_model
    from repro_torch.training.data import DataConfig, SyntheticTokens
    from repro_torch.training.tree import tree_paths

    class Mixed(torch.autograd.Function):
        """K4's forward or the plain one, K4b or the plain backward."""

        @staticmethod
        def forward(ctx, xh, b, c, dt, a_log, chunk, out_dtype, fwd_plain,
                    bwd_plain):
            ctx.save_for_backward(xh, b, c, dt, a_log)
            ctx.chunk, ctx.bwd_plain = chunk, bwd_plain
            return ms._scan_fwd(xh, b, c, dt, a_log, chunk, None, out_dtype,
                                fwd_plain)

        @staticmethod
        def backward(ctx, dy, _):
            xh, b, c, dt, a_log = ctx.saved_tensors
            g = (ms.mamba2_scan_bwd_ref(xh, b, c, dt, a_log, dy)
                 if ctx.bwd_plain else
                 ms.mamba2_scan_bwd(xh, b, c, dt, a_log, dy,
                                    chunk=ctx.chunk))
            return (*g[:5], None, None, None, None)

    def scan(fwd_plain, bwd_plain):
        return lambda xh, b, c, dt, a_log, *, chunk, state0=None, \
            out_dtype=None: Mixed.apply(xh, b, c, dt, a_log,
                                        ms._chunk(xh.shape[1], chunk),
                                        out_dtype, fwd_plain, bwd_plain)

    zamba = ARCHS["zamba2-2.7b"]
    seq = cs.ZAMBA2_PARITY_SEQ
    batch = SyntheticTokens(DataConfig(zamba.vocab_size, seq,
                                       cs.TRAIN_GLOBAL_BATCH, seed=0)) \
        .batch_at(1)
    micro = {k: v[:cs.TRAIN_MICROBATCH] for k, v in batch.items()}
    kernel_scan, kernel_attn = ops.mamba2_scan, ops.flash_attention
    # (K4's forward plain, K4b plain, the attention plain)
    runs = {"kernels": (False, False, False),
            "k4_forward_only": (False, True, True),
            "k4b_backward_only": (True, False, True),
            "attention_only": (True, True, False)}
    norm = lambda gs: float(torch.sqrt(sum((g.float() ** 2).sum()
                                           for g in gs)))
    layers = cs.ZAMBA2_BF16_GATE_LAYERS
    with cs.expandable_segments():
        for dtype, init in ((torch.bfloat16, None),
                            (torch.float32, None),
                            (torch.bfloat16, cs.attention_at_input_width)):
            cfg = dataclasses.replace(zamba, num_layers=layers, dtype=str(
                dtype).split(".")[-1])
            model = build_model(cfg, "cuda")
            masters = cs.master_params(model, 0, init)
            paths = [p for p, _ in tree_paths(masters)]
            out = {}
            try:
                ops.mamba2_scan = scan(True, True)
                ops.flash_attention = ref.flash_attention_ref
                lp, gp = cs.loss_and_grads(model, masters, micro, dtype)
                for name, (fp, bp, ap) in runs.items():
                    ops.mamba2_scan = scan(fp, bp)
                    ops.flash_attention = (ref.flash_attention_ref if ap
                                           else kernel_attn)
                    lk, gk = cs.loss_and_grads(model, masters, micro, dtype)
                    rel = {p: cs.rel_err(a, b)
                           for p, a, b in zip(paths, gk, gp) if b.numel()}
                    worst = max(rel, key=rel.get)
                    out[name] = {
                        "loss_rel_diff": float(abs(lk - lp) / abs(lp)),
                        "grad_norm_rel_diff": abs(norm(gk) - norm(gp))
                        / norm(gp),
                        "grad_rel_diff_max": rel[worst],
                        "worst_leaf": worst}
                    del gk
            finally:
                ops.mamba2_scan, ops.flash_attention = kernel_scan, \
                    kernel_attn
            print(json.dumps({"probe": "mamba2-parity-split",
                              "layers": layers, "dtype": str(dtype),
                              "init": cs.INIT_LABEL[init],
                              "microbatch": [cs.TRAIN_MICROBATCH, seq],
                              "grad_norm_plain": norm(gp), **out}),
                  flush=True)
            del model, masters, gp
            torch.cuda.empty_cache()


TRAIN_RWKV_RUN = """
import sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {root!r} + "/src")
import chip_smoke as cs
from repro_torch.configs.archs import ARCHS
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.training import optimizer as opt
with cs.expandable_segments():
    cs.phase_train(dict(ops=ops, steps=steps, opt=opt), ARCHS["rwkv6-3b"], 0,
                   profile=True, phase="train_rwkv")
"""


def train_rwkv_turns(against: Path) -> None:
    trees = {"this": ROOT, "against": against}
    for turn, name in enumerate(("against", "this", "this", "against")):
        root = str(trees[name])
        run = subprocess.run([sys.executable, "-c",
                              TRAIN_RWKV_RUN.format(root=root)],
                             cwd=root, capture_output=True, text=True,
                             timeout=1500)
        line = next((json.loads(x) for x in reversed(run.stdout.splitlines())
                     if x.startswith("{") and '"train_rwkv"' in x), None)
        if run.returncode != 0 or line is None:
            sys.exit(f"kernel_probe: train_rwkv in {root} failed "
                     f"(exit {run.returncode}):\n{run.stderr[-3000:]}")
        prof = line.get("profile", {})
        print(json.dumps({
            "probe": "train-rwkv-turns", "turn": turn, "tree": name,
            "root": root, "ok": line["ok"],
            "step_s": line["step_s"], "step_s_mean": line["step_s_mean"],
            "tokens_per_s": line["tokens_per_s"],
            "peak_gb": line["peak_gb"],
            "launches": {k: v for k, v in line["launches"].items() if v},
            "launches_expected": {k: v for k, v in
                                  line["launches_expected"].items() if v},
            "traced_device_s": prof.get("device_s"),
            "traced_busy_share": prof.get("device_busy_share"),
            "device_s_by_kind": prof.get("device_s_by_kind")}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("probe", choices=["decode-splits", "mamba2-phases",
                                      "rwkv6-phases", "flash-bits",
                                      "flash-bwd", "flash-bwd-phases",
                                      "moe-dw-phases", "moe-grad-phases",
                                      "rwkv6-bwd-phases",
                                      "rwkv6-parity-split",
                                      "mamba2-bwd-phases",
                                      "mamba2-parity-split",
                                      "train-rwkv-turns"])
    ap.add_argument("--against", type=Path,
                    help="flash-bits, flash-bwd, train-rwkv-turns: the "
                         "root of the other checkout")
    args = ap.parse_args()
    if args.probe in ("flash-bits", "flash-bwd", "train-rwkv-turns") \
            and args.against is None:
        ap.error(f"{args.probe} needs --against DIR")
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
    elif args.probe == "mamba2-phases":
        mamba2_phases()
    elif args.probe == "rwkv6-phases":
        rwkv6_phases()
    elif args.probe == "flash-bits":
        flash_bits(args.against.resolve())
    elif args.probe == "flash-bwd":
        flash_bwd(args.against.resolve())
    elif args.probe == "moe-dw-phases":
        moe_dw_phases()
    elif args.probe == "moe-grad-phases":
        moe_grad_phases()
    elif args.probe == "rwkv6-bwd-phases":
        rwkv6_bwd_phases()
    elif args.probe == "rwkv6-parity-split":
        rwkv6_parity_split()
    elif args.probe == "mamba2-bwd-phases":
        mamba2_bwd_phases()
    elif args.probe == "mamba2-parity-split":
        mamba2_parity_split()
    elif args.probe == "train-rwkv-turns":
        train_rwkv_turns(args.against.resolve())
    else:
        flash_bwd_phases()


if __name__ == "__main__":
    main()
