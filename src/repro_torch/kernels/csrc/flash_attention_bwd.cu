// Backward of prefill attention (K1) for Hopper: GQA, optional causal
// mask, optional sliding window.  The TPU kernel
// src/repro/kernels/flash_attention.py :: flash_attention has no backward:
// the JAX models differentiate its XLA twin (repro.models.attention), and
// this kernel computes that gradient for the port's K1 forward, which
// saves each row's log-sum-exp (csrc/flash_attention.cu).
//
// What it computes, per batch b and query head h over its KV head h / G,
// with s = (q . k) * D^-0.5 masked as the forward masks it:
//   p  = exp(s - lse)                 (float32, 0 where masked)
//   dv = sum over the G heads of p^T dO
//   dp = dO v^T,   delta = rowsum(dO * o),   ds = p * (dp - delta)
//   dq = ds k * D^-0.5,   dk = sum over the G heads of ds^T q * D^-0.5
// with float32 sums, written in the input type.  Inputs and outputs are
// contiguous [B, S, heads, D] for q, k, dq, dk and [B, S, heads, Dv] for
// v, o, dO, dv (the wrapper copies anything else); Dv == D but for
// deepseek-v2's latent attention, (D, Dv) = (192, 128), whose dp and
// delta sum over Dv; lse is float32 [B, H, Sq].
//
// What bounds it.  The function needs five products over the attended
// (query, key) pairs (s, dp, dv, dk, dq: 2 * D flops a pair each) against
// 989 TFLOP/s in bf16: at qwen3-1.7b's training shape (B 2, S 4096, H 16,
// KV 8, D 128, causal) about 344 GFLOP, 0.35 ms; its bytes (q, k, v, o,
// dO, lse in; dq, dk, dv out, each once) are about 0.2 GB, 0.06 ms.  So
// operations bound it, and only wgmma reaches the tensor cores' rate.
//
// bf16: one pass on wgmma, after FlashAttention-3's backward, at the head
// dim rounded up to DP = 64 or 128 (rows of whole 128-byte swizzle lines:
// TMA fills the columns past D with zeros, which add nothing to any
// product, and only the first D columns are written).  Three launches:
//   1. bwd_prep_kernel, one warp per (b, head, query row up to Sq rounded
//      up to 64): delta = rowsum(dO * o), lse * log2 e (+inf past Sq) into
//      padded float32 rows; zeroes the float32 dq accumulator and the
//      counters below;
//   2. flash_bwd_wgmma_kernel: a persistent grid (one block per SM) takes
//      work tiles (b, KV head, key tile of 128 keys) from a device counter,
//      key tile major, so lower key tiles are always taken first (in a
//      causal call also the longest first).  A block keeps the tile's K and
//      V in shared memory (TMA, 128-byte swizzle) and streams the 64-row
//      query tiles of the G heads of its KV head that see a key of the
//      tile, highest first, through a 2-stage ring (q and dO by TMA, lse
//      and delta by bulk copies, completing on mbarriers).  Two warpgroups;
//      warpgroup w owns keys 64 w .. 64 w + 63 and, per query tile, in two
//      halves of 32 queries, runs on wgmma s^T = K q^T and dp^T = V dO^T
//      (both operands in shared memory), forms p^T and ds^T in float32
//      registers, rounded to bf16 as the A operands of dV += p^T dO and
//      dK += ds^T q (A from registers), and writes ds^T to shared memory;
//      then dQ = ds K (A taken transposed from shared memory): at DP = 128
//      each warpgroup 64 columns over the 128 keys, at DP = 64 each its own
//      keys, the two parts summed in the hand-off in a fixed order.  Thread
//      0 also takes the work tiles, issues the copies and sums each tile's
//      dq (a float32 hand-off buffer, 2 of them) into the accumulator with
//      one bulk reduce-add (cp.reduce.async.bulk .add.f32).
//   3. bwd_dq_kernel: dq = accumulator * D^-0.5, rounded to bf16.
// dk and dv (the G heads summed in the block) are written from registers
// at the end of a work tile.
//
// Why no producer warpgroup (a departure from FlashAttention-3's layout):
// a block of more than 8 warps puts 3 on some of the SM's four
// sub-partitions (16K registers each), and ptxas (CUDA 12.9) then compiles
// every thread for at most 168 registers, setmaxnreg notwithstanding; the
// consumers need about 238 at D = 128 (dk and dv are 128 of them).  With 8
// warps they get 255: on an H100 80GB HBM3 at 700 W, at qwen3-1.7b's
// training shape, 384 threads with a producer warpgroup and setmaxnreg
// 56 / 224 spilled (ptxas -v), serialised every wgmma and took 4.64 ms a
// call; 256 threads, 1.48 ms (tools/kernel_probe.py flash-bwd-phases, the
// full kernel).
//
// dq in a fixed order, with no nondeterministic atomics: a counter per
// (b, head, query tile) admits the key tiles' contributions in ascending
// key-tile order.  Thread 0 runs the sums one tile behind the hand-offs: a
// tile's sum is issued once its counter equals the number of key tiles
// before its own that visit that query tile (ld.acquire), and when it has
// landed (bulk wait) the counter is incremented with release semantics; a
// hand-off buffer is reused two tiles later, so at the end of each tile
// the oldest pending sum is waited for (nanosleep back-off) if it has not
// been admitted yet, and mid-tile the sums issued at the last tile's end
// land early.  So the accumulator sees the same additions in the same
// order in every call and two calls give the same bits.  This cannot
// deadlock: a block waits only for its own oldest pending tile, whose
// predecessors have lower key tiles of the same (b, KV head) and so were
// taken from the work counter earlier, by blocks that are running (a block
// takes a work tile only while it runs, and work tiles are taken in
// ascending order); the pending tile of the lowest work tile that waits
// has predecessors that wait for nothing, so it is admitted.  The set of
// key tiles that visit a query tile is a range (key_tile_queries moves up
// monotonically with the key tile), so "the key tiles before mine" is
// kt - first_key_tile(qt).  Any wait that has not ended after about 20 s
// traps (common.cuh :: WAIT_LIMIT) instead of hanging the card.
//
// Rows of a ragged tail: TMA fills rows past Sq or Sk with zeros, the
// padded lse is +inf, and the mask test (only in tiles that cross the
// diagonal, the window or a tail) zeroes their p and ds.  Tiles wholly
// outside the mask are never visited.  A row with no key has lse = +inf,
// so p = 0 and it gets no gradient (ROADMAP H10).
//
// The padding does 4x the work at D = 16, 2x at 32 and 1.6x at 80, dims
// that no model of the registry trains at full size on the card.
//
// bf16 at D = 256 (gemma3): flash_bwd_colsplit_kernel, the same three
// launches, pre-pass, dq pass, counters and ordered sums.  The layout
// above cannot hold it: a warpgroup owning 64 keys would keep 2 x 64 x 256
// / 128 = 256 floats a thread of dk and dv (ptxas gives 255 at 8 warps),
// and 128-key tiles need 128 KB of K and V.  So a work tile is 64 keys,
// shared by both warpgroups, and its columns are split: warpgroup w keeps
// dk and dv for columns 128 w .. 128 w + 127 (64 + 64 floats a thread).
// Per 64-row query tile, warpgroup w computes s^T and dp^T for queries
// 32 w .. 32 w + 31 over all 256 columns and writes p^T and ds^T to shared
// memory in bf16; then both run dV[:, cols] += p^T dO[:, cols] and
// dK[:, cols] += ds^T q[:, cols] over the 64 queries with A from shared
// memory (five products a pair, none twice), and dq = ds K by 64-column
// blocks, two a warpgroup.  Shared memory (ColTile, 213,504 bytes of the
// 232,448) holds K and V (32 KB each), ONE stage of q and dO (32 KB each),
// p^T and ds^T (8 KB each) and ONE 64 KB dq hand-off: the next query
// tile's copies are issued once both warpgroups have read the stage (they
// land during the dq products), and the hand-off is freed before the dq
// products are written, so the leader waits there for the admission and
// landing of the last tile's sum.  The ordered sums and the argument above
// hold for 64-key tiles unchanged (a block has at most one pending tile).
//
// bf16 at (D, Dv) = (192, 128) (deepseek-v2's latent attention, G = 1):
// flash_bwd_kvsplit_kernel, the same three launches, pre-pass, dq pass,
// counters and ordered sums, and the column split's 64-key work tiles
// shared by both warpgroups.  dk and dv are 192 + 128 = 320 columns, five
// 64-column swizzle lines, which do not split evenly; the split is by
// accumulator: warpgroup 0 keeps dk (96 floats a thread: 128 columns in
// one m64n128 accumulator and 64 in one m64n64), warpgroup 1 dv (64), so
// dk's products run on warpgroup 0 and dv's on warpgroup 1, and the three
// 64-column dq blocks are dealt one to warpgroup 0 and two to warpgroup
// 1, four 64 x 64 x 64 products a tile each (180 registers, no spill).
// Per 64-row query tile, warpgroup w computes s^T over the 192 columns
// and dp^T over the 128 for queries 32 w .. 32 w + 31, and writes p^T and
// ds^T to shared memory in bf16, as at D = 256.  Shared memory (KvTile,
// 190,496 bytes) holds K and V (24 + 16 KB), TWO stages of q and dO (24 +
// 16 KB each; the next tile's copies land during a whole tile), p^T and
// ds^T (8 KB each) and ONE 48 KB dq hand-off, freed as at D = 256; one
// stage with two hand-offs (198,168 bytes) timed 1.5 % slower in an
// earlier form of this kernel (tools/kernel_probe.py flash-bwd-phases on
// an H100), and two of each do not fit.  The work tiles are taken key
// tile major within groups of KS_HEAD_GROUP = 8 (b, KV head) pairs: at
// 128 heads key tile major over all of them leaves each query tile's q,
// dO and 48 KB of float32 dq out of L2 between two visits (805 MB of dq
// accumulators at 2 x 4096 tokens), and one head at a time makes its key
// tiles wait on each other's admissions (on an H100, 31.3 and 27.8 ms a
// call against 16.9 in groups of 8).  The ordered sums and the argument
// above hold: within a (b, KV head) pair the key tiles are still taken in
// ascending order, and a block has at most one pending tile.
//
// float32 at every head dim: FMA on a 16 x 16 thread grid, three launches
// (delta pre-pass; one block per (b, KV head, 32 keys) streams query
// tiles, sums dk and dv; one block per (b, head, 32 queries) streams key
// tiles, sums dq; s and dp computed in both), no atomics, 32 resident and
// 32 streamed rows per tile, p and ds through shared memory, s over D and
// dp over Dv; for the tests' tight bar.
#include <cuda.h>   // CUtensorMap (types only: the encoder is fetched at run time)

#include "common.cuh"

namespace {

using namespace fate;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// pre-pass: delta = rowsum(dO * o)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
bwd_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                 float* __restrict__ delta, int Sq, int H, int Dv,
                 int64_t rows) {
  // row = (b * Sq + i) * H + h, the order of o's rows
  const int64_t row = (int64_t)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;       // the same for every lane of the warp
  const float* orow = o + row * Dv;
  const float* drow = dout + row * Dv;
  float acc = 0.f;
  for (int c = lane; c < Dv; c += 32) acc += orow[c] * drow[c];
  acc = warp_sum(acc);
  if (lane == 0) {
    const int h = (int)(row % H);
    const int64_t bi = row / H;
    const int i = (int)(bi % Sq);
    const int64_t b = bi / Sq;
    delta[(b * H + h) * Sq + i] = acc;
  }
}

// Where one block's resident and streamed rows live.  KV_SIDE: the
// resident rows are keys (A1 = k, A2 = v) and the streamed ones the
// queries of the G heads (B1 = q, B2 = dO); else the resident rows are
// queries (A1 = q, A2 = dO) and the streamed ones keys (B1 = k, B2 = v).
struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;             // scratch: see fate_flash_attention_bwd
  float* dq_accum;          // scratch of the wgmma kernel
  int* counters;            // scratch of the wgmma kernel
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Sk, H, KV, D, Dv, causal, window;   // q, k: D; v, o: Dv
  int dtype;                // 0 float32 (FMA), 1 bfloat16 (wgmma)
  cudaStream_t stream;
};

template <bool KV_SIDE>
struct Plan {
  int x0, nx;            // resident rows [x0, x0 + BX), nx = rows of x
  int ny;                // rows of y
  int y_begin, y_end;    // streamed range for each of the G heads
  int heads;             // streamed heads: G (KV side) or 1
  __device__ Plan(const BwdArgs& a, int x0_, int BX, int BY) {
    x0 = x0_;
    const int G = a.H / a.KV;
    if (KV_SIDE) {
      nx = a.Sk;
      ny = a.Sq;
      heads = G;
      // queries that can see a key of [x0, x0 + BX)
      y_begin = a.causal ? x0 / BY * BY : 0;
      y_end = a.Sq;
      if (a.window > 0) y_end = min(a.Sq, x0 + BX - 1 + a.window);
    } else {
      nx = a.Sq;
      ny = a.Sk;
      heads = 1;
      // keys that a query of [x0, x0 + BX) can see
      y_begin = a.window > 0 ? max(0, x0 - a.window + 1) / BY * BY : 0;
      y_end = a.causal ? min(a.Sk, x0 + BX) : a.Sk;
    }
  }
  __device__ int tiles_per_head(int BY) const {
    return y_end > y_begin ? (y_end - y_begin + BY - 1) / BY : 0;
  }
};

__device__ __forceinline__ bool attends(const BwdArgs& a, int qp, int kp) {
  return qp < a.Sq && kp < a.Sk && (!a.causal || qp >= kp) &&
         (a.window <= 0 || qp - kp < a.window);
}

// ---------------------------------------------------------------------------
// float32: FMA
// ---------------------------------------------------------------------------

constexpr int FMA_BX = 32;          // resident rows, 2 per thread row
constexpr int FMA_BY = 32;          // streamed rows, 2 per thread column
constexpr int FMA_THREADS = 256;    // 16 x 16

// A1 and B1 (q, k) are D wide, A2 and B2 (dO, v) DV wide, DV <= D
template <int D, int DV>
struct FmaBwdTile {
  static constexpr int RS = D + 4;          // row stride of A1, B1
  static constexpr int RSV = DV + 4;        // row stride of A2, B2
  static constexpr int PS = FMA_BY + 4;     // row stride of p and ds
  static constexpr int SMEM = ((FMA_BX + FMA_BY) * (RS + RSV) +
                               2 * FMA_BX * PS + 2 * FMA_BY) * 4;
  static_assert(DV <= D, "the value head dim is at most the query's");
};

template <int D, int DV, bool KV_SIDE>
__global__ void __launch_bounds__(FMA_THREADS)
flash_bwd_fma_kernel(BwdArgs a, float scale) {
  using Tile = FmaBwdTile<D, DV>;
  constexpr int RS = Tile::RS;
  constexpr int RSV = Tile::RSV;
  constexpr int PS = Tile::PS;
  constexpr int D4 = D / 4;
  constexpr int DV4 = DV / 4;
  constexpr int DN = D / 16;        // output columns per thread: dq, dk
  constexpr int DNV = DV / 16;      // and dv

  extern __shared__ __align__(16) float fsmem[];
  float* A1s = fsmem;                   // [BX][RS]
  float* A2s = A1s + FMA_BX * RS;       // [BX][RSV]
  float* B1s = A2s + FMA_BX * RSV;      // [BY][RS]
  float* B2s = B1s + FMA_BY * RS;       // [BY][RSV]
  float* Ps = B2s + FMA_BY * RSV;       // [BX][PS]
  float* DSs = Ps + FMA_BX * PS;        // [BX][PS]
  float* lse_s = DSs + FMA_BX * PS;     // [BY]
  float* delta_s = lse_s + FMA_BY;      // [BY]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int xt = KV_SIDE ? blockIdx.x : gridDim.x - 1 - blockIdx.x;
  const Plan<KV_SIDE> plan(a, xt * FMA_BX, FMA_BX, FMA_BY);
  const int x0 = plan.x0;
  const int hx = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.H / a.KV;
  const int64_t q_rs = (int64_t)a.H * D, k_rs = (int64_t)a.KV * D;
  const int64_t o_rs = (int64_t)a.H * DV, v_rs = (int64_t)a.KV * DV;
  const float* q = static_cast<const float*>(a.q) + (int64_t)b * a.Sq * q_rs;
  const float* dO =
      static_cast<const float*>(a.dout) + (int64_t)b * a.Sq * o_rs;
  const float* k = static_cast<const float*>(a.k) + (int64_t)b * a.Sk * k_rs;
  const float* v = static_cast<const float*>(a.v) + (int64_t)b * a.Sk * v_rs;
  const float* a1 = KV_SIDE ? k + hx * D : q + hx * D;
  const float* a2 = KV_SIDE ? v + hx * DV : dO + hx * DV;
  const int64_t x_rs = KV_SIDE ? k_rs : q_rs;    // rows of A1 (and B1's
  const int64_t y_rs = KV_SIDE ? q_rs : k_rs;    // below), then A2, B2
  const int64_t xv_rs = KV_SIDE ? v_rs : o_rs;
  const int64_t yv_rs = KV_SIDE ? o_rs : v_rs;

  for (int idx = tid; idx < FMA_BX * D4; idx += FMA_THREADS) {
    const int r = idx / D4;
    const int c = (idx % D4) * 4;
    float4 v1 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (x0 + r < plan.nx) v1 = load4<float>(a1 + (int64_t)(x0 + r) * x_rs + c);
    *reinterpret_cast<float4*>(&A1s[r * RS + c]) = v1;
  }
  for (int idx = tid; idx < FMA_BX * DV4; idx += FMA_THREADS) {
    const int r = idx / DV4;
    const int c = (idx % DV4) * 4;
    float4 v2 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (x0 + r < plan.nx)
      v2 = load4<float>(a2 + (int64_t)(x0 + r) * xv_rs + c);
    *reinterpret_cast<float4*>(&A2s[r * RSV + c]) = v2;
  }
  float x_lse[2] = {0.f, 0.f}, x_delta[2] = {0.f, 0.f};
  if (!KV_SIDE) {
    const int64_t base = ((int64_t)b * a.H + hx) * a.Sq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = x0 + 2 * ty + i;
      if (r < a.Sq) {
        x_lse[i] = a.lse[base + r];
        x_delta[i] = a.delta[base + r];
      }
    }
  }
  float acc1[2][DN], acc2[2][KV_SIDE ? DNV : 1];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      acc1[i][j] = 0.f;
      if constexpr (KV_SIDE) {
        if (j < DNV) acc2[i][j] = 0.f;
      }
    }

  const int per_head = plan.tiles_per_head(FMA_BY);
  const int n_it = per_head * plan.heads;
  for (int it = 0; it < n_it; ++it) {
    const int h = KV_SIDE ? hx * G + it / per_head : hx;
    const int y0 = plan.y_begin + (it % per_head) * FMA_BY;
    const float* b1 = KV_SIDE ? q + h * D : k + (hx / G) * D;
    const float* b2 = KV_SIDE ? dO + h * DV : v + (hx / G) * DV;
    __syncthreads();   // the previous tile's products have read B, P, dS
    for (int idx = tid; idx < FMA_BY * D4; idx += FMA_THREADS) {
      const int r = idx / D4;
      const int c = (idx % D4) * 4;
      float4 v1 = make_float4(0.f, 0.f, 0.f, 0.f);
      if (y0 + r < plan.ny)
        v1 = load4<float>(b1 + (int64_t)(y0 + r) * y_rs + c);
      *reinterpret_cast<float4*>(&B1s[r * RS + c]) = v1;
    }
    for (int idx = tid; idx < FMA_BY * DV4; idx += FMA_THREADS) {
      const int r = idx / DV4;
      const int c = (idx % DV4) * 4;
      float4 v2 = make_float4(0.f, 0.f, 0.f, 0.f);
      if (y0 + r < plan.ny)
        v2 = load4<float>(b2 + (int64_t)(y0 + r) * yv_rs + c);
      *reinterpret_cast<float4*>(&B2s[r * RSV + c]) = v2;
    }
    if (KV_SIDE) {
      const int64_t base = ((int64_t)b * a.H + h) * a.Sq;
      for (int r = tid; r < FMA_BY; r += FMA_THREADS) {
        const bool ok = y0 + r < a.Sq;
        lse_s[r] = ok ? a.lse[base + y0 + r] : 0.f;
        delta_s[r] = ok ? a.delta[base + y0 + r] : 0.f;
      }
    }
    __syncthreads();

    // s (over D) and dp (over DV) for resident rows 2 ty + i, streamed
    // columns tx + 16 c: both over the first DV columns, then s alone
    float s[2][2], dp[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        s[i][c] = 0.f;
        dp[i][c] = 0.f;
      }
#pragma unroll 4
    for (int d = 0; d < DV; d += 4) {
      float4 x1[2], x2[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        x1[i] = *reinterpret_cast<const float4*>(&A1s[(2 * ty + i) * RS + d]);
        x2[i] = *reinterpret_cast<const float4*>(&A2s[(2 * ty + i) * RSV + d]);
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float4 y1 =
            *reinterpret_cast<const float4*>(&B1s[(tx + 16 * c) * RS + d]);
        const float4 y2 =
            *reinterpret_cast<const float4*>(&B2s[(tx + 16 * c) * RSV + d]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          s[i][c] = fmaf(x1[i].x, y1.x, s[i][c]);
          s[i][c] = fmaf(x1[i].y, y1.y, s[i][c]);
          s[i][c] = fmaf(x1[i].z, y1.z, s[i][c]);
          s[i][c] = fmaf(x1[i].w, y1.w, s[i][c]);
          dp[i][c] = fmaf(x2[i].x, y2.x, dp[i][c]);
          dp[i][c] = fmaf(x2[i].y, y2.y, dp[i][c]);
          dp[i][c] = fmaf(x2[i].z, y2.z, dp[i][c]);
          dp[i][c] = fmaf(x2[i].w, y2.w, dp[i][c]);
        }
      }
    }
#pragma unroll 4
    for (int d = DV; d < D; d += 4) {
      float4 x1[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        x1[i] = *reinterpret_cast<const float4*>(&A1s[(2 * ty + i) * RS + d]);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float4 y1 =
            *reinterpret_cast<const float4*>(&B1s[(tx + 16 * c) * RS + d]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          s[i][c] = fmaf(x1[i].x, y1.x, s[i][c]);
          s[i][c] = fmaf(x1[i].y, y1.y, s[i][c]);
          s[i][c] = fmaf(x1[i].z, y1.z, s[i][c]);
          s[i][c] = fmaf(x1[i].w, y1.w, s[i][c]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int xp = x0 + 2 * ty + i;
        const int yc = tx + 16 * c;
        const int yp = y0 + yc;
        const bool ok = KV_SIDE ? attends(a, yp, xp) : attends(a, xp, yp);
        const float l = KV_SIDE ? lse_s[yc] : x_lse[i];
        const float dl = KV_SIDE ? delta_s[yc] : x_delta[i];
        const float p = ok ? expf(s[i][c] * scale - l) : 0.f;
        Ps[(2 * ty + i) * PS + yc] = p;
        DSs[(2 * ty + i) * PS + yc] = p * (dp[i][c] - dl);
      }
    __syncthreads();

    // acc1 += ds . B1, acc2 += p . B2 over the tile's streamed rows
#pragma unroll 4
    for (int n = 0; n < FMA_BY; ++n) {
      float ds[2], p[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ds[i] = DSs[(2 * ty + i) * PS + n];
        p[i] = Ps[(2 * ty + i) * PS + n];
      }
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        const float y1 = B1s[n * RS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 2; ++i) acc1[i][j] = fmaf(ds[i], y1, acc1[i][j]);
        if constexpr (KV_SIDE) {
          if (j < DNV) {
            const float y2 = B2s[n * RSV + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 2; ++i)
              acc2[i][j] = fmaf(p[i], y2, acc2[i][j]);
          }
        }
      }
    }
  }

  float* o1 = static_cast<float*>(KV_SIDE ? a.dk : a.dq) +
              (int64_t)b * plan.nx * x_rs + hx * D;
  float* o2 = KV_SIDE ? static_cast<float*>(a.dv) +
                            (int64_t)b * plan.nx * xv_rs + hx * DV
                      : nullptr;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = x0 + 2 * ty + i;
    if (r >= plan.nx) continue;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      o1[(int64_t)r * x_rs + tx + 16 * j] = acc1[i][j] * scale;
      if constexpr (KV_SIDE) {
        if (j < DNV) o2[(int64_t)r * xv_rs + tx + 16 * j] = acc2[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: one pass on wgmma
// ---------------------------------------------------------------------------

// d[64 x 32] (+)= A . B, both from shared memory (descriptors); TA / TB:
// A / B stored MN-major (the transpose bits); scale_d 0 ignores d's input.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss32(float (&d)[16], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d[64 x 64] (+)= A . B, both from shared memory (descriptors); TA / TB:
// A / B stored MN-major (the transpose bits); scale_d 0 ignores d's input.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d[64 x 64] += A . B, A from registers (four bf16 pairs a thread, the
// m16n8k16 A layout of each warp's 16 rows), B from shared memory; TB as above.
template <int TB>
__device__ __forceinline__ void wgmma_rs64(float (&d)[32],
                                          const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %37;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB),
        "r"(1));
}

// d[64 x 128] += A . B, A from registers (four bf16 pairs a thread, the
// m16n8k16 A layout of each warp's 16 rows), B from shared memory; TB as above.
template <int TB>
__device__ __forceinline__ void wgmma_rs128(float (&d)[64],
                                          const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %69;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB),
        "r"(1));
}

// the SS form at N = 32 or 64 columns, the RS form at 64 or 128
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 32) wgmma_ss32<TA, TB>(d, da, db, scale_d);
  else wgmma_ss64<TA, TB>(d, da, db, scale_d);
}
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs64<TB>(d, a, db);
  else wgmma_rs128<TB>(d, a, db);
}

constexpr int WG_BC = 128;       // keys of a work tile, 64 per warpgroup
constexpr int WG_BR = 64;        // queries of a streamed tile
constexpr int WG_STAGES = 2;     // ring of streamed tiles (q, dO, lse, delta)
constexpr int WG_NDQ = 2;        // dq hand-off buffers
constexpr int WG_THREADS = 256;  // two warpgroups: 8 warps keep 255 registers
constexpr int LINE = 128;        // bytes of a swizzled line: 64 bf16

// DP: the head dim rounded up to 64 (whole swizzle lines; TMA fills the
// columns past D with zeros, and only the first D are written back)
template <int DP>
struct WgTile {
  static constexpr int NB = DP / 64;              // 64-column blocks of a row
  static constexpr int KV_BLOCK = WG_BC * LINE;   // one block of K or V
  static constexpr int Q_BLOCK = WG_BR * LINE;    // one block of q or dO
  static constexpr int KV_BYTES = NB * KV_BLOCK;
  static constexpr int Q_BYTES = NB * Q_BLOCK;
  static constexpr int DS_BYTES = 64 * LINE;      // 64 keys x 64 queries
  static constexpr int DQ_FLOATS = WG_BR * DP;    // float32 dq of a tile
  // dq's product: at DP = 128 each warpgroup takes 64 of its columns over
  // all 128 keys (32 accumulators a thread); at DP = 64 each takes all 64
  // columns over its own 64 keys, and the two halves are summed in the
  // hand-off
  static constexpr bool COL_SPLIT = DP == 128;
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + KV_BYTES;
  static constexpr int Q_OFF = V_OFF + KV_BYTES;                // [STAGES]
  static constexpr int DO_OFF = Q_OFF + WG_STAGES * Q_BYTES;    // [STAGES]
  static constexpr int DS_OFF = DO_OFF + WG_STAGES * Q_BYTES;   // [2]
  static constexpr int DQ_OFF = DS_OFF + 2 * DS_BYTES;          // [NDQ]
  // [STAGES][lse * log2 e, delta][64]
  static constexpr int LD_OFF = DQ_OFF + WG_NDQ * DQ_FLOATS * 4;
  static constexpr int BAR_OFF = LD_OFF + WG_STAGES * 2 * WG_BR * 4;
  static constexpr int N_BAR = 1 + WG_STAGES;     // kv_full, q_full[STAGES]
  static constexpr int SCHED_OFF = BAR_OFF + 8 * N_BAR;          // int [2]
  static constexpr int SMEM = SCHED_OFF + 8 + 1024;   // + alignment slack
  static constexpr uint32_t Q_TX = 2 * Q_BYTES + 2 * WG_BR * 4;
  static_assert(DP % 64 == 0 && DP <= 128, "rows of whole swizzle lines");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

struct WgArgs {
  const float* lse2;    // [B, H, n_qt * 64]: lse * log2 e, +inf past Sq
  const float* delta;   // [B, H, n_qt * 64]
  float* dq_accum;      // [B, H, n_qt][64 * DP] float32, fragment order
  int* counters;        // [B, H, n_qt] dq admissions, then the work counter
  __nv_bfloat16* dk;    // [B, Sk, KV, D]
  __nv_bfloat16* dv;    // [B, Sk, KV, Dv]
  int B, Sq, Sk, H, KV, D, Dv, causal, window, n_qt, n_items;
  float scale, scale_log2;
};

// The query tiles [lo, hi) that key tile kt (of BC keys) visits: those
// holding a query that sees a key of the tile.  lo and hi never decrease
// as kt grows (tests/test_torch_kernels.py :: bwd_key_tile_queries is the
// same).
struct TileRange {
  int lo, hi;
};
template <int BC>
__device__ __forceinline__ TileRange key_tile_queries(const WgArgs& a,
                                                      int kt) {
  const int k0 = kt * BC;
  const int k_last = min(k0 + BC, a.Sk) - 1;
  const int q_begin = a.causal ? k0 : 0;   // the first query that sees k0
  const int q_end =                        // past the last that sees k_last
      a.window > 0 ? min(a.Sq, k_last + a.window) : a.Sq;
  TileRange r;
  r.lo = q_begin / WG_BR;
  r.hi = q_end > q_begin ? (q_end + WG_BR - 1) / WG_BR : r.lo;
  return r;
}
// The first key tile that visits query tile qt (which some key tile
// visits): without a window every key tile's range reaches the last query
// tile; with one, the first whose last key is within the window of the
// tile's first query (tests/test_torch_kernels.py :: bwd_first_key_tile).
template <int BC>
__device__ __forceinline__ int first_key_tile(const WgArgs& a, int qt) {
  if (a.window <= 0) return 0;
  return max(0, qt * WG_BR - a.window + 1) / BC;
}

// 2^x by the hardware's approximation (flushing denormal results to 0),
// without exp2f's range fix-up
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}
// Wait until *p == want.
__device__ __forceinline__ void wait_counter(const int* p, int want) {
  if (ld_acquire(p) == want) return;
  const long long t0 = clock64();
  while (ld_acquire(p) != want) {
    __nanosleep(32);
    if (clock64() - t0 > WAIT_LIMIT) __trap();
  }
}

// The leader's dq sums, run one tile behind the hand-offs.  A tile handed
// off in buffer b is PENDING until its counter admits it, ISSUED once its
// bulk reduce-add is on its way, and FREE again once the sum has landed and
// the counter is incremented.  Before tile t's hand-off reuses buffer
// t % 2, tile t - 2's sum must have landed.  land_all is kept out of line:
// so ptxas fits the DP = 128 kernel in 255 registers without a spill (4
// bytes of spill otherwise), for about 3 % of its time on an H100 (tools/
// kernel_probe.py flash-bwd against the inline build).  The others are
// forced inline: with issue out of line, ptxas 12.9 compiled its
// `cp.reduce.async.bulk ... .add.f32` in the DP = 64 kernel to a 64-bit
// integer add (UBLKRED.G.S.ADD.U64), and dq came out as garbage;
// chip_smoke.py's device phase fails on any bulk reduce that is not F32.
struct DqSums {
  enum { FREE = 0, PENDING = 1, ISSUED = 2 };
  int state[WG_NDQ];
  int want[WG_NDQ];       // the counter value that admits the tile
  int64_t tile[WG_NDQ];   // (b * H + h) * n_qt + qt

  __device__ __forceinline__ void issue(const WgArgs& a, int b, uint32_t buf,
                                        int bytes) {
    fence_proxy_async_global();
    bulk_reduce_add_f32(a.dq_accum + tile[b] * (bytes / 4), buf, bytes);
    state[b] = ISSUED;
  }
  __device__ __noinline__ void land_all(const WgArgs& a) {
    if (state[0] != ISSUED && state[1] != ISSUED) return;
    bulk_wait_all();
    fence_proxy_async_global();
    for (int b = 0; b < WG_NDQ; ++b)
      if (state[b] == ISSUED) {
        red_release_add(a.counters + tile[b], 1);
        state[b] = FREE;
      }
  }
  // Issue buffer b's sum if its counter admits it now.
  __device__ __forceinline__ void try_issue(const WgArgs& a, int b,
                                            uint32_t bufs, int bytes) {
    if (state[b] == PENDING && ld_acquire(a.counters + tile[b]) == want[b])
      issue(a, b, bufs + b * bytes, bytes);
  }
  // Free buffer `next` (its tile's sum lands, after waiting for its
  // admission if need be); issue the other buffer's sum if admitted now.
  // At the end of each tile.
  __device__ __forceinline__ void advance(const WgArgs& a, int next,
                                          uint32_t bufs, int bytes) {
    if (state[next] == PENDING) {
      wait_counter(a.counters + tile[next], want[next]);
      issue(a, next, bufs + next * bytes, bytes);
    }
    land_all(a);
    try_issue(a, next ^ 1, bufs, bytes);
  }
  // Mid-tile: land what was issued at the end of the last tile, so that
  // the next key tile of its query tile is admitted half a tile sooner,
  // and issue a pending sum that is admitted now.
  __device__ __forceinline__ void poll(const WgArgs& a, int pending,
                                       uint32_t bufs, int bytes) {
    land_all(a);
    try_issue(a, pending, bufs, bytes);
  }
};

template <int DP>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const WgArgs a) {
  using Tl = WgTile<DP>;
  constexpr int NB = Tl::NB;
  constexpr int DQ_BYTES = Tl::DQ_FLOATS * 4;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // the swizzle atom's size
  uint8_t* sm = smem_raw + (base - raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + Tl::BAR_OFF);
  uint64_t* q_full = kv_full + 1;               // [STAGES]
  volatile int* sched = reinterpret_cast<volatile int*>(sm + Tl::SCHED_OFF);

  const int tid = threadIdx.x;
  const bool leader = tid == 0;
  // warp-uniform values through a shuffle, so that the compiler keeps what
  // derives from them (the wgmma descriptors) in uniform registers
  const int cw = __shfl_sync(0xffffffffu, tid >> 7, 0);   // warpgroup
  const int ct = tid & 127;                               // its thread
  const int warp = __shfl_sync(0xffffffffu, ct >> 5, 0);
  const int lane = tid & 31;
  // Every `if (leader)` block before a barrier or a wgmma ends in
  // __syncwarp(): the leader may wait in it (for a counter, a bulk copy),
  // and those are .aligned instructions, which warp 0 must reach converged.
  if (leader) {
    mbar_init(kv_full, 1);
    for (int i = 0; i < WG_STAGES; ++i) mbar_init(&q_full[i], 1);
    mbar_init_fence();
  }
  __syncwarp();
  __syncthreads();
  const int G = a.H / a.KV;
  const int BKV = a.B * a.KV;
  const int sq_pad = a.n_qt * WG_BR;
  const uint32_t sK = base + Tl::K_OFF, sV = base + Tl::V_OFF;
  const uint32_t sDS = base + Tl::DS_OFF + cw * Tl::DS_BYTES;
  const uint32_t sDQ = base + Tl::DQ_OFF;
  uint8_t* ds_s = sm + Tl::DS_OFF + cw * Tl::DS_BYTES;
  const float* ld_s = reinterpret_cast<const float*>(sm + Tl::LD_OFF);
  float* dq_s = reinterpret_cast<float*>(sm + Tl::DQ_OFF);
  const int64_t k_rs = (int64_t)a.KV * a.D;

  // the leader's copies of streamed tile i of a work tile: head g = i / n,
  // query tile hi - 1 - i % n (highest first), into stage `st`
  auto load_tile = [&](int st, int i, int n, const TileRange& qr, int b,
                       int hk) {
    const int h = hk * G + i / n;
    const int qt = qr.hi - 1 - i % n;
    mbar_expect_tx(&q_full[st], Tl::Q_TX);
    for (int c = 0; c < NB; ++c) {
      tma_load_4d(base + Tl::Q_OFF + st * Tl::Q_BYTES + c * Tl::Q_BLOCK, &tq,
                  &q_full[st], 64 * c, h, qt * WG_BR, b);
      tma_load_4d(base + Tl::DO_OFF + st * Tl::Q_BYTES + c * Tl::Q_BLOCK,
                  &tdo, &q_full[st], 64 * c, h, qt * WG_BR, b);
    }
    const int64_t row = ((int64_t)b * a.H + h) * sq_pad + qt * WG_BR;
    const uint32_t ld = base + Tl::LD_OFF + st * 2 * WG_BR * 4;
    bulk_load(ld, a.lse2 + row, WG_BR * 4, &q_full[st]);
    bulk_load(ld + WG_BR * 4, a.delta + row, WG_BR * 4, &q_full[st]);
  };

  DqSums sums;
  sums.state[0] = sums.state[1] = DqSums::FREE;
  int tc = 0;                      // streamed tiles so far: stage, phase
  for (int n = 0;; ++n) {
    if (leader) {
      const int item = atomicAdd(a.counters + (int64_t)a.B * a.H * a.n_qt, 1);
      sched[n & 1] = item < a.n_items ? item : -1;
    }
    __syncwarp();
    bar_sync(1, WG_THREADS);
    const int item = __shfl_sync(0xffffffffu, sched[n & 1], 0);
    if (item < 0) break;
    const int kt = item / BKV;
    const int b = (item % BKV) / a.KV;
    const int hk = item % a.KV;
    const TileRange qr = key_tile_queries<WG_BC>(a, kt);
    const int per_head = qr.hi - qr.lo;
    const int n_tiles = per_head * G;
    if (leader) {
      mbar_expect_tx(kv_full, 2 * Tl::KV_BYTES);
      for (int c = 0; c < NB; ++c) {
        tma_load_4d(sK + c * Tl::KV_BLOCK, &tk, kv_full, 64 * c, hk,
                    kt * WG_BC, b);
        tma_load_4d(sV + c * Tl::KV_BLOCK, &tv, kv_full, 64 * c, hk,
                    kt * WG_BC, b);
      }
      for (int i = 0; i < WG_STAGES && i < n_tiles; ++i)
        load_tile((tc + i) % WG_STAGES, i, per_head, qr, b, hk);
    }
    __syncwarp();
    // accumulator layout of m64nNk16: thread (warp w, lane l) holds rows
    // 16 w + l / 4 (+ 8) and columns 8 j + 2 (l % 4) (+ 1) of every
    // 8-column group j, as d[4 j + 2 half + e]
    const int kw0 = kt * WG_BC + 64 * cw;        // this warpgroup's keys
    const int key0 = kw0 + 16 * warp + (lane >> 2);
    const int col0 = 2 * (lane & 3);
    float dk[DP / 2], dv[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) {
      dk[i] = 0.f;
      dv[i] = 0.f;
    }
    mbar_wait(kv_full, n & 1);
    for (int it = 0; it < n_tiles; ++it, ++tc) {
      const int h = hk * G + it / per_head;
      const int qt = qr.hi - 1 - it % per_head;
      const int q0 = qt * WG_BR;
      const int stage = tc % WG_STAGES;
      mbar_wait(&q_full[stage], (tc / WG_STAGES) & 1);
      const uint32_t sQ = base + Tl::Q_OFF + stage * Tl::Q_BYTES;
      const uint32_t sDO = base + Tl::DO_OFF + stage * Tl::Q_BYTES;
      const float* lse_s = ld_s + stage * 2 * WG_BR;
      const float* del_s = lse_s + WG_BR;
      const bool edge =
          q0 + WG_BR > a.Sq || kw0 + 64 > a.Sk ||
          (a.causal && q0 < kw0 + 63) ||
          (a.window > 0 && q0 + WG_BR - 1 - kw0 >= a.window);

      // The tile in two halves of 32 queries, so that only 32 score
      // registers live beside dk and dv.  Per half: s^T = K_w q^T and
      // dp^T = V_w dO^T ([64 keys x 32 queries], both operands K-major, a
      // k16 step 32 bytes along a line); p^T and ds^T; dV += p^T dO and
      // dK += ds^T q (A from registers), with the second half's s^T and
      // dp^T issued behind them into the same registers; ds^T to shared
      // memory while they run.
      float s[16], dp[16];
      auto scores = [&](int hq) {
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t ko = (kk >> 2) * Tl::KV_BLOCK + cw * 64 * LINE +
                              (kk & 3) * 32;
          const uint32_t qo = (kk >> 2) * Tl::Q_BLOCK + hq * 32 * LINE +
                              (kk & 3) * 32;
          wgmma_ss<32, 0, 0>(s, sw128_desc(sK + ko, 16, 1024),
                             sw128_desc(sQ + qo, 16, 1024), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t ko = (kk >> 2) * Tl::KV_BLOCK + cw * 64 * LINE +
                              (kk & 3) * 32;
          const uint32_t qo = (kk >> 2) * Tl::Q_BLOCK + hq * 32 * LINE +
                              (kk & 3) * 32;
          wgmma_ss<32, 0, 0>(dp, sw128_desc(sV + ko, 16, 1024),
                             sw128_desc(sDO + qo, 16, 1024), kk > 0);
        }
        wgmma_commit();
      };
      wgmma_fence();
      scores(0);
#pragma unroll
      for (int hq = 0; hq < 2; ++hq) {
        wgmma_wait<0>();
        fence_acc(s);
        fence_acc(dp);

        // p^T = 2^(s^T scale log2 e - lse log2 e), ds^T = p^T (dp^T -
        // delta); the mask test only where the tile crosses it or a tail
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 32 * hq + 8 * j + col0;   // query column
          const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
          const float2 dl = *reinterpret_cast<const float2*>(del_s + c);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = 4 * j + r;
            const int qp = q0 + c + (r & 1);
            const int kp = key0 + 8 * (r >> 1);
            const bool ok =
                !edge ||
                (qp < a.Sq && kp < a.Sk && (!a.causal || qp >= kp) &&
                 (a.window <= 0 || qp - kp < a.window));
            const float p =
                ok ? fast_exp2(s[i] * a.scale_log2 - ((r & 1) ? l2.y : l2.x))
                   : 0.f;
            s[i] = p;
            dp[i] = p * (dp[i] - ((r & 1) ? dl.y : dl.x));
          }
        }
        // as A operands: k16 step t of the half is 8-column groups 2 t and
        // 2 t + 1 of its accumulator
        uint32_t pa[2][4], da[2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pa[t][r] = pack_bf16(s[8 * t + 2 * r], s[8 * t + 2 * r + 1]);
            da[t][r] = pack_bf16(dp[8 * t + 2 * r], dp[8 * t + 2 * r + 1]);
          }
        // dV += p^T dO and dK += ds^T q: B MN-major, 16 query lines a
        // step, 64-column blocks Q_BLOCK apart
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < 2; ++t)
          wgmma_rs<DP, 1>(dv, pa[t],
                         sw128_desc(sDO + (2 * hq + t) * 16 * LINE,
                                    Tl::Q_BLOCK, 1024));
#pragma unroll
        for (int t = 0; t < 2; ++t)
          wgmma_rs<DP, 1>(dk, da[t],
                         sw128_desc(sQ + (2 * hq + t) * 16 * LINE,
                                    Tl::Q_BLOCK, 1024));
        wgmma_commit();
        if (hq == 0) scores(1);

        // ds^T to shared memory as the MN-major A of dq: line = key, 64
        // queries along it, 16-byte chunks XORed with the line mod 8; the
        // two warpgroups' lines together are the 128 keys (the last
        // tile's dq products read it before the barrier that ended it)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int j = 4 * hq + 2 * t + (r >> 1);
            const int kl = 16 * warp + (lane >> 2) + 8 * (r & 1);
            *reinterpret_cast<uint32_t*>(
                ds_s + kl * LINE + (((j ^ kl) & 7) << 4) + col0 * 2) =
                da[t][r];
          }
      }
      wgmma_wait<0>();
      fence_acc(dv);
      fence_acc(dk);
      // ds written; q, dO, lse and delta of this stage read by both
      // warpgroups: the leader refills the stage
      fence_proxy_async();
      bar_sync(1, WG_THREADS);
      if (leader) {
        if (it + WG_STAGES < n_tiles)
          load_tile(stage, it + WG_STAGES, per_head, qr, b, hk);
        sums.poll(a, (tc + 1) % WG_NDQ, sDQ, DQ_BYTES);   // the last tile's
      }
      __syncwarp();

      // dq products: A = ds (MN-major), B = K (MN-major), 16 key lines a
      // step.  Split columns: dQ[:, 64 cw ..] = ds K[:, 64 cw ..] over the
      // 128 keys; else dQ_w = ds_w K_w over this warpgroup's 64 keys
      float dq[Tl::COL_SPLIT ? 32 : DP / 2];
      wgmma_fence();
      if constexpr (Tl::COL_SPLIT) {
#pragma unroll
        for (int t = 0; t < 8; ++t)
          wgmma_ss<64, 1, 1>(
              dq, sw128_desc(base + Tl::DS_OFF + t * 16 * LINE,
                             2 * Tl::DS_BYTES, 1024),
              sw128_desc(sK + cw * Tl::KV_BLOCK + t * 16 * LINE,
                         Tl::KV_BLOCK, 1024),
              t > 0);
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          wgmma_ss<DP, 1, 1>(
              dq, sw128_desc(sDS + t * 16 * LINE, Tl::DS_BYTES, 1024),
              sw128_desc(sK + cw * 64 * LINE + t * 16 * LINE, Tl::KV_BLOCK,
                         1024),
              t > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dq);

      // hand-off into buffer tc % 2 (freed by the leader after the last
      // tile): per 64-column block, the fragment order of a 64 x 64
      // accumulator (float2 i / 2 of thread ct at (i / 2 * 128 + ct) * 2).
      // Split columns: each warpgroup writes its block.  Else warpgroup 0
      // writes dQ_0 and warpgroup 1 adds its dQ_1.
      const int hb = tc % WG_NDQ;
      float2* buf = reinterpret_cast<float2*>(dq_s + hb * Tl::DQ_FLOATS);
      if constexpr (Tl::COL_SPLIT) {
        float2* mine = buf + cw * (WG_BR * 64 / 2);
#pragma unroll
        for (int i = 0; i < 32; i += 2)
          mine[(i >> 1) * 128 + ct] = make_float2(dq[i], dq[i + 1]);
      } else {
        if (cw == 0) {
#pragma unroll
          for (int i = 0; i < DP / 2; i += 2)
            buf[(i >> 1) * 128 + ct] = make_float2(dq[i], dq[i + 1]);
        }
        bar_sync(1, WG_THREADS);
        if (cw == 1) {
#pragma unroll
          for (int i = 0; i < DP / 2; i += 2) {
            float2 v = buf[(i >> 1) * 128 + ct];
            v.x += dq[i];
            v.y += dq[i + 1];
            buf[(i >> 1) * 128 + ct] = v;
          }
        }
      }
      fence_proxy_async();
      bar_sync(1, WG_THREADS);
      if (leader) {
        sums.state[hb] = DqSums::PENDING;
        sums.want[hb] = kt - first_key_tile<WG_BC>(a, qt);
        sums.tile[hb] = ((int64_t)b * a.H + h) * a.n_qt + qt;
        sums.advance(a, hb ^ 1, sDQ, DQ_BYTES);
      }
      __syncwarp();
    }

    // dk, dv of this warpgroup's keys, every row below Sk, the first D
    // columns
    __nv_bfloat16* dkp = a.dk + (int64_t)b * a.Sk * k_rs + hk * a.D;
    __nv_bfloat16* dvp = a.dv + (int64_t)b * a.Sk * k_rs + hk * a.D;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kp = key0 + 8 * half;
      if (kp >= a.Sk) continue;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        if (8 * j >= a.D) break;
        const int64_t off = (int64_t)kp * k_rs + 8 * j + col0;
        store2(dkp + off, dk[4 * j + 2 * half] * a.scale,
               dk[4 * j + 2 * half + 1] * a.scale);
        store2(dvp + off, dv[4 * j + 2 * half], dv[4 * j + 2 * half + 1]);
      }
    }
  }
  if (leader) {   // the last sums, the older buffer first
    sums.advance(a, tc % WG_NDQ, sDQ, DQ_BYTES);
    sums.advance(a, (tc + 1) % WG_NDQ, sDQ, DQ_BYTES);
  }
}

// ---------------------------------------------------------------------------
// bf16 at D = 256: the column-split wgmma kernel
// ---------------------------------------------------------------------------

constexpr int CS_BC = 64;   // keys of a work tile, shared by both warpgroups

// Descriptor `desc` advanced by `bytes` (its address field holds the
// shared address >> 4 in 14 bits, which addresses below 256 KB never
// overflow), and `x` made opaque to the compiler where it is formed.  The
// descriptors of a tile's products do not change from tile to tile; formed
// from such bases, each is added next to its product instead of all being
// kept across the loop in registers, which made ptxas spill at 255.
__device__ __forceinline__ uint64_t desc_plus(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}
__device__ __forceinline__ uint64_t per_tile(uint64_t x) {
  asm volatile("mov.b64 %0, %0;\n" : "+l"(x));
  return x;
}

// Shared memory of the column-split kernel at D = 256 (four 64-column
// blocks a row): K and V of the tile's 64 keys, 32 KB each; ONE stage of q
// and dO for a 64-row query tile, 32 KB each; p^T and ds^T in bf16, 8 KB
// each; ONE float32 dq hand-off of the query tile, 64 KB; lse and delta,
// 512 bytes: 213,504 bytes beside the barriers, of the 232,448 a block may
// hold (a second stage or a second hand-off would need 64 KB more).
template <int DP>
struct ColTile {
  static constexpr int NB = DP / 64;
  static constexpr int KV_BLOCK = CS_BC * LINE;
  static constexpr int Q_BLOCK = WG_BR * LINE;
  static constexpr int KV_BYTES = NB * KV_BLOCK;
  static constexpr int Q_BYTES = NB * Q_BLOCK;
  static constexpr int PD_BYTES = CS_BC * LINE;   // 64 keys x 64 queries
  static constexpr int DQ_FLOATS = WG_BR * DP;
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + KV_BYTES;
  static constexpr int Q_OFF = V_OFF + KV_BYTES;
  static constexpr int DO_OFF = Q_OFF + Q_BYTES;
  static constexpr int P_OFF = DO_OFF + Q_BYTES;
  static constexpr int DS_OFF = P_OFF + PD_BYTES;
  static constexpr int DQ_OFF = DS_OFF + PD_BYTES;
  static constexpr int LD_OFF = DQ_OFF + DQ_FLOATS * 4;   // lse log2 e, delta
  static constexpr int BAR_OFF = LD_OFF + 2 * WG_BR * 4;  // kv_full, q_full
  static constexpr int SCHED_OFF = BAR_OFF + 16;          // int [2]
  static constexpr int SMEM = SCHED_OFF + 8 + 1024;   // + alignment slack
  static constexpr uint32_t Q_TX = 2 * Q_BYTES + 2 * WG_BR * 4;
  static_assert(DP == 256, "the column split is the design of D = 256");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

template <int DP>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_colsplit_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const WgArgs a) {
  using Tl = ColTile<DP>;
  constexpr int NB = Tl::NB;
  constexpr int DQ_BYTES = Tl::DQ_FLOATS * 4;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // the swizzle atom's size
  uint8_t* sm = smem_raw + (base - raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + Tl::BAR_OFF);
  uint64_t* q_full = kv_full + 1;
  volatile int* sched = reinterpret_cast<volatile int*>(sm + Tl::SCHED_OFF);

  const int tid = threadIdx.x;
  const bool leader = tid == 0;
  const int cw = __shfl_sync(0xffffffffu, tid >> 7, 0);   // warpgroup
  const int ct = tid & 127;                               // its thread
  const int warp = __shfl_sync(0xffffffffu, ct >> 5, 0);
  const int lane = tid & 31;
  // as in flash_bwd_wgmma_kernel, every `if (leader)` block before a
  // barrier or a wgmma ends in __syncwarp()
  if (leader) {
    mbar_init(kv_full, 1);
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncwarp();
  __syncthreads();
  const int G = a.H / a.KV;
  const int BKV = a.B * a.KV;
  const int sq_pad = a.n_qt * WG_BR;
  const uint32_t sK = base + Tl::K_OFF, sV = base + Tl::V_OFF;
  const uint32_t sQ = base + Tl::Q_OFF, sDO = base + Tl::DO_OFF;
  const uint32_t sP = base + Tl::P_OFF, sDS = base + Tl::DS_OFF;
  const uint32_t sDQ = base + Tl::DQ_OFF;
  uint8_t* p_s = sm + Tl::P_OFF;
  uint8_t* ds_s = sm + Tl::DS_OFF;
  const float* lse_s = reinterpret_cast<const float*>(sm + Tl::LD_OFF);
  const float* del_s = lse_s + WG_BR;
  float2* dq_s = reinterpret_cast<float2*>(sm + Tl::DQ_OFF);
  const int64_t k_rs = (int64_t)a.KV * a.D;

  // the leader's copies of streamed tile i of a work tile: head g = i / n,
  // query tile hi - 1 - i % n (highest first)
  auto load_tile = [&](int i, int n, const TileRange& qr, int b, int hk) {
    const int h = hk * G + i / n;
    const int qt = qr.hi - 1 - i % n;
    mbar_expect_tx(q_full, Tl::Q_TX);
    for (int c = 0; c < NB; ++c) {
      tma_load_4d(sQ + c * Tl::Q_BLOCK, &tq, q_full, 64 * c, h, qt * WG_BR,
                  b);
      tma_load_4d(sDO + c * Tl::Q_BLOCK, &tdo, q_full, 64 * c, h,
                  qt * WG_BR, b);
    }
    const int64_t row = ((int64_t)b * a.H + h) * sq_pad + qt * WG_BR;
    bulk_load(base + Tl::LD_OFF, a.lse2 + row, WG_BR * 4, q_full);
    bulk_load(base + Tl::LD_OFF + WG_BR * 4, a.delta + row, WG_BR * 4,
              q_full);
  };

  // one hand-off buffer: the other kernel's DqSums on buffer 0 alone
  DqSums sums;
  sums.state[0] = sums.state[1] = DqSums::FREE;
  int tc = 0;                      // streamed tiles so far: the phase
  for (int n = 0;; ++n) {
    if (leader) {
      const int item = atomicAdd(a.counters + (int64_t)a.B * a.H * a.n_qt, 1);
      sched[n & 1] = item < a.n_items ? item : -1;
    }
    __syncwarp();
    bar_sync(1, WG_THREADS);
    const int item = __shfl_sync(0xffffffffu, sched[n & 1], 0);
    if (item < 0) break;
    const int kt = item / BKV;
    const int b = (item % BKV) / a.KV;
    const int hk = item % a.KV;
    const TileRange qr = key_tile_queries<CS_BC>(a, kt);
    const int per_head = qr.hi - qr.lo;
    const int n_tiles = per_head * G;
    if (leader) {
      mbar_expect_tx(kv_full, 2 * Tl::KV_BYTES);
      for (int c = 0; c < NB; ++c) {
        tma_load_4d(sK + c * Tl::KV_BLOCK, &tk, kv_full, 64 * c, hk,
                    kt * CS_BC, b);
        tma_load_4d(sV + c * Tl::KV_BLOCK, &tv, kv_full, 64 * c, hk,
                    kt * CS_BC, b);
      }
      if (n_tiles > 0) load_tile(0, per_head, qr, b, hk);
    }
    __syncwarp();
    // accumulator layout of m64nNk16: thread (warp w, lane l) holds rows
    // 16 w + l / 4 (+ 8) and columns 8 j + 2 (l % 4) (+ 1) of every
    // 8-column group j, as d[4 j + 2 half + e].  Both warpgroups hold the
    // tile's 64 keys; warpgroup w their dk and dv columns 128 w .. + 127.
    const int k0 = kt * CS_BC;
    const int key0 = k0 + 16 * warp + (lane >> 2);
    const int col0 = 2 * (lane & 3);
    float dk[64], dv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      dk[i] = 0.f;
      dv[i] = 0.f;
    }
    mbar_wait(kv_full, n & 1);
    for (int it = 0; it < n_tiles; ++it, ++tc) {
      const int h = hk * G + it / per_head;
      const int qt = qr.hi - 1 - it % per_head;
      const int q0 = qt * WG_BR;
      mbar_wait(q_full, tc & 1);
      const bool masked =
          q0 + WG_BR > a.Sq || k0 + CS_BC > a.Sk ||
          (a.causal && q0 < k0 + CS_BC - 1) ||
          (a.window > 0 && q0 + WG_BR - 1 - k0 >= a.window);

      // s^T = K q^T and dp^T = V dO^T for this warpgroup's 32 queries
      // (queries 32 w .. + 31 of the tile) over all 256 columns: [64 keys
      // x 32 queries], both operands K-major, a k16 step 32 bytes along a
      // line, the 64-column blocks apart
      float s[16], dp[16];
      const uint64_t kd = per_tile(sw128_desc(sK, 16, 1024));
      const uint64_t vd = per_tile(sw128_desc(sV, 16, 1024));
      const uint64_t qd = per_tile(sw128_desc(sQ + cw * 32 * LINE, 16, 1024));
      const uint64_t od =
          per_tile(sw128_desc(sDO + cw * 32 * LINE, 16, 1024));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t ko = (kk >> 2) * Tl::KV_BLOCK + (kk & 3) * 32;
        const uint32_t qo = (kk >> 2) * Tl::Q_BLOCK + (kk & 3) * 32;
        wgmma_ss<32, 0, 0>(s, desc_plus(kd, ko), desc_plus(qd, qo), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t ko = (kk >> 2) * Tl::KV_BLOCK + (kk & 3) * 32;
        const uint32_t qo = (kk >> 2) * Tl::Q_BLOCK + (kk & 3) * 32;
        wgmma_ss<32, 0, 0>(dp, desc_plus(vd, ko), desc_plus(od, qo), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(s);
      fence_acc(dp);

      // p^T = 2^(s^T scale log2 e - lse log2 e), ds^T = p^T (dp^T - delta)
      // (the mask test only where the tile crosses it or a tail), rounded
      // to bf16 into the shared p^T and ds^T: line = key, the tile's 64
      // queries along it, 16-byte chunks XORed with the line mod 8 (the
      // last tile's dq products read ds^T before the barrier that ended it)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 32 * cw + 8 * j + col0;    // query column
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
        const float2 dl = *reinterpret_cast<const float2*>(del_s + c);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 4 * j + r;
          const int qp = q0 + c + (r & 1);
          const int kp = key0 + 8 * (r >> 1);
          const float row_lse = (r & 1) ? l2.y : l2.x;
          const float row_delta = (r & 1) ? dl.y : dl.x;
          const bool keep =
              !masked ||
              (qp < a.Sq && kp < a.Sk && (!a.causal || qp >= kp) &&
               (a.window <= 0 || qp - kp < a.window));
          const float p =
              keep ? fast_exp2(s[i] * a.scale_log2 - row_lse) : 0.f;
          s[i] = p;
          dp[i] = p * (dp[i] - row_delta);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int kl = 16 * warp + (lane >> 2) + 8 * half;
          const int at = kl * LINE + ((((4 * cw + j) ^ kl) & 7) << 4) +
                         col0 * 2;
          *reinterpret_cast<uint32_t*>(p_s + at) =
              pack_bf16(s[4 * j + 2 * half], s[4 * j + 2 * half + 1]);
          *reinterpret_cast<uint32_t*>(ds_s + at) =
              pack_bf16(dp[4 * j + 2 * half], dp[4 * j + 2 * half + 1]);
        }
      }
      fence_proxy_async();
      bar_sync(1, WG_THREADS);

      // dV[:, 128 w ..] += p^T dO[:, 128 w ..] and dK[:, 128 w ..] +=
      // ds^T q[:, 128 w ..] over the tile's 64 queries: A K-major from the
      // shared p^T / ds^T, B MN-major, 16 query lines a step, its two
      // 64-column blocks Q_BLOCK apart
      const uint64_t pd = per_tile(sw128_desc(sP, 16, 1024));
      const uint64_t sd = per_tile(sw128_desc(sDS, 16, 1024));
      const uint64_t om = per_tile(
          sw128_desc(sDO + 2 * cw * Tl::Q_BLOCK, Tl::Q_BLOCK, 1024));
      const uint64_t qm = per_tile(
          sw128_desc(sQ + 2 * cw * Tl::Q_BLOCK, Tl::Q_BLOCK, 1024));
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 4; ++t)
        wgmma_m64n128k16<0, 1>(dv, desc_plus(pd, t * 32),
                               desc_plus(om, t * 16 * LINE));
#pragma unroll
      for (int t = 0; t < 4; ++t)
        wgmma_m64n128k16<0, 1>(dk, desc_plus(sd, t * 32),
                               desc_plus(qm, t * 16 * LINE));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dv);
      fence_acc(dk);
      // q, dO, lse and delta read by both warpgroups: the leader refills
      // the stage, then frees the hand-off buffer (the last tile's sum is
      // issued once its counter admits it, and lands)
      bar_sync(1, WG_THREADS);
      if (leader) {
        if (it + 1 < n_tiles) load_tile(it + 1, per_head, qr, b, hk);
        sums.advance(a, 0, sDQ, DQ_BYTES);
      }
      __syncwarp();

      // dq[:, 64 c ..] = ds K[:, 64 c ..] for this warpgroup's blocks
      // c = 2 w, 2 w + 1 over the 64 keys: A = ds (MN-major), B = K
      // (MN-major), 16 key lines a step; each block into the hand-off in
      // the fragment order of a 64 x 64 accumulator (float2 i / 2 of
      // thread ct at (i / 2 * 128 + ct) * 2), blocks 64 x 64 floats apart
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = 2 * cw + j;
        float dq[32];
        const uint64_t am = per_tile(sw128_desc(sDS, Tl::PD_BYTES, 1024));
        const uint64_t km = per_tile(
            sw128_desc(sK + c * Tl::KV_BLOCK, Tl::KV_BLOCK, 1024));
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < 4; ++t)
          wgmma_ss<64, 1, 1>(dq, desc_plus(am, t * 16 * LINE),
                             desc_plus(km, t * 16 * LINE), t > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(dq);
        if (j == 0) bar_sync(1, WG_THREADS);     // the buffer is free
        float2* blk = dq_s + c * (WG_BR * 64 / 2);
#pragma unroll
        for (int i = 0; i < 32; i += 2)
          blk[(i >> 1) * 128 + ct] = make_float2(dq[i], dq[i + 1]);
      }
      fence_proxy_async();
      bar_sync(1, WG_THREADS);
      if (leader) {
        sums.state[0] = DqSums::PENDING;
        sums.want[0] = kt - first_key_tile<CS_BC>(a, qt);
        sums.tile[0] = ((int64_t)b * a.H + h) * a.n_qt + qt;
        sums.try_issue(a, 0, sDQ, DQ_BYTES);
      }
      __syncwarp();
    }

    // dk, dv of the tile's keys below Sk, this warpgroup's columns
    __nv_bfloat16* dkp = a.dk + (int64_t)b * a.Sk * k_rs + hk * a.D;
    __nv_bfloat16* dvp = a.dv + (int64_t)b * a.Sk * k_rs + hk * a.D;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kp = key0 + 8 * half;
      if (kp >= a.Sk) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int64_t off = (int64_t)kp * k_rs + 128 * cw + 8 * j + col0;
        store2(dkp + off, dk[4 * j + 2 * half] * a.scale,
               dk[4 * j + 2 * half + 1] * a.scale);
        store2(dvp + off, dv[4 * j + 2 * half], dv[4 * j + 2 * half + 1]);
      }
    }
  }
  if (leader) sums.advance(a, 0, sDQ, DQ_BYTES);   // the last sum lands
}

// ---------------------------------------------------------------------------
// bf16 at (D, Dv) = (192, 128): the kv-split wgmma kernel
// ---------------------------------------------------------------------------

// Stages of the kv-split kernel's q / dO ring (KvTile)
constexpr int KS_STAGES = 2;
// (b, KV head) pairs whose work tiles the kv-split kernel takes together,
// key tile major among them (see flash_bwd_kvsplit_kernel)
constexpr int KS_HEAD_GROUP = 8;

// Shared memory of the kv-split kernel at (D, DV) (D / 64 and DV / 64
// blocks of 64 columns a row): K and V of the tile's 64 keys (24 + 16 KB
// at (192, 128)); KS_STAGES stages of q and dO for a 64-row query tile
// (24 + 16 KB each); p^T and ds^T in bf16 (8 KB each); ONE float32 dq
// hand-off of the query tile (48 KB); lse and delta per stage: 190,496
// bytes (two hand-offs and one stage would take 198,168; two of each do
// not fit).
template <int D, int DV>
struct KvTile {
  static constexpr int NBK = D / 64, NBV = DV / 64;
  static constexpr int KV_BLOCK = CS_BC * LINE;
  static constexpr int Q_BLOCK = WG_BR * LINE;
  static constexpr int K_BYTES = NBK * KV_BLOCK;
  static constexpr int V_BYTES = NBV * KV_BLOCK;
  static constexpr int Q_BYTES = NBK * Q_BLOCK;
  static constexpr int DO_BYTES = NBV * Q_BLOCK;
  static constexpr int PD_BYTES = CS_BC * LINE;   // 64 keys x 64 queries
  static constexpr int DQ_FLOATS = WG_BR * D;
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + K_BYTES;
  static constexpr int Q_OFF = V_OFF + V_BYTES;                  // [STAGES]
  static constexpr int DO_OFF = Q_OFF + KS_STAGES * Q_BYTES;     // [STAGES]
  static constexpr int P_OFF = DO_OFF + KS_STAGES * DO_BYTES;
  static constexpr int DS_OFF = P_OFF + PD_BYTES;
  static constexpr int DQ_OFF = DS_OFF + PD_BYTES;
  // [STAGES][lse * log2 e, delta][64]
  static constexpr int LD_OFF = DQ_OFF + DQ_FLOATS * 4;
  static constexpr int BAR_OFF = LD_OFF + KS_STAGES * 2 * WG_BR * 4;
  static constexpr int N_BAR = 1 + KS_STAGES;   // kv_full, q_full[STAGES]
  static constexpr int SCHED_OFF = BAR_OFF + 8 * N_BAR;          // int [2]
  static constexpr int SMEM = SCHED_OFF + 8 + 1024;   // + alignment slack
  static constexpr uint32_t Q_TX = Q_BYTES + DO_BYTES + 2 * WG_BR * 4;
  // warpgroup 0 keeps dk (D columns: 128 + 64), warpgroup 1 dv (DV: 128)
  static_assert(D == 192 && DV == 128, "the kv split is the design of "
                                       "(192, 128)");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

template <int D, int DV>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_kvsplit_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const WgArgs a) {
  using Tl = KvTile<D, DV>;
  constexpr int DQ_BYTES = Tl::DQ_FLOATS * 4;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // the swizzle atom's size
  uint8_t* sm = smem_raw + (base - raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + Tl::BAR_OFF);
  uint64_t* q_full = kv_full + 1;               // [STAGES]
  volatile int* sched = reinterpret_cast<volatile int*>(sm + Tl::SCHED_OFF);

  const int tid = threadIdx.x;
  const bool leader = tid == 0;
  const int cw = __shfl_sync(0xffffffffu, tid >> 7, 0);   // warpgroup
  const int ct = tid & 127;                               // its thread
  const int warp = __shfl_sync(0xffffffffu, ct >> 5, 0);
  const int lane = tid & 31;
  // as in flash_bwd_wgmma_kernel, every `if (leader)` block before a
  // barrier or a wgmma ends in __syncwarp()
  if (leader) {
    mbar_init(kv_full, 1);
    for (int i = 0; i < KS_STAGES; ++i) mbar_init(&q_full[i], 1);
    mbar_init_fence();
  }
  __syncwarp();
  __syncthreads();
  const int G = a.H / a.KV;
  const int BKV = a.B * a.KV;
  const int n_kt = a.n_items / BKV;
  const int sq_pad = a.n_qt * WG_BR;
  const uint32_t sK = base + Tl::K_OFF, sV = base + Tl::V_OFF;
  const uint32_t sP = base + Tl::P_OFF, sDS = base + Tl::DS_OFF;
  const uint32_t sDQ = base + Tl::DQ_OFF;
  uint8_t* pt_s = sm + Tl::P_OFF;
  uint8_t* dst_s = sm + Tl::DS_OFF;
  const float* ld_s = reinterpret_cast<const float*>(sm + Tl::LD_OFF);
  float2* dq_s = reinterpret_cast<float2*>(sm + Tl::DQ_OFF);
  const int64_t k_rs = (int64_t)a.KV * D, v_rs = (int64_t)a.KV * DV;

  // the leader's copies of streamed tile i of a work tile: head g = i / n,
  // query tile hi - 1 - i % n (highest first), into stage `st`
  auto load_tile = [&](int st, int i, int n, const TileRange& qr, int b,
                       int hk) {
    const int h = hk * G + i / n;
    const int qt = qr.hi - 1 - i % n;
    mbar_expect_tx(&q_full[st], Tl::Q_TX);
    for (int c = 0; c < Tl::NBK; ++c)
      tma_load_4d(base + Tl::Q_OFF + st * Tl::Q_BYTES + c * Tl::Q_BLOCK, &tq,
                  &q_full[st], 64 * c, h, qt * WG_BR, b);
    for (int c = 0; c < Tl::NBV; ++c)
      tma_load_4d(base + Tl::DO_OFF + st * Tl::DO_BYTES + c * Tl::Q_BLOCK,
                  &tdo, &q_full[st], 64 * c, h, qt * WG_BR, b);
    const int64_t row = ((int64_t)b * a.H + h) * sq_pad + qt * WG_BR;
    const uint32_t ld = base + Tl::LD_OFF + st * 2 * WG_BR * 4;
    bulk_load(ld, a.lse2 + row, WG_BR * 4, &q_full[st]);
    bulk_load(ld + WG_BR * 4, a.delta + row, WG_BR * 4, &q_full[st]);
  };

  // one hand-off buffer: DqSums on buffer 0 alone, as at D = 256
  DqSums sums;
  sums.state[0] = sums.state[1] = DqSums::FREE;
  int tc = 0;                      // streamed tiles so far: stage, phase
  for (int n = 0;; ++n) {
    if (leader) {
      const int item = atomicAdd(a.counters + (int64_t)a.B * a.H * a.n_qt, 1);
      sched[n & 1] = item < a.n_items ? item : -1;
    }
    __syncwarp();
    bar_sync(1, WG_THREADS);
    const int item = __shfl_sync(0xffffffffu, sched[n & 1], 0);
    if (item < 0) break;
    // key tile major within groups of KS_HEAD_GROUP (b, KV head) pairs:
    // the group's q, dO and float32 dq rows stay in L2 while they are
    // read and summed (all 256 of deepseek's training shape would not
    // fit), and a head's consecutive key tiles are taken a group apart,
    // so that each has mostly been admitted to its dq sums before the
    // next one's wait for it
    const int group = item / (KS_HEAD_GROUP * n_kt);
    const int in_group = min(KS_HEAD_GROUP, BKV - group * KS_HEAD_GROUP);
    const int r = item - group * KS_HEAD_GROUP * n_kt;
    const int kt = r / in_group;
    const int bh = group * KS_HEAD_GROUP + r % in_group;
    const int b = bh / a.KV;
    const int hk = bh % a.KV;
    const TileRange qr = key_tile_queries<CS_BC>(a, kt);
    const int per_head = qr.hi - qr.lo;
    const int n_tiles = per_head * G;
    if (leader) {
      mbar_expect_tx(kv_full, Tl::K_BYTES + Tl::V_BYTES);
      for (int c = 0; c < Tl::NBK; ++c)
        tma_load_4d(sK + c * Tl::KV_BLOCK, &tk, kv_full, 64 * c, hk,
                    kt * CS_BC, b);
      for (int c = 0; c < Tl::NBV; ++c)
        tma_load_4d(sV + c * Tl::KV_BLOCK, &tv, kv_full, 64 * c, hk,
                    kt * CS_BC, b);
      for (int i = 0; i < KS_STAGES && i < n_tiles; ++i)
        load_tile((tc + i) % KS_STAGES, i, per_head, qr, b, hk);
    }
    __syncwarp();
    // accumulator layout of m64nNk16: thread (warp w, lane l) holds rows
    // 16 w + l / 4 (+ 8) and columns 8 j + 2 (l % 4) (+ 1) of every
    // 8-column group j, as d[4 j + 2 half + e].  Both warpgroups hold the
    // tile's 64 keys: warpgroup 0 dk's columns 0 .. 127 in acc and
    // 128 .. 191 in acc2, warpgroup 1 dv's 128 columns in acc.
    const int k0 = kt * CS_BC;
    const int key0 = k0 + 16 * warp + (lane >> 2);
    const int col0 = 2 * (lane & 3);
    float acc[64], acc2[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc2[i] = 0.f;
    mbar_wait(kv_full, n & 1);
    for (int it = 0; it < n_tiles; ++it, ++tc) {
      const int h = hk * G + it / per_head;
      const int qt = qr.hi - 1 - it % per_head;
      const int q0 = qt * WG_BR;
      const int stage = tc % KS_STAGES;
      mbar_wait(&q_full[stage], (tc / KS_STAGES) & 1);
      const uint32_t sQ = base + Tl::Q_OFF + stage * Tl::Q_BYTES;
      const uint32_t sDO = base + Tl::DO_OFF + stage * Tl::DO_BYTES;
      const float* lse_s = ld_s + stage * 2 * WG_BR;
      const float* del_s = lse_s + WG_BR;
      const bool crossed =
          q0 + WG_BR > a.Sq || k0 + CS_BC > a.Sk ||
          (a.causal && q0 < k0 + CS_BC - 1) ||
          (a.window > 0 && q0 + WG_BR - 1 - k0 >= a.window);

      // s^T = K q^T over the D columns and dp^T = V dO^T over the DV
      // columns, for this warpgroup's 32 queries (32 w .. + 31 of the
      // tile): [64 keys x 32 queries], both operands K-major, a k16 step
      // 32 bytes along a line, the 64-column blocks apart
      float s[16], dp[16];
      const uint64_t kd = per_tile(sw128_desc(sK, 16, 1024));
      const uint64_t vd = per_tile(sw128_desc(sV, 16, 1024));
      const uint64_t qd = per_tile(sw128_desc(sQ + cw * 32 * LINE, 16, 1024));
      const uint64_t od =
          per_tile(sw128_desc(sDO + cw * 32 * LINE, 16, 1024));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t ko = (kk >> 2) * Tl::KV_BLOCK + (kk & 3) * 32;
        const uint32_t qo = (kk >> 2) * Tl::Q_BLOCK + (kk & 3) * 32;
        wgmma_ss<32, 0, 0>(s, desc_plus(kd, ko), desc_plus(qd, qo), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
        const uint32_t ko = (kk >> 2) * Tl::KV_BLOCK + (kk & 3) * 32;
        const uint32_t qo = (kk >> 2) * Tl::Q_BLOCK + (kk & 3) * 32;
        wgmma_ss<32, 0, 0>(dp, desc_plus(vd, ko), desc_plus(od, qo), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(s);
      fence_acc(dp);

      // p^T = 2^(s^T scale log2 e - lse log2 e), ds^T = p^T (dp^T - delta)
      // (the mask test only where the tile crosses it or a tail), rounded
      // to bf16 into the shared p^T and ds^T: line = key, the tile's 64
      // queries along it, 16-byte chunks XORed with the line mod 8 (the
      // last tile's dq products read ds^T before the barrier that ended it)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 32 * cw + 8 * j + col0;    // query column
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
        const float2 dl = *reinterpret_cast<const float2*>(del_s + c);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 4 * j + r;
          const int qp = q0 + c + (r & 1);
          const int kp = key0 + 8 * (r >> 1);
          const float row_lse = (r & 1) ? l2.y : l2.x;
          const float row_delta = (r & 1) ? dl.y : dl.x;
          const bool keep =
              !crossed ||
              (qp < a.Sq && kp < a.Sk && (!a.causal || qp >= kp) &&
               (a.window <= 0 || qp - kp < a.window));
          const float pv =
              keep ? fast_exp2(s[i] * a.scale_log2 - row_lse) : 0.f;
          s[i] = pv;
          dp[i] = pv * (dp[i] - row_delta);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int kl = 16 * warp + (lane >> 2) + 8 * half;
          const int at = kl * LINE + ((((4 * cw + j) ^ kl) & 7) << 4) +
                         col0 * 2;
          *reinterpret_cast<uint32_t*>(pt_s + at) =
              pack_bf16(s[4 * j + 2 * half], s[4 * j + 2 * half + 1]);
          *reinterpret_cast<uint32_t*>(dst_s + at) =
              pack_bf16(dp[4 * j + 2 * half], dp[4 * j + 2 * half + 1]);
        }
      }
      fence_proxy_async();
      bar_sync(1, WG_THREADS);

      // warpgroup 0: dK += ds^T q over the D columns (128 in acc, the last
      // 64 in acc2); warpgroup 1: dV += p^T dO over the DV columns, over
      // the tile's 64 queries: A K-major from the shared ds^T / p^T, B
      // MN-major, 16 query lines a step, 64-column blocks Q_BLOCK apart
      const uint64_t ad = per_tile(sw128_desc(cw == 0 ? sDS : sP, 16, 1024));
      const uint64_t bd =
          per_tile(sw128_desc(cw == 0 ? sQ : sDO, Tl::Q_BLOCK, 1024));
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 4; ++t)
        wgmma_m64n128k16<0, 1>(acc, desc_plus(ad, t * 32),
                               desc_plus(bd, t * 16 * LINE));
      if (cw == 0) {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          wgmma_ss<64, 0, 1>(acc2, desc_plus(ad, t * 32),
                             desc_plus(bd, 2 * Tl::Q_BLOCK + t * 16 * LINE),
                             1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      fence_acc(acc2);
      // q, dO, lse and delta of this stage read by both warpgroups: the
      // leader refills the stage, then frees the hand-off buffer (the last
      // tile's sum is issued once its counter admits it, and lands)
      bar_sync(1, WG_THREADS);
      if (leader) {
        if (it + KS_STAGES < n_tiles)
          load_tile(stage, it + KS_STAGES, per_head, qr, b, hk);
        sums.advance(a, 0, sDQ, DQ_BYTES);
      }
      __syncwarp();

      // dq[:, 64 c ..] = ds K[:, 64 c ..] over the 64 keys, block c = 0 on
      // warpgroup 0 and c = 1, 2 on warpgroup 1 (each then has four
      // 64-column products a tile): A = ds (MN-major), B = K (MN-major), 16
      // key lines a step; each block into the hand-off in the fragment
      // order of a 64 x 64 accumulator (float2 i / 2 of thread ct at
      // (i / 2 * 128 + ct) * 2), blocks 64 x 64 floats apart
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (cw == 0 && j == 1) break;
        const int c = cw == 0 ? 0 : 1 + j;
        float dq[32];
        const uint64_t am = per_tile(sw128_desc(sDS, Tl::PD_BYTES, 1024));
        const uint64_t km = per_tile(
            sw128_desc(sK + c * Tl::KV_BLOCK, Tl::KV_BLOCK, 1024));
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < 4; ++t)
          wgmma_ss<64, 1, 1>(dq, desc_plus(am, t * 16 * LINE),
                             desc_plus(km, t * 16 * LINE), t > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(dq);
        if (j == 0) bar_sync(1, WG_THREADS);     // the hand-off is free
        float2* hand = dq_s + c * (WG_BR * 64 / 2);
#pragma unroll
        for (int i = 0; i < 32; i += 2)
          hand[(i >> 1) * 128 + ct] = make_float2(dq[i], dq[i + 1]);
      }
      fence_proxy_async();
      bar_sync(1, WG_THREADS);
      if (leader) {
        sums.state[0] = DqSums::PENDING;
        sums.want[0] = kt - first_key_tile<CS_BC>(a, qt);
        sums.tile[0] = ((int64_t)b * a.H + h) * a.n_qt + qt;
        sums.try_issue(a, 0, sDQ, DQ_BYTES);
      }
      __syncwarp();
    }

    // dk (warpgroup 0) or dv (warpgroup 1) of the tile's keys below Sk
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kp = key0 + 8 * half;
      if (kp >= a.Sk) continue;
      if (cw == 0) {
        __nv_bfloat16* dkp =
            a.dk + ((int64_t)b * a.Sk + kp) * k_rs + hk * D + col0;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          store2(dkp + 8 * j, acc[4 * j + 2 * half] * a.scale,
                 acc[4 * j + 2 * half + 1] * a.scale);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          store2(dkp + 128 + 8 * j, acc2[4 * j + 2 * half] * a.scale,
                 acc2[4 * j + 2 * half + 1] * a.scale);
      } else {
        __nv_bfloat16* dvp =
            a.dv + ((int64_t)b * a.Sk + kp) * v_rs + hk * DV + col0;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          store2(dvp + 8 * j, acc[4 * j + 2 * half],
                 acc[4 * j + 2 * half + 1]);
      }
    }
  }
  if (leader) sums.advance(a, 0, sDQ, DQ_BYTES);   // the last sum lands
}

// pre-pass of the wgmma kernel, one warp per row (b * H + h) * sq_pad + i
template <int DP>
__global__ void __launch_bounds__(256)
bwd_prep_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                const float* __restrict__ lse, float* __restrict__ lse2,
                float* __restrict__ delta, float* __restrict__ dq_accum,
                int* __restrict__ counters, int B, int Sq, int H, int Dv,
                int n_qt) {
  const int sq_pad = n_qt * WG_BR;
  const int64_t row = (int64_t)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (int64_t)B * H * sq_pad) return;   // uniform in the warp
  const int i = (int)(row % sq_pad);
  const int64_t bh = row / sq_pad;
  float acc = 0.f;
  if (i < Sq) {
    const int h = (int)(bh % H);
    const int64_t off = (((bh / H) * Sq + i) * H + h) * Dv;
    for (int c = lane; c < Dv; c += 32)
      acc += __bfloat162float(o[off + c]) * __bfloat162float(dout[off + c]);
    acc = warp_sum(acc);
  }
  if (lane == 0) {
    delta[row] = acc;
    lse2[row] = i < Sq ? lse[bh * Sq + i] * LOG2E : __int_as_float(0x7f800000);
    if (i % WG_BR == 0) counters[bh * n_qt + i / WG_BR] = 0;
    if (row == 0) counters[(int64_t)B * H * n_qt] = 0;   // the work counter
  }
  float4* z = reinterpret_cast<float4*>(dq_accum + row * DP);
  for (int c = lane; c < DP / 4; c += 32) z[c] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// dq = accumulator * scale in bf16: a thread per (tile, row r, 8 columns
// 8 j), whose 8 floats lie together in the hand-off's fragment order; the
// columns past D are not written
template <int DP>
__global__ void __launch_bounds__(256)
bwd_dq_kernel(const float* __restrict__ dq_accum, bf16* __restrict__ dq,
              int Sq, int H, int D, int n_qt, float scale, int64_t tasks) {
  const int64_t t = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (t >= tasks) return;
  const int j = (int)(t % (DP / 8));
  const int r = (int)((t / (DP / 8)) % WG_BR);
  const int64_t tile = t / (DP / 8) / WG_BR;
  const int q = (int)(tile % n_qt) * WG_BR + r;
  if (q >= Sq || 8 * j >= D) return;
  const int64_t bh = tile / n_qt;
  // row r = 16 w + 8 half + l and column 8 (j % 8) + 2 m + e of the
  // 64-column block j / 8: fragment index i = 4 (j % 8) + 2 half + e of
  // thread 32 w + 4 l + m
  const int w = r >> 4, half = (r >> 3) & 1, l = r & 7;
  const float4* src = reinterpret_cast<const float4*>(
      dq_accum + tile * WG_BR * DP + (j >> 3) * WG_BR * 64 +
      ((2 * (j & 7) + half) * 128 + 32 * w + 4 * l) * 2);
  const float4 x = src[0], y = src[1];
  uint4 out;
  out.x = pack_bf16(x.x * scale, x.y * scale);
  out.y = pack_bf16(x.z * scale, x.w * scale);
  out.z = pack_bf16(y.x * scale, y.y * scale);
  out.w = pack_bf16(y.z * scale, y.w * scale);
  const int64_t b = bh / H, h = bh % H;
  *reinterpret_cast<uint4*>(dq + ((b * Sq + q) * H + h) * D + 8 * j) = out;
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

int launch_delta(const BwdArgs& a) {
  const int64_t rows = (int64_t)a.B * a.Sq * a.H;
  const unsigned blocks = (unsigned)((rows + 7) / 8);
  bwd_delta_kernel<<<blocks, 256, 0, a.stream>>>(
      static_cast<const float*>(a.o), static_cast<const float*>(a.dout),
      a.delta, a.Sq, a.H, a.Dv, rows);
  return (int)cudaGetLastError();
}

template <int D, int DV, bool KV_SIDE>
int launch_fma_side(const BwdArgs& a) {
  constexpr int smem_bytes = FmaBwdTile<D, DV>::SMEM;
  static unsigned smem_set = 0;
  auto kern = flash_bwd_fma_kernel<D, DV, KV_SIDE>;
  cudaError_t err = allow_smem(kern, smem_bytes, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int nx = KV_SIDE ? a.Sk : a.Sq;
  const dim3 grid((nx + FMA_BX - 1) / FMA_BX, KV_SIDE ? a.KV : a.H, a.B);
  kern<<<grid, FMA_THREADS, smem_bytes, a.stream>>>(
      a, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

// float32: the delta pre-pass, the dk / dv kernel, the dq kernel
template <int D, int DV>
int launch_bwd_fma(const BwdArgs& a) {
  int rc = launch_delta(a);
  if (rc == 0) rc = launch_fma_side<D, DV, true>(a);
  if (rc == 0) rc = launch_fma_side<D, DV, false>(a);
  return rc;
}

// cuTensorMapEncodeTiled, from the driver at run time (the library links
// only the runtime)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map of a contiguous bf16 [B, S, heads, D] tensor as (D, heads, S, B),
// whose box is 64 columns (one 128-byte swizzled line) of one head over
// `rows` rows; rows past S read as zeros.
bool head_rows_map(CUtensorMap* map, const void* ptr, int B, int S,
                   int heads, int D, int rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

// bf16: the pre-pass, the wgmma pass `kern` (its shared memory `smem`,
// work tiles of BC keys), the dq pass, at the head dim a.D rounded up to DP
template <int DP, int BC, typename Kernel>
int launch_bwd_passes(const BwdArgs& a, Kernel kern, int smem,
                      unsigned& smem_set) {
  if (a.dq_accum == nullptr || a.counters == nullptr) return -1;
  cudaError_t err = allow_smem(kern, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq, tk, tv, tdo;
  if (!head_rows_map(&tq, a.q, a.B, a.Sq, a.H, a.D, WG_BR) ||
      !head_rows_map(&tdo, a.dout, a.B, a.Sq, a.H, a.Dv, WG_BR) ||
      !head_rows_map(&tk, a.k, a.B, a.Sk, a.KV, a.D, BC) ||
      !head_rows_map(&tv, a.v, a.B, a.Sk, a.KV, a.Dv, BC))
    return -1;
  const int sms = sm_count();
  if (sms < 1) return -1;
  const int n_qt = (a.Sq + WG_BR - 1) / WG_BR;
  const int n_kt = (a.Sk + BC - 1) / BC;
  const int64_t rows = (int64_t)a.B * a.H * n_qt * WG_BR;
  float* lse2 = a.delta + rows;
  bwd_prep_kernel<DP><<<(unsigned)((rows + 7) / 8), 256, 0, a.stream>>>(
      static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout),
      a.lse, lse2, a.delta, a.dq_accum, a.counters, a.B, a.Sq, a.H, a.Dv,
      n_qt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const double scale = 1.0 / sqrt((double)a.D);
  const WgArgs w{lse2, a.delta, a.dq_accum, a.counters,
                 static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
                 a.B, a.Sq, a.Sk, a.H, a.KV, a.D, a.Dv, a.causal, a.window,
                 n_qt,
                 n_kt * a.B * a.KV, (float)scale,
                 (float)(scale * 1.4426950408889634)};
  kern<<<min(sms, w.n_items), WG_THREADS, smem, a.stream>>>(tq, tk, tv, tdo,
                                                          w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t tasks = rows * (DP / 8);
  bwd_dq_kernel<DP><<<(unsigned)((tasks + 255) / 256), 256, 0, a.stream>>>(
      a.dq_accum, static_cast<bf16*>(a.dq), a.Sq, a.H, a.D, n_qt,
      (float)scale, tasks);
  return (int)cudaGetLastError();
}

// DP 64 or 128: work tiles of 128 keys, 64 a warpgroup
template <int DP>
int launch_bwd_wgmma(const BwdArgs& a) {
  static unsigned smem_set = 0;
  return launch_bwd_passes<DP, WG_BC>(a, flash_bwd_wgmma_kernel<DP>,
                                      WgTile<DP>::SMEM, smem_set);
}

// DP 256: work tiles of 64 keys, their columns split between the
// warpgroups
template <int DP>
int launch_bwd_colsplit(const BwdArgs& a) {
  static unsigned smem_set = 0;
  return launch_bwd_passes<DP, CS_BC>(a, flash_bwd_colsplit_kernel<DP>,
                                      ColTile<DP>::SMEM, smem_set);
}

// (D, Dv) = (192, 128): work tiles of 64 keys, dk on one warpgroup and
// dv on the other
template <int D, int DV>
int launch_bwd_kvsplit(const BwdArgs& a) {
  static unsigned smem_set = 0;
  return launch_bwd_passes<D, CS_BC>(a, flash_bwd_kvsplit_kernel<D, DV>,
                                     KvTile<D, DV>::SMEM, smem_set);
}

// (D, Dv) pairs: kernels/_build.py :: FLASH_HEAD_DIMS lists the same; in
// bf16 each D == Dv takes the wgmma kernel at its head dim rounded up to
// 64, but 256, which takes the column-split kernel; (192, 128) takes the
// kv-split kernel
int dispatch_fma(const BwdArgs& a) {
  const int D = a.D, Dv = a.Dv;
  if (D == 16 && Dv == 16) return launch_bwd_fma<16, 16>(a);
  if (D == 32 && Dv == 32) return launch_bwd_fma<32, 32>(a);
  if (D == 64 && Dv == 64) return launch_bwd_fma<64, 64>(a);
  if (D == 80 && Dv == 80) return launch_bwd_fma<80, 80>(a);
  if (D == 128 && Dv == 128) return launch_bwd_fma<128, 128>(a);
  if (D == 256 && Dv == 256) return launch_bwd_fma<256, 256>(a);
  if (D == 192 && Dv == 128) return launch_bwd_fma<192, 128>(a);
  return -1;
}

int dispatch_bf16(const BwdArgs& a) {
  const int D = a.D, Dv = a.Dv;
  if (D == 16 && Dv == 16) return launch_bwd_wgmma<64>(a);
  if (D == 32 && Dv == 32) return launch_bwd_wgmma<64>(a);
  if (D == 64 && Dv == 64) return launch_bwd_wgmma<64>(a);
  if (D == 80 && Dv == 80) return launch_bwd_wgmma<128>(a);
  if (D == 128 && Dv == 128) return launch_bwd_wgmma<128>(a);
  if (D == 256 && Dv == 256) return launch_bwd_colsplit<256>(a);
  if (D == 192 && Dv == 128) return launch_bwd_kvsplit<192, 128>(a);
  return -1;
}

}  // namespace

// q, dq: [B, Sq, H, D]; o, dout: [B, Sq, H, Dv]; k, dk: [B, Sk, KV, D];
// v, dv: [B, Sk, KV, Dv]; all contiguous at 16-byte aligned bases, in
// float32 (dtype 0) or bfloat16 (dtype 1); lse: float32 [B, H, Sq] from
// the forward.  Scratch, float32 `delta` and, for the wgmma kernels
// (bf16), `dq_accum` and int32 `counters` (float32 may pass null for
// both): with Sq_pad = Sq rounded up to 64 and DP = D rounded up to 64,
// delta holds [2, B, H, Sq_pad] (delta, then lse * log2 e) in bf16 and
// [B, H, Sq] in float32; dq_accum [B, H, Sq_pad, DP]; counters B * H *
// Sq_pad / 64 + 1.  Launches three kernels on `stream`; returns
// cudaGetLastError() after the launches (0 on success), -1 for an
// unsupported (D, Dv) pair, dtype, alignment or missing scratch.  Does not
// synchronise, allocates nothing.
extern "C" int fate_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, float* dq_accum,
    int* counters, void* dq, void* dk, void* dv, int B, int Sq, int Sk,
    int H, int KV, int D, int Dv, int causal, int window, int dtype,
    void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  if (H % KV != 0 || B < 1 || Sq < 1 || Sk < 1) return -1;
  const void* ptrs[] = {q, k, v, o, dout, dq, dk, dv};
  for (const void* p : ptrs)
    if (!base16(p)) return -1;
  const BwdArgs a{q, k, v, o, dout, lse, delta, dq_accum, counters, dq, dk,
                  dv, B, Sq, Sk, H, KV, D, Dv, causal, window, dtype,
                  static_cast<cudaStream_t>(stream)};
  return dtype == 1 ? dispatch_bf16(a) : dispatch_fma(a);
}
