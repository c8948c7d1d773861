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
// contiguous [B, S, heads, D] (the wrapper copies anything else);
// lse and delta are float32 [B, H, Sq].
//
// Shape: FlashAttention-2's, three launches and no atomics, so that two
// calls give the same bits.
//   1. a pre-pass writes delta, one warp per (b, row, head);
//   2. one block per (b, KV head, key tile) keeps its keys and values
//      resident and streams the query tiles of its G heads, accumulating
//      dk and dv in registers; it sums the G heads itself;
//   3. one block per (b, head, query tile) keeps its queries and dO
//      resident and streams the key tiles, accumulating dq.
// Both are one template: the resident rows x and the streamed rows y,
// with s and dp computed as [x][y] tiles (s^T and dp^T for 2.), and the
// accumulators += ds (and p) times the streamed tile.  Tiles wholly above
// the causal diagonal or below the window are never visited.  Rows of a
// ragged tail are zero-filled and masked.
//
// What bounds it.  The function needs five products over the attended
// (query, key) pairs (s, dp, dv, dk, dq: 2 * D flops a pair each; this
// design recomputes s and dp in 3., seven in all), against 989 TFLOP/s in
// bf16: at qwen3-1.7b's training shape (B 2, S 4096, H 16, KV 8, D 128,
// causal) about 344 GFLOP, 0.35 ms; its bytes (q, k, v, o, dO, lse in;
// dq, dk, dv out, each once) are about 0.2 GB, 0.06 ms.  So operations
// bound it.
//
// bf16: mma.sync m16n8k16 (bf16 operands, float32 sums), 4 warps of 16
// resident rows each; every operand fragment comes from shared memory by
// ldmatrix (the streamed tiles through a 2-stage ring of 16-byte
// cp.async copies, rows padded by 16 bytes as in the forward), and p and
// ds stay in registers, rounded to bf16 as the A operand of the
// accumulating products (as FlashAttention-2 rounds them).  Streamed
// tiles are 64 rows up to D = 64 and 32 above, so that dk and dv (D / 2
// floats per thread each) fit the registers beside s and dp.
// float32: FMA on a 16 x 16 thread grid, 32 resident and 32 streamed rows
// per tile, p and ds through shared memory; for the tests' tight bar.
// Left undone: wgmma, TMA, warp specialisation, one pass that computes s
// and dp once.
#include "common.cuh"

namespace {

using namespace fate;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// pre-pass: delta = rowsum(dO * o)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, int Sq, int H, int D,
                 int64_t rows) {
  // row = (b * Sq + i) * H + h, the order of o's rows
  const int64_t row = (int64_t)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;       // the same for every lane of the warp
  const T* orow = o + row * D;
  const T* drow = dout + row * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32)
    acc += to_float<T>(orow[c]) * to_float<T>(drow[c]);
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
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Sk, H, KV, causal, window;
  int dtype;                // 0 float32 (FMA), 1 bfloat16 (mma.sync)
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
// bf16: mma.sync
// ---------------------------------------------------------------------------

constexpr int MMA_BX = 64;         // resident rows, 16 per warp
constexpr int MMA_THREADS = 128;

template <int D>
struct MmaBwdTile {
  static constexpr int BY = D > 64 ? 32 : 64;   // streamed rows per tile
  static constexpr int RS = D + 8;              // row stride: 16-byte pad
  static constexpr int SMEM =                   // A1, A2, 2 x (B1, B2), lse, delta
      (2 * MMA_BX + 4 * BY) * RS * 2 + 4 * BY * 4;
};

template <int D, bool KV_SIDE>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_mma_kernel(BwdArgs a, float scale, float scale_log2) {
  using Tile = MmaBwdTile<D>;
  constexpr int BY = Tile::BY;
  constexpr int RS = Tile::RS;
  constexpr int SJ = BY / 8;      // 8-column tiles of s and dp
  constexpr int CH = D / 8;       // 16-byte chunks per row
  constexpr int KS = D / 16;      // k16 steps of the score products
  constexpr int NT = D / 8;       // 8-column tiles of the accumulators

  extern __shared__ __align__(16) uint8_t bwd_smem[];
  bf16* A1s = reinterpret_cast<bf16*>(bwd_smem);   // [BX][RS]
  bf16* A2s = A1s + MMA_BX * RS;                  // [BX][RS]
  bf16* B1s = A2s + MMA_BX * RS;                  // [2][BY][RS]
  bf16* B2s = B1s + 2 * BY * RS;                  // [2][BY][RS]
  float* lse_s = reinterpret_cast<float*>(B2s + 2 * BY * RS);   // [2][BY]
  float* delta_s = lse_s + 2 * BY;                               // [2][BY]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // the dq blocks of late query tiles have the most key tiles: first
  const int xt = KV_SIDE ? blockIdx.x : gridDim.x - 1 - blockIdx.x;
  const Plan<KV_SIDE> plan(a, xt * MMA_BX, MMA_BX, BY);
  const int x0 = plan.x0;
  const int hx = blockIdx.y;     // KV head (KV side) or query head
  const int b = blockIdx.z;
  const int G = a.H / a.KV;
  const int64_t q_rs = (int64_t)a.H * D, k_rs = (int64_t)a.KV * D;
  const bf16* q = static_cast<const bf16*>(a.q) + (int64_t)b * a.Sq * q_rs;
  const bf16* dO = static_cast<const bf16*>(a.dout) + (int64_t)b * a.Sq * q_rs;
  const bf16* k = static_cast<const bf16*>(a.k) + (int64_t)b * a.Sk * k_rs;
  const bf16* v = static_cast<const bf16*>(a.v) + (int64_t)b * a.Sk * k_rs;
  const bf16* a1 = KV_SIDE ? k + hx * D : q + hx * D;
  const bf16* a2 = KV_SIDE ? v + hx * D : dO + hx * D;
  const int64_t x_rs = KV_SIDE ? k_rs : q_rs;
  const int64_t y_rs = KV_SIDE ? q_rs : k_rs;

  // the resident tile, with the first streamed tile the first copy group
  for (int idx = tid; idx < MMA_BX * CH; idx += MMA_THREADS) {
    const int r = idx / CH;
    const int c = idx % CH;
    const bool ok = x0 + r < plan.nx;
    const int64_t off = (int64_t)(x0 + r) * x_rs + 8 * c;
    cp_async16(smem_addr(A1s + r * RS + 8 * c), ok ? a1 + off : a1,
               ok ? 16 : 0);
    cp_async16(smem_addr(A2s + r * RS + 8 * c), ok ? a2 + off : a2,
               ok ? 16 : 0);
  }
  const int per_head = plan.tiles_per_head(BY);
  const int n_it = per_head * plan.heads;
  // streamed tile `it`: head g = it / per_head of the group, rows from y0
  auto tile_at = [&](int it, int& h, int& y0) {
    const int g = it / per_head;
    h = KV_SIDE ? hx * G + g : hx;
    y0 = plan.y_begin + (it % per_head) * BY;
  };
  auto load_y = [&](int stage, int it) {
    int h, y0;
    tile_at(it, h, y0);
    const bf16* b1 = KV_SIDE ? q + h * D : k + (hx / G) * D;
    const bf16* b2 = KV_SIDE ? dO + h * D : v + (hx / G) * D;
    bf16* b1s = B1s + stage * BY * RS;
    bf16* b2s = B2s + stage * BY * RS;
    for (int idx = tid; idx < BY * CH; idx += MMA_THREADS) {
      const int r = idx / CH;
      const int c = idx % CH;
      const bool ok = y0 + r < plan.ny;
      const int64_t off = (int64_t)(y0 + r) * y_rs + 8 * c;
      cp_async16(smem_addr(b1s + r * RS + 8 * c), ok ? b1 + off : b1,
                 ok ? 16 : 0);
      cp_async16(smem_addr(b2s + r * RS + 8 * c), ok ? b2 + off : b2,
                 ok ? 16 : 0);
    }
    if (KV_SIDE) {     // each streamed query's lse (log2 domain) and delta
      const int64_t base = ((int64_t)b * a.H + h) * a.Sq;
      for (int r = tid; r < BY; r += MMA_THREADS) {
        const bool ok = y0 + r < a.Sq;
        lse_s[stage * BY + r] = ok ? a.lse[base + y0 + r] * LOG2E : 0.f;
        delta_s[stage * BY + r] = ok ? a.delta[base + y0 + r] : 0.f;
      }
    }
  };
  if (n_it > 0) load_y(0, 0);
  cp_async_commit();

  // m16n8 fragment layout: rows row0 and row0 + 8 of the warp's 16,
  // columns col0 and col0 + 1 of every 8-column tile
  const int row0 = x0 + warp * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  float x_lse[2] = {0.f, 0.f}, x_delta[2] = {0.f, 0.f};
  if (!KV_SIDE) {      // the resident queries' lse and delta
    const int64_t base = ((int64_t)b * a.H + hx) * a.Sq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + 8 * i;
      if (r < a.Sq) {
        x_lse[i] = a.lse[base + r] * LOG2E;
        x_delta[i] = a.delta[base + r];
      }
    }
  }
  float acc1[NT][4];                       // dk or dq
  float acc2[KV_SIDE ? NT : 1][4];         // dv
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      acc1[j][r] = 0.f;
      if constexpr (KV_SIDE) acc2[j][r] = 0.f;
    }
  const uint32_t a1_frag = smem_addr(A1s + (warp * 16 + (lane & 15)) * RS +
                                     8 * (lane >> 4));
  const uint32_t a2_frag = smem_addr(A2s + (warp * 16 + (lane & 15)) * RS +
                                     8 * (lane >> 4));

  int st = 0;
  for (int it = 0; it < n_it; ++it, st ^= 1) {
    if (it + 1 < n_it) {
      load_y(st ^ 1, it + 1);   // read at the previous iteration, released
      cp_async_commit();        // by its closing barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    int h, y0;
    tile_at(it, h, y0);
    const bf16* b1s = B1s + st * BY * RS;
    const bf16* b2s = B2s + st * BY * RS;

    // s = A1 . B1^T and dp = A2 . B2^T, [16 resident x BY streamed] a warp
    float s[SJ][4], dp[SJ][4];
#pragma unroll
    for (int j = 0; j < SJ; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        s[j][r] = 0.f;
        dp[j][r] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t fa1[4], fa2[4];
      ldsm_x4(fa1, a1_frag + 32 * kk);
      ldsm_x4(fa2, a2_frag + 32 * kk);
#pragma unroll
      for (int jj = 0; jj < SJ / 2; ++jj) {
        const int off = (16 * jj + (lane & 7) + 8 * (lane >> 4)) * RS +
                        16 * kk + 8 * ((lane >> 3) & 1);
        uint32_t fb[4];
        ldsm_x4(fb, smem_addr(b1s + off));
        mma_bf16(s[2 * jj], fa1, fb[0], fb[1]);
        mma_bf16(s[2 * jj + 1], fa1, fb[2], fb[3]);
        ldsm_x4(fb, smem_addr(b2s + off));
        mma_bf16(dp[2 * jj], fa2, fb[0], fb[1]);
        mma_bf16(dp[2 * jj + 1], fa2, fb[2], fb[3]);
      }
    }

    // p = 2^(s * scale * log2 e - lse * log2 e), ds = p (dp - delta)
#pragma unroll
    for (int j = 0; j < SJ; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int xp = row0 + 8 * (r >> 1);
        const int yc = 8 * j + col0 + (r & 1);
        const int yp = y0 + yc;
        const bool ok = KV_SIDE ? attends(a, yp, xp) : attends(a, xp, yp);
        const float l2 = KV_SIDE ? lse_s[st * BY + yc] : x_lse[r >> 1];
        const float dl = KV_SIDE ? delta_s[st * BY + yc] : x_delta[r >> 1];
        const float p = ok ? exp2f(s[j][r] * scale_log2 - l2) : 0.f;
        s[j][r] = p;
        dp[j][r] = p * (dp[j][r] - dl);
      }

    // acc1 += ds . B1 and (KV side) acc2 += p . B2: the score fragments of
    // 8-column tiles 2t, 2t + 1 are the A fragment of k16 step t; the
    // streamed tiles' B fragments through ldmatrix.trans
#pragma unroll
    for (int t = 0; t < SJ / 2; ++t) {
      const uint32_t fds[4] = {pack_bf16(dp[2 * t][0], dp[2 * t][1]),
                               pack_bf16(dp[2 * t][2], dp[2 * t][3]),
                               pack_bf16(dp[2 * t + 1][0], dp[2 * t + 1][1]),
                               pack_bf16(dp[2 * t + 1][2], dp[2 * t + 1][3])};
      uint32_t fp[4];
      if constexpr (KV_SIDE) {
        fp[0] = pack_bf16(s[2 * t][0], s[2 * t][1]);
        fp[1] = pack_bf16(s[2 * t][2], s[2 * t][3]);
        fp[2] = pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]);
        fp[3] = pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3]);
      }
#pragma unroll
      for (int jd = 0; jd < NT / 2; ++jd) {
        const int off = (16 * t + (lane & 7) + 8 * ((lane >> 3) & 1)) * RS +
                        8 * (2 * jd + (lane >> 4));
        uint32_t fb[4];
        ldsm_x4_trans(fb, smem_addr(b1s + off));
        mma_bf16(acc1[2 * jd], fds, fb[0], fb[1]);
        mma_bf16(acc1[2 * jd + 1], fds, fb[2], fb[3]);
        if constexpr (KV_SIDE) {
          ldsm_x4_trans(fb, smem_addr(b2s + off));
          mma_bf16(acc2[2 * jd], fp, fb[0], fb[1]);
          mma_bf16(acc2[2 * jd + 1], fp, fb[2], fb[3]);
        }
      }
    }
    __syncthreads();   // this stage is refilled two iterations on
  }
  cp_async_wait<0>();  // the resident copy, where no tile was streamed

  // every resident row below nx is written, zeros where nothing attends
  bf16* o1 = static_cast<bf16*>(KV_SIDE ? a.dk : a.dq) +
             (int64_t)b * plan.nx * x_rs + hx * D;
  bf16* o2 = KV_SIDE ? static_cast<bf16*>(a.dv) +
                           (int64_t)b * plan.nx * x_rs + hx * D
                     : nullptr;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    if (r >= plan.nx) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int64_t off = (int64_t)r * x_rs + 8 * j + col0;
      store2(o1 + off, acc1[j][2 * i] * scale, acc1[j][2 * i + 1] * scale);
      if constexpr (KV_SIDE) store2(o2 + off, acc2[j][2 * i], acc2[j][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: FMA
// ---------------------------------------------------------------------------

constexpr int FMA_BX = 32;          // resident rows, 2 per thread row
constexpr int FMA_BY = 32;          // streamed rows, 2 per thread column
constexpr int FMA_THREADS = 256;    // 16 x 16

template <int D>
struct FmaBwdTile {
  static constexpr int RS = D + 4;          // row stride of the tiles
  static constexpr int PS = FMA_BY + 4;     // row stride of p and ds
  static constexpr int SMEM =
      ((2 * FMA_BX + 2 * FMA_BY) * RS + 2 * FMA_BX * PS + 2 * FMA_BY) * 4;
};

template <int D, bool KV_SIDE>
__global__ void __launch_bounds__(FMA_THREADS)
flash_bwd_fma_kernel(BwdArgs a, float scale) {
  using Tile = FmaBwdTile<D>;
  constexpr int RS = Tile::RS;
  constexpr int PS = Tile::PS;
  constexpr int D4 = D / 4;
  constexpr int DN = D / 16;        // output columns per thread

  extern __shared__ __align__(16) float fsmem[];
  float* A1s = fsmem;                   // [BX][RS]
  float* A2s = A1s + FMA_BX * RS;       // [BX][RS]
  float* B1s = A2s + FMA_BX * RS;       // [BY][RS]
  float* B2s = B1s + FMA_BY * RS;       // [BY][RS]
  float* Ps = B2s + FMA_BY * RS;        // [BX][PS]
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
  const float* q = static_cast<const float*>(a.q) + (int64_t)b * a.Sq * q_rs;
  const float* dO =
      static_cast<const float*>(a.dout) + (int64_t)b * a.Sq * q_rs;
  const float* k = static_cast<const float*>(a.k) + (int64_t)b * a.Sk * k_rs;
  const float* v = static_cast<const float*>(a.v) + (int64_t)b * a.Sk * k_rs;
  const float* a1 = KV_SIDE ? k + hx * D : q + hx * D;
  const float* a2 = KV_SIDE ? v + hx * D : dO + hx * D;
  const int64_t x_rs = KV_SIDE ? k_rs : q_rs;
  const int64_t y_rs = KV_SIDE ? q_rs : k_rs;

  for (int idx = tid; idx < FMA_BX * D4; idx += FMA_THREADS) {
    const int r = idx / D4;
    const int c = (idx % D4) * 4;
    float4 v1 = make_float4(0.f, 0.f, 0.f, 0.f), v2 = v1;
    if (x0 + r < plan.nx) {
      v1 = load4<float>(a1 + (int64_t)(x0 + r) * x_rs + c);
      v2 = load4<float>(a2 + (int64_t)(x0 + r) * x_rs + c);
    }
    *reinterpret_cast<float4*>(&A1s[r * RS + c]) = v1;
    *reinterpret_cast<float4*>(&A2s[r * RS + c]) = v2;
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
  float acc1[2][DN], acc2[2][KV_SIDE ? DN : 1];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      acc1[i][j] = 0.f;
      if constexpr (KV_SIDE) acc2[i][j] = 0.f;
    }

  const int per_head = plan.tiles_per_head(FMA_BY);
  const int n_it = per_head * plan.heads;
  for (int it = 0; it < n_it; ++it) {
    const int h = KV_SIDE ? hx * G + it / per_head : hx;
    const int y0 = plan.y_begin + (it % per_head) * FMA_BY;
    const float* b1 = KV_SIDE ? q + h * D : k + (hx / G) * D;
    const float* b2 = KV_SIDE ? dO + h * D : v + (hx / G) * D;
    __syncthreads();   // the previous tile's products have read B, P, dS
    for (int idx = tid; idx < FMA_BY * D4; idx += FMA_THREADS) {
      const int r = idx / D4;
      const int c = (idx % D4) * 4;
      float4 v1 = make_float4(0.f, 0.f, 0.f, 0.f), v2 = v1;
      if (y0 + r < plan.ny) {
        v1 = load4<float>(b1 + (int64_t)(y0 + r) * y_rs + c);
        v2 = load4<float>(b2 + (int64_t)(y0 + r) * y_rs + c);
      }
      *reinterpret_cast<float4*>(&B1s[r * RS + c]) = v1;
      *reinterpret_cast<float4*>(&B2s[r * RS + c]) = v2;
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

    // s and dp for resident rows 2 ty + i, streamed columns tx + 16 c
    float s[2][2], dp[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        s[i][c] = 0.f;
        dp[i][c] = 0.f;
      }
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 x1[2], x2[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        x1[i] = *reinterpret_cast<const float4*>(&A1s[(2 * ty + i) * RS + d]);
        x2[i] = *reinterpret_cast<const float4*>(&A2s[(2 * ty + i) * RS + d]);
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float4 y1 =
            *reinterpret_cast<const float4*>(&B1s[(tx + 16 * c) * RS + d]);
        const float4 y2 =
            *reinterpret_cast<const float4*>(&B2s[(tx + 16 * c) * RS + d]);
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
        const float y2 = B2s[n * RS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc1[i][j] = fmaf(ds[i], y1, acc1[i][j]);
          if constexpr (KV_SIDE) acc2[i][j] = fmaf(p[i], y2, acc2[i][j]);
        }
      }
    }
  }

  float* o1 = static_cast<float*>(KV_SIDE ? a.dk : a.dq) +
              (int64_t)b * plan.nx * x_rs + hx * D;
  float* o2 = KV_SIDE ? static_cast<float*>(a.dv) +
                            (int64_t)b * plan.nx * x_rs + hx * D
                      : nullptr;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = x0 + 2 * ty + i;
    if (r >= plan.nx) continue;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      const int64_t off = (int64_t)r * x_rs + tx + 16 * j;
      o1[off] = acc1[i][j] * scale;
      if constexpr (KV_SIDE) o2[off] = acc2[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T>
int launch_delta(const BwdArgs& a, const void* o, float* delta, int D) {
  const int64_t rows = (int64_t)a.B * a.Sq * a.H;
  const unsigned blocks = (unsigned)((rows + 7) / 8);
  bwd_delta_kernel<T><<<blocks, 256, 0, a.stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(a.dout), delta, a.Sq,
      a.H, D, rows);
  return (int)cudaGetLastError();
}

template <int D, bool KV_SIDE>
int launch_bwd_mma(const BwdArgs& a) {
  constexpr int smem_bytes = MmaBwdTile<D>::SMEM;
  static unsigned smem_set = 0;
  auto kern = flash_bwd_mma_kernel<D, KV_SIDE>;
  cudaError_t err = allow_smem(kern, smem_bytes, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int nx = KV_SIDE ? a.Sk : a.Sq;
  const dim3 grid((nx + MMA_BX - 1) / MMA_BX, KV_SIDE ? a.KV : a.H, a.B);
  const double scale = 1.0 / sqrt((double)D);
  kern<<<grid, MMA_THREADS, smem_bytes, a.stream>>>(
      a, (float)scale, (float)(scale * 1.4426950408889634));
  return (int)cudaGetLastError();
}

template <int D, bool KV_SIDE>
int launch_bwd_fma(const BwdArgs& a) {
  constexpr int smem_bytes = FmaBwdTile<D>::SMEM;
  static unsigned smem_set = 0;
  auto kern = flash_bwd_fma_kernel<D, KV_SIDE>;
  cudaError_t err = allow_smem(kern, smem_bytes, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int nx = KV_SIDE ? a.Sk : a.Sq;
  const dim3 grid((nx + FMA_BX - 1) / FMA_BX, KV_SIDE ? a.KV : a.H, a.B);
  kern<<<grid, FMA_THREADS, smem_bytes, a.stream>>>(
      a, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

// dk and dv, then dq: each launch_bwd<D> instantiates the kernel of its
// type twice, for the key side and the query side
template <int D>
int launch_bwd(const BwdArgs& a) {
  int rc = a.dtype == 1 ? launch_bwd_mma<D, true>(a)
                        : launch_bwd_fma<D, true>(a);
  if (rc != 0) return rc;
  return a.dtype == 1 ? launch_bwd_mma<D, false>(a)
                      : launch_bwd_fma<D, false>(a);
}

// head dims: kernels/_build.py :: FLASH_BWD_HEAD_DIMS lists the same
int dispatch_bwd(const BwdArgs& a, int D) {
  if (D == 16) return launch_bwd<16>(a);
  if (D == 32) return launch_bwd<32>(a);
  if (D == 64) return launch_bwd<64>(a);
  if (D == 80) return launch_bwd<80>(a);
  if (D == 128) return launch_bwd<128>(a);
  return -1;
}

}  // namespace

// q, o, dout, dq: [B, Sq, H, D]; k, v, dk, dv: [B, Sk, KV, D]; all
// contiguous, in float32 (dtype 0, the FMA kernels) or bfloat16 (dtype 1,
// the mma.sync kernels, which need 16-byte aligned bases); lse: float32
// [B, H, Sq] from the forward; delta: float32 [B, H, Sq] scratch.
// Launches the delta pre-pass, the dk / dv kernel and the dq kernel on
// `stream`; returns cudaGetLastError() after the launches (0 on success),
// -1 for an unsupported head dim, dtype or alignment.  Does not
// synchronise, allocates nothing.
extern "C" int fate_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int H, int KV, int D, int causal,
    int window, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  if (H % KV != 0 || B < 1 || Sq < 1 || Sk < 1) return -1;
  const void* ptrs[] = {q, k, v, o, dout, dq, dk, dv};
  for (const void* p : ptrs)
    if (!base16(p)) return -1;
  const BwdArgs a{q, k, v, dout, lse, delta, dq, dk, dv,
                  B, Sq, Sk, H, KV, causal, window, dtype,
                  static_cast<cudaStream_t>(stream)};
  const int rc = dtype == 1 ? launch_delta<bf16>(a, o, delta, D)
                            : launch_delta<float>(a, o, delta, D);
  if (rc != 0) return rc;
  return dispatch_bwd(a, D);
}
