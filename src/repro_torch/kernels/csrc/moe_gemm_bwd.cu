// K3's weight gradient for Hopper: dw[e] = sum over b of x[b, e]^T dy[b, e]
// for every expert e, float32 accumulation, rounded to the weight's type
// once, at the store.  Replaces no TPU kernel: the reference
// differentiates the einsums of src/repro/models/moe.py:104-109 (its
// Pallas grouped GEMM, src/repro/kernels/moe_gemm.py, has no backward).
// K3's input gradient dx = dy w^T is K3's own kernel reading w K-major
// (csrc/moe_gemm.cu, plan bit 2).
//
// What it computes.  x [B, E, C, D] (the forward's input: the dispatch
// view, or the hidden activations before the down projection), dy
// [B, E, C, F] (the gradient of the forward's output) -> dw [E, D, F].
// The contraction runs over the B*C rows (b, c) of one expert, read
// through the batch stride as the forward reads them (row r: b = r / C,
// c = r % C); rows beyond B*C are zero-filled.  Dims need not be tile
// multiples.
//
// What bounds it on an NVIDIA H100 SXM (data-sheet rates, 700 W).  At
// granite-moe's training microbatch (B*C = 2048 rows per expert, 40
// experts, D x F = 1536 x 512) one call does 128.8 GFLOP and moves
// 399 MB once, about 323 flops per byte, above the card's bf16 ridge
// (295): operations bound it (0.130 ms at 989 TFLOP/s), and only the
// tensor cores can reach that.
//
// bf16: warpgroup tensor cores fed by a cp.async ring, the forward's
// pipeline with both operands MN-major.  One block owns a 128 x 128 tile
// (D rows, F columns) of one expert's dw; each of its two warpgroups
// issues wgmma.mma_async m64n128k16 with both operands in shared memory
// and 64 float32 accumulators per thread.  x's rows (D contiguous) are
// A = x^T taken through the transpose bit of A: a stage holds 64 rows as
// 128-byte lines of 64 D values, one 64-wide block per warpgroup.  dy's
// rows (F contiguous) are B as the forward's weight tile is: two 64-column
// halves, transpose bit of B set.  Rows go in stages of 64 through a ring
// of 4 stages in the 128-byte swizzle, copies two stages ahead, one wgmma
// group in flight.  One block sums every row of its expert in increasing
// order: there is no split over rows and no atomic, so two calls give the
// same bits.  Operands whose rows are not 16-byte aligned take an
// element-wise loader that writes the same layout.
//
// float32: an FMA kernel for the 1e-5 relative bar (TF32 would miss it):
// grid (F / 64, D / 64, E), 256 threads with 4 x 4 outputs each, rows in
// steps of 16 through shared memory, in increasing order.
//
// Left undone: a persistent grid, TMA loads, fusing the gate and up
// weight gradients (they share x).
#include "common.cuh"

namespace {

using namespace fate;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// float32: FMA kernel
// ---------------------------------------------------------------------------

constexpr int FMA_BM = 64;    // rows d of dw per block
constexpr int FMA_BN = 64;    // columns f of dw per block
constexpr int FMA_BK = 16;    // rows (b, c) of the contraction per stage
constexpr int FMA_NT = 256;   // a 16 x 16 grid of threads, 4 x 4 outputs each
constexpr int FMA_LOADS = FMA_BM * FMA_BK / FMA_NT;   // elements per thread

__global__ void __launch_bounds__(FMA_NT)
moe_dw_fma_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                  float* __restrict__ dw, int C, int D, int F, int rows,
                  int64_t x_sb, int64_t x_se, int64_t x_sc, int64_t x_sd,
                  int64_t y_sb, int64_t y_se, int64_t y_sc, int64_t y_sf) {
  __shared__ float As[FMA_BK][FMA_BM + 4];
  __shared__ float Bs[FMA_BK][FMA_BN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n0 = blockIdx.x * FMA_BN;
  const int m0 = blockIdx.y * FMA_BM;
  const int e = blockIdx.z;
  const float* xe = x + (int64_t)e * x_se;
  const float* ye = dy + (int64_t)e * y_se;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < rows; k0 += FMA_BK) {
    // element idx: row k of the stage, column idx % 64 (neighbouring
    // threads on neighbouring columns)
#pragma unroll
    for (int i = 0; i < FMA_LOADS; ++i) {
      const int idx = tid + i * FMA_NT;
      const int k = idx / FMA_BM;
      const int col = idx % FMA_BM;
      const int r = k0 + k;
      const bool ok = r < rows;
      const int64_t b = ok ? r / C : 0;
      const int64_t c = ok ? r % C : 0;
      As[k][col] = (ok && m0 + col < D)
                       ? xe[b * x_sb + c * x_sc + (int64_t)(m0 + col) * x_sd]
                       : 0.f;
      Bs[k][col] = (ok && n0 + col < F)
                       ? ye[b * y_sb + c * y_sc + (int64_t)(n0 + col) * y_sf]
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FMA_BK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();   // the tiles are overwritten by the next stage
  }

  float* de = dw + (int64_t)e * D * F;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= D) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < F) de[(int64_t)m * F + n] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma kernel
// ---------------------------------------------------------------------------

constexpr int BM = 128;        // rows d of dw per block (two warpgroups)
constexpr int BN = 128;        // columns f of dw per block (the wgmma's N)
constexpr int BK = 64;         // rows (b, c) per stage
constexpr int STAGES = 4;      // shared-memory ring
constexpr int THREADS = 256;
constexpr int BLOCK64 = BK * 64 * 2;  // 64 lines of 64 columns
constexpr int A_BYTES = 2 * BLOCK64;  // x^T: two 64-wide blocks of D
constexpr int STAGE = A_BYTES + 2 * BLOCK64;  // + dy: two blocks of F
constexpr int SMEM = STAGES * STAGE + 1024;  // + alignment slack

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
moe_dw_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                    bf16* __restrict__ dw, int C, int D, int F, int rows,
                    int64_t x_sb, int64_t x_se, int64_t x_sc, int64_t x_sd,
                    int64_t y_sb, int64_t y_se, int64_t y_sc, int64_t y_sf) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // the swizzle atom's size
  uint8_t* sbase = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int e = blockIdx.z;
  const bf16* xe = x + (int64_t)e * x_se;
  const bf16* ye = dy + (int64_t)e * y_se;
  const int KT = (rows + BK - 1) / BK;

  // Vector loader: this thread's fixed 16-byte chunk column cc of both
  // operands' 128-wide tiles (8 elements), its byte counts there, and its
  // rows of the next stage to load (row[i]; slot[i] = row[i] % C and the
  // rows' offsets in x and dy), advanced by BK rows a stage without a
  // division: a division per row and stage took 0.47 of 0.78 ms at
  // granite's training shape (tools/kernel_probe.py moe-dw-phases).
  constexpr int PT = BK * 16 / THREADS;   // chunks per thread and operand
  const int cc = tid & 15;
  const int a_bytes = max(0, min(16, (D - m0 - 8 * cc) * 2));
  const int b_bytes = max(0, min(16, (F - n0 - 8 * cc) * 2));
  int row[PT], slot[PT];
  int64_t ox[PT], oy[PT];
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    row[i] = (tid >> 4) + i * (THREADS / 16);
    const int b = row[i] / C;
    slot[i] = row[i] % C;
    ox[i] = (int64_t)b * x_sb + (int64_t)slot[i] * x_sc;
    oy[i] = (int64_t)b * y_sb + (int64_t)slot[i] * y_sc;
  }

  // line kr of a stage is row k0 + kr of the expert; a 128-wide tile's
  // two 64-wide blocks lie BLOCK64 apart, each line's chunks XORed with its
  // index mod 8.  Stages are loaded in increasing order, once each.
  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK;
    uint8_t* sa = sbase + stage * STAGE;
    uint8_t* sb = sa + A_BYTES;
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        const int kr = (tid >> 4) + i * (THREADS / 16);
        const bool ok = row[i] < rows;
        const uint32_t off =
            (cc >> 3) * BLOCK64 + kr * 128 + ((((cc & 7) ^ kr) & 7) << 4);
        const int na = ok ? a_bytes : 0;
        const int nb = ok ? b_bytes : 0;
        cp_async16(smem_addr(sa + off), na ? xe + ox[i] + m0 + 8 * cc : x,
                   na);
        cp_async16(smem_addr(sb + off), nb ? ye + oy[i] + n0 + 8 * cc : dy,
                   nb);
        // the same thread's row BK further on
        row[i] += BK;
        slot[i] += BK;
        ox[i] += BK * x_sc;
        oy[i] += BK * y_sc;
        while (slot[i] >= C) {
          slot[i] -= C;
          ox[i] += x_sb - (int64_t)C * x_sc;
          oy[i] += y_sb - (int64_t)C * y_sc;
        }
      }
    } else {
      const bf16 zero = __float2bfloat16_rn(0.f);
      const int col = tid & 127;              // this thread's column
#pragma unroll 4
      for (int j = 0; j < BK * 128 / THREADS; ++j) {
        const int kr = (tid >> 7) + j * (THREADS / 128);
        const int r = k0 + kr;
        bf16 va = zero, vb = zero;
        if (r < rows) {
          const int64_t b = r / C, c = r % C;
          if (m0 + col < D)
            va = xe[b * x_sb + c * x_sc + (int64_t)(m0 + col) * x_sd];
          if (n0 + col < F)
            vb = ye[b * y_sb + c * y_sc + (int64_t)(n0 + col) * y_sf];
        }
        const int off = (col >> 6) * BLOCK64 + sw128_offset(kr, col & 63);
        *reinterpret_cast<bf16*>(sa + off) = va;
        *reinterpret_cast<bf16*>(sb + off) = vb;
      }
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const int wg = tid >> 7;      // this warpgroup's 64 rows d of the tile

  // The forward's ring: stage kt % STAGES holds rows of tile kt, loaded
  // STAGES - 2 ahead, one wgmma group in flight.
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 3>();    // this thread's copies of tile kt
    fence_proxy_async();
    __syncthreads();                // everyone's copies of tile kt
    if (kt + STAGES - 2 < KT)
      load_stage((kt + STAGES - 2) % STAGES, kt + STAGES - 2);
    cp_async_commit();
    const uint32_t sa = base + (kt % STAGES) * STAGE;
    const uint32_t sb = sa + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // both MN-major, k16 step = 16 lines, 8-line groups 1024 bytes
      // apart (SBO): A this warpgroup's 64-wide block, B both blocks,
      // BLOCK64 apart (LBO)
      wgmma_m64n128k16<1, 1>(
          acc, sw128_desc(sa + wg * BLOCK64 + kk * 16 * 128, BLOCK64, 1024),
          sw128_desc(sb + kk * 16 * 128, BLOCK64, 1024));
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_acc(acc);
  cp_async_wait<0>();

  // Accumulator layout of m64nNk16: thread (warp w, lane l) of the
  // warpgroup holds rows 16 w + l / 4 (+ 8) and columns 8 j + 2 (l % 4)
  // (+ 1) of every 8-column group j.  dw is contiguous [E, D, F].
  const int warp = (tid & 127) >> 5;
  const int lane = tid & 31;
  const bool pairs = (F & 1) == 0;
  bf16* de = dw + (int64_t)e * D * F;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * half;
    if (m >= D) continue;
    bf16* drow = de + (int64_t)m * F;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane & 3);
      const float v0 = acc[4 * j + 2 * half];
      const float v1 = acc[4 * j + 2 * half + 1];
      if (pairs && n + 1 < F) {
        *reinterpret_cast<__nv_bfloat162*>(drow + n) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        if (n < F) drow[n] = __float2bfloat16_rn(v0);
        if (n + 1 < F) drow[n + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

struct DwArgs {
  const void* x;
  const void* dy;
  void* dw;
  int B, E, C, D, F;
  int64_t x_sb, x_se, x_sc, x_sd, y_sb, y_se, y_sc, y_sf;
  cudaStream_t stream;
};

int launch_dw_fma(const DwArgs& a) {
  const dim3 grid((a.F + FMA_BN - 1) / FMA_BN, (a.D + FMA_BM - 1) / FMA_BM,
                  a.E);
  if (grid.y > 65535) return -1;
  moe_dw_fma_kernel<<<grid, FMA_NT, 0, a.stream>>>(
      static_cast<const float*>(a.x), static_cast<const float*>(a.dy),
      static_cast<float*>(a.dw), a.C, a.D, a.F, a.B * a.C, a.x_sb, a.x_se,
      a.x_sc, a.x_sd, a.y_sb, a.y_se, a.y_sc, a.y_sf);
  return (int)cudaGetLastError();
}

template <bool VEC>
int launch_dw_wgmma(const DwArgs& a) {
  static unsigned smem_set = 0;
  auto kern = moe_dw_wgmma_kernel<VEC>;
  cudaError_t err = allow_smem(kern, SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.F + BN - 1) / BN, (a.D + BM - 1) / BM, a.E);
  if (grid.y > 65535) return -1;
  kern<<<grid, THREADS, SMEM, a.stream>>>(
      static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.dy),
      static_cast<bf16*>(a.dw), a.C, a.D, a.F, a.B * a.C, a.x_sb, a.x_se,
      a.x_sc, a.x_sd, a.y_sb, a.y_se, a.y_sc, a.y_sf);
  return (int)cudaGetLastError();
}

// The vector loader's condition: the 16-byte rule (common.cuh) on both
// operands, unit stride along D in x and along F in dy.
bool dw_vector_ok(const DwArgs& a) {
  return base16(a.x) && base16(a.dy) && (a.D == 1 || a.x_sd == 1) &&
         (a.F == 1 || a.y_sf == 1) && stride16(a.B, a.x_sb) &&
         stride16(a.E, a.x_se) && stride16(a.C, a.x_sc) &&
         stride16(a.B, a.y_sb) && stride16(a.E, a.y_se) &&
         stride16(a.C, a.y_sc);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, dy and dw share it).  vector (bf16
// only): 1 = 16-byte cp.async copies (refused with -1 for operands that
// dw_vector_ok rejects), 0 = the element-wise loader.  Strides are in
// elements.  x [B, E, C, D], dy [B, E, C, F], dw [E, D, F] contiguous.
// Requires every dimension >= 1, B * C < 2^31, E <= 65535.  Returns
// cudaGetLastError() after the launch (0 on success), -1 for arguments it
// does not take.  Launches on `stream`, does not synchronise, allocates
// nothing.
extern "C" int fate_moe_gemm_dw(const void* x, const void* dy, void* dw,
                                int B, int E, int C, int D, int F,
                                long long x_sb, long long x_se,
                                long long x_sc, long long x_sd,
                                long long y_sb, long long y_se,
                                long long y_sc, long long y_sf, int dtype,
                                int vector, void* stream) {
  if (B < 1 || E < 1 || C < 1 || D < 1 || F < 1 || E > 65535) return -1;
  if ((long long)B * C >= (1LL << 31)) return -1;
  const DwArgs a{x, dy, dw, B, E, C, D, F, x_sb, x_se, x_sc, x_sd,
                 y_sb, y_se, y_sc, y_sf, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_dw_fma(a);
  if (dtype != 1 || vector < 0 || vector > 1) return -1;
  if (vector) return dw_vector_ok(a) ? launch_dw_wgmma<true>(a) : -1;
  return launch_dw_wgmma<false>(a);
}
