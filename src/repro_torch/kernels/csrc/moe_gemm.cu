// Grouped per-expert GEMM for Hopper: out[b, e] = x[b, e] @ w[e] for
// every expert e, float32 accumulation, rounded to the input type at the
// store.  Replaces the TPU kernel src/repro/kernels/moe_gemm.py ::
// moe_gemm / _moe_kernel.
//
// What it computes.  x [B, E, C, D] (the MoE layer's capacity-padded
// per-sample dispatch blocks), w [E, D, F] -> out [B, E, C, F].  The TPU
// kernel took [E, C, D] and was called once per sample by vmap; here the
// batch axis is read through its stride and the B*C rows (b, c) of one
// expert form one row range (row r: b = r / C, c = r % C), so each block
// loads its slice of the expert's weights once for all samples, and the
// strided view the model hands over (its dispatch buffer minus the
// dropped-token slot) is read as it lies: nothing is copied.  Dims need
// not be tile multiples.
//
// What bounds it on an NVIDIA H100 SXM (data-sheet rates, 700 W power
// limit).  At granite-moe's prefill (B*C = 1024 rows per expert) one call
// does 64.4 GFLOP and moves 230 MB once, about 280 flops per byte: the
// card's bf16 ridge is 295, so operations (0.065 ms at 989 TFLOP/s) and
// bytes (0.069 ms at 3.35 TB/s) bound it alike, and only the tensor
// cores can reach either.  At its decode (B*C = 64 or 32) the 63 MB of
// bf16 expert weights must be read once: bytes bound it (0.022 ms).
//
// bf16: warpgroup tensor cores fed by a cp.async ring.  One block owns a
// BM x 128 output tile of one expert: BM = 128 (two warpgroups, 64 rows
// each) where an expert has >= 256 rows, else BM = 64 (one warpgroup).
// Each warpgroup issues wgmma.mma_async m64n128k16 with both operands in
// shared memory and 64 float32 accumulators per thread.  x is the K-major
// A operand; w [D, F] with F contiguous is an MN-major B operand, taken
// through the descriptor's transpose bit, so the weights are never
// transposed or copied.  Depth goes in stages of 64 through a ring of 4
// shared-memory stages, laid out in the 128-byte swizzle the descriptors
// name (a 64-element row segment is one 128-byte line, its 16-byte chunks
// XORed with the line index mod 8: no bank conflicts).  Every thread
// issues 16-byte cp.async copies two stages ahead of the one the tensor
// cores read, and one wgmma group stays in flight while the next stage
// is waited for, so loads overlap the products.  Rows beyond B*C, depth
// beyond D and columns beyond F are zero-filled by the copies (source
// size below 16).  Operands whose rows are not 16-byte aligned (odd D or
// F, a weight with F not contiguous) take an element-wise loader that
// writes the same swizzled layout, and the same pipeline runs on it.
// There is no split-K: every output sums its k16 steps in increasing
// depth with the same instruction in both tile shapes, so a sample's
// rows do not depend on what else is in the call.  The tile shape and the
// loader are chosen in Python (kernels/moe_gemm.py :: gemm_plan) and
// passed as a code; this file refuses the vector loader for operands it
// cannot read that way.
//
// Left undone: a persistent grid (granite's decode gate/up has 160 blocks
// for 132 SMs), warp specialisation with a TMA producer for the regular w
// operand, and skipping empty capacity rows (at decode about 97 % of the
// [B, E, 8] slots are empty, but the call is bound by the weights' bytes,
// which every expert needs).
//
// float32: the FMA kernel of the first port, kept for the 1e-5 relative
// bar, which needs true float32 products (TF32 would miss it).  Grid
// (F / 64, B*C / 64, E), 256 threads with 4 x 4 outputs each, depth in
// steps of 16 through shared memory.  No bf16 input reaches it.
//
// K3's input gradient, dx[b, e] = dy[b, e] [C, F] . w[e]^T -> [B, E, C, D],
// is this kernel too: it replaces no TPU kernel (the reference
// differentiates the einsums of src/repro/models/moe.py:104-109).  The
// caller passes dy as x and w's transpose [E, F, D] as w, whose
// contraction (the weight's F) is contiguous.  In bf16 the wgmma kernel
// then reads w K-major (template KB, plan bit 2): each of the tile's 128
// output columns d is one 128-byte swizzled line of 64 depth elements, read
// by 16-byte copies along w's rows as A is read, and the transpose bit of
// B is clear; the element-wise loader reading w through swapped strides
// would give the same numbers but read w a column at a time.  Bound as the
// forward: at granite's training microbatch (2048 rows an expert) a call
// is 128.8 GFLOP over 399 MB, operations bound (0.130 ms).  In float32 the
// FMA kernel takes w's swapped strides as they are.  The weight gradient
// is csrc/moe_gemm_bwd.cu.
#include "common.cuh"

namespace {

using namespace fate;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// float32: FMA kernel
// ---------------------------------------------------------------------------

constexpr int FMA_BM = 64;    // rows (b, c) of one expert per block
constexpr int FMA_BN = 64;    // output columns per block
constexpr int FMA_BK = 16;    // contraction depth per shared-memory stage
constexpr int FMA_NT = 256;   // a 16 x 16 grid of threads, 4 x 4 outputs each
constexpr int FMA_LOADS = FMA_BM * FMA_BK / FMA_NT;   // elements per thread

static_assert(FMA_BM * FMA_BK == FMA_BK * FMA_BN, "A and B tiles load alike");

__global__ void __launch_bounds__(FMA_NT)
moe_gemm_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ out, int C, int D, int F, int rows,
                    int64_t x_sb, int64_t x_se, int64_t x_sc, int64_t x_sd,
                    int64_t w_se, int64_t w_sd, int64_t w_sf,
                    int64_t o_sb, int64_t o_se, int64_t o_sc) {
  __shared__ float As[FMA_BK][FMA_BM + 4];
  __shared__ float Bs[FMA_BK][FMA_BN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n0 = blockIdx.x * FMA_BN;
  const int r0 = blockIdx.y * FMA_BM;
  const int e = blockIdx.z;
  const float* xe = x + (int64_t)e * x_se;
  const float* we = w + (int64_t)e * w_se;

  // the A elements this thread loads: row m of the tile, depth a_k
  int64_t a_row[FMA_LOADS];
  int a_m[FMA_LOADS], a_k[FMA_LOADS];
  bool a_ok[FMA_LOADS];
#pragma unroll
  for (int i = 0; i < FMA_LOADS; ++i) {
    const int idx = tid + i * FMA_NT;
    a_m[i] = idx / FMA_BK;
    a_k[i] = idx % FMA_BK;
    const int r = r0 + a_m[i];
    a_ok[i] = r < rows;
    const int b = a_ok[i] ? r / C : 0;
    const int c = a_ok[i] ? r % C : 0;
    a_row[i] = (int64_t)b * x_sb + (int64_t)c * x_sc;
  }
  // the B elements: depth b_k, column b_n
  int b_k[FMA_LOADS], b_n[FMA_LOADS];
#pragma unroll
  for (int i = 0; i < FMA_LOADS; ++i) {
    const int idx = tid + i * FMA_NT;
    b_k[i] = idx / FMA_BN;
    b_n[i] = idx % FMA_BN;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += FMA_BK) {
#pragma unroll
    for (int i = 0; i < FMA_LOADS; ++i) {
      const int kx = k0 + a_k[i];
      As[a_k[i]][a_m[i]] =
          (a_ok[i] && kx < D) ? xe[a_row[i] + (int64_t)kx * x_sd] : 0.f;
      const int kw = k0 + b_k[i];
      const int n = n0 + b_n[i];
      Bs[b_k[i]][b_n[i]] =
          (kw < D && n < F) ? we[(int64_t)kw * w_sd + (int64_t)n * w_sf] : 0.f;
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

  float* oe = out + (int64_t)e * o_se;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= rows) continue;
    const int b = r / C;
    const int c = r % C;
    float* orow = oe + (int64_t)b * o_sb + (int64_t)c * o_sc;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < F) orow[n] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma kernel
// ---------------------------------------------------------------------------

constexpr int BN = 128;        // output columns per block (the wgmma's N)
constexpr int BK = 64;         // depth per stage: one 128-byte swizzle line
constexpr int STAGES = 4;      // shared-memory ring
constexpr int B_BYTES = BK * BN * 2;
constexpr int B_HALF = BK * 64 * 2;   // one 64-column half of the B stage

template <int BM>
struct Tile {
  static constexpr int THREADS = 2 * BM;            // BM / 64 warpgroups
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + alignment slack
};

// KB (K3's input gradient): w is read K-major, w[e] an [F, D] operand with
// its D (the contraction) contiguous, as the weight [E, F, D] of the
// forward is when dX = dY . w^T takes its rows: B is 128 lines of 64
// depth elements, like A, and the transpose bit of B is clear.
template <int BM, bool VEC, bool KB>
__global__ void __launch_bounds__(Tile<BM>::THREADS, 1)
moe_gemm_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      bf16* __restrict__ out, int C, int D, int F, int rows,
                      int64_t x_sb, int64_t x_se, int64_t x_sc, int64_t x_sd,
                      int64_t w_se, int64_t w_sd, int64_t w_sf,
                      int64_t o_sb, int64_t o_se, int64_t o_sc) {
  constexpr int T = Tile<BM>::THREADS;
  constexpr int A_BYTES = Tile<BM>::A_BYTES;
  constexpr int STAGE = Tile<BM>::STAGE;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // the swizzle atom's size
  uint8_t* sbase = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int r0 = blockIdx.y * BM;
  const int e = blockIdx.z;
  const bf16* xe = x + (int64_t)e * x_se;
  const bf16* we = w + (int64_t)e * w_se;
  const int KT = (D + BK - 1) / BK;

  // Vector loader: this thread's fixed 16-byte chunk column in A (a_c)
  // and in B (b_cc; K-major: a_c as in A), its A rows' offsets, its B
  // columns' byte count.
  constexpr int A_PT = BM * 8 / T;       // A chunks per thread (4)
  constexpr int B_PT = BK * 16 / T;      // B chunks per thread (8 or 4)
  const int a_c = tid & 7;
  const int b_cc = tid & 15;
  const int b_n = n0 + 8 * b_cc;
  const int b_bytes = max(0, min(16, (F - b_n) * 2));
  static_assert(BK * 16 == BN * 8, "both B layouts take B_PT chunks");
  int64_t a_off[A_PT];
  bool a_ok[A_PT];
#pragma unroll
  for (int i = 0; i < A_PT; ++i) {
    const int r = r0 + (tid >> 3) + i * (T / 8);
    a_ok[i] = r < rows;
    const int b = a_ok[i] ? r / C : 0;
    const int c = a_ok[i] ? r % C : 0;
    a_off[i] = (int64_t)b * x_sb + (int64_t)c * x_sc;
  }

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK;
    uint8_t* sa = sbase + stage * STAGE;
    uint8_t* sb = sa + A_BYTES;
    if constexpr (VEC) {
      const int ka = k0 + 8 * a_c;
      const int ka_bytes = max(0, min(16, (D - ka) * 2));
#pragma unroll
      for (int i = 0; i < A_PT; ++i) {
        const int m = (tid >> 3) + i * (T / 8);
        const int nb = a_ok[i] ? ka_bytes : 0;
        const bf16* src = nb ? xe + a_off[i] + ka : x;
        cp_async16(smem_addr(sa + m * 128 + (((a_c ^ m) & 7) << 4)), src, nb);
      }
      if constexpr (KB) {
        // line n of the tile: w[e] row n0 + n, its depth ka.. contiguous
#pragma unroll
        for (int i = 0; i < B_PT; ++i) {
          const int n = (tid >> 3) + i * (T / 8);
          const int nb = (n0 + n < F) ? ka_bytes : 0;
          const bf16* src = nb ? we + (int64_t)(n0 + n) * w_sf + ka : w;
          cp_async16(smem_addr(sb + n * 128 + (((a_c ^ n) & 7) << 4)), src,
                     nb);
        }
      } else {
#pragma unroll
        for (int i = 0; i < B_PT; ++i) {
          const int kr = (tid >> 4) + i * (T / 16);
          const int nb = (k0 + kr < D) ? b_bytes : 0;
          const bf16* src = nb ? we + (int64_t)(k0 + kr) * w_sd + b_n : w;
          cp_async16(smem_addr(sb + (b_cc >> 3) * B_HALF + kr * 128 +
                               ((((b_cc & 7) ^ kr) & 7) << 4)),
                     src, nb);
        }
      }
    } else {
      const bf16 zero = __float2bfloat16_rn(0.f);
      const int k = tid & 63;                 // this thread's A column
#pragma unroll 4
      for (int j = 0; j < BM * BK / T; ++j) {
        const int m = (tid >> 6) + j * (T / 64);
        const int r = r0 + m;
        bf16 val = zero;
        if (r < rows && k0 + k < D)
          val = xe[(int64_t)(r / C) * x_sb + (int64_t)(r % C) * x_sc +
                   (int64_t)(k0 + k) * x_sd];
        *reinterpret_cast<bf16*>(sa + sw128_offset(m, k)) = val;
      }
      if constexpr (KB) {
#pragma unroll 4
        for (int j = 0; j < BK * BN / T; ++j) {
          const int n = (tid >> 6) + j * (T / 64);   // k: A's column
          bf16 val = zero;
          if (k0 + k < D && n0 + n < F)
            val = we[(int64_t)(k0 + k) * w_sd + (int64_t)(n0 + n) * w_sf];
          *reinterpret_cast<bf16*>(sb + sw128_offset(n, k)) = val;
        }
      } else {
        const int n = tid & 127;              // this thread's B column
#pragma unroll 4
        for (int j = 0; j < BK * BN / T; ++j) {
          const int kr = (tid >> 7) + j * (T / 128);
          bf16 val = zero;
          if (k0 + kr < D && n0 + n < F)
            val = we[(int64_t)(k0 + kr) * w_sd + (int64_t)(n0 + n) * w_sf];
          *reinterpret_cast<bf16*>(sb + (n >> 6) * B_HALF +
                                   sw128_offset(kr, n & 63)) = val;
        }
      }
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const int wg = tid >> 7;      // this warpgroup's 64 rows of the tile

  // Ring: stage kt % STAGES holds depth tile kt.  Tiles are loaded
  // STAGES - 2 ahead; one wgmma group stays in flight, so the stage
  // written at iteration kt (tile kt + 2) was last read by tile kt - 2,
  // whose group every warpgroup retired before this iteration's barrier.
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
      // A: this warpgroup's 64 lines, k16 step = 32 bytes along the line;
      // B: two 64-column halves B_HALF apart (LBO), 8-deep line groups
      // 1024 bytes apart (SBO), k16 step = 16 lines; K-major B: 128 lines
      // as A's, 8-line groups 1024 bytes apart
      const uint64_t da = sw128_desc(sa + wg * 64 * 128 + kk * 32, 16, 1024);
      if constexpr (KB) {
        wgmma_m64n128k16<0, 0>(acc, da,
                               sw128_desc(sb + kk * 32, 16, 1024));
      } else {
        wgmma_m64n128k16<0, 1>(
            acc, da, sw128_desc(sb + kk * 16 * 128, B_HALF, 1024));
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_acc(acc);
  cp_async_wait<0>();

  // Accumulator layout of m64nNk16: thread (warp w, lane l) of the
  // warpgroup holds rows 16 w + l / 4 (+ 8) and columns 8 j + 2 (l % 4)
  // (+ 1) of every 8-column group j.
  const int warp = (tid & 127) >> 5;
  const int lane = tid & 31;
  const bool pairs = ((o_sb | o_se | o_sc) & 1) == 0 &&
                     (reinterpret_cast<uintptr_t>(out) & 3) == 0;
  bf16* oe = out + (int64_t)e * o_se;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * half;
    if (r >= rows) continue;
    bf16* orow = oe + (int64_t)(r / C) * o_sb + (int64_t)(r % C) * o_sc;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane & 3);
      const float v0 = acc[4 * j + 2 * half];
      const float v1 = acc[4 * j + 2 * half + 1];
      if (pairs && n + 1 < F) {
        *reinterpret_cast<__nv_bfloat162*>(orow + n) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        if (n < F) orow[n] = __float2bfloat16_rn(v0);
        if (n + 1 < F) orow[n + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

struct GemmArgs {
  const void* x;
  const void* w;
  void* out;
  int B, E, C, D, F;
  int64_t x_sb, x_se, x_sc, x_sd, w_se, w_sd, w_sf, o_sb, o_se, o_sc;
  cudaStream_t stream;
};

int launch_fma(const GemmArgs& a) {
  const int rows = a.B * a.C;
  const dim3 grid((a.F + FMA_BN - 1) / FMA_BN, (rows + FMA_BM - 1) / FMA_BM,
                  a.E);
  if (grid.y > 65535) return -1;
  moe_gemm_fma_kernel<<<grid, FMA_NT, 0, a.stream>>>(
      static_cast<const float*>(a.x), static_cast<const float*>(a.w),
      static_cast<float*>(a.out), a.C, a.D, a.F, rows, a.x_sb, a.x_se,
      a.x_sc, a.x_sd, a.w_se, a.w_sd, a.w_sf, a.o_sb, a.o_se, a.o_sc);
  return (int)cudaGetLastError();
}

template <int BM, bool VEC, bool KB>
int launch_wgmma(const GemmArgs& a) {
  static unsigned smem_set = 0;
  auto kern = moe_gemm_wgmma_kernel<BM, VEC, KB>;
  cudaError_t err = allow_smem(kern, Tile<BM>::SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int rows = a.B * a.C;
  const dim3 grid((a.F + BN - 1) / BN, (rows + BM - 1) / BM, a.E);
  if (grid.y > 65535) return -1;
  kern<<<grid, Tile<BM>::THREADS, Tile<BM>::SMEM, a.stream>>>(
      static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.w),
      static_cast<bf16*>(a.out), a.C, a.D, a.F, rows, a.x_sb, a.x_se,
      a.x_sc, a.x_sd, a.w_se, a.w_sd, a.w_sf, a.o_sb, a.o_se, a.o_sc);
  return (int)cudaGetLastError();
}

// The vector loader's condition: the 16-byte rule (common.cuh) on both
// operands, unit stride along D in x and along F in w (along D in a
// K-major w).
bool vector_ok(const GemmArgs& a, bool kb) {
  const bool w_ok = kb ? (a.D == 1 || a.w_sd == 1) && stride16(a.F, a.w_sf)
                       : (a.F == 1 || a.w_sf == 1) && stride16(a.D, a.w_sd);
  return base16(a.x) && base16(a.w) && (a.D == 1 || a.x_sd == 1) && w_ok &&
         stride16(a.B, a.x_sb) && stride16(a.E, a.x_se) &&
         stride16(a.C, a.x_sc) && stride16(a.E, a.w_se);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it).  plan (bf16
// only): bit 0 = the 128-row tile (else 64 rows), bit 1 = the element-wise
// loader (else 16-byte cp.async copies, refused with -1 for operands that
// vector_ok rejects), bit 2 = w read K-major (K3's input gradient: w the
// transposed view of a weight whose rows hold the contraction; the FMA
// kernel takes any strides, so float32 needs no bit).  Strides are in
// elements; out's last dimension has stride 1.  x [B, E, C, D], w [E, D,
// F], out [B, E, C, F].  Requires every
// dimension >= 1, B * C < 2^31, at most 65535 row tiles and E <= 65535.
// Returns cudaGetLastError() after the launch (0 on success), -1 for
// arguments it does not take.  Launches on `stream`, does not
// synchronise, allocates nothing.
extern "C" int fate_moe_gemm(const void* x, const void* w, void* out, int B,
                             int E, int C, int D, int F, long long x_sb,
                             long long x_se, long long x_sc, long long x_sd,
                             long long w_se, long long w_sd, long long w_sf,
                             long long o_sb, long long o_se, long long o_sc,
                             int dtype, int plan, void* stream) {
  if (B < 1 || E < 1 || C < 1 || D < 1 || F < 1 || E > 65535) return -1;
  if ((long long)B * C >= (1LL << 31)) return -1;
  const GemmArgs a{x, w, out, B, E, C, D, F, x_sb, x_se, x_sc, x_sd,
                   w_se, w_sd, w_sf, o_sb, o_se, o_sc,
                   static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_fma(a);
  if (dtype != 1 || plan < 0 || plan > 7) return -1;
  const bool wide = plan & 1;
  const bool element = plan & 2;
  const bool kb = plan & 4;
  if (!element && !vector_ok(a, kb)) return -1;
  if (kb) {
    if (wide)
      return element ? launch_wgmma<128, false, true>(a)
                     : launch_wgmma<128, true, true>(a);
    return element ? launch_wgmma<64, false, true>(a)
                   : launch_wgmma<64, true, true>(a);
  }
  if (wide)
    return element ? launch_wgmma<128, false, false>(a)
                   : launch_wgmma<128, true, false>(a);
  return element ? launch_wgmma<64, false, false>(a)
                 : launch_wgmma<64, true, false>(a);
}
