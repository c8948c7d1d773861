// Chunked Mamba2 (SSD) scan for Hopper.  Replaces the TPU kernel
// src/repro/kernels/mamba2_scan.py :: mamba2_scan / _mamba_kernel.
//
// What it computes, per batch b and head h, with S the [P, N] float32
// state (initial state given, not zero as in the TPU kernel) and
// a = -exp(a_log[h]):
//   S_t = exp(dt_t a) S_{t-1} + dt_t x_t b_t^T,    y_t = S_t c_t
// in chunks of L steps: cum = inclusive cumulative sum of dt a over the
// chunk, total = cum[L-1];
//   y_i = sum_{j<=i} exp(cum_i - cum_j) dt_j (c_i . b_j) x_j
//         + exp(cum_i) S c_i,
//   S  <- exp(total) S + sum_j exp(total - cum_j) dt_j x_j b_j^T.
// dt >= 0 and a < 0, so every exponent formed here is <= 0.  The TPU body
// evaluates exp(cum_i - cum_j) over the whole [L, L] tile and masks after;
// above the diagonal that exponent is positive and can overflow to inf
// (and inf * 0 is NaN).  Here a pair with j > i never reaches the exp.
// cum is kept in float64: cum_i - cum_j is a difference of two prefix
// sums that reach |sum dt a| over the chunk (about 100 at zamba2's
// shapes), and in float32 its rounding error, about 1e-5, is a relative
// error of every decay weight: 1.9e-3 on outputs of magnitude ~100 at
// the serving shape, against the 5e-4 bar.  The scan is O(L) and the
// differences O(L^2 / 2) per chunk, against O(L^2 N) FMAs.
//
// Shape of both kernels.  The TPU grid (B*H, nChunks) carried the state
// in VMEM across sequential grid steps; here one block per (b, h) walks
// the chunks in a loop.  b and c are [B, S, N] and shared by the heads:
// every block reads them through their strides, so the [B*H, S, N]
// broadcast copy of the TPU wrapper is never made, and x, b, c may be
// column slices of one conv output (row stride d_inner + 2N).  dt is
// float32 [B, S, H]; dt * a is formed here.
//
// What bounds it.  At zamba2-2.7b's prefill (B 8, S 512, H 80, P = N =
// 64, L 128, bf16 x, b, c) the causal half of the products is about 11
// GFLOP, 0.011 ms at an H100's 989 TFLOP/s bf16 tensor-core peak, against
// about 107 MB of traffic (x and y, the states, dt, b, c), 0.032 ms at
// 3.35 TB/s: bytes bound it on the tensor cores (operations, 0.16 ms at
// 67 TFLOP/s, bound the float32 FMA kernel).
//
// bf16: tensor cores through mma.sync (m16n8k16, bf16 operands, float32
// sums).  A block takes two heads of one batch (they share the b and c
// tiles) with 8 warps each; a warp owns one 16-row block of a chunk of up
// to 128, the blocks paired so that the two warps of a head on one SM
// sub-partition hold a long and a short triangle (0 and 7, 1 and 6, ...).
// x, b and c stay bf16 in shared memory (rows padded by 16 bytes for
// conflict-free ldmatrix), loaded by 16-byte cp.async copies in two
// stages, so chunk t + 1 loads while chunk t computes.  The first warp of
// each head (the shortest triangle) scans dt * a in float64 a chunk ahead,
// after its own rows of y, and keeps cum as hi + lo floats: (hi_i - hi_j)
// + (lo_i - lo_j) is the difference to float32 precision relative to
// itself, as the float64 difference rounded once would be.  Per chunk,
// between three block-wide barriers:
//   1. per warp: y = exp(cum_i) (C S^T) + G X for its rows.  C is the A
//      operand (ldmatrix); S^T's B fragments come from the state's two
//      bf16 terms in shared memory.  C B^T is formed per 16-column block
//      up to the diagonal only (b through ldmatrix, as K in K1), turned in
//      registers into G_ij = s exp(cum_i - cum_j) dt_j for j <= i (0
//      above the diagonal; below the diagonal block as exp(cum_i -
//      cum_e) v_j with e the column block's last row and v_j = exp(cum_e
//      - cum_j) dt_j from the scan, so two exponentials per row and
//      block instead of one per pair; no positive exponent is formed),
//      and
//      G's C fragments are at once the A fragments of G X (x through
//      ldmatrix.trans), as p is in K1;
//   2. S <- exp(total) S + (w x)^T b with w_j = exp(total - cum_j) dt_j:
//      the [P, N] state is spread over a head's warps as 16 x 8 tiles
//      (16 x 32 per warp at P = N = 64) held in float32 registers for the
//      whole scan; x^T and b both through ldmatrix.trans.
// Precision: every float32 factor of a product is split into two bf16
// terms, hi = bf16(v) and lo = bf16(v - hi), and both are multiplied (G
// and w x as A operands, S for y as B operand): 16 bits of mantissa
// against the 5e-4 bar on the state, where one bf16 rounding of w x
// missed it 4x in a float64 emulation at the card test's shape.  x, b and
// c are bf16 inputs and exact.  Sums are in a fixed order (no atomics,
// nothing summed across heads), so a call's bits repeat.  (P, N) = (16,
// 8) takes the same kernel with N padded to 16 by zero columns.  Shared
// memory: 194,560 bytes at P = N = 64 (two stages of two heads' x and of
// b, c; each head's state terms and two chunks' cum, dt, w and v): one
// block of 16 warps per SM.
//
// float32: the FMA kernel of the first port, kept for the 5e-4 bar of the
// float32 sweep, which needs true float32 products.  256 threads as a
// 16 x 16 grid (ty, tx), each with a register tile.  Per chunk, between
// four block-wide barriers:
//   1. warp 0 scans dt * a (float64) with shuffles into cum, exp(cum)
//      and w = exp(total - cum) * dt; the other warps load the x, b, c
//      tiles, widened to float32;
//   2. scores G_ij = (c_i . b_j) exp(cum_i - cum_j) dt_j for j <= i, and 0
//      above the diagonal (rows ty + 16r, columns tx + 16c, c <= r only);
//   3. y = G x + (exp(cum) c) S^T, written to device memory;
//   4. S <- exp(total) S + (w x)^T b.
// Its shared memory is laid out for the longest chunk MAXL = 128 whatever
// L is (tile rows at or past L hold zeros): cum [MAXL] doubles, then in
// floats dt, exp(cum) and w [MAXL] each, S [P][N+1], x [MAXL][P], b and
// c [MAXL][N+1] and G [MAXL][MAXL+1]: 184,576 bytes at P = N = 64.  Rows
// of S, b, c and G are padded by one float, so that the 16 threads of a
// half-warp walking down a column hit 16 banks.  No bf16 input reaches it.
//
// Both kernels store y in the type the caller asks for (OT: float32, as
// the model keeps the scan's output, or bf16, the Pallas contract).
#include "common.cuh"

namespace {

using namespace fate;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// float32: FMA kernel
// ---------------------------------------------------------------------------

constexpr int NT = 256;          // 16 x 16 threads
constexpr int MAXL = 128;        // longest chunk
constexpr int RM = MAXL / 16;    // tile rows per thread

template <typename T, int P, int N, typename OT>
__global__ void __launch_bounds__(NT)
mamba2_scan_kernel(const T* __restrict__ x, const T* __restrict__ bm,
                   const T* __restrict__ cm, const float* __restrict__ dt,
                   const float* __restrict__ a_log, const float* state0,
                   OT* __restrict__ y, float* state_out, int H, int S, int L,
                   int64_t x_sb, int64_t x_ss, int64_t x_sh,
                   int64_t b_sb, int64_t b_ss, int64_t c_sb, int64_t c_ss,
                   int64_t dt_sb, int64_t dt_ss, int64_t dt_sh,
                   int64_t y_sb, int64_t y_ss, int64_t y_sh) {
  constexpr int NS = N + 1;          // row stride of S, b, c
  constexpr int GS = MAXL + 1;       // row stride of G
  constexpr int PC = P / 16;         // y columns / S rows per thread
  constexpr int NC = (N + 15) / 16;  // S columns per thread
  extern __shared__ double smem_d[];
  double* cum = smem_d;              // [MAXL] cumulative dt * a
  float* dts = reinterpret_cast<float*>(cum + MAXL);   // [MAXL] dt
  float* ecum = dts + MAXL;          // [MAXL] exp(cum)
  float* wdec = ecum + MAXL;         // [MAXL] exp(total - cum) * dt
  float* st = wdec + MAXL;           // [P][NS] state
  float* xs = st + P * NS;           // [MAXL][P]
  float* bs = xs + MAXL * P;         // [MAXL][NS]
  float* cs = bs + MAXL * NS;        // [MAXL][NS]
  float* gs = cs + MAXL * NS;        // [MAXL][GS] scores

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const T* xb = x + (int64_t)b * x_sb + (int64_t)h * x_sh;
  const T* bb = bm + (int64_t)b * b_sb;
  const T* cb = cm + (int64_t)b * c_sb;
  const float* db = dt + (int64_t)b * dt_sb + (int64_t)h * dt_sh;
  OT* yb = y + (int64_t)b * y_sb + (int64_t)h * y_sh;
  const float a = -expf(a_log[h]);
  const int64_t st_off = (int64_t)blockIdx.x * P * N;   // [B, H, P, N]
  const int JB = (L + 15) / 16;      // 16-column blocks of G in use

  for (int idx = tid; idx < P * N; idx += NT)
    st[(idx / N) * NS + idx % N] = state0[st_off + idx];

  for (int t0 = 0; t0 < S; t0 += L) {
    __syncthreads();   // the previous chunk is done with tiles and state
    if (tid < 32) {
      // inclusive scan of dt * a; steps at or past L add 0, so the last
      // carry is total = cum[L-1]
      double carry = 0.0;
      for (int base = 0; base < MAXL; base += 32) {
        const int i = base + tid;
        const float d = i < L ? db[(int64_t)(t0 + i) * dt_ss] : 0.f;
        double v = (double)(d * a);
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const double u = __shfl_up_sync(0xffffffffu, v, off);
          if (tid >= off) v += u;
        }
        v += carry;
        carry = __shfl_sync(0xffffffffu, v, 31);
        cum[i] = v;
        dts[i] = d;
      }
      for (int i = tid; i < MAXL; i += 32) {
        ecum[i] = i < L ? expf((float)cum[i]) : 0.f;
        wdec[i] = i < L ? expf((float)(carry - cum[i])) * dts[i] : 0.f;
      }
    } else {
      for (int idx = tid - 32; idx < MAXL * P; idx += NT - 32) {
        const int i = idx / P;
        xs[idx] = i < L ? to_float<T>(xb[(int64_t)(t0 + i) * x_ss + idx % P])
                        : 0.f;
      }
      for (int idx = tid - 32; idx < MAXL * N; idx += NT - 32) {
        const int i = idx / N;
        const int n = idx % N;
        const int64_t t = t0 + i;
        bs[i * NS + n] = i < L ? to_float<T>(bb[t * b_ss + n]) : 0.f;
        cs[i * NS + n] = i < L ? to_float<T>(cb[t * c_ss + n]) : 0.f;
      }
    }
    __syncthreads();

    // 2. scores on and below the diagonal
    {
      float acc[RM][RM];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c <= r; ++c) acc[r][c] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[RM], bv[RM];
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          cv[r] = cs[(ty + 16 * r) * NS + n];
          bv[r] = bs[(tx + 16 * r) * NS + n];
        }
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int c = 0; c <= r; ++c) acc[r][c] = fmaf(cv[r], bv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int i = ty + 16 * r;
#pragma unroll
        for (int c = 0; c < RM; ++c) {
          const int j = tx + 16 * c;
          float g = 0.f;
          if (c <= r && j <= i && i < L)
            g = acc[r][c] * expf((float)(cum[i] - cum[j])) * dts[j];
          gs[i * GS + j] = g;
        }
      }
    }
    __syncthreads();

    // 3. y_i = sum_{j<=i} G_ij x_j + (exp(cum_i) c_i) S^T
    {
      float acc[RM][PC];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < PC; ++c) acc[r][c] = 0.f;
      for (int jb = 0; jb < JB; ++jb) {
#pragma unroll 4
        for (int jj = 0; jj < 16; ++jj) {
          const int j = 16 * jb + jj;
          float xv[PC];
#pragma unroll
          for (int c = 0; c < PC; ++c) xv[c] = xs[j * P + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < RM; ++r) {
            if (r >= jb) {   // rows of blocks r < jb lie above the diagonal
              const float g = gs[(ty + 16 * r) * GS + j];
#pragma unroll
              for (int c = 0; c < PC; ++c) acc[r][c] = fmaf(g, xv[c], acc[r][c]);
            }
          }
        }
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[RM], sv[PC];
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const int i = ty + 16 * r;
          cv[r] = cs[i * NS + n] * ecum[i];
        }
#pragma unroll
        for (int c = 0; c < PC; ++c) sv[c] = st[(tx + 16 * c) * NS + n];
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int c = 0; c < PC; ++c) acc[r][c] = fmaf(cv[r], sv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int i = ty + 16 * r;
        if (i < L) {
#pragma unroll
          for (int c = 0; c < PC; ++c)
            yb[(int64_t)(t0 + i) * y_ss + tx + 16 * c] = from_float<OT>(acc[r][c]);
        }
      }
    }
    __syncthreads();   // every y has read the old state

    // 4. S <- exp(total) S + (w x)^T b; each thread owns its entries
    {
      const float decay = expf((float)cum[L - 1]);
      float acc[PC][NC];
#pragma unroll
      for (int rp = 0; rp < PC; ++rp)
#pragma unroll
        for (int cn = 0; cn < NC; ++cn) {
          const int n = tx + 16 * cn;
          acc[rp][cn] = n < N ? st[(ty + 16 * rp) * NS + n] * decay : 0.f;
        }
#pragma unroll 4
      for (int j = 0; j < L; ++j) {
        const float w = wdec[j];
        float xw[PC], bv[NC];
#pragma unroll
        for (int rp = 0; rp < PC; ++rp) xw[rp] = xs[j * P + ty + 16 * rp] * w;
#pragma unroll
        for (int cn = 0; cn < NC; ++cn) {
          const int n = tx + 16 * cn;
          bv[cn] = n < N ? bs[j * NS + n] : 0.f;
        }
#pragma unroll
        for (int rp = 0; rp < PC; ++rp)
#pragma unroll
          for (int cn = 0; cn < NC; ++cn)
            acc[rp][cn] = fmaf(xw[rp], bv[cn], acc[rp][cn]);
      }
#pragma unroll
      for (int rp = 0; rp < PC; ++rp)
#pragma unroll
        for (int cn = 0; cn < NC; ++cn) {
          const int n = tx + 16 * cn;
          if (n < N) st[(ty + 16 * rp) * NS + n] = acc[rp][cn];
        }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < P * N; idx += NT)
    state_out[st_off + idx] = st[(idx / N) * NS + idx % N];
}

size_t smem_bytes(int P, int N) {
  return sizeof(double) * MAXL +
         sizeof(float) * ((size_t)3 * MAXL + (size_t)P * (N + 1) +
                          (size_t)MAXL * P + 2 * (size_t)MAXL * (N + 1) +
                          (size_t)MAXL * (MAXL + 1));
}

// ---------------------------------------------------------------------------
// bf16: mma.sync kernel
// ---------------------------------------------------------------------------

constexpr int HEAD_WARPS = 8;   // warps per head, one 16-row block each
constexpr int HEADS = 2;        // heads per block, sharing the b, c tiles
constexpr int MMA_WARPS = HEADS * HEAD_WARPS;

template <int P, int N>
struct ScanTile {
  static constexpr int NP = N < 16 ? 16 : N;   // N padded to the k16 depth
  static constexpr int RX = P + 8;             // row strides (elements):
  static constexpr int RN = NP + 8;            // 16-byte pads
  // x of each head, then b and c
  static constexpr int STAGE = HEADS * MAXL * RX + 2 * MAXL * RN;
  static constexpr int SM = P * RN;            // one bf16 term of the state
  static constexpr int SCAN = 2 * MAXL * (16 + 4);   // per head, bytes
  static constexpr int SMEM = HEADS * SCAN + (2 * STAGE + 2 * HEADS * SM) * 2;
  // the state's 16 x 8 tiles, PER to a warp, all of a warp's in one row
  // block of 16
  static constexpr int TILES = (P / 16) * (N / 8);
  static constexpr int PER = (TILES + HEAD_WARPS - 1) / HEAD_WARPS;
  static_assert((N / 8) % PER == 0, "a warp's state tiles share a row block");
};

template <int P, int N, typename OT>
__global__ void __launch_bounds__(32 * MMA_WARPS, 1)
mamba2_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ bm,
                  const bf16* __restrict__ cm, const float* __restrict__ dt,
                  const float* __restrict__ a_log, const float* state0,
                  OT* __restrict__ y, float* state_out, int H, int S, int L,
                  int64_t x_sb, int64_t x_ss, int64_t x_sh,
                  int64_t b_sb, int64_t b_ss, int64_t c_sb, int64_t c_ss,
                  int64_t dt_sb, int64_t dt_ss, int64_t dt_sh,
                  int64_t y_sb, int64_t y_ss, int64_t y_sh) {
  using Tile = ScanTile<P, N>;
  constexpr int RX = Tile::RX;
  constexpr int RN = Tile::RN;
  constexpr int NP = Tile::NP;
  constexpr int PER = Tile::PER;
  constexpr int XC = P / 8;        // 16-byte chunks of an x row
  constexpr int NC = N / 8;        // ... of a b or c row
  constexpr int NTH = 32 * MMA_WARPS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;          // fragment row (and row + 8)
  const int col0 = 2 * (lane & 3);  // fragment columns col0, col0 + 1
  const int hs = warp / HEAD_WARPS;   // this warp's head slot
  const int lw = warp % HEAD_WARPS;
  // its 16-row block: warps lw and lw + 4 share an SM sub-partition, so
  // the longest triangle pairs with the shortest (0..3 -> 0..3, 4..7 ->
  // 7..4)
  const int rb = lw < 4 ? lw : 11 - lw;
  const int HP = (H + HEADS - 1) / HEADS;
  const int b = blockIdx.x / HP;
  const int h0 = (blockIdx.x % HP) * HEADS;   // the block's first head
  const int h = h0 + hs;
  const bool head_ok = h < H;                 // an odd H leaves one out
  const int hh = head_ok ? h : h0;

  extern __shared__ __align__(16) double smem_mma[];
  // per head, two chunks' (hi, lo, dt, w): cum as hi + lo floats, w_j =
  // exp(total - cum_j) dt_j
  float4* cd = reinterpret_cast<float4*>(
      reinterpret_cast<uint8_t*>(smem_mma) + hs * Tile::SCAN);
  // and two chunks' v_j = exp(cum_e - cum_j) dt_j, e the last row of j's
  // 16-row block
  float* vd = reinterpret_cast<float*>(cd + 2 * MAXL);
  bf16* stage0 = reinterpret_cast<bf16*>(
      reinterpret_cast<uint8_t*>(smem_mma) + HEADS * Tile::SCAN);   // 2 x STAGE
  bf16* s_hi = stage0 + 2 * Tile::STAGE + hs * 2 * Tile::SM;   // [P][RN]
  bf16* s_lo = s_hi + Tile::SM;                                // [P][RN]

  const bf16* bb = bm + (int64_t)b * b_sb;
  const bf16* cb = cm + (int64_t)b * c_sb;
  const float* db = dt + (int64_t)b * dt_sb + (int64_t)hh * dt_sh;
  OT* yb = y + (int64_t)b * y_sb + (int64_t)hh * y_sh;
  const float a = -expf(a_log[hh]);
  const int64_t st_off = ((int64_t)b * H + hh) * P * N;   // [B, H, P, N]

  // zero every tile once: pad columns and rows past L stay 0
  {
    uint4* p = reinterpret_cast<uint4*>(stage0);
    const int n16 = (2 * Tile::STAGE + 2 * HEADS * Tile::SM) * 2 / 16;
    for (int i = tid; i < n16; i += NTH) p[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  auto load_chunk = [&](int t0, int stg) {
    bf16* xs = stage0 + stg * Tile::STAGE;
    bf16* bs = xs + HEADS * MAXL * RX;
    bf16* cs = bs + MAXL * RN;
    for (int idx = tid; idx < HEADS * MAXL * XC; idx += NTH) {
      const int hx = idx / (MAXL * XC);
      const int i = idx / XC % MAXL;
      const int c = idx % XC;
      const bool ok = i < L && h0 + hx < H;
      const bf16* xr = x + (int64_t)b * x_sb + (int64_t)(h0 + hx) * x_sh +
                       (int64_t)(t0 + i) * x_ss + 8 * c;
      cp_async16(smem_addr(xs + (hx * MAXL + i) * RX + 8 * c), ok ? xr : x,
                 ok ? 16 : 0);
    }
    for (int idx = tid; idx < MAXL * NC; idx += NTH) {
      const int i = idx / NC;
      const int c = idx % NC;
      const bool ok = i < L;
      const int64_t t = t0 + i;
      cp_async16(smem_addr(bs + i * RN + 8 * c),
                 ok ? bb + t * b_ss + 8 * c : bm, ok ? 16 : 0);
      cp_async16(smem_addr(cs + i * RN + 8 * c),
                 ok ? cb + t * c_ss + 8 * c : cm, ok ? 16 : 0);
    }
  };
  load_chunk(0, 0);
  cp_async_commit();
  if (L < S) load_chunk(L, 1);
  cp_async_commit();

  // this warp's state tiles: 16 rows of P from row block srb, 8 columns
  // of N each from column tile snt; held in float32 registers throughout
  const int tile0 = lw * PER;
  const bool owner = head_ok && tile0 < Tile::TILES;
  const int srb = tile0 / (N / 8);
  const int snt = tile0 % (N / 8);
  float st[PER][4];
#pragma unroll
  for (int k = 0; k < PER; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = 16 * srb + g + 8 * (r >> 1);
      const int n = 8 * (snt + k) + col0 + (r & 1);
      st[k][r] = owner ? state0[st_off + (int64_t)p * N + n] : 0.f;
    }
  auto store_split_state = [&]() {
    if (!owner) return;
#pragma unroll
    for (int k = 0; k < PER; ++k)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        uint32_t hi, lo;
        split_pack(st[k][2 * hr], st[k][2 * hr + 1], hi, lo);
        const int off = (16 * srb + g + 8 * hr) * RN + 8 * (snt + k) + col0;
        *reinterpret_cast<uint32_t*>(s_hi + off) = hi;
        *reinterpret_cast<uint32_t*>(s_lo + off) = lo;
      }
  };
  store_split_state();

  // the first warp of each head (its row block is the shortest) scans
  // dt * a a chunk ahead, in float64 with shuffles, from dt it loaded a
  // chunk before that; steps at or past L add 0, so the last carry is
  // total = cum[L-1].  cum reaches about -100 over a chunk at zamba2's
  // shapes, so it is kept as hi + lo floats: the difference
  // (hi_i - hi_j) + (lo_i - lo_j) keeps float32 precision relative to
  // itself, where a float32 prefix sum would not
  const bool scanner = lw == 0 && head_ok;
  float dtn[MAXL / 32];
  auto load_dt = [&](int t0) {
#pragma unroll
    for (int q = 0; q < MAXL / 32; ++q) {
      const int i = 32 * q + lane;
      dtn[q] = (i < L && t0 < S) ? db[(int64_t)(t0 + i) * dt_ss] : 0.f;
    }
  };
  auto scan_chunk = [&](int buf) {
    double carry = 0.0;
    double v[MAXL / 32];
#pragma unroll
    for (int q = 0; q < MAXL / 32; ++q) {
      v[q] = (double)(dtn[q] * a);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, v[q], off);
        if (lane >= off) v[q] += u;
      }
      v[q] += carry;
      carry = __shfl_sync(0xffffffffu, v[q], 31);
    }
#pragma unroll
    for (int q = 0; q < MAXL / 32; ++q) {
      const int i = 32 * q + lane;
      const float hi = (float)v[q];
      const double end = __shfl_sync(0xffffffffu, v[q], lane | 15);
      cd[buf * MAXL + i] = make_float4(
          hi, (float)(v[q] - (double)hi), dtn[q],
          i < L ? expf((float)(carry - v[q])) * dtn[q] : 0.f);
      vd[buf * MAXL + i] = expf((float)(end - v[q])) * dtn[q];
    }
  };
  if (scanner) {
    load_dt(0);
    scan_chunk(0);
    load_dt(L);
  }

  for (int t0 = 0, stg = 0; t0 < S; t0 += L, stg ^= 1) {
    cp_async_wait<1>();
    __syncthreads();   // this chunk's scan and tiles are visible
    const float4* cdc = cd + stg * MAXL;
    const float* vdc = vd + stg * MAXL;

    const bf16* xs = stage0 + stg * Tile::STAGE + hs * MAXL * RX;
    const bf16* bs = stage0 + stg * Tile::STAGE + HEADS * MAXL * RX;
    const bf16* cs = bs + MAXL * RN;

    // y for this warp's 16 rows
    if (head_ok && 16 * rb < L) {
      const int r0 = 16 * rb;
      uint32_t cf[NP / 16][4];
#pragma unroll
      for (int kk = 0; kk < NP / 16; ++kk)
        ldsm_x4(cf[kk], smem_addr(cs + (r0 + (lane & 15)) * RN + 16 * kk +
                                  8 * (lane >> 4)));
      const int i_row[2] = {r0 + g, r0 + g + 8};
      const float4 cd_i[2] = {cdc[i_row[0]], cdc[i_row[1]]};
      float acc[P / 8][4];
#pragma unroll
      for (int j = 0; j < P / 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;
      const float e_i[2] = {expf(cd_i[0].x), expf(cd_i[1].x)};
      // exp(cum_i) C S^T, S as its two bf16 terms
#pragma unroll
      for (int kk = 0; kk < NP / 16; ++kk)
#pragma unroll
        for (int term = 0; term < 2; ++term)
#pragma unroll
          for (int pt = 0; pt < P / 16; ++pt) {
            uint32_t bf[4];
            ldsm_x4(bf, smem_addr((term ? s_lo : s_hi) +
                                  (16 * pt + (lane & 7) + 8 * (lane >> 4)) * RN +
                                  16 * kk + 8 * ((lane >> 3) & 1)));
            mma_bf16(acc[2 * pt], cf[kk], bf[0], bf[1]);
            mma_bf16(acc[2 * pt + 1], cf[kk], bf[2], bf[3]);
          }
#pragma unroll
      for (int j = 0; j < P / 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[j][r] *= e_i[r >> 1];
      // + G X over the 16-column blocks up to the diagonal
      for (int tb = 0; tb <= rb; ++tb) {
        float s[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) s[j][r] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NP / 16; ++kk) {
          uint32_t bf[4];
          ldsm_x4(bf, smem_addr(bs + (16 * tb + (lane & 7) + 8 * (lane >> 4)) * RN +
                                16 * kk + 8 * ((lane >> 3) & 1)));
          mma_bf16(s[0], cf[kk], bf[0], bf[1]);
          mma_bf16(s[1], cf[kk], bf[2], bf[3]);
        }
        // G_ij = (c_i . b_j) exp(cum_i - cum_j) dt_j for j <= i < L, no
        // exponent above 0 formed.  Below the diagonal block it factors
        // through the block's last row e: exp(cum_i - cum_e) (one per
        // row) times v_j = exp(cum_e - cum_j) dt_j (one per column, from
        // the scan), both exponents <= 0; on it, pair by pair.
        if (tb < rb) {
          const float4 ce = cdc[16 * tb + 15];
          float u[2];
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
            u[hr] = i_row[hr] < L
                        ? __expf(fminf((cd_i[hr].x - ce.x) + (cd_i[hr].y - ce.y), 0.f))
                        : 0.f;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              s[j][r] *= u[r >> 1] * vdc[16 * tb + 8 * j + col0 + (r & 1)];
        } else {
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int i = i_row[r >> 1];
              const int jj = 16 * tb + 8 * j + col0 + (r & 1);
              const float4 c = cdc[jj];
              const float4 ci = cd_i[r >> 1];
              s[j][r] = (jj <= i && i < L)
                            ? s[j][r] * __expf(fminf((ci.x - c.x) + (ci.y - c.y), 0.f)) * c.z
                            : 0.f;
            }
        }
        uint32_t ah[4], al[4];
        split_pack(s[0][0], s[0][1], ah[0], al[0]);
        split_pack(s[0][2], s[0][3], ah[1], al[1]);
        split_pack(s[1][0], s[1][1], ah[2], al[2]);
        split_pack(s[1][2], s[1][3], ah[3], al[3]);
#pragma unroll
        for (int pd = 0; pd < P / 16; ++pd) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, smem_addr(xs + (16 * tb + (lane & 7) +
                                            8 * ((lane >> 3) & 1)) * RX +
                                      8 * (2 * pd + (lane >> 4))));
          mma_bf16(acc[2 * pd], ah, bf[0], bf[1]);
          mma_bf16(acc[2 * pd + 1], ah, bf[2], bf[3]);
          mma_bf16(acc[2 * pd], al, bf[0], bf[1]);
          mma_bf16(acc[2 * pd + 1], al, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = i_row[hr];
        if (i >= L) continue;
        OT* yrow = yb + (int64_t)(t0 + i) * y_ss;
#pragma unroll
        for (int j = 0; j < P / 8; ++j)
          store2(yrow + 8 * j + col0, acc[j][2 * hr], acc[j][2 * hr + 1]);
      }
    }
    if (scanner && t0 + L < S) {   // the next chunk's scan, off the path
      scan_chunk(stg ^ 1);
      load_dt(t0 + 2 * L);
    }
    __syncthreads();   // every y has read the old state's bf16 terms

    // S <- exp(total) S + (w x)^T b: (w x) as two bf16 terms, x^T through
    // ldmatrix.trans, b through ldmatrix.trans
    if (owner) {
      const float decay = expf(cdc[L - 1].x);
#pragma unroll
      for (int k = 0; k < PER; ++k)
#pragma unroll
        for (int r = 0; r < 4; ++r) st[k][r] *= decay;
      for (int kj = 0; 16 * kj < L; ++kj) {
        uint32_t xf[4];
        ldsm_x4_trans(xf, smem_addr(xs + (16 * kj + (lane & 7) + 8 * (lane >> 4)) * RX +
                                    16 * srb + 8 * ((lane >> 3) & 1)));
        const int j0 = 16 * kj + col0;
        const float w0 = cdc[j0].w, w1 = cdc[j0 + 1].w, w8 = cdc[j0 + 8].w,
                    w9 = cdc[j0 + 9].w;
        uint32_t ah[4], al[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 v = unpack_bf16(xf[q]);
          const bool hi8 = q >= 2;   // a2, a3 hold depth columns + 8
          split_pack(v.x * (hi8 ? w8 : w0), v.y * (hi8 ? w9 : w1), ah[q],
                     al[q]);
        }
#pragma unroll
        for (int k2 = 0; k2 < (PER + 1) / 2; ++k2) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, smem_addr(bs + (16 * kj + (lane & 7) +
                                            8 * ((lane >> 3) & 1)) * RN +
                                      8 * (snt + 2 * k2 + (lane >> 4))));
          mma_bf16(st[2 * k2], ah, bf[0], bf[1]);
          mma_bf16(st[2 * k2], al, bf[0], bf[1]);
          if (2 * k2 + 1 < PER) {
            mma_bf16(st[2 * k2 + 1], ah, bf[2], bf[3]);
            mma_bf16(st[2 * k2 + 1], al, bf[2], bf[3]);
          }
        }
      }
      store_split_state();
    }
    __syncthreads();   // the new state's terms are written; this stage is free
    if (t0 + 2 * L < S) load_chunk(t0 + 2 * L, stg);
    cp_async_commit();
  }
  cp_async_wait<0>();
  if (owner) {
#pragma unroll
    for (int k = 0; k < PER; ++k)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = 16 * srb + g + 8 * (r >> 1);
        const int n = 8 * (snt + k) + col0 + (r & 1);
        state_out[st_off + (int64_t)p * N + n] = st[k][r];
      }
  }
}

struct ScanArgs {
  const void *x, *b, *c;
  const float *dt, *a_log, *state0;
  void* y;
  float* state_out;
  int B, S, H, L;
  int64_t x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss, dt_sb, dt_ss, dt_sh;
  int64_t y_sb, y_ss, y_sh;
  bool out_f32;   // y float32, else bf16
  cudaStream_t stream;
};

template <typename T, int P, int N, typename OT>
int launch_scan(const ScanArgs& a) {
  // the dynamic shared-memory ceiling is raised once per instantiation
  static bool granted = false;
  const size_t bytes = smem_bytes(P, N);
  if (!granted) {
    cudaError_t err = cudaFuncSetAttribute(
        mamba2_scan_kernel<T, P, N, OT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    granted = true;
  }
  mamba2_scan_kernel<T, P, N, OT><<<a.B * a.H, NT, bytes, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.b),
      static_cast<const T*>(a.c), a.dt, a.a_log, a.state0,
      static_cast<OT*>(a.y), a.state_out, a.H, a.S, a.L, a.x_sb, a.x_ss,
      a.x_sh, a.b_sb, a.b_ss, a.c_sb, a.c_ss, a.dt_sb, a.dt_ss, a.dt_sh,
      a.y_sb, a.y_ss, a.y_sh);
  return (int)cudaGetLastError();
}

template <int P, int N, typename OT>
int launch_scan_mma(const ScanArgs& a) {
  static unsigned smem_set = 0;
  auto kern = mamba2_mma_kernel<P, N, OT>;
  cudaError_t err = allow_smem(kern, ScanTile<P, N>::SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int blocks = a.B * ((a.H + HEADS - 1) / HEADS);
  kern<<<blocks, 32 * MMA_WARPS, ScanTile<P, N>::SMEM, a.stream>>>(
      static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.b),
      static_cast<const bf16*>(a.c), a.dt, a.a_log, a.state0,
      static_cast<OT*>(a.y), a.state_out, a.H, a.S, a.L, a.x_sb, a.x_ss,
      a.x_sh, a.b_sb, a.b_ss, a.c_sb, a.c_ss, a.dt_sb, a.dt_ss, a.dt_sh,
      a.y_sb, a.y_ss, a.y_sh);
  return (int)cudaGetLastError();
}

int dispatch_fma(const ScanArgs& a, int P, int N) {
  if (P == 16 && N == 8)
    return a.out_f32 ? launch_scan<float, 16, 8, float>(a)
                     : launch_scan<float, 16, 8, bf16>(a);
  if (P == 64 && N == 64)
    return a.out_f32 ? launch_scan<float, 64, 64, float>(a)
                     : launch_scan<float, 64, 64, bf16>(a);
  return -1;
}

int dispatch_mma(const ScanArgs& a, int P, int N) {
  if (P == 16 && N == 8)
    return a.out_f32 ? launch_scan_mma<16, 8, float>(a)
                     : launch_scan_mma<16, 8, bf16>(a);
  if (P == 64 && N == 64)
    return a.out_f32 ? launch_scan_mma<64, 64, float>(a)
                     : launch_scan_mma<64, 64, bf16>(a);
  return -1;
}

// The bf16 kernel's 16-byte copies: the 16-byte rule (common.cuh) on x, b
// and c (column slices of the conv output pass it); its pair stores of y:
// an 8-byte aligned base and even strides.
bool aligned_for_mma(const ScanArgs& a) {
  return base16(a.x) && base16(a.b) && base16(a.c) &&
         reinterpret_cast<uintptr_t>(a.y) % 8 == 0 &&
         stride16(a.B, a.x_sb) && stride16(a.S, a.x_ss) &&
         stride16(a.H, a.x_sh) && stride16(a.B, a.b_sb) &&
         stride16(a.S, a.b_ss) && stride16(a.B, a.c_sb) &&
         stride16(a.S, a.c_ss) && (a.y_sb | a.y_ss | a.y_sh) % 2 == 0;
}

}  // namespace

// dtype: 0 = float32 (the FMA kernel), 1 = bfloat16 (the mma.sync
// kernel, which needs aligned_for_mma), for x, b and c; out_dtype, the
// same codes, for y; dt, a_log, state0 and state_out are float32.  x and y are [B, S, H, P], b and c
// [B, S, N], dt [B, S, H], all with the given strides (in elements; the
// last dimension of x, b, c and y has stride 1); a_log is a contiguous
// [H], state0 and state_out contiguous [B, H, P, N] (they may be the same
// buffer).  Takes (P, N) in {(16, 8), (64, 64)}, 1 <= L <= 128 and
// S % L == 0.  Returns cudaGetLastError() after the launch (0 on
// success), -1 for arguments (or a bf16 alignment) it does not take.  Launches on `stream`, does
// not synchronise, allocates nothing.
extern "C" int fate_mamba2_scan(
    const void* x, const void* b, const void* c, const void* dt,
    const void* a_log, const void* state0, void* y, void* state_out,
    int B, int S, int H, int P, int N, int L,
    long long x_sb, long long x_ss, long long x_sh,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    long long dt_sb, long long dt_ss, long long dt_sh,
    long long y_sb, long long y_ss, long long y_sh, int dtype, int out_dtype,
    void* stream) {
  if (B < 1 || H < 1 || S < 1 || L < 1 || L > MAXL || S % L != 0) return -1;
  if (out_dtype != 0 && out_dtype != 1) return -1;
  ScanArgs a{x, b, c,
             static_cast<const float*>(dt), static_cast<const float*>(a_log),
             static_cast<const float*>(state0), y,
             static_cast<float*>(state_out), B, S, H, L,
             x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss, dt_sb, dt_ss, dt_sh,
             y_sb, y_ss, y_sh, out_dtype == 0,
             static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_fma(a, P, N);
  if (dtype == 1) return aligned_for_mma(a) ? dispatch_mma(a, P, N) : -1;
  return -1;
}
