// Chunked RWKV6 ("Finch") scan with per-channel data-dependent decay, for
// Hopper.  Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py ::
// rwkv6_scan / _rwkv_kernel.
//
// What it computes, per batch b and head h, with S the [D, D] float32
// state (initial state given, not zero as in the TPU kernel):
//   out_t = r_t S_{t-1} + (r_t . (bonus * k_t)) v_t
//   S_t   = diag(w_t) S_{t-1} + k_t v_t^T,    w clipped to [1e-8, 1]
// in chunks of L steps: lw = log(w), ci = inclusive and ce = exclusive
// cumulative sums of lw over the chunk, total = ci[L-1];
//   out_i = (r_i * exp(ce_i)) S + sum_{j<i} score_ij v_j + diag_i v_i,
//   score_ij = sum_k r_ik k_jk exp(ce_ik - ci_jk),
//   diag_i = sum_k r_ik bonus_k k_ik,
//   S <- exp(total) * S + (k * exp(total - ci))^T v.
// The exponent ce_i - ci_j is a sum of log decays over (j, i), always <= 0.
// A factorised exp(ce_i) * exp(-ci_j) overflows under strong decay (w =
// 1e-6, log w = -13.8 per step); no exponent formed here is positive.
// Both kernels store out in the type the caller asks for (OT: float32, as
// the model keeps the scan's output, or bf16, the Pallas contract).
//
// Shape of both kernels.  The TPU grid (B*H, nChunks) carried the state in
// VMEM across sequential grid steps; here one block per (b, h) walks the
// chunks in a loop.
//
// What bounds it.  At rwkv6-3b's prefill (B 8, S 512, H 40, D 64, L 32,
// bf16 r, k, v, float32 w and out) bytes do: about 157 MB (r, k, v, w
// and out once, the two states), 0.047 ms at an H100's 3.35 TB/s, against
// about 8 GFLOP of tensor-core products with their split terms, 0.008 ms
// at 989 TFLOP/s.  Under them lies the exp floor: about 1.4e8 MUFU
// operations in this design (the diagonal blocks' pairs, the factors, the
// logs), near 0.04 ms at 16 per clock per SM.  So the products go to the tensor cores, the loads
// overlap the compute, every exp of the factored terms is taken once per
// element, and all 320 blocks of the serving shape are resident at once.
//
// bf16: tensor cores through mma.sync (m16n8k16, bf16 operands, float32
// sums).  A block of 4 warps (8 at D = 128; at most 68,640 bytes of shared
// memory at D = 64, L = 32: three blocks per SM).  r, k, v stay bf16 in
// shared memory (rows padded by 16 bytes for conflict-free ldmatrix),
// loaded by 16-byte cp.async copies in two stages (one where two do not
// fit: D = 128, L > 48), so chunk t + 1 loads while chunk t computes; w
// (float32) in one buffer that the next chunk's copy refills once the
// cumulative sums have read it.  A chunk is cut into 16-row sub-chunks a,
// starting at row a0 (Lp = L rounded up to 16; rows at or past L are
// zero-filled and take log w = 0, which leaves the state alone).  Per
// chunk, between four block-wide barriers:
//   1. one thread per channel takes log2(clip(w)) and cum[i + 1] =
//      sum_{s <= i} log2 w_s in float32 (ce_i = cum[i], ci_i = cum[i + 1];
//      base 2, so that every exponential below is one MUFU ex2; lg2.approx
//      errs by under 2^-22 absolute, below the bars' reach);
//   2. scores into shared memory.  Below the diagonal 8 x 8 blocks they
//      are factored through a boundary row e, exp(ce_i - ci_j) =
//      exp(ce_i - ce_e) * exp(ce_e - ci_j), both exponents <= 0 for j < e
//      <= i: the 16 x 16 blocks of sub-chunk a against earlier sub-chunks
//      through its first row a0, and its rows 8..15 against its columns
//      0..7 through row a0 + 8; each as q~ k~^T on the tensor cores, q~ =
//      r * exp(ce - ce_e) and k~ = k * exp(ce_e - ci) built in registers
//      (a factor underflows to 0 only where the true weight is below
//      float32's smallest value).  The diagonal 8 x 8 blocks go pair by
//      pair on the CUDA cores in float32 with the clamp exp(min(ce_i -
//      ci_j, 0)) (a factored exponent inside the block could pass 88 and
//      overflow), with the bonus on the diagonal: 36 pairs a block over
//      all threads, four channels a step.  8-row blocks and not 16: the
//      pairs are half as many, and the probe (tools/kernel_probe.py
//      rwkv6-phases) priced the pairwise part at 0.10 of 0.25 ms with
//      16-row blocks;
//   3. per warp, units of 16 rows and D/2 columns (16 at D <= 32): out =
//      (r * exp(ce)) S + scores v, S's B fragments from its two bf16
//      terms in shared memory (ldmatrix.trans), v through ldmatrix.trans;
//   4. S <- exp(total) S + (k * exp(total - ci))^T v: the [D, D] state is
//      spread over the warps as 16 x 8 tiles (one 16-row block per warp at
//      D = 64) held in float32 registers for the whole scan, the factor
//      built from k and cum in registers, v through ldmatrix.trans; after
//      the last barrier each warp writes its tiles' two bf16 terms for the
//      next chunk's step 3.
// Precision: every float32 factor of a product is split into two bf16
// terms, hi = bf16(x) and lo = bf16(x - hi); a product of two float32
// factors takes hi.hi + hi.lo + lo.hi, of a float32 factor and an exact
// bf16 input (v) both terms: 16 bits of mantissa against the 5e-4 bar on
// the state.  Sums are in a fixed order (no atomics), so a call's bits
// repeat.
//
// float32: the FMA kernel of the first port, kept for the 5e-4 bar of the
// float32 sweep, which needs true float32 products.  256 threads; per
// chunk the [L, D] tiles of r, k, v and log(clip(w)) (rows padded to D + 1
// floats), one thread per channel takes the cumulative sums, one thread per
// (i, j) pair reduces the score over k in registers, then r and k are
// rescaled in place, each thread produces (i, c) outputs from the old
// state (in shared memory) and the scores and updates its (k, c) entries
// of the state: six block-wide barriers per chunk, every operand read
// from shared memory.  No bf16 input reaches it.
#include "common.cuh"

namespace {

using namespace fate;

constexpr int NT = 256;

template <int D, typename OT>
__global__ void __launch_bounds__(NT)
rwkv6_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ bonus,
                  const float* __restrict__ state0, OT* __restrict__ out,
                  float* __restrict__ state_out, int H, int S, int L,
                  int64_t r_sb, int64_t r_ss, int64_t r_sh,
                  int64_t k_sb, int64_t k_ss, int64_t k_sh,
                  int64_t v_sb, int64_t v_ss, int64_t v_sh,
                  int64_t w_sb, int64_t w_ss, int64_t w_sh,
                  int64_t o_sb, int64_t o_ss, int64_t o_sh) {
  constexpr int DP = D + 1;   // padded row stride of the [L, D] tiles
  extern __shared__ float smem[];
  float* st = smem;            // [D][D] state
  float* rs = st + D * D;      // [L][DP] r, then r * exp(ce)
  float* ks = rs + L * DP;     // [L][DP] k, then k * exp(total - ci)
  float* vs = ks + L * DP;     // [L][DP] v
  float* ce = vs + L * DP;     // [L][DP] log w, then exclusive cumsum
  float* ci = ce + L * DP;     // [L][DP] inclusive cumsum
  float* sc = ci + L * DP;     // [L][L] scores, diagonal = bonus term
  float* bon = sc + L * L;     // [D]

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const float* rb = r + (int64_t)b * r_sb + (int64_t)h * r_sh;
  const float* kb = k + (int64_t)b * k_sb + (int64_t)h * k_sh;
  const float* vb = v + (int64_t)b * v_sb + (int64_t)h * v_sh;
  const float* wb = w + (int64_t)b * w_sb + (int64_t)h * w_sh;
  OT* ob = out + (int64_t)b * o_sb + (int64_t)h * o_sh;
  const int64_t st_off = (int64_t)blockIdx.x * D * D;   // [B, H, D, D]

  for (int idx = tid; idx < D * D; idx += NT) st[idx] = state0[st_off + idx];
  for (int d = tid; d < D; d += NT) bon[d] = bonus[(int64_t)h * D + d];

  for (int t0 = 0; t0 < S; t0 += L) {
    __syncthreads();   // the previous chunk is done with the tiles
    for (int idx = tid; idx < L * D; idx += NT) {
      const int i = idx / D;
      const int d = idx % D;
      const int64_t t = t0 + i;
      rs[i * DP + d] = rb[t * r_ss + d];
      ks[i * DP + d] = kb[t * k_ss + d];
      vs[i * DP + d] = vb[t * v_ss + d];
      ce[i * DP + d] = logf(fminf(fmaxf(wb[t * w_ss + d], 1e-8f), 1.f));
    }
    __syncthreads();
    for (int d = tid; d < D; d += NT) {
      float run = 0.f;
      for (int i = 0; i < L; ++i) {
        const float lw = ce[i * DP + d];
        ce[i * DP + d] = run;
        run += lw;
        ci[i * DP + d] = run;
      }
    }
    __syncthreads();
    // scores: one (i, j) pair per thread and pass, reduced over k here
    for (int idx = tid; idx < L * L; idx += NT) {
      const int i = idx / L;
      const int j = idx % L;
      float s = 0.f;
      if (j < i) {
#pragma unroll 8
        for (int kk = 0; kk < D; ++kk) {
          const float dec = expf(fminf(ce[i * DP + kk] - ci[j * DP + kk], 0.f));
          s = fmaf(rs[i * DP + kk] * ks[j * DP + kk], dec, s);
        }
      } else if (j == i) {
#pragma unroll 8
        for (int kk = 0; kk < D; ++kk)
          s = fmaf(rs[i * DP + kk] * bon[kk], ks[i * DP + kk], s);
      }
      sc[idx] = s;
    }
    __syncthreads();
    for (int idx = tid; idx < L * D; idx += NT) {
      const int i = idx / D;
      const int d = idx % D;
      const float total = ci[(L - 1) * DP + d];
      rs[i * DP + d] *= expf(ce[i * DP + d]);
      ks[i * DP + d] *= expf(total - ci[i * DP + d]);
    }
    __syncthreads();
    // out_i = (r_i * exp(ce_i)) S + sum_{j<=i} score_ij v_j
    for (int idx = tid; idx < L * D; idx += NT) {
      const int i = idx / D;
      const int c = idx % D;
      float o = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < D; ++kk)
        o = fmaf(rs[i * DP + kk], st[kk * D + c], o);
      for (int j = 0; j <= i; ++j) o = fmaf(sc[i * L + j], vs[j * DP + c], o);
      ob[(int64_t)(t0 + i) * o_ss + c] = from_float<OT>(o);
    }
    __syncthreads();   // every output has read the old state
    // S <- exp(total) * S + (k * exp(total - ci))^T v
    for (int idx = tid; idx < D * D; idx += NT) {
      const int kk = idx / D;
      const int c = idx % D;
      float s = st[idx] * expf(ci[(L - 1) * DP + kk]);
      for (int j = 0; j < L; ++j) s = fmaf(ks[j * DP + kk], vs[j * DP + c], s);
      st[idx] = s;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < D * D; idx += NT) state_out[st_off + idx] = st[idx];
}

size_t smem_bytes_fma(int D, int L) {
  return sizeof(float) *
         ((size_t)D * D + 5 * (size_t)L * (D + 1) + (size_t)L * L + D);
}

// ---------------------------------------------------------------------------
// bf16: mma.sync kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

template <int D>
struct MmaTile {
  static constexpr int NW = D >= 128 ? 8 : 4;     // warps
  static constexpr int MIN_BLOCKS = D >= 128 ? 1 : 3;
  static constexpr int RS = D + 8;   // row stride (elements) of the bf16
                                     // tiles and of cum: 16-byte pads
  // output columns of a unit of 16 rows, and units per row block
  static constexpr int NCOL = D >= 64 ? D / 2 : 16;
  static constexpr int CSPLIT = D / NCOL;
  // the state's 16 x 8 tiles, PER to a warp, all of a warp's in one row
  // block of 16
  static constexpr int TILES = (D / 16) * (D / 8);
  static constexpr int PER = (TILES + NW - 1) / NW;
  static_assert((D / 8) % PER == 0, "a warp's state tiles share a row block");
};

// Byte offsets of the block's shared memory (kernels/rwkv6_scan.py ::
// smem_bytes mirrors it), Lp = L rounded up to 16.
struct MmaLayout {
  int lp;
  size_t rkv, s_terms, w, cum, sc, bonus, total;
};

inline __host__ __device__ MmaLayout mma_layout(int D, int L, int stages) {
  MmaLayout m;
  m.lp = (L + 15) / 16 * 16;
  const size_t rs = D + 8;
  m.rkv = 0;                                              // [stages][3][Lp][RS] bf16
  m.s_terms = m.rkv + 2 * (size_t)stages * 3 * m.lp * rs; // 2 x [D][RS] bf16
  m.w = m.s_terms + 2 * 2 * (size_t)D * rs;               // [Lp][D] float
  m.cum = m.w + 4 * (size_t)m.lp * D;                     // [Lp+1][RS] float
  m.sc = m.cum + 4 * (size_t)(m.lp + 1) * rs;             // [Lp][Lp+4] float
  m.bonus = m.sc + 4 * (size_t)m.lp * (m.lp + 4);         // [D] float
  m.total = m.bonus + 4 * (size_t)D;
  return m;
}

constexpr size_t SMEM_LIMIT = 232448;

// MUFU's base-2 exponential and logarithm (.approx.ftz): the mma kernel
// keeps its log decays in base 2, so an exponential is one instruction
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float log2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

inline int mma_stages(int D, int L) {
  return mma_layout(D, L, 2).total <= SMEM_LIMIT ? 2 : 1;
}

template <int D, typename OT>
__global__ void __launch_bounds__(32 * MmaTile<D>::NW, MmaTile<D>::MIN_BLOCKS)
rwkv6_mma_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ bonus, const float* state0,
                 OT* __restrict__ out, float* state_out, int H, int S, int L,
                 int stages,
                 int64_t r_sb, int64_t r_ss, int64_t r_sh,
                 int64_t k_sb, int64_t k_ss, int64_t k_sh,
                 int64_t v_sb, int64_t v_ss, int64_t v_sh,
                 int64_t w_sb, int64_t w_ss, int64_t w_sh,
                 int64_t o_sb, int64_t o_ss, int64_t o_sh) {
  using Tile = MmaTile<D>;
  constexpr int NW = Tile::NW;
  constexpr int NTH = 32 * NW;
  constexpr int RS = Tile::RS;
  constexpr int NCOL = Tile::NCOL;
  constexpr int PER = Tile::PER;
  constexpr int DC = D / 8;         // 16-byte pieces of a bf16 row
  constexpr int WC = D / 4;         // ... of a float row

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;          // fragment row (and row + 8)
  const int col0 = 2 * (lane & 3);  // fragment columns col0, col0 + 1
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;

  const MmaLayout lay = mma_layout(D, L, stages);
  const int LP = lay.lp;
  const int NSUB = LP / 16;         // 16-row sub-chunks
  const int SCS = LP + 4;           // row stride of the scores
  extern __shared__ __align__(16) float smem_mma[];
  uint8_t* base = reinterpret_cast<uint8_t*>(smem_mma);
  bf16* rkv = reinterpret_cast<bf16*>(base + lay.rkv);
  bf16* s_hi = reinterpret_cast<bf16*>(base + lay.s_terms);   // [D][RS]
  bf16* s_lo = s_hi + D * RS;
  float* ws = reinterpret_cast<float*>(base + lay.w);         // [Lp][D]
  float* cum = reinterpret_cast<float*>(base + lay.cum);      // [Lp+1][RS]
  float* sc = reinterpret_cast<float*>(base + lay.sc);        // [Lp][SCS]
  float* bon = reinterpret_cast<float*>(base + lay.bonus);    // [D]

  const bf16* rb = r + (int64_t)b * r_sb + (int64_t)h * r_sh;
  const bf16* kb = k + (int64_t)b * k_sb + (int64_t)h * k_sh;
  const bf16* vb = v + (int64_t)b * v_sb + (int64_t)h * v_sh;
  const float* wb = w + (int64_t)b * w_sb + (int64_t)h * w_sh;
  OT* ob = out + (int64_t)b * o_sb + (int64_t)h * o_sh;
  const int64_t st_off = (int64_t)blockIdx.x * D * D;   // [B, H, D, D]

  // scores above the diagonal stay 0; cum's row 0 is the empty sum
  for (int i = tid; i < LP * SCS; i += NTH) sc[i] = 0.f;
  for (int d = tid; d < D; d += NTH) {
    bon[d] = bonus[(int64_t)h * D + d];
    cum[d] = 0.f;
  }

  // rows at or past L are zero-filled: r = k = v = 0 leave the outputs'
  // rows that are never stored and the state alone
  auto load_rkv = [&](int t0, int stg) {
    bf16* dst = rkv + stg * 3 * LP * RS;
    const int c = tid % DC;
#pragma unroll
    for (int which = 0; which < 3; ++which) {
      const bf16* src = which == 0 ? rb : which == 1 ? kb : vb;
      const int64_t ss = which == 0 ? r_ss : which == 1 ? k_ss : v_ss;
      for (int i = tid / DC; i < LP; i += NTH / DC) {
        const bool ok = i < L;
        cp_async16(smem_addr(dst + (which * LP + i) * RS + 8 * c),
                   ok ? src + (int64_t)(t0 + i) * ss + 8 * c : r, ok ? 16 : 0);
      }
    }
  };
  auto load_w = [&](int t0) {
    const int c = tid % WC;
    for (int i = tid / WC; i < LP; i += NTH / WC) {
      const bool ok = i < L;
      cp_async16(smem_addr(ws + i * D + 4 * c),
                 ok ? wb + (int64_t)(t0 + i) * w_ss + 4 * c : w, ok ? 16 : 0);
    }
  };
  load_rkv(0, 0);
  load_w(0);
  cp_async_commit();
  if (stages == 2 && L < S) load_rkv(L, 1);
  cp_async_commit();

  // this warp's state tiles: 16 rows from row block srb, 8 columns each
  // from column tile snt; held in float32 registers for the whole scan
  const int tile0 = warp * PER;
  const bool owner = tile0 < Tile::TILES;
  const int srb = tile0 / (D / 8);
  const int snt = tile0 % (D / 8);
  float st[PER][4];
#pragma unroll
  for (int q = 0; q < PER; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 16 * srb + g + 8 * (e >> 1);
      const int n = 8 * (snt + q) + col0 + (e & 1);
      st[q][e] = owner ? state0[st_off + (int64_t)m * D + n] : 0.f;
    }
  auto store_split_state = [&]() {
    if (!owner) return;
#pragma unroll
    for (int q = 0; q < PER; ++q)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        uint32_t hi, lo;
        split_pack(st[q][2 * hr], st[q][2 * hr + 1], hi, lo);
        const int off = (16 * srb + g + 8 * hr) * RS + 8 * (snt + q) + col0;
        *reinterpret_cast<uint32_t*>(s_hi + off) = hi;
        *reinterpret_cast<uint32_t*>(s_lo + off) = lo;
      }
  };
  store_split_state();

  for (int t0 = 0, stg = 0; t0 < S; t0 += L, stg = stages == 2 ? stg ^ 1 : 0) {
    if (stages == 2) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();   // B1: this chunk's tiles and w, the state's terms
    const bf16* rs = rkv + stg * 3 * LP * RS;
    const bf16* ks = rs + LP * RS;
    const bf16* vs = ks + LP * RS;

    // 1. cum[i + 1] = sum_{s <= i} log2(clip(w_s)), one thread per
    // channel; rows at or past L add 0, so cum[Lp] is the chunk's total
    // (8 rows' w loaded before any store: the stores to cum could alias)
    if (tid < D) {
      float run = 0.f;
      for (int i0 = 0; i0 < LP; i0 += 8) {
        float lw[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) lw[q] = ws[(i0 + q) * D + tid];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float l2 = log2_approx(fminf(fmaxf(lw[q], 1e-8f), 1.f));
          run += i0 + q < L ? l2 : 0.f;
          cum[(i0 + q + 1) * RS + tid] = run;
        }
      }
    }
    __syncthreads();   // B2: cum is complete, w's buffer free
    if (t0 + L < S) load_w(t0 + L);
    cp_async_commit();

    // 2a. scores below the diagonal 8 x 8 blocks, factored through a
    // boundary row e: exp(ce_i - ci_j) = exp(ce_i - ce_e) * exp(ce_e -
    // ci_j), both exponents <= 0 for j < e <= i.  Units: the 16 x 16 block
    // of row sub-chunk a and column sub-chunk c < a, e = 16 a; and per
    // sub-chunk the 8 x 8 block of its rows 8..15 and columns 0..7, e =
    // 16 a + 8 (the fragment's rows g + 8 carry zeros).  q~ k~^T on the
    // tensor cores, q~ = r * exp(ce - ce_e) and k~ = k * exp(ce_e - ci)
    // built in registers, each as hi + lo bf16 terms (hi.hi + hi.lo +
    // lo.hi)
    const int n_off = NSUB * (NSUB - 1) / 2;
    for (int u = warp; u < n_off + NSUB; u += NW) {
      int e, c0, nnt;
      bool half;
      if (u < n_off) {
        int a = 1, c = u;
        while (c >= a) { c -= a; ++a; }
        e = 16 * a; c0 = 16 * c; nnt = 2; half = false;
      } else {
        e = 16 * (u - n_off) + 8; c0 = e - 8; nnt = 1; half = true;
      }
      float s[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (half && (q & 1)) {
            ah[q] = al[q] = 0u;
            continue;
          }
          const int i = e + g + 8 * (q & 1);
          const int kc = 16 * kk + col0 + 8 * (q >> 1);
          const float2 rr = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(rs + i * RS + kc));
          const float2 ce = *reinterpret_cast<const float2*>(cum + i * RS + kc);
          const float2 e0 = *reinterpret_cast<const float2*>(cum + e * RS + kc);
          split_pack(rr.x * exp2_approx(fminf(ce.x - e0.x, 0.f)),
                     rr.y * exp2_approx(fminf(ce.y - e0.y, 0.f)), ah[q], al[q]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          if (nt >= nnt) break;
          uint32_t bh[2], bl[2];
          const int j = c0 + 8 * nt + g;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int kc = 16 * kk + col0 + 8 * hf;
            const float2 kv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(ks + j * RS + kc));
            const float2 ci =
                *reinterpret_cast<const float2*>(cum + (j + 1) * RS + kc);
            const float2 e0 =
                *reinterpret_cast<const float2*>(cum + e * RS + kc);
            split_pack(kv.x * exp2_approx(fminf(e0.x - ci.x, 0.f)),
                       kv.y * exp2_approx(fminf(e0.y - ci.y, 0.f)), bh[hf],
                       bl[hf]);
          }
          mma_bf16(s[nt], al, bh[0], bh[1]);
          mma_bf16(s[nt], ah, bl[0], bl[1]);
          mma_bf16(s[nt], ah, bh[0], bh[1]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          if (nt < nnt && !(half && hr))
            *reinterpret_cast<float2*>(
                sc + (e + g + 8 * hr) * SCS + c0 + 8 * nt + col0) =
                make_float2(s[nt][2 * hr], s[nt][2 * hr + 1]);
    }

    // 2b. the diagonal 8 x 8 blocks, pair by pair in float32 on the CUDA
    // cores: exp(min(ce_i - ci_j, 0)) for j < i (a factored exponent could
    // overflow inside the block), the bonus term for j = i; 36 pairs a
    // block spread over all threads from the last warp down (the first
    // warps also take the factored units), four channels a step in four
    // sums, each pair starting on its own channel so that a warp's loads
    // spread over the banks
    for (int p = NTH - 1 - tid; p < NSUB * 72; p += NTH) {
      const int a0 = 8 * (p / 36);
      const int q = p % 36;
      int ii = (int)((sqrtf(8.f * q + 1.f) - 1.f) * 0.5f);
      if ((ii + 1) * (ii + 2) / 2 <= q) ++ii;
      if (ii * (ii + 1) / 2 > q) --ii;
      const int i = a0 + ii;
      const int j = a0 + q - ii * (ii + 1) / 2;
      const int k0 = (4 * p) & (D - 1);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      if (i < L) {
        const bf16* ri = rs + i * RS;
        const bf16* kj = ks + j * RS;
        const float* cei = cum + i * RS;
        const float* cij = cum + (j + 1) * RS;
#pragma unroll 4
        for (int kx = 0; kx < D; kx += 4) {
          const int kc = (k0 + kx) & (D - 1);
          const uint2 r4 = *reinterpret_cast<const uint2*>(ri + kc);
          const uint2 k4 = *reinterpret_cast<const uint2*>(kj + kc);
          const float2 r01 = unpack_bf16(r4.x), r23 = unpack_bf16(r4.y);
          const float2 k01 = unpack_bf16(k4.x), k23 = unpack_bf16(k4.y);
          float4 f;
          if (j < i) {
            const float4 ce = *reinterpret_cast<const float4*>(cei + kc);
            const float4 ci = *reinterpret_cast<const float4*>(cij + kc);
            f = make_float4(exp2_approx(fminf(ce.x - ci.x, 0.f)),
                            exp2_approx(fminf(ce.y - ci.y, 0.f)),
                            exp2_approx(fminf(ce.z - ci.z, 0.f)),
                            exp2_approx(fminf(ce.w - ci.w, 0.f)));
          } else {
            f = *reinterpret_cast<const float4*>(bon + kc);
          }
          acc[0] = fmaf(r01.x * k01.x, f.x, acc[0]);
          acc[1] = fmaf(r01.y * k01.y, f.y, acc[1]);
          acc[2] = fmaf(r23.x * k23.x, f.z, acc[2]);
          acc[3] = fmaf(r23.y * k23.y, f.w, acc[3]);
        }
      }
      sc[i * SCS + j] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
    __syncthreads();   // B3: the scores are complete

    // 3. out = (r * exp(ce)) S + scores v, per unit of 16 rows and NCOL
    // columns: (r * exp(ce)) and S as hi + lo terms (hi.hi + hi.lo +
    // lo.hi), the scores as hi + lo against the exact bf16 v
    for (int u = warp; u < NSUB * Tile::CSPLIT; u += NW) {
      const int a = u / Tile::CSPLIT;
      const int a0 = 16 * a;
      const int n0 = (u % Tile::CSPLIT) * NCOL;
      float acc[NCOL / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {   // (r * exp(ce)) S
        uint32_t ah[4], al[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = a0 + g + 8 * (q & 1);
          const int kc = 16 * kk + col0 + 8 * (q >> 1);
          const float2 rr = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(rs + i * RS + kc));
          const float2 ce = *reinterpret_cast<const float2*>(cum + i * RS + kc);
          split_pack(rr.x * exp2_approx(ce.x), rr.y * exp2_approx(ce.y), ah[q], al[q]);
        }
#pragma unroll
        for (int pd = 0; pd < NCOL / 16; ++pd) {
          const int off = (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * RS +
                          n0 + 8 * (2 * pd + (lane >> 4));
          uint32_t bh[4], bl[4];
          ldsm_x4_trans(bh, smem_addr(s_hi + off));
          ldsm_x4_trans(bl, smem_addr(s_lo + off));
          mma_bf16(acc[2 * pd], al, bh[0], bh[1]);
          mma_bf16(acc[2 * pd + 1], al, bh[2], bh[3]);
          mma_bf16(acc[2 * pd], ah, bl[0], bl[1]);
          mma_bf16(acc[2 * pd + 1], ah, bl[2], bl[3]);
          mma_bf16(acc[2 * pd], ah, bh[0], bh[1]);
          mma_bf16(acc[2 * pd + 1], ah, bh[2], bh[3]);
        }
      }
      for (int cb = 0; cb <= a; ++cb) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 sv = *reinterpret_cast<const float2*>(
              sc + (a0 + g + 8 * (q & 1)) * SCS + 16 * cb + col0 +
              8 * (q >> 1));
          split_pack(sv.x, sv.y, ah[q], al[q]);
        }
#pragma unroll
        for (int pd = 0; pd < NCOL / 16; ++pd) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, smem_addr(vs + (16 * cb + (lane & 7) +
                                            8 * ((lane >> 3) & 1)) * RS +
                                      n0 + 8 * (2 * pd + (lane >> 4))));
          mma_bf16(acc[2 * pd], al, bf[0], bf[1]);
          mma_bf16(acc[2 * pd + 1], al, bf[2], bf[3]);
          mma_bf16(acc[2 * pd], ah, bf[0], bf[1]);
          mma_bf16(acc[2 * pd + 1], ah, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = a0 + g + 8 * hr;
        if (i >= L) continue;
        OT* orow = ob + (int64_t)(t0 + i) * o_ss + n0 + col0;
#pragma unroll
        for (int nt = 0; nt < NCOL / 8; ++nt)
          store2(orow + 8 * nt, acc[nt][2 * hr], acc[nt][2 * hr + 1]);
      }
    }

    // 4. S <- exp(total) S + (k * exp(total - ci))^T v in the owners'
    // registers: the float32 factor as hi + lo terms (A operand, built
    // from k and cum), v through ldmatrix.trans
    if (owner) {
      float tot[2], dec[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        tot[hr] = cum[LP * RS + 16 * srb + g + 8 * hr];
        dec[hr] = exp2_approx(tot[hr]);
      }
#pragma unroll
      for (int q = 0; q < PER; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[q][e] *= dec[e >> 1];
      for (int kj = 0; kj < NSUB; ++kj) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int m = 16 * srb + g + 8 * (q & 1);
          const int j = 16 * kj + col0 + 8 * (q >> 1);
          const float f0 = __bfloat162float(ks[j * RS + m]) *
                           exp2_approx(fminf(tot[q & 1] - cum[(j + 1) * RS + m], 0.f));
          const float f1 = __bfloat162float(ks[(j + 1) * RS + m]) *
                           exp2_approx(fminf(tot[q & 1] - cum[(j + 2) * RS + m], 0.f));
          split_pack(f0, f1, ah[q], al[q]);
        }
#pragma unroll
        for (int k2 = 0; k2 < (PER + 1) / 2; ++k2) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, smem_addr(vs + (16 * kj + (lane & 7) +
                                            8 * ((lane >> 3) & 1)) * RS +
                                      8 * (snt + 2 * k2 + (lane >> 4))));
          mma_bf16(st[2 * k2], al, bf[0], bf[1]);
          mma_bf16(st[2 * k2], ah, bf[0], bf[1]);
          if (2 * k2 + 1 < PER) {
            mma_bf16(st[2 * k2 + 1], al, bf[2], bf[3]);
            mma_bf16(st[2 * k2 + 1], ah, bf[2], bf[3]);
          }
        }
      }
    }
    __syncthreads();   // B4: every read of the state's terms and the tiles done
    store_split_state();
    if (t0 + stages * L < S) load_rkv(t0 + stages * L, stg);
    cp_async_commit();
  }
  cp_async_wait<0>();
  if (owner) {
#pragma unroll
    for (int q = 0; q < PER; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 16 * srb + g + 8 * (e >> 1);
        const int n = 8 * (snt + q) + col0 + (e & 1);
        state_out[st_off + (int64_t)m * D + n] = st[q][e];
      }
  }
}

struct ScanArgs {
  const void *r, *k, *v;
  const float *w, *bonus, *state0;
  void* out;
  float* state_out;
  int B, S, H, L;
  int64_t r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int64_t w_sb, w_ss, w_sh, o_sb, o_ss, o_sh;
  bool out_f32;   // out float32, else bf16
  cudaStream_t stream;
};

template <int D, typename OT>
int launch_scan(const ScanArgs& a) {
  // raise the dynamic shared-memory ceiling once per instantiation, to
  // the most this process has asked of it
  static size_t granted = 48 * 1024;
  const size_t bytes = smem_bytes_fma(D, a.L);
  if (bytes > granted) {
    cudaError_t err = cudaFuncSetAttribute(
        rwkv6_scan_kernel<D, OT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    granted = bytes;
  }
  rwkv6_scan_kernel<D, OT><<<a.B * a.H, NT, bytes, a.stream>>>(
      static_cast<const float*>(a.r), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.w, a.bonus, a.state0,
      static_cast<OT*>(a.out), a.state_out, a.H, a.S, a.L, a.r_sb, a.r_ss,
      a.r_sh, a.k_sb, a.k_ss, a.k_sh, a.v_sb, a.v_ss, a.v_sh, a.w_sb, a.w_ss,
      a.w_sh, a.o_sb, a.o_ss, a.o_sh);
  return (int)cudaGetLastError();
}

template <int D, typename OT>
int launch_scan_mma(const ScanArgs& a) {
  // the ceiling is raised once per instantiation and device, to the most
  // any chunk takes
  static unsigned smem_set = 0;
  auto kern = rwkv6_mma_kernel<D, OT>;
  cudaError_t err = allow_smem(kern, (int)SMEM_LIMIT, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int stages = mma_stages(D, a.L);
  const size_t bytes = mma_layout(D, a.L, stages).total;
  kern<<<a.B * a.H, 32 * MmaTile<D>::NW, bytes, a.stream>>>(
      static_cast<const bf16*>(a.r), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.w, a.bonus, a.state0,
      static_cast<OT*>(a.out), a.state_out, a.H, a.S, a.L, stages, a.r_sb,
      a.r_ss, a.r_sh, a.k_sb, a.k_ss, a.k_sh, a.v_sb, a.v_ss, a.v_sh, a.w_sb,
      a.w_ss, a.w_sh, a.o_sb, a.o_ss, a.o_sh);
  return (int)cudaGetLastError();
}

int dispatch_fma(const ScanArgs& a, int D) {
  switch (D) {
    case 16: return a.out_f32 ? launch_scan<16, float>(a) : launch_scan<16, bf16>(a);
    case 32: return a.out_f32 ? launch_scan<32, float>(a) : launch_scan<32, bf16>(a);
    case 64: return a.out_f32 ? launch_scan<64, float>(a) : launch_scan<64, bf16>(a);
    case 128: return a.out_f32 ? launch_scan<128, float>(a) : launch_scan<128, bf16>(a);
    default: return -1;
  }
}

int dispatch_mma(const ScanArgs& a, int D) {
  switch (D) {
    case 16: return a.out_f32 ? launch_scan_mma<16, float>(a) : launch_scan_mma<16, bf16>(a);
    case 32: return a.out_f32 ? launch_scan_mma<32, float>(a) : launch_scan_mma<32, bf16>(a);
    case 64: return a.out_f32 ? launch_scan_mma<64, float>(a) : launch_scan_mma<64, bf16>(a);
    case 128: return a.out_f32 ? launch_scan_mma<128, float>(a) : launch_scan_mma<128, bf16>(a);
    default: return -1;
  }
}

// The bf16 kernel's 16-byte copies: the 16-byte rule (common.cuh) on r, k
// and v (slices of one fused projection pass it) and on the float32 w
// (strides of 4 elements); its pair stores of out: an 8-byte aligned base
// and even strides.
bool aligned_for_mma(const ScanArgs& a) {
  auto stride4 = [](int64_t size, int64_t stride) {
    return size == 1 || stride % 4 == 0;
  };
  return base16(a.r) && base16(a.k) && base16(a.v) && base16(a.w) &&
         reinterpret_cast<uintptr_t>(a.out) % 8 == 0 &&
         stride16(a.B, a.r_sb) && stride16(a.S, a.r_ss) &&
         stride16(a.H, a.r_sh) && stride16(a.B, a.k_sb) &&
         stride16(a.S, a.k_ss) && stride16(a.H, a.k_sh) &&
         stride16(a.B, a.v_sb) && stride16(a.S, a.v_ss) &&
         stride16(a.H, a.v_sh) && stride4(a.B, a.w_sb) &&
         stride4(a.S, a.w_ss) && stride4(a.H, a.w_sh) &&
         (a.o_sb | a.o_ss | a.o_sh) % 2 == 0;
}

}  // namespace

// dtype: 0 = float32 (the FMA kernel), 1 = bfloat16 (the mma.sync
// kernel, which needs aligned_for_mma), for r, k and v; out_dtype, the
// same codes, for out; w, bonus, state0 and state_out are float32.  r, k,
// v, w, out are [B, S, H, D] with the given strides (in elements; the
// last dimension has stride 1); bonus is a contiguous [H, D], state0 and
// state_out contiguous [B, H, D, D] (they may be the same buffer).
// Requires S % L == 0, 1 <= L <= 64 and the launched kernel's shared
// memory (smem_bytes_fma, mma_layout) within the card's 227 KB.  Returns
// cudaGetLastError() after the launch (0 on success), -1 for arguments
// it does not take.  Launches on `stream`, does not synchronise,
// allocates nothing.
extern "C" int fate_rwkv6_scan(
    const void* r, const void* k, const void* v, const void* w,
    const void* bonus, const void* state0, void* out, void* state_out,
    int B, int S, int H, int D, int L,
    long long r_sb, long long r_ss, long long r_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long w_sb, long long w_ss, long long w_sh,
    long long o_sb, long long o_ss, long long o_sh, int dtype, int out_dtype,
    void* stream) {
  if (B < 1 || H < 1 || S < 1 || L < 1 || L > 64 || S % L != 0) return -1;
  if (out_dtype != 0 && out_dtype != 1) return -1;
  ScanArgs a{r, k, v,
             static_cast<const float*>(w), static_cast<const float*>(bonus),
             static_cast<const float*>(state0), out,
             static_cast<float*>(state_out), B, S, H, L,
             r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
             w_sb, w_ss, w_sh, o_sb, o_ss, o_sh, out_dtype == 0,
             static_cast<cudaStream_t>(stream)};
  if (dtype == 0) {
    if (smem_bytes_fma(D, L) > SMEM_LIMIT) return -1;
    return dispatch_fma(a, D);
  }
  if (dtype == 1) {
    if (mma_layout(D, L, mma_stages(D, L)).total > SMEM_LIMIT) return -1;
    return aligned_for_mma(a) ? dispatch_mma(a, D) : -1;
  }
  return -1;
}
