// Prefill attention for Hopper: GQA, optional causal mask, optional
// sliding window, online softmax.  Replaces the TPU kernel
// src/repro/kernels/flash_attention.py :: flash_attention / _flash_kernel.
//
// What it computes (per batch b, query head h, KV head h / G):
//   s = (q . k) * D^-0.5, masked to -1e30 where k_pos >= Sk, or
//   (causal) q_pos < k_pos, or (window) q_pos - k_pos >= window, where
//   query row i sits at q_pos = q_offset + i (0 but for a lane of a
//   sequence-parallel prefill, models/attention.py :: flash_attention_sp)
//   and key row j at k_pos = j;
//   out = softmax(s) @ v, with float32 scores and a float32 accumulator;
//   out = acc / max(l, 1e-30) cast to the input type.
// q and k have head dim D, v and out a value head dim Dv, which is D for
// every model but deepseek-v2's multi-head latent attention, whose prefill
// attends with D = 128 + 64 (no-rope and rope parts) over Dv = 128.  The
// scale stays D^-0.5, as in the XLA twin of the JAX models.
//
// Shape of both kernels.  The TPU grid (B*KV*G, nQ, nK) carried (m, l,
// acc) in VMEM across sequential nK steps.  Here one block owns one
// (batch, head, 64-row query tile) and loops over KV tiles itself; the
// running (m, l, acc) stay in registers.  KV tiles wholly above the
// causal diagonal or wholly below the window are never visited.  q, k, v
// are read through their strides ([B, S, heads, D] as the models hold
// them): no transposed copy is made.
//
// What bounds it.  On an H100 (3.35 TB/s, 989 TFLOP/s bf16: 295 flops per
// byte) the least time for the function is set by bytes: causal bf16
// prefill at B = 8, S = 512, H = 16, KV = 8, D = 128 does about 171 flops
// per byte of q/k/v/out moved once, 0.015 ms of traffic.  gemma3's
// prefill (B = 8, S = 2048, H = 8, KV = 4, D = 256) is bound by operations
// instead: 137 GFLOP causal, 0.139 ms at 989 TFLOP/s, and 0.104 ms with its
// local layers' window of 1024, whose tiles wholly below the window are
// never visited.
//
// bf16: tensor cores through mma.sync.  4 warps per block, each owning 16
// query rows.  The Q tile is copied once into shared memory; up to D = 128
// it is held in registers as mma A fragments (ldmatrix).  K and V tiles of
// 64 rows come through a 2-stage ring of 16-byte cp.async copies, kept in
// bf16 (rows padded by 16 bytes: conflict-free ldmatrix for every head
// dim, 80 included), the next tile loading while this one is used.
// At D = 256 (gemma3) a warp's output accumulator alone is 128 floats per
// thread, and Q's fragments would be 64 registers more: there Q's
// fragments are read from shared memory by ldmatrix at each k16 step, and
// the KV tiles are 32 rows (the score tile 16 floats per thread), which
// also brings the block's shared memory to 101,376 bytes, so that two
// blocks fit an SM.  At (D, Dv) = (192, 128) Q's fragments (48 registers)
// stay in registers beside the 128-column accumulator and the KV tiles
// stay 64 rows: 111,616 bytes, two blocks per SM.  S = Q K^T is
// mma.sync m16n8k16 (bf16 operands, float32 accumulation: the products of
// the Pallas kernel, which casts bf16 to float32 before its dot).  The
// accumulator fragments are masked and online-softmaxed in registers;
// each row lives in one quad of 4 threads, whose max is reduced with two
// shuffles per tile and whose sum once at the end.  p never leaves the
// registers: rounded to bf16 (as the JAX model's XLA twin rounds it; the
// Pallas kernel keeps it float32, ROADMAP H1b / H19), the score fragments
// are the A operand of P V, with V read through ldmatrix.trans.  Query
// tiles are issued longest first, so the causal tail is not one late
// block.  mma.sync rather than wgmma: the function is bound by bytes at
// the served shapes, and the register-resident p saves the shared-memory
// round trip that a wgmma with p in shared memory would need.  The bf16
// path needs 16-byte aligned rows (strides multiples of 8 elements); the
// wrapper copies anything else first (kernels/_build.py :: kernel_operand).
// Left undone: wgmma with a TMA producer, splitting long KV ranges over
// blocks, a K / V wait split so that S starts before V lands.
//
// float32: the FMA kernel of the first port, kept for the 2e-5 bar, which
// needs true float32 products (TF32 would miss it).  256 threads as a
// 16 x 16 grid; thread (ty, tx) owns query rows 4*ty .. 4*ty+3, score
// columns tx + 16*c and output columns tx + 16*j; Q, K, V tiles in shared
// memory, p through shared memory as float32.  No bf16 input reaches it.
//
// lse: when the caller passes a float32 [B, H, Sq] buffer (training: the
// backward, csrc/flash_attention_bwd.cu, recomputes p from it), each row's
// natural log-sum-exp of its scaled, masked scores is written beside the
// output, m + log(l) from the running max and sum (+inf for a row that
// attended no key).  The output's arithmetic is the same with or without
// it; serving passes none.
//
// Rows that have no valid key at all (possible only with a window, where
// q_offset + i >= Sk - 1 + window) are degenerate in the reference (a
// uniform average over masked keys); here they give 0 and a log-sum-exp
// of +inf (their running max never leaves NEG_INF), so that the
// backward's zero gradient for them is exact.
#include "common.cuh"

namespace {

using namespace fate;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// float32: FMA kernel
// ---------------------------------------------------------------------------

constexpr int BM = 64;          // query rows per block
constexpr int NTHREADS = 256;   // 16 x 16

template <typename T, int D, int DV, int BN>
__global__ void __launch_bounds__(NTHREADS)
flash_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int G,
                 int64_t q_sb, int64_t q_ss, int64_t q_sh,
                 int64_t k_sb, int64_t k_ss, int64_t k_sh,
                 int64_t v_sb, int64_t v_ss, int64_t v_sh,
                 int64_t o_sb, int64_t o_ss, int64_t o_sh,
                 int causal, int window, int q_offset, float scale) {
  constexpr int QS = D + 4;     // row stride of Qs and Ks (floats)
  constexpr int PS = BN + 4;    // row stride of Ps
  constexpr int CN = BN / 16;   // score columns per thread
  constexpr int DN = DV / 16;   // output columns per thread
  constexpr int D4 = D / 4;
  constexpr int DV4 = DV / 4;

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // [BM][QS]
  float* Ks = Qs + BM * QS;       // [BN][QS]
  float* Vs = Ks + BN * QS;       // [BN][DV]
  float* Ps = Vs + BN * DV;       // [BM][PS]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / G;

  const T* qb = q + (int64_t)b * q_sb + (int64_t)h * q_sh;
  const T* kb = k + (int64_t)b * k_sb + (int64_t)kvh * k_sh;
  const T* vb = v + (int64_t)b * v_sb + (int64_t)kvh * v_sh;

  for (int idx = tid; idx < BM * D4; idx += NTHREADS) {
    const int r = idx / D4;
    const int c = (idx % D4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq) val = load4<T>(qb + (int64_t)(q0 + r) * q_ss + c);
    *reinterpret_cast<float4*>(&Qs[r * QS + c]) = val;
  }

  float acc[4][DN];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;
  }

  // KV tiles that can hold a valid key for some row of this query tile,
  // whose first row sits at position qa0
  const int qa0 = q_offset + q0;
  int k_end = Sk;
  if (causal) k_end = min(Sk, qa0 + BM);
  int k_begin = 0;
  if (window > 0) k_begin = (max(0, qa0 - window + 1) / BN) * BN;

  for (int k0 = k_begin; k0 < k_end; k0 += BN) {
    __syncthreads();   // the previous tile's PV product has read Ks/Vs/Ps
    if constexpr (D == DV) {   // K and V rows side by side
      for (int idx = tid; idx < BN * D4; idx += NTHREADS) {
        const int r = idx / D4;
        const int c = (idx % D4) * 4;
        float4 kval = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 vval = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + r < Sk) {
          kval = load4<T>(kb + (int64_t)(k0 + r) * k_ss + c);
          vval = load4<T>(vb + (int64_t)(k0 + r) * v_ss + c);
        }
        *reinterpret_cast<float4*>(&Ks[r * QS + c]) = kval;
        *reinterpret_cast<float4*>(&Vs[r * DV + c]) = vval;
      }
    } else {
      for (int idx = tid; idx < BN * D4; idx += NTHREADS) {
        const int r = idx / D4;
        const int c = (idx % D4) * 4;
        float4 kval = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + r < Sk) kval = load4<T>(kb + (int64_t)(k0 + r) * k_ss + c);
        *reinterpret_cast<float4*>(&Ks[r * QS + c]) = kval;
      }
      for (int idx = tid; idx < BN * DV4; idx += NTHREADS) {
        const int r = idx / DV4;
        const int c = (idx % DV4) * 4;
        float4 vval = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + r < Sk) vval = load4<T>(vb + (int64_t)(k0 + r) * v_ss + c);
        *reinterpret_cast<float4*>(&Vs[r * DV + c]) = vval;
      }
    }
    __syncthreads();

    // s = q . k for a 4 x CN register tile
    float s[4][CN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CN; ++c) s[i][c] = 0.f;

#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * QS + d]);
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const float4 kv4 =
            *reinterpret_cast<const float4*>(&Ks[(tx + 16 * c) * QS + d]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][c] = fmaf(qv[i].x, kv4.x, s[i][c]);
          s[i][c] = fmaf(qv[i].y, kv4.y, s[i][c]);
          s[i][c] = fmaf(qv[i].z, kv4.z, s[i][c]);
          s[i][c] = fmaf(qv[i].w, kv4.w, s[i][c]);
        }
      }
    }

    // mask, online-softmax update, p -> shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      const int q_pos = qa0 + row;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const int k_pos = k0 + tx + 16 * c;
        bool ok = k_pos < Sk;
        if (causal) ok = ok && (q_pos >= k_pos);
        if (window > 0) ok = ok && (q_pos - k_pos < window);
        s[i][c] = ok ? s[i][c] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][c]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const float p = expf(s[i][c] - m_new);
        Ps[row * PS + tx + 16 * c] = p;
        row_sum += p;
      }
      row_sum = half_warp_sum(row_sum);
      l_i[i] = l_i[i] * alpha + row_sum;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += p @ v
#pragma unroll 2
    for (int n = 0; n < BN; n += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty * 4 + i) * PS + n]);
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        const int dc = tx + 16 * j;
        const float v0 = Vs[(n + 0) * DV + dc];
        const float v1 = Vs[(n + 1) * DV + dc];
        const float v2 = Vs[(n + 2) * DV + dc];
        const float v3 = Vs[(n + 3) * DV + dc];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j] = fmaf(pv[i].x, v0, acc[i][j]);
          acc[i][j] = fmaf(pv[i].y, v1, acc[i][j]);
          acc[i][j] = fmaf(pv[i].z, v2, acc[i][j]);
          acc[i][j] = fmaf(pv[i].w, v3, acc[i][j]);
        }
      }
    }
  }

  T* ob = out + (int64_t)b * o_sb + (int64_t)h * o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r < Sq) {
      const float denom = fmaxf(l_i[i], 1e-30f);
      const bool none = m_i[i] == NEG_INF;   // no valid key: 0, lse +inf
#pragma unroll
      for (int j = 0; j < DN; ++j)
        ob[(int64_t)r * o_ss + tx + 16 * j] =
            from_float<T>(none ? 0.f : acc[i][j] / denom);
      if (lse != nullptr && tx == 0)
        lse[((int64_t)b * gridDim.y + h) * Sq + r] =
            row_lse(m_i[i], none ? 0.f : l_i[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync kernel
// ---------------------------------------------------------------------------

constexpr int MMA_BM = 64;         // query rows per block, 16 per warp
constexpr int MMA_THREADS = 128;   // 4 warps

// The output accumulator is DV / 2 floats per thread and Q's fragments
// D / 4 registers: with DV <= 128 both fit beside a 64-key score tile up
// to D = 192 (deepseek's 128 + 64 query/key dims over a value dim of 128).
template <int D, int DV>
struct MmaTile {
  static constexpr int BN = DV > 128 ? 32 : 64;   // keys per KV tile
  static constexpr bool Q_IN_REGS = D <= 192 && DV <= 128;  // else ldmatrix
  static constexpr int RS = D + 8;    // row stride of Q and K: 16-byte pad
  static constexpr int RSV = DV + 8;  // row stride of V
  static constexpr int SMEM =         // Q, 2 K stages, 2 V stages
      ((MMA_BM + 2 * BN) * RS + 2 * BN * RSV) * 2;
};

template <int D, int DV>
__global__ void __launch_bounds__(MMA_THREADS)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int G,
                 int64_t q_sb, int64_t q_ss, int64_t q_sh,
                 int64_t k_sb, int64_t k_ss, int64_t k_sh,
                 int64_t v_sb, int64_t v_ss, int64_t v_sh,
                 int64_t o_sb, int64_t o_ss, int64_t o_sh,
                 int causal, int window, int q_offset, float scale_log2) {
  using Tile = MmaTile<D, DV>;
  constexpr int RS = Tile::RS;
  constexpr int RSV = Tile::RSV;
  constexpr int MMA_BN = Tile::BN;
  constexpr int SJ = MMA_BN / 8;   // 8-key tiles of the scores
  constexpr int CH = D / 8;    // 16-byte chunks per Q / K row
  constexpr int CHV = DV / 8;  // 16-byte chunks per V row
  constexpr int KS = D / 16;   // k16 steps of Q K^T
  constexpr int NT = DV / 8;   // 8-column tiles of the output

  extern __shared__ __align__(16) uint8_t mma_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(mma_smem);   // [BM][RS]
  bf16* Ks = Qs + MMA_BM * RS;                    // [2][BN][RS]
  bf16* Vs = Ks + 2 * MMA_BN * RS;                // [2][BN][RSV]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * MMA_BM;   // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / G;
  const bf16* qb = q + (int64_t)b * q_sb + (int64_t)h * q_sh;
  const bf16* kb = k + (int64_t)b * k_sb + (int64_t)kvh * k_sh;
  const bf16* vb = v + (int64_t)b * v_sb + (int64_t)kvh * v_sh;

  // KV tiles that can hold a valid key for some row of this query tile,
  // whose first row sits at position qa0
  const int qa0 = q_offset + q0;
  int k_end = Sk;
  if (causal) k_end = min(Sk, qa0 + MMA_BM);
  int k_begin = 0;
  if (window > 0) k_begin = (max(0, qa0 - window + 1) / MMA_BN) * MMA_BN;

  // the Q tile and the first KV tile form the first copy group; rows
  // beyond Sq or Sk are zero-filled
  for (int idx = tid; idx < MMA_BM * CH; idx += MMA_THREADS) {
    const int r = idx / CH;
    const int c = idx % CH;
    const bool ok = q0 + r < Sq;
    cp_async16(smem_addr(Qs + r * RS + 8 * c),
               ok ? qb + (int64_t)(q0 + r) * q_ss + 8 * c : q, ok ? 16 : 0);
  }
  auto load_kv = [&](int stage, int k0) {
    bf16* ks = Ks + stage * MMA_BN * RS;
    bf16* vs = Vs + stage * MMA_BN * RSV;
    if constexpr (D == DV) {   // K and V rows side by side
      for (int idx = tid; idx < MMA_BN * CH; idx += MMA_THREADS) {
        const int r = idx / CH;
        const int c = idx % CH;
        const bool ok = k0 + r < Sk;
        const int64_t row = k0 + r;
        cp_async16(smem_addr(ks + r * RS + 8 * c),
                   ok ? kb + row * k_ss + 8 * c : k, ok ? 16 : 0);
        cp_async16(smem_addr(vs + r * RSV + 8 * c),
                   ok ? vb + row * v_ss + 8 * c : v, ok ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < MMA_BN * CH; idx += MMA_THREADS) {
        const int r = idx / CH;
        const int c = idx % CH;
        const bool ok = k0 + r < Sk;
        cp_async16(smem_addr(ks + r * RS + 8 * c),
                   ok ? kb + (int64_t)(k0 + r) * k_ss + 8 * c : k,
                   ok ? 16 : 0);
      }
      for (int idx = tid; idx < MMA_BN * CHV; idx += MMA_THREADS) {
        const int r = idx / CHV;
        const int c = idx % CHV;
        const bool ok = k0 + r < Sk;
        cp_async16(smem_addr(vs + r * RSV + 8 * c),
                   ok ? vb + (int64_t)(k0 + r) * v_ss + 8 * c : v,
                   ok ? 16 : 0);
      }
    }
  };
  if (k_begin < k_end) load_kv(0, k_begin);
  cp_async_commit();

  // m16n8 fragment layout: this thread holds two of the warp's 16 rows,
  // at positions pos0 and pos0 + 8 (row pos0 - q_offset of q and the one
  // 8 below it), and columns col0 and col0 + 1 of every 8-column tile
  const int pos0 = qa0 + warp * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[j][r] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};      // this thread's share of the row sums
  uint32_t qf[Tile::Q_IN_REGS ? KS : 1][4];
  const uint32_t q_frag = smem_addr(Qs + (warp * 16 + (lane & 15)) * RS +
                                    8 * (lane >> 4));

  int st = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += MMA_BN, st ^= 1) {
    if (k0 + MMA_BN < k_end) {
      load_kv(st ^ 1, k0 + MMA_BN);   // read at the previous iteration,
      cp_async_commit();              // released by its closing barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (Tile::Q_IN_REGS) {
      if (k0 == k_begin) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) ldsm_x4(qf[kk], q_frag + 32 * kk);
      }
    }
    const bf16* ks = Ks + st * MMA_BN * RS;
    const bf16* vs = Vs + st * MMA_BN * RSV;

    // s = q . k: SJ tiles of 8 keys; one ldmatrix.x4 gives the B
    // fragments of two key tiles at one k16 step
    float s[SJ][4];
#pragma unroll
    for (int j = 0; j < SJ; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4];
      if constexpr (Tile::Q_IN_REGS) {
#pragma unroll
        for (int r = 0; r < 4; ++r) qa[r] = qf[kk][r];
      } else {
        ldsm_x4(qa, q_frag + 32 * kk);
      }
#pragma unroll
      for (int jj = 0; jj < SJ / 2; ++jj) {
        uint32_t bf[4];
        ldsm_x4(bf, smem_addr(ks + (16 * jj + (lane & 7) + 8 * (lane >> 4)) * RS +
                              16 * kk + 8 * ((lane >> 3) & 1)));
        mma_bf16(s[2 * jj], qa, bf[0], bf[1]);
        mma_bf16(s[2 * jj + 1], qa, bf[2], bf[3]);
      }
    }

    // scale (log2 domain) and mask
    const bool full = k0 + MMA_BN <= Sk &&
                      (!causal || k0 + MMA_BN - 1 <= qa0) &&
                      (window <= 0 || qa0 + MMA_BM - 1 - k0 < window);
#pragma unroll
    for (int j = 0; j < SJ; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kp = k0 + 8 * j + col0 + (r & 1);
        const int qp = pos0 + 8 * (r >> 1);
        const bool ok = full || (kp < Sk && (!causal || qp >= kp) &&
                                 (window <= 0 || qp - kp < window));
        s[j][r] = ok ? s[j][r] * scale_log2 : NEG_INF;
      }

    // online softmax per row: max over the quad, rescale, p = 2^(s - m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < SJ; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[i], mx);
      const float alpha = exp2f(m_r[i] - m_new);
      m_r[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        s[j][2 * i] = exp2f(s[j][2 * i] - m_new);
        s[j][2 * i + 1] = exp2f(s[j][2 * i + 1] - m_new);
        sum += s[j][2 * i] + s[j][2 * i + 1];
      }
      l_r[i] = l_r[i] * alpha + sum;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        o[j][2 * i] *= alpha;
        o[j][2 * i + 1] *= alpha;
      }
    }

    // o += p v: the score fragments of key tiles 2t, 2t + 1 are the A
    // fragment of k16 step t; V's B fragments through ldmatrix.trans, two
    // 8-column tiles per load
#pragma unroll
    for (int t = 0; t < SJ / 2; ++t) {
      const uint32_t a[4] = {pack_bf16(s[2 * t][0], s[2 * t][1]),
                             pack_bf16(s[2 * t][2], s[2 * t][3]),
                             pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]),
                             pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3])};
#pragma unroll
      for (int jd = 0; jd < NT / 2; ++jd) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, smem_addr(vs + (16 * t + (lane & 7) +
                                          8 * ((lane >> 3) & 1)) * RSV +
                                    8 * (2 * jd + (lane >> 4))));
        mma_bf16(o[2 * jd], a, bf[0], bf[1]);
        mma_bf16(o[2 * jd + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();   // this stage is refilled two iterations on
  }
  cp_async_wait<0>();  // the Q copy, where no KV tile was visited

  bf16* ob = out + (int64_t)b * o_sb + (int64_t)h * o_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float denom = fmaxf(l, 1e-30f);
    const bool none = m_r[i] == NEG_INF;   // no valid key: 0, lse +inf
    const int r = pos0 - q_offset + 8 * i;
    if (r >= Sq) continue;
    if (lse != nullptr && (lane & 3) == 0)   // m is in the log2 domain
      lse[((int64_t)b * gridDim.y + h) * Sq + r] =
          row_lse(m_r[i] * LN2, none ? 0.f : l);
    bf16* orow = ob + (int64_t)r * o_ss;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col0) =
          none ? __floats2bfloat162_rn(0.f, 0.f)
               : __floats2bfloat162_rn(o[j][2 * i] / denom,
                                       o[j][2 * i + 1] / denom);
  }
}

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  int B, Sq, Sk, H, KV;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  int causal, window, q_offset;
  cudaStream_t stream;
};

template <int D, int DV>
int launch_flash(const FlashArgs& a) {
  constexpr int BN = (D > 64) ? 32 : 64;
  constexpr size_t smem_bytes =
      sizeof(float) * (BM * (D + 4) + BN * (D + 4) + BN * DV + BM * (BN + 4));
  static unsigned smem_set = 0;
  auto kern = flash_fma_kernel<float, D, DV, BN>;
  cudaError_t err = allow_smem(kern, (int)smem_bytes, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + BM - 1) / BM, a.H, a.B);
  const float scale = (float)(1.0 / sqrt((double)D));
  kern<<<grid, NTHREADS, smem_bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.lse, a.Sq,
      a.Sk,
      a.H / a.KV, a.q_sb, a.q_ss, a.q_sh, a.k_sb, a.k_ss, a.k_sh, a.v_sb,
      a.v_ss, a.v_sh, a.o_sb, a.o_ss, a.o_sh, a.causal, a.window, a.q_offset,
      scale);
  return (int)cudaGetLastError();
}

template <int D, int DV>
int launch_flash_mma(const FlashArgs& a) {
  constexpr int smem_bytes = MmaTile<D, DV>::SMEM;
  static unsigned smem_set = 0;
  auto kern = flash_mma_kernel<D, DV>;
  cudaError_t err = allow_smem(kern, smem_bytes, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + MMA_BM - 1) / MMA_BM, a.H, a.B);
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  kern<<<grid, MMA_THREADS, smem_bytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.out), a.lse, a.Sq,
      a.Sk,
      a.H / a.KV, a.q_sb, a.q_ss, a.q_sh, a.k_sb, a.k_ss, a.k_sh, a.v_sb,
      a.v_ss, a.v_sh, a.o_sb, a.o_ss, a.o_sh, a.causal, a.window, a.q_offset,
      scale_log2);
  return (int)cudaGetLastError();
}

// (query/key head dim D, value head dim Dv) pairs: kernels/_build.py ::
// FLASH_HEAD_DIMS lists the same
int dispatch_fma(const FlashArgs& a, int D, int Dv) {
  if (D == 16 && Dv == 16) return launch_flash<16, 16>(a);
  if (D == 32 && Dv == 32) return launch_flash<32, 32>(a);
  if (D == 64 && Dv == 64) return launch_flash<64, 64>(a);
  if (D == 80 && Dv == 80) return launch_flash<80, 80>(a);
  if (D == 128 && Dv == 128) return launch_flash<128, 128>(a);
  if (D == 256 && Dv == 256) return launch_flash<256, 256>(a);
  if (D == 192 && Dv == 128) return launch_flash<192, 128>(a);
  return -1;
}

int dispatch_mma(const FlashArgs& a, int D, int Dv) {
  if (D == 16 && Dv == 16) return launch_flash_mma<16, 16>(a);
  if (D == 32 && Dv == 32) return launch_flash_mma<32, 32>(a);
  if (D == 64 && Dv == 64) return launch_flash_mma<64, 64>(a);
  if (D == 80 && Dv == 80) return launch_flash_mma<80, 80>(a);
  if (D == 128 && Dv == 128) return launch_flash_mma<128, 128>(a);
  if (D == 256 && Dv == 256) return launch_flash_mma<256, 256>(a);
  if (D == 192 && Dv == 128) return launch_flash_mma<192, 128>(a);
  return -1;
}

// The bf16 kernel's 16-byte copies: the 16-byte rule (common.cuh) on q,
// k and v; the output's pair stores: even strides.
bool aligned_for_mma(const FlashArgs& a) {
  return base16(a.q) && base16(a.k) && base16(a.v) &&
         reinterpret_cast<uintptr_t>(a.out) % 4 == 0 &&
         stride16(a.B, a.q_sb) && stride16(a.Sq, a.q_ss) &&
         stride16(a.H, a.q_sh) && stride16(a.B, a.k_sb) &&
         stride16(a.Sk, a.k_ss) && stride16(a.KV, a.k_sh) &&
         stride16(a.B, a.v_sb) && stride16(a.Sk, a.v_ss) &&
         stride16(a.KV, a.v_sh) && (a.o_sb | a.o_ss | a.o_sh) % 2 == 0;
}

}  // namespace

// dtype: 0 = float32 (the FMA kernel), 1 = bfloat16 (the mma.sync kernel,
// which needs aligned_for_mma).  q and k have head dim D, v and out Dv.
// q_offset >= 0: the position of query row 0 (key row 0 is at 0).
// Strides are in elements; the last dimension of every tensor has stride
// 1.  Returns cudaGetLastError() after the launch (0 on success), -1 for
// an unsupported (D, Dv) pair, dtype or alignment.  Launches on `stream`,
// does not synchronise, allocates nothing.
extern "C" int fate_flash_attention(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int B, int Sq, int Sk, int H, int KV, int D, int Dv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, int q_offset, int dtype, void* stream) {
  if (q_offset < 0) return -1;
  FlashArgs a{q, k, v, out, lse, B, Sq, Sk, H, KV,
              q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
              o_sb, o_ss, o_sh, causal, window, q_offset,
              static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_fma(a, D, Dv);
  if (dtype == 1) return aligned_for_mma(a) ? dispatch_mma(a, D, Dv) : -1;
  return -1;
}
