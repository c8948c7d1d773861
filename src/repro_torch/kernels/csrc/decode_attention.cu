// Decode attention for Hopper: one query token per sequence against a
// static KV cache of S rows, of which the first cache_len are valid.  Replaces
// the TPU kernel src/repro/kernels/decode_attention.py ::
// decode_attention / _decode_kernel.
//
// What it computes (per batch b and KV head kvh, for the G query heads
// kvh*G .. kvh*G+G-1 that share that KV head):
//   s = (q . k_cache[0:cache_len]) * D^-0.5, softmax in float32,
//   out = p @ v_cache[0:cache_len],
//   out = acc / max(l, 1e-30) cast to the input type.
//
// Shape of both kernels.  The TPU grid (B*KV, nS) walked the whole cache
// sequentially and masked rows >= cache_len.  On this card B*KV blocks
// alone leave most of the 132 SMs idle at small batch, so the valid part
// of the cache may be split across blocks (grid nsplit x KV x B; the
// wrapper's split_plan chooses): each block runs the online softmax over
// its own rows and, where nsplit > 1, leaves an unnormalised partial
// (m, l, acc) in float32 scratch.  Rows at or beyond cache_len are never
// read: the tile loads are bounded by it.  The [B, S, KV, D] caches are
// read through their strides, so no transposed copy of the cache is made.
//
// The length.  As the Pallas kernel's `lens` operand, cache_len may be a
// device int32 that the kernel reads when it runs (a captured CUDA graph
// replays one launch while the length grows); else it is a launch
// argument.  Either way the grid is planned from S, not from the length,
// so both forms launch the same blocks and give the same bits.  A block
// whose rows start at or past cache_len reads no row and leaves an empty
// partial (m = -1e30, l = 0, acc = 0), whose weight in the combine is 0; it
// still draws its ticket, so the last block always combines all nsplit
// partials in split order.  A device length is trusted, clamped to S;
// nothing is read back to the host.
//
// What bounds it: bytes.  Each cache row is read once and used for
// 4*G*D flops, far below the card's 295 flops per byte; at qwen3's decode
// (B 8, 544 rows, 8 KV heads of 128) the K and V rows are 17.8 MB, 5.3 us
// at 3.35 TB/s.  At the short caches of the served workflows the launch
// and the latency of the first loads are a large part of the time.
//
// bf16: tensor cores through mma.sync, one launch.  4 warps per block;
// the G query heads of the KV head, padded with zero rows to 16, are the
// A operand, loaded once into registers (ldmatrix).  The block's rows are
// cut into 16-row tiles, and warp w takes tiles w, w + 4, ...: each warp
// feeds its own 3-stage ring of 16-byte cp.async copies (K and V tiles in
// bf16, rows padded by 16 bytes for conflict-free ldmatrix), synchronised
// by __syncwarp alone, so two tiles are in flight while one is used.  S =
// Q K^T is two m16n8k16 products per k16 step (bf16 operands, float32
// sums), K's B fragments through ldmatrix.  Each warp keeps its own
// online softmax (m, l) in float32, in the log2 domain; the score
// fragments of the two 8-row tiles, rounded to bf16 in registers (as
// repro.models.attention rounds p; the Pallas kernel keeps it float32:
// ROADMAP H20), are the A fragment of P V, with V through ldmatrix.trans.
// At D = 256 (gemma3) a warp's output accumulator is 128 floats per
// thread, and Q's fragments would be 64 registers more: there they are
// read from shared memory by ldmatrix at each k16 step, and each warp's
// ring has 2 stages (143,616 bytes in all, against 211,200 with 3).
// At the end the warps' (m, l, o) merge in shared memory in warp order.
// With nsplit > 1 each block writes its partial, takes a ticket (an
// atomic per (b, KV head), the only atomic), and the last block to
// arrive combines the partials in split order, writes out and hands the
// ticket back at 0: the bits never depend on the order the blocks ran
// in, and no second launch is needed.  The padded query rows hold zeros,
// so their scores are finite; they are never written.  The 16-byte
// copies need strides that are whole 16 bytes; the C entry refuses
// others, and the wrapper copies them first (kernels/_build.py ::
// kernel_operand).
//
// float32: the FMA kernels of the first port, kept for the 2e-5 bar,
// which needs true float32 products and p: a block stages 32-row tiles
// widened to float32 in dynamic shared memory (84,096 bytes at D = 256),
// one (head, row) pair per thread for the scores and one (head, column)
// for P V, and a second small kernel combines the partials.  No bf16
// input reaches them.
#include "common.cuh"

namespace {

using namespace fate;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// float32: FMA kernels (partials, then a combine pass)
// ---------------------------------------------------------------------------

constexpr int MAXG = 16;   // query heads per KV head the kernel takes
constexpr int BS = 32;     // cache rows per tile (= warp width)
constexpr int NT = 128;    // threads per block

template <int D>
struct FmaTile {   // q, K (rows padded by one float), V, scores
  static constexpr int SMEM =
      (MAXG * D + BS * (D + 1) + BS * D + MAXG * BS) * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(NT)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                      const T* __restrict__ vc, float* __restrict__ part_acc,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      int G, const int* __restrict__ len_dev, int len_host,
                      int S, int chunk,
                      int64_t q_sb, int64_t q_sh,
                      int64_t k_sb, int64_t k_ss, int64_t k_sh,
                      int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale) {
  constexpr int KS = D + 1;             // row stride of Ks (floats)
  constexpr int D4 = D / 4;
  constexpr int NJ = MAXG * D / NT;     // (head, column) pairs per thread

  extern __shared__ __align__(16) float fma_smem[];   // FmaTile<D>::SMEM
  float* qs = fma_smem;                 // [MAXG][D]
  float* Ks = qs + MAXG * D;            // [BS][KS]
  float* Vs = Ks + BS * KS;             // [BS][D], 16-byte aligned
  float* Ss = Vs + BS * D;              // [MAXG][BS]
  __shared__ float m_s[MAXG], l_s[MAXG], a_s[MAXG];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const int kvh = blockIdx.y;
  const int KV = gridDim.y;
  const int b = blockIdx.z;

  const int cache_len = min(len_dev != nullptr ? *len_dev : len_host, S);
  const int s_begin = split * chunk;
  const int s_end = min(cache_len, s_begin + chunk);   // < s_begin: empty

  const T* qb = q + (int64_t)b * q_sb + (int64_t)(kvh * G) * q_sh;
  const T* kb = kc + (int64_t)b * k_sb + (int64_t)kvh * k_sh;
  const T* vb = vc + (int64_t)b * v_sb + (int64_t)kvh * v_sh;

  for (int idx = tid; idx < G * D; idx += NT) {
    const int g = idx / D;
    const int d = idx % D;
    qs[idx] = to_float<T>(qb[(int64_t)g * q_sh + d]);
  }
  if (tid < MAXG) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
    a_s[tid] = 1.f;
  }

  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;

  for (int s0 = s_begin; s0 < s_end; s0 += BS) {
    __syncthreads();   // the previous tile's PV product has read Vs/Ss/a_s
    for (int idx = tid; idx < BS * D4; idx += NT) {
      const int r = idx / D4;
      const int c = (idx % D4) * 4;
      float4 kval = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vval = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s0 + r < s_end) {
        kval = load4<T>(kb + (int64_t)(s0 + r) * k_ss + c);
        vval = load4<T>(vb + (int64_t)(s0 + r) * v_ss + c);
      }
      Ks[r * KS + c + 0] = kval.x;
      Ks[r * KS + c + 1] = kval.y;
      Ks[r * KS + c + 2] = kval.z;
      Ks[r * KS + c + 3] = kval.w;
      *reinterpret_cast<float4*>(&Vs[r * D + c]) = vval;
    }
    __syncthreads();

    // scores: one (head, row) pair per thread and pass
    for (int idx = tid; idx < G * BS; idx += NT) {
      const int g = idx / BS;
      const int r = idx % BS;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(qs[g * D + d], Ks[r * KS + d], dot);
      Ss[idx] = (s0 + r < s_end) ? dot * scale : NEG_INF;
    }
    __syncthreads();

    // online-softmax update: one warp per head, one lane per row.  Every
    // tile visited holds at least one valid row, so m_new is a real score
    // and the masked rows get p = 0.
    for (int g = warp; g < G; g += NT / 32) {
      const float sv = Ss[g * BS + lane];
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(sv));
      const float p = expf(sv - m_new);
      const float tile_sum = warp_sum(p);
      Ss[g * BS + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + tile_sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int idx = tid + j * NT;
      if (idx < G * D) {
        const int g = idx / D;
        const int d = idx % D;
        float a = acc[j] * a_s[g];
#pragma unroll 8
        for (int r = 0; r < BS; ++r) a = fmaf(Ss[g * BS + r], Vs[r * D + d], a);
        acc[j] = a;
      }
    }
  }

  // partials, laid out [B, KV, nsplit, G, (D)]
  const int64_t base = ((int64_t)b * KV + kvh) * nsplit + split;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int idx = tid + j * NT;
    if (idx < G * D) part_acc[base * G * D + idx] = acc[j];
  }
  if (tid < G) {
    part_m[base * G + tid] = m_s[tid];
    part_l[base * G + tid] = l_s[tid];
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_m,
                      const float* __restrict__ part_l, T* __restrict__ out,
                      int G, int D, int nsplit, int64_t o_sb, int64_t o_sh) {
  const int kvh = blockIdx.x;
  const int KV = gridDim.x;
  const int b = blockIdx.y;
  const int64_t base = ((int64_t)b * KV + kvh) * nsplit;
  T* ob = out + (int64_t)b * o_sb + (int64_t)(kvh * G) * o_sh;
  for (int idx = threadIdx.x; idx < G * D; idx += NT) {
    const int g = idx / D;
    const int d = idx % D;
    float m = NEG_INF;
    for (int s = 0; s < nsplit; ++s) m = fmaxf(m, part_m[(base + s) * G + g]);
    float num = 0.f, den = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float w = expf(part_m[(base + s) * G + g] - m);
      num = fmaf(w, part_acc[(base + s) * G * D + idx], num);
      den = fmaf(w, part_l[(base + s) * G + g], den);
    }
    ob[(int64_t)g * o_sh + d] = from_float<T>(num / fmaxf(den, 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync kernel, one launch
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 4;            // warps per block
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int TR = 16;                  // cache rows per tile: one k16 step of P V
constexpr int MAX_SPLIT = 132;          // splits the last block combines

template <int D>
struct DecodeTile {
  static constexpr int NST = D > 128 ? 2 : 3;       // stages of each warp's ring
  static constexpr bool Q_IN_REGS = D <= 128;       // else ldmatrix per step
  static constexpr int RS = D + 8;                  // row stride (elements)
  static constexpr int STAGE = 2 * TR * RS;         // K then V (elements)
  static constexpr int RING = NST * STAGE;          // one warp's ring
  static constexpr int TILES = (MAXG * RS + MMA_WARPS * RING) * 2;
  static constexpr int MERGE =                      // (m, l, o) per warp
      (2 * MMA_WARPS * MAXG + MMA_WARPS * MAXG * D) * 4;
  static constexpr int COMBINE = (2 * MAXG * MAX_SPLIT + MAXG) * 4;
  static constexpr int SMEM_TM = TILES > MERGE ? TILES : MERGE;
  static constexpr int SMEM = SMEM_TM > COMBINE ? SMEM_TM : COMBINE;
};

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
decode_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kc,
                  const bf16* __restrict__ vc, bf16* __restrict__ out,
                  float* __restrict__ part_acc, float* __restrict__ part_m,
                  float* __restrict__ part_l, int* __restrict__ tickets,
                  int G, const int* __restrict__ len_dev, int len_host,
                  int S, int chunk,
                  int64_t q_sb, int64_t q_sh,
                  int64_t k_sb, int64_t k_ss, int64_t k_sh,
                  int64_t v_sb, int64_t v_ss, int64_t v_sh,
                  int64_t o_sb, int64_t o_sh, float scale_log2) {
  constexpr int RS = DecodeTile<D>::RS;
  constexpr int NST = DecodeTile<D>::NST;
  constexpr int CH = D / 8;     // 16-byte chunks per row
  constexpr int KS = D / 16;    // k16 steps of Q K^T
  constexpr int NO = D / 8;     // 8-column tiles of the output

  extern __shared__ __align__(16) uint8_t dec_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(dec_smem);            // [MAXG][RS]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  bf16* ring = Qs + MAXG * RS + warp * DecodeTile<D>::RING;

  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const int kvh = blockIdx.y;
  const int KV = gridDim.y;
  const int b = blockIdx.z;
  const int cache_len = min(len_dev != nullptr ? *len_dev : len_host, S);
  const int s_begin = split * chunk;
  const int s_end = min(cache_len, s_begin + chunk);   // < s_begin: empty
  const bf16* qb = q + (int64_t)b * q_sb + (int64_t)(kvh * G) * q_sh;
  const bf16* kb = kc + (int64_t)b * k_sb + (int64_t)kvh * k_sh;
  const bf16* vb = vc + (int64_t)b * v_sb + (int64_t)kvh * v_sh;

  // the G query rows, zero rows up to 16: the first copy group
  for (int idx = tid; idx < MAXG * CH; idx += MMA_THREADS) {
    const int g = idx / CH;
    const int c = idx % CH;
    const bool ok = g < G;
    cp_async16(smem_addr(Qs + g * RS + 8 * c),
               ok ? qb + (int64_t)g * q_sh + 8 * c : q, ok ? 16 : 0);
  }
  cp_async_commit();

  // this warp's tiles: warp, warp + 4, ... of the block's run of rows;
  // rows at or past s_end are zero-filled and never read (an empty block
  // has no tile: its warps keep m = -1e30, l = 0, o = 0)
  const int n_tiles = max(0, s_end - s_begin + TR - 1) / TR;
  const int n_mine = n_tiles > warp ? (n_tiles - warp + MMA_WARPS - 1) / MMA_WARPS
                                    : 0;
  auto load_tile = [&](int i) {
    const int s0 = s_begin + (warp + MMA_WARPS * i) * TR;
    bf16* ks = ring + (i % NST) * DecodeTile<D>::STAGE;
    bf16* vs = ks + TR * RS;
    for (int idx = lane; idx < TR * CH; idx += 32) {
      const int r = idx / CH;
      const int c = idx % CH;
      const bool ok = s0 + r < s_end;
      const int64_t row = s0 + r;
      cp_async16(smem_addr(ks + r * RS + 8 * c),
                 ok ? kb + row * k_ss + 8 * c : kc, ok ? 16 : 0);
      cp_async16(smem_addr(vs + r * RS + 8 * c),
                 ok ? vb + row * v_ss + 8 * c : vc, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {
    if (i < n_mine) load_tile(i);
    cp_async_commit();
  }
  cp_async_wait<NST - 1>();   // the Q group
  __syncthreads();
  const uint32_t q_frag = smem_addr(Qs + (lane & 15) * RS + 8 * (lane >> 4));
  uint32_t qf[DecodeTile<D>::Q_IN_REGS ? KS : 1][4];
  if constexpr (DecodeTile<D>::Q_IN_REGS) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) ldsm_x4(qf[kk], q_frag + 32 * kk);
  }

  // m16n8 fragments: this thread holds query rows (heads) g0 and g0 + 8,
  // cache rows col0, col0 + 1 of each 8-row tile, output columns col0,
  // col0 + 1 of each 8-column tile
  const int col0 = 2 * (lane & 3);
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[j][r] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};

  for (int i = 0; i < n_mine; ++i) {
    if (i + NST - 1 < n_mine) load_tile(i + NST - 1);   // stage of tile i - 1
    cp_async_commit();
    cp_async_wait<NST - 1>();
    __syncwarp();
    const int s0 = s_begin + (warp + MMA_WARPS * i) * TR;
    const bf16* ks = ring + (i % NST) * DecodeTile<D>::STAGE;
    const bf16* vs = ks + TR * RS;

    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4];
      if constexpr (DecodeTile<D>::Q_IN_REGS) {
#pragma unroll
        for (int r = 0; r < 4; ++r) qa[r] = qf[kk][r];
      } else {
        ldsm_x4(qa, q_frag + 32 * kk);
      }
      uint32_t bf[4];
      ldsm_x4(bf, smem_addr(ks + ((lane & 7) + 8 * (lane >> 4)) * RS +
                            16 * kk + 8 * ((lane >> 3) & 1)));
      mma_bf16(s[0], qa, bf[0], bf[1]);
      mma_bf16(s[1], qa, bf[2], bf[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        s[j][r] = s0 + 8 * j + col0 + (r & 1) < s_end ? s[j][r] * scale_log2
                                                        : NEG_INF;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]),
                       fmaxf(s[1][2 * h], s[1][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[h], mx);
      const float alpha = exp2f(m_r[h] - m_new);
      m_r[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[j][2 * h] = exp2f(s[j][2 * h] - m_new);
        s[j][2 * h + 1] = exp2f(s[j][2 * h + 1] - m_new);
        sum += s[j][2 * h] + s[j][2 * h + 1];
      }
      l_r[h] = l_r[h] * alpha + sum;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[j][2 * h] *= alpha;
        o[j][2 * h + 1] *= alpha;
      }
    }
    // o += p v: the two score tiles are the A fragment of one k16 step
    const uint32_t a[4] = {pack_bf16(s[0][0], s[0][1]),
                           pack_bf16(s[0][2], s[0][3]),
                           pack_bf16(s[1][0], s[1][1]),
                           pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int jd = 0; jd < NO / 2; ++jd) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, smem_addr(vs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * RS +
                                  8 * (2 * jd + (lane >> 4))));
      mma_bf16(o[2 * jd], a, bf[0], bf[1]);
      mma_bf16(o[2 * jd + 1], a, bf[2], bf[3]);
    }
    __syncwarp();   // this stage is refilled at the next iteration
  }
  cp_async_wait<0>();

  // merge the warps' (m, l, o) in shared memory, in warp order; a warp
  // without a tile holds m = -1e30, l = 0, o = 0 and weighs exp2(-inf) = 0
  __syncthreads();   // every warp is done with Q and its ring
  float* mw = reinterpret_cast<float*>(dec_smem);   // [WARPS][16]
  float* lw = mw + MMA_WARPS * MAXG;                // [WARPS][16]
  float* ow = lw + MMA_WARPS * MAXG;                // [WARPS][16][D]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_r[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int g = (lane >> 2) + 8 * h;
    if ((lane & 3) == 0) {
      mw[warp * MAXG + g] = m_r[h];
      lw[warp * MAXG + g] = l;
    }
    float* orow = ow + (warp * MAXG + g) * D;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      orow[8 * j + col0] = o[j][2 * h];
      orow[8 * j + col0 + 1] = o[j][2 * h + 1];
    }
  }
  __syncthreads();

  const int64_t pair = (int64_t)b * KV + kvh;
  const int64_t base = pair * nsplit + split;   // partials [B, KV, nsplit, G, (D)]
  bf16* ob = out + (int64_t)b * o_sb + (int64_t)(kvh * G) * o_sh;
  for (int idx = tid; idx < G * D; idx += MMA_THREADS) {
    const int g = idx / D;
    const int d = idx % D;
    float m = NEG_INF;
#pragma unroll
    for (int w = 0; w < MMA_WARPS; ++w) m = fmaxf(m, mw[w * MAXG + g]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < MMA_WARPS; ++w) {
      const float e = exp2f(mw[w * MAXG + g] - m);
      num = fmaf(e, ow[(w * MAXG + g) * D + d], num);
      den = fmaf(e, lw[w * MAXG + g], den);
    }
    if (nsplit == 1) {
      ob[(int64_t)g * o_sh + d] = __float2bfloat16_rn(num / fmaxf(den, 1e-30f));
    } else {
      part_acc[base * G * D + idx] = num;
      if (d == 0) {
        part_m[base * G + g] = m;
        part_l[base * G + g] = den;
      }
    }
  }
  if (nsplit == 1) return;

  // the last block of this (b, KV head) to arrive combines the partials
  // in split order (the bits do not depend on which block is last) and
  // hands the ticket back at 0
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&tickets[pair], 1) == nsplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // per head: the splits' weights exp2(m_s - m) and the denominator, in
  // shared memory (no more than 132 splits: split_plan's block target);
  // then every thread sums four columns over the splits, the splits'
  // loads independent of each other
  const int64_t first = pair * nsplit;
  float* pm = reinterpret_cast<float*>(dec_smem);   // [G][nsplit]
  float* pl = pm + MAXG * nsplit;                   // [G][nsplit]
  float* den = pl + MAXG * nsplit;                  // [G]
  for (int i = tid; i < G * nsplit; i += MMA_THREADS) {
    const int gg = i / nsplit;
    const int sp = i % nsplit;
    pm[i] = __ldcg(&part_m[(first + sp) * G + gg]);
    pl[i] = __ldcg(&part_l[(first + sp) * G + gg]);
  }
  __syncthreads();
  for (int gg = tid; gg < G; gg += MMA_THREADS) {
    float m = NEG_INF;
    for (int sp = 0; sp < nsplit; ++sp) m = fmaxf(m, pm[gg * nsplit + sp]);
    float d = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) {
      const float e = exp2f(pm[gg * nsplit + sp] - m);
      pm[gg * nsplit + sp] = e;
      d = fmaf(e, pl[gg * nsplit + sp], d);
    }
    den[gg] = fmaxf(d, 1e-30f);
  }
  __syncthreads();
  for (int i4 = tid; i4 < G * D / 4; i4 += MMA_THREADS) {
    const int gg = 4 * i4 / D;
    const int d = 4 * i4 % D;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < nsplit; ++sp) {
      const float e = pm[gg * nsplit + sp];
      const float4 v = __ldcg(reinterpret_cast<const float4*>(
          part_acc + (first + sp) * G * D) + i4);
      num.x = fmaf(e, v.x, num.x);
      num.y = fmaf(e, v.y, num.y);
      num.z = fmaf(e, v.z, num.z);
      num.w = fmaf(e, v.w, num.w);
    }
    bf16* o = ob + (int64_t)gg * o_sh + d;
    const float r = den[gg];
    o[0] = __float2bfloat16_rn(num.x / r);
    o[1] = __float2bfloat16_rn(num.y / r);
    o[2] = __float2bfloat16_rn(num.z / r);
    o[3] = __float2bfloat16_rn(num.w / r);
  }
  if (tid == 0) tickets[pair] = 0;
}

struct DecodeArgs {
  const void* q;
  const void* kc;
  const void* vc;
  void* out;
  float* part_acc;
  float* part_m;
  float* part_l;
  int* tickets;
  const int* len_dev;
  int B, H, KV, S, cache_len, chunk, nsplit;
  int64_t q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_decode(const DecodeArgs& a) {
  static unsigned smem_set = 0;
  auto kern = decode_partial_kernel<T, D>;
  cudaError_t err = allow_smem(kern, FmaTile<D>::SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int G = a.H / a.KV;
  const float scale = (float)(1.0 / sqrt((double)D));
  const dim3 grid(a.nsplit, a.KV, a.B);
  kern<<<grid, NT, FmaTile<D>::SMEM, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kc),
      static_cast<const T*>(a.vc), a.part_acc, a.part_m, a.part_l, G,
      a.len_dev, a.cache_len, a.S, a.chunk, a.q_sb, a.q_sh, a.k_sb, a.k_ss,
      a.k_sh, a.v_sb, a.v_ss, a.v_sh, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T><<<dim3(a.KV, a.B), NT, 0, a.stream>>>(
      a.part_acc, a.part_m, a.part_l, static_cast<T*>(a.out), G, D, a.nsplit,
      a.o_sb, a.o_sh);
  return (int)cudaGetLastError();
}

template <int D>
int launch_decode_mma(const DecodeArgs& a) {
  static unsigned smem_set = 0;
  auto kern = decode_mma_kernel<D>;
  cudaError_t err = allow_smem(kern, DecodeTile<D>::SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  kern<<<dim3(a.nsplit, a.KV, a.B), MMA_THREADS, DecodeTile<D>::SMEM,
         a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.kc),
      static_cast<const bf16*>(a.vc), static_cast<bf16*>(a.out), a.part_acc,
      a.part_m, a.part_l, a.tickets, a.H / a.KV, a.len_dev, a.cache_len,
      a.S, a.chunk,
      a.q_sb, a.q_sh, a.k_sb, a.k_ss, a.k_sh, a.v_sb, a.v_ss, a.v_sh,
      a.o_sb, a.o_sh, scale_log2);
  return (int)cudaGetLastError();
}

int dispatch_fma(const DecodeArgs& a, int D) {
  switch (D) {
    case 16: return launch_decode<float, 16>(a);
    case 32: return launch_decode<float, 32>(a);
    case 64: return launch_decode<float, 64>(a);
    case 80: return launch_decode<float, 80>(a);
    case 128: return launch_decode<float, 128>(a);
    case 256: return launch_decode<float, 256>(a);
    default: return -1;
  }
}

int dispatch_mma(const DecodeArgs& a, int D) {
  switch (D) {
    case 16: return launch_decode_mma<16>(a);
    case 32: return launch_decode_mma<32>(a);
    case 64: return launch_decode_mma<64>(a);
    case 80: return launch_decode_mma<80>(a);
    case 128: return launch_decode_mma<128>(a);
    case 256: return launch_decode_mma<256>(a);
    default: return -1;
  }
}

// The bf16 kernel's 16-byte copies: the 16-byte rule (common.cuh) on q
// and the caches; where nsplit > 1 it needs the ticket array.
bool aligned_for_mma(const DecodeArgs& a) {
  return base16(a.q) && base16(a.kc) && base16(a.vc) &&
         stride16(a.B, a.q_sb) && stride16(a.H, a.q_sh) &&
         stride16(a.B, a.k_sb) && stride16(a.S, a.k_ss) &&
         stride16(a.KV, a.k_sh) && stride16(a.B, a.v_sb) &&
         stride16(a.S, a.v_ss) && stride16(a.KV, a.v_sh) &&
         (a.nsplit == 1 || a.tickets != nullptr);
}

}  // namespace

// dtype: 0 = float32 (the FMA kernels, two launches), 1 = bfloat16 (the
// mma.sync kernel, one launch, which needs aligned_for_mma).  Strides are
// in elements; the last dimension of every tensor has stride 1.
// part_acc [B, KV, nsplit, G, D], part_m and part_l [B, KV, nsplit, G] are
// float32 scratch, tickets [B, KV] int32 scratch (bf16 only), that the
// caller allocates; the tickets must be 0 before the launch and are 0
// after it.  The length: the device int32 at cache_len_dev where that is
// not null (read when the kernel runs, clamped to S), else cache_len, which
// must lie in [1, S].  The split plan covers the S rows: nsplit * chunk >=
// S and (nsplit - 1) * chunk < S.  Requires H / KV <= 16 and, in bf16,
// nsplit <= 132.  Returns
// cudaGetLastError() after the launches (0 on success), -1 for an
// unsupported head dim, dtype, group size or alignment.  Launches on
// `stream`, does not synchronise, allocates nothing.
extern "C" int fate_decode_attention(
    const void* q, const void* kc, const void* vc, void* out,
    void* part_acc, void* part_m, void* part_l, void* tickets,
    int B, int H, int KV, int D, int S, const void* cache_len_dev,
    int cache_len, int chunk, int nsplit,
    long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_sh, int dtype, void* stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > MAXG) return -1;
  if (S < 1 || (long long)nsplit * chunk < S ||
      (long long)(nsplit - 1) * chunk >= S)
    return -1;
  if (cache_len_dev == nullptr && (cache_len < 1 || cache_len > S)) return -1;
  if (dtype == 1 && nsplit > MAX_SPLIT) return -1;
  DecodeArgs a{q, kc, vc, out,
               static_cast<float*>(part_acc), static_cast<float*>(part_m),
               static_cast<float*>(part_l), static_cast<int*>(tickets),
               static_cast<const int*>(cache_len_dev),
               B, H, KV, S, cache_len, chunk, nsplit,
               q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_fma(a, D);
  if (dtype == 1) return aligned_for_mma(a) ? dispatch_mma(a, D) : -1;
  return -1;
}
