// Decode attention for Hopper: one query token per sequence against a
// static KV cache of which the first cache_len rows are valid.  Replaces
// the TPU kernel src/repro/kernels/decode_attention.py ::
// decode_attention / _decode_kernel.
//
// What it computes (per batch b and KV head kvh, for the G query heads
// kvh*G .. kvh*G+G-1 that share that KV head):
//   s = (q . k_cache[0:cache_len]) * D^-0.5, softmax in float32,
//   out = p @ v_cache[0:cache_len], p kept float32,
//   out = acc / max(l, 1e-30) cast to the input type.
//
// Shape of the kernel.  The TPU grid (B*KV, nS) walked the whole cache
// sequentially and masked rows >= cache_len.  On this card B*KV blocks
// alone would leave most of the 132 SMs idle, so the valid part of the
// cache is split across blocks (grid nsplit x KV x B): each block runs
// the online softmax over its own rows and writes an unnormalised
// partial (m, l, acc); a second small kernel combines the partials.
// Rows at or beyond cache_len are never read: the wrapper sizes the
// split so that every block starts below cache_len, and the tile loads
// are bounded by it.  The [B, S, KV, D] caches are read through their
// strides, so no transposed copy of the cache is made.  cache_len comes
// from the host as an integer; nothing is read back.
//
// What bounds it: bytes.  Each cache row is read once and used for
// 4*G*D flops, far below the card's flops-per-byte ratio; the design
// shares one pass over K and V among the G heads of the group and
// spreads the cache over enough blocks to pull from many SMs at once.
// At the short caches of the served workflows the launch itself is the
// larger part of the time.
#include "common.cuh"

namespace {

using namespace fate;

constexpr int MAXG = 16;   // query heads per KV head the kernel takes
constexpr int BS = 32;     // cache rows per tile (= warp width)
constexpr int NT = 128;    // threads per block

template <typename T, int D>
__global__ void __launch_bounds__(NT)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                      const T* __restrict__ vc, float* __restrict__ part_acc,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      int G, int cache_len, int chunk,
                      int64_t q_sb, int64_t q_sh,
                      int64_t k_sb, int64_t k_ss, int64_t k_sh,
                      int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale) {
  constexpr int KS = D + 1;             // row stride of Ks (floats)
  constexpr int D4 = D / 4;
  constexpr int NJ = MAXG * D / NT;     // (head, column) pairs per thread

  __shared__ float qs[MAXG * D];
  __shared__ float Ks[BS * KS];
  __shared__ __align__(16) float Vs[BS * D];
  __shared__ float Ss[MAXG * BS];
  __shared__ float m_s[MAXG], l_s[MAXG], a_s[MAXG];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const int kvh = blockIdx.y;
  const int KV = gridDim.y;
  const int b = blockIdx.z;

  const int s_begin = split * chunk;
  const int s_end = min(cache_len, s_begin + chunk);

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
    // tile holds at least one valid row, so m_new is a real score and the
    // masked rows get p = 0.
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

struct DecodeArgs {
  const void* q;
  const void* kc;
  const void* vc;
  void* out;
  float* part_acc;
  float* part_m;
  float* part_l;
  int B, H, KV, cache_len, chunk, nsplit;
  int64_t q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_decode(const DecodeArgs& a) {
  const int G = a.H / a.KV;
  const float scale = (float)(1.0 / sqrt((double)D));
  const dim3 grid(a.nsplit, a.KV, a.B);
  decode_partial_kernel<T, D><<<grid, NT, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kc),
      static_cast<const T*>(a.vc), a.part_acc, a.part_m, a.part_l, G,
      a.cache_len, a.chunk, a.q_sb, a.q_sh, a.k_sb, a.k_ss, a.k_sh, a.v_sb,
      a.v_ss, a.v_sh, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T><<<dim3(a.KV, a.B), NT, 0, a.stream>>>(
      a.part_acc, a.part_m, a.part_l, static_cast<T*>(a.out), G, D, a.nsplit,
      a.o_sb, a.o_sh);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_head_dim(const DecodeArgs& a, int D) {
  switch (D) {
    case 16: return launch_decode<T, 16>(a);
    case 32: return launch_decode<T, 32>(a);
    case 64: return launch_decode<T, 64>(a);
    case 80: return launch_decode<T, 80>(a);
    case 128: return launch_decode<T, 128>(a);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last
// dimension of every tensor has stride 1.  part_acc [B, KV, nsplit, G, D],
// part_m and part_l [B, KV, nsplit, G] are float32 scratch that the
// caller allocates.  Requires 1 <= cache_len, nsplit * chunk >= cache_len,
// (nsplit - 1) * chunk < cache_len and H / KV <= 16.  Returns
// cudaGetLastError() after the launches (0 on success), -1 for an
// unsupported head dim, dtype or group size.  Launches on `stream`, does
// not synchronise, allocates nothing.
extern "C" int fate_decode_attention(
    const void* q, const void* kc, const void* vc, void* out,
    void* part_acc, void* part_m, void* part_l,
    int B, int H, int KV, int D, int cache_len, int chunk, int nsplit,
    long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_sh, int dtype, void* stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > MAXG) return -1;
  if (cache_len < 1 || (long long)nsplit * chunk < cache_len ||
      (long long)(nsplit - 1) * chunk >= cache_len)
    return -1;
  DecodeArgs a{q, kc, vc, out,
               static_cast<float*>(part_acc), static_cast<float*>(part_m),
               static_cast<float*>(part_l),
               B, H, KV, cache_len, chunk, nsplit,
               q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_head_dim<float>(a, D);
  if (dtype == 1) return dispatch_head_dim<__nv_bfloat16>(a, D);
  return -1;
}
