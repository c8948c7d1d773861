// Prefill attention for Hopper: GQA, optional causal mask, optional
// sliding window, online softmax.  Replaces the TPU kernel
// src/repro/kernels/flash_attention.py :: flash_attention / _flash_kernel.
//
// What it computes (per batch b, query head h, KV head h / G):
//   s = (q . k) * D^-0.5, masked to -1e30 where k_pos >= Sk, or
//   (causal) q_pos < k_pos, or (window) q_pos - k_pos >= window;
//   out = softmax(s) @ v, with float32 scores, float32 p and a float32
//   accumulator; out = acc / max(l, 1e-30) cast to the input type.
//
// Shape of the kernel.  The TPU grid (B*KV*G, nQ, nK) carried (m, l, acc)
// in VMEM across sequential nK steps.  Here one block owns one
// (batch, head, 64-row query tile) and loops over KV tiles itself; the
// running (m, l, acc) stay in registers.  KV tiles wholly above the
// causal diagonal or wholly below the window are never visited.  q, k, v
// are read through their strides ([B, S, heads, D] as the models hold
// them): no transposed copy is made.
//
// Work split inside a block: 256 threads as a 16 x 16 grid.  Thread
// (ty, tx) owns query rows 4*ty .. 4*ty+3, score columns tx + 16*c and
// output columns tx + 16*j, so the 16 threads of a row are one half-warp
// and the row statistics are reduced with shuffles.  Q, K, V tiles are
// widened to float32 in shared memory; p goes through shared memory into
// the PV product as float32, as the TPU kernel keeps it.
//
// What bounds it.  On an H100 (3.35 TB/s, 989 TFLOP/s bf16: 295 flops per
// byte) the least time for the function is set by bytes: causal bf16
// prefill at B = 8, S = 512, H = 16, KV = 8, D = 128 does about 171 flops
// per byte of q/k/v/out moved once, 0.015 ms of traffic.  THIS version is
// limited elsewhere: it does the products as float32 FMAs on the CUDA
// cores (67 TFLOP/s peak, no tensor cores), so it runs at the float32 FMA
// rate, far above that bound.  The design keeps the FMA pipe fed (4 x CN
// and 4 x DN register tiles, 128-bit shared-memory loads, conflict-free
// strides) and leaves mma/wgmma, TMA and pipelining for a later version.
//
// Rows that have no valid key at all (possible only with a window and
// Sq > Sk + window) are degenerate in the reference (a uniform average
// over masked keys); here they average over the visited tiles, or give 0
// when no tile is visited.
#include "common.cuh"

namespace {

using namespace fate;

constexpr int BM = 64;          // query rows per block
constexpr int NTHREADS = 256;   // 16 x 16

template <typename T, int D, int BN>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 int Sq, int Sk, int G,
                 int64_t q_sb, int64_t q_ss, int64_t q_sh,
                 int64_t k_sb, int64_t k_ss, int64_t k_sh,
                 int64_t v_sb, int64_t v_ss, int64_t v_sh,
                 int64_t o_sb, int64_t o_ss, int64_t o_sh,
                 int causal, int window, float scale) {
  constexpr int QS = D + 4;     // row stride of Qs and Ks (floats)
  constexpr int PS = BN + 4;    // row stride of Ps
  constexpr int CN = BN / 16;   // score columns per thread
  constexpr int DN = D / 16;    // output columns per thread
  constexpr int D4 = D / 4;

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // [BM][QS]
  float* Ks = Qs + BM * QS;       // [BN][QS]
  float* Vs = Ks + BN * QS;       // [BN][D]
  float* Ps = Vs + BN * D;        // [BM][PS]

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

  // KV tiles that can hold a valid key for some row of this query tile.
  int k_end = Sk;
  if (causal) k_end = min(Sk, q0 + BM);
  int k_begin = 0;
  if (window > 0) k_begin = (max(0, q0 - window + 1) / BN) * BN;

  for (int k0 = k_begin; k0 < k_end; k0 += BN) {
    __syncthreads();   // the previous tile's PV product has read Ks/Vs/Ps
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
      *reinterpret_cast<float4*>(&Vs[r * D + c]) = vval;
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
      const int q_pos = q0 + row;
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
        const float v0 = Vs[(n + 0) * D + dc];
        const float v1 = Vs[(n + 1) * D + dc];
        const float v2 = Vs[(n + 2) * D + dc];
        const float v3 = Vs[(n + 3) * D + dc];
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
#pragma unroll
      for (int j = 0; j < DN; ++j)
        ob[(int64_t)r * o_ss + tx + 16 * j] = from_float<T>(acc[i][j] / denom);
    }
  }
}

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int B, Sq, Sk, H, KV;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  int causal, window;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_flash(const FlashArgs& a) {
  constexpr int BN = (D > 64) ? 32 : 64;
  constexpr size_t smem_bytes =
      sizeof(float) * (BM * (D + 4) + BN * (D + 4) + BN * D + BM * (BN + 4));
  auto kern = flash_fwd_kernel<T, D, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + BM - 1) / BM, a.H, a.B);
  const float scale = (float)(1.0 / sqrt((double)D));
  kern<<<grid, NTHREADS, smem_bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.Sq, a.Sk,
      a.H / a.KV, a.q_sb, a.q_ss, a.q_sh, a.k_sb, a.k_ss, a.k_sh, a.v_sb,
      a.v_ss, a.v_sh, a.o_sb, a.o_ss, a.o_sh, a.causal, a.window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_head_dim(const FlashArgs& a, int D) {
  switch (D) {
    case 16: return launch_flash<T, 16>(a);
    case 32: return launch_flash<T, 32>(a);
    case 64: return launch_flash<T, 64>(a);
    case 80: return launch_flash<T, 80>(a);
    case 128: return launch_flash<T, 128>(a);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last
// dimension of every tensor has stride 1.  Returns cudaGetLastError()
// after the launch (0 on success), -1 for an unsupported head dim or
// dtype.  Launches on `stream`, does not synchronise, allocates nothing.
extern "C" int fate_flash_attention(
    const void* q, const void* k, const void* v, void* out,
    int B, int Sq, int Sk, int H, int KV, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, int dtype, void* stream) {
  FlashArgs a{q, k, v, out, B, Sq, Sk, H, KV,
              q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
              o_sb, o_ss, o_sh, causal, window,
              static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_head_dim<float>(a, D);
  if (dtype == 1) return dispatch_head_dim<__nv_bfloat16>(a, D);
  return -1;
}
