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
//   score_ij = sum_k r_ik k_jk exp(min(ce_ik - ci_jk, 0)),
//   S <- exp(total) * S + (k * exp(total - ci))^T v.
// The pairwise exponent ce_i - ci_j is a sum of log decays over (j, i),
// always <= 0, so it stays in log space: a factorised exp(ce_i) *
// exp(-ci_j) overflows under strong decay (w = 1e-6), this form cannot.
//
// Shape of the kernel.  The TPU grid (B*H, nChunks) carried the state in
// VMEM across sequential grid steps; here one block per (b, h) walks the
// chunks in a loop with the [D, D] state in shared memory.
// Per chunk: load the [L, D] tiles of r, k, v and log(clip(w)) (rows
// padded to D + 1 floats, so that threads on neighbouring rows hit
// different banks), one thread per channel takes the cumulative sums,
// then one thread per (i, j) pair reduces the score over k in registers:
// the [L, L, D] pairwise tensor of the TPU kernel is never materialised.
// Then r and k are rescaled in place, each thread produces (i, c)
// outputs from the old state and the scores, and each thread updates its
// (k, c) entries of the state.  Six block-wide barriers per chunk.
//
// Why no tensor cores yet.  Every product here is float32 (the 5e-4 bar
// and the strong-decay case leave no room for bf16 operands in the
// exponentials), and at L = 32, D = 64 the three small products per chunk
// are [32 x 64] @ [64 x 64]-sized: TF32 mma would lose the float32
// accumulation the bar needs, and the exp count (L^2 / 2 * D per chunk)
// is a fixed share of the work either way.  So the arithmetic is float32
// FMAs and expf on the CUDA cores.  On an NVIDIA H100 SXM (data-sheet
// rates, 700 W power limit) what bounds the function is operations: at
// rwkv6-3b's prefill shape, about 4 GFLOP and 1.6e8 exp take ~0.06 ms at
// its 67 TFLOP/s float32 peak, against 136 MB of traffic taking 0.04 ms
// at its 3.35 TB/s.  Times are in PERF.md.
#include "common.cuh"

namespace {

using namespace fate;

constexpr int NT = 256;

template <typename T, int D>
__global__ void __launch_bounds__(NT)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ bonus,
                  const float* __restrict__ state0, T* __restrict__ out,
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
  const T* rb = r + (int64_t)b * r_sb + (int64_t)h * r_sh;
  const T* kb = k + (int64_t)b * k_sb + (int64_t)h * k_sh;
  const T* vb = v + (int64_t)b * v_sb + (int64_t)h * v_sh;
  const float* wb = w + (int64_t)b * w_sb + (int64_t)h * w_sh;
  T* ob = out + (int64_t)b * o_sb + (int64_t)h * o_sh;
  const int64_t st_off = (int64_t)blockIdx.x * D * D;   // [B, H, D, D]

  for (int idx = tid; idx < D * D; idx += NT) st[idx] = state0[st_off + idx];
  for (int d = tid; d < D; d += NT) bon[d] = bonus[(int64_t)h * D + d];

  for (int t0 = 0; t0 < S; t0 += L) {
    __syncthreads();   // the previous chunk is done with the tiles
    for (int idx = tid; idx < L * D; idx += NT) {
      const int i = idx / D;
      const int d = idx % D;
      const int64_t t = t0 + i;
      rs[i * DP + d] = to_float<T>(rb[t * r_ss + d]);
      ks[i * DP + d] = to_float<T>(kb[t * k_ss + d]);
      vs[i * DP + d] = to_float<T>(vb[t * v_ss + d]);
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
      ob[(int64_t)(t0 + i) * o_ss + c] = from_float<T>(o);
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

size_t smem_bytes(int D, int L) {
  return sizeof(float) *
         ((size_t)D * D + 5 * (size_t)L * (D + 1) + (size_t)L * L + D);
}

struct ScanArgs {
  const void *r, *k, *v;
  const float *w, *bonus, *state0;
  void* out;
  float* state_out;
  int B, S, H, L;
  int64_t r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int64_t w_sb, w_ss, w_sh, o_sb, o_ss, o_sh;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_scan(const ScanArgs& a) {
  // raise the dynamic shared-memory ceiling once per instantiation, to
  // the most this process has asked of it
  static size_t granted = 48 * 1024;
  const size_t bytes = smem_bytes(D, a.L);
  if (bytes > granted) {
    cudaError_t err = cudaFuncSetAttribute(
        rwkv6_scan_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    granted = bytes;
  }
  rwkv6_scan_kernel<T, D><<<a.B * a.H, NT, bytes, a.stream>>>(
      static_cast<const T*>(a.r), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.w, a.bonus, a.state0,
      static_cast<T*>(a.out), a.state_out, a.H, a.S, a.L, a.r_sb, a.r_ss,
      a.r_sh, a.k_sb, a.k_ss, a.k_sh, a.v_sb, a.v_ss, a.v_sh, a.w_sb, a.w_ss,
      a.w_sh, a.o_sb, a.o_ss, a.o_sh);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_head_dim(const ScanArgs& a, int D) {
  switch (D) {
    case 16: return launch_scan<T, 16>(a);
    case 32: return launch_scan<T, 32>(a);
    case 64: return launch_scan<T, 64>(a);
    case 128: return launch_scan<T, 128>(a);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for r, k, v and out; w, bonus, state0
// and state_out are float32.  r, k, v, w, out are [B, S, H, D] with the
// given strides (in elements; the last dimension has stride 1); bonus is
// a contiguous [H, D], state0 and state_out contiguous [B, H, D, D] (they
// may be the same buffer).  Requires S % L == 0, 1 <= L <= 64 and the
// shared memory of smem_bytes(D, L) within the card's 227 KB.  Returns
// cudaGetLastError() after the launch (0 on success), -1 for arguments it
// does not take.  Launches on `stream`, does not synchronise, allocates
// nothing.
extern "C" int fate_rwkv6_scan(
    const void* r, const void* k, const void* v, const void* w,
    const void* bonus, const void* state0, void* out, void* state_out,
    int B, int S, int H, int D, int L,
    long long r_sb, long long r_ss, long long r_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long w_sb, long long w_ss, long long w_sh,
    long long o_sb, long long o_ss, long long o_sh, int dtype, void* stream) {
  if (B < 1 || H < 1 || S < 1 || L < 1 || L > 64 || S % L != 0) return -1;
  if (smem_bytes(D, L) > 232448) return -1;
  ScanArgs a{r, k, v,
             static_cast<const float*>(w), static_cast<const float*>(bonus),
             static_cast<const float*>(state0), out,
             static_cast<float*>(state_out), B, S, H, L,
             r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
             w_sb, w_ss, w_sh, o_sb, o_ss, o_sh,
             static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_head_dim<float>(a, D);
  if (dtype == 1) return dispatch_head_dim<__nv_bfloat16>(a, D);
  return -1;
}
