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
// Shape of the kernel.  The TPU grid (B*H, nChunks) carried the state in
// VMEM across sequential grid steps; here one block per (b, h) walks the
// chunks in a loop with the state in shared memory.  b and c are
// [B, S, N] and shared by the heads: every block reads them through their
// strides, so the [B*H, S, N] broadcast copy of the TPU wrapper is never
// made, and x, b, c may be column slices of one conv output (row stride
// d_inner + 2N).  dt is float32 [B, S, H]; dt * a is formed here.
// Per chunk, between four block-wide barriers:
//   1. warp 0 scans dt * a (float64) with shuffles into cum, exp(cum)
//      and w = exp(total - cum) * dt; the other warps load the x, b, c
//      tiles, widened to float32;
//   2. scores G_ij = (c_i . b_j) exp(cum_i - cum_j) dt_j for j <= i, and 0
//      above the diagonal;
//   3. y = G x + (exp(cum) c) S^T, written to device memory;
//   4. S <- exp(total) S + (w x)^T b.
// 256 threads as a 16 x 16 grid (ty, tx), each with a register tile:
// rows ty + 16r and columns tx + 16c of G in 2. (only c <= r: the
// blocks above the diagonal hold no pair j <= i and are never computed),
// of y in 3., and of S in 4.
//
// Shared memory, laid out for the longest chunk MAXL = 128 whatever L is
// (tile rows at or past L hold zeros): cum [MAXL] doubles, then in
// floats dt, exp(cum) and w [MAXL] each, S [P][N+1], x [MAXL][P], b and
// c [MAXL][N+1] and G [MAXL][MAXL+1]: 184,576 bytes at P = N = 64, so
// one block per SM.  Rows of S, b, c and G are padded by one float, so
// that the 16 threads of a half-warp walking down a column hit 16 banks.
//
// What bounds it.  All arithmetic is float32 FMAs on the CUDA cores for
// either input type: the 5e-4 bar of the float32 sweep needs true float32
// accumulation.  At zamba2-2.7b's prefill (B 8, S 512, H 80, P = N = 64,
// L 128, bf16 x, b, c) the causal half of the products is about 11 GFLOP,
// 0.16 ms at an H100's 67 TFLOP/s float32 peak, against about 107 MB of
// traffic (x and y, the states, dt, b, c), 0.03 ms at 3.35 TB/s:
// operations bound it.  Tensor cores (each product is [128 x 64] @
// [64 x 128]-sized), TMA loads and sharing the c . b scores among the
// heads of a batch (they do not depend on h) are left for a later
// version.  Times are in PERF.md.
#include "common.cuh"

namespace {

using namespace fate;

constexpr int NT = 256;          // 16 x 16 threads
constexpr int MAXL = 128;        // longest chunk
constexpr int RM = MAXL / 16;    // tile rows per thread

template <typename T, int P, int N>
__global__ void __launch_bounds__(NT)
mamba2_scan_kernel(const T* __restrict__ x, const T* __restrict__ bm,
                   const T* __restrict__ cm, const float* __restrict__ dt,
                   const float* __restrict__ a_log, const float* state0,
                   T* __restrict__ y, float* state_out, int H, int S, int L,
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
  T* yb = y + (int64_t)b * y_sb + (int64_t)h * y_sh;
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
            yb[(int64_t)(t0 + i) * y_ss + tx + 16 * c] = from_float<T>(acc[r][c]);
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

struct ScanArgs {
  const void *x, *b, *c;
  const float *dt, *a_log, *state0;
  void* y;
  float* state_out;
  int B, S, H, L;
  int64_t x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss, dt_sb, dt_ss, dt_sh;
  int64_t y_sb, y_ss, y_sh;
  cudaStream_t stream;
};

template <typename T, int P, int N>
int launch_scan(const ScanArgs& a) {
  // the dynamic shared-memory ceiling is raised once per instantiation
  static bool granted = false;
  const size_t bytes = smem_bytes(P, N);
  if (!granted) {
    cudaError_t err = cudaFuncSetAttribute(
        mamba2_scan_kernel<T, P, N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    granted = true;
  }
  mamba2_scan_kernel<T, P, N><<<a.B * a.H, NT, bytes, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.b),
      static_cast<const T*>(a.c), a.dt, a.a_log, a.state0,
      static_cast<T*>(a.y), a.state_out, a.H, a.S, a.L, a.x_sb, a.x_ss,
      a.x_sh, a.b_sb, a.b_ss, a.c_sb, a.c_ss, a.dt_sb, a.dt_ss, a.dt_sh,
      a.y_sb, a.y_ss, a.y_sh);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dims(const ScanArgs& a, int P, int N) {
  if (P == 16 && N == 8) return launch_scan<T, 16, 8>(a);
  if (P == 64 && N == 64) return launch_scan<T, 64, 64>(a);
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for x, b, c and y; dt, a_log, state0
// and state_out are float32.  x and y are [B, S, H, P], b and c
// [B, S, N], dt [B, S, H], all with the given strides (in elements; the
// last dimension of x, b, c and y has stride 1); a_log is a contiguous
// [H], state0 and state_out contiguous [B, H, P, N] (they may be the same
// buffer).  Takes (P, N) in {(16, 8), (64, 64)}, 1 <= L <= 128 and
// S % L == 0.  Returns cudaGetLastError() after the launch (0 on
// success), -1 for arguments it does not take.  Launches on `stream`, does
// not synchronise, allocates nothing.
extern "C" int fate_mamba2_scan(
    const void* x, const void* b, const void* c, const void* dt,
    const void* a_log, const void* state0, void* y, void* state_out,
    int B, int S, int H, int P, int N, int L,
    long long x_sb, long long x_ss, long long x_sh,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    long long dt_sb, long long dt_ss, long long dt_sh,
    long long y_sb, long long y_ss, long long y_sh, int dtype, void* stream) {
  if (B < 1 || H < 1 || S < 1 || L < 1 || L > MAXL || S % L != 0) return -1;
  ScanArgs a{x, b, c,
             static_cast<const float*>(dt), static_cast<const float*>(a_log),
             static_cast<const float*>(state0), y,
             static_cast<float*>(state_out), B, S, H, L,
             x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss, dt_sb, dt_ss, dt_sh,
             y_sb, y_ss, y_sh, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_dims<float>(a, P, N);
  if (dtype == 1) return dispatch_dims<__nv_bfloat16>(a, P, N);
  return -1;
}
