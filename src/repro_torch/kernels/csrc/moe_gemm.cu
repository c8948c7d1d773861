// Grouped per-expert GEMM for Hopper: out[b, e] = x[b, e] @ w[e] for
// every expert e, float32 accumulation, rounded to the input type at the
// store.  Replaces the TPU kernel src/repro/kernels/moe_gemm.py ::
// moe_gemm / _moe_kernel.
//
// What it computes.  x [B, E, C, D] (the MoE layer's capacity-padded
// per-sample dispatch blocks), w [E, D, F] -> out [B, E, C, F].  The TPU
// kernel took [E, C, D] and was called once per sample by vmap; here the
// batch axis is read through its stride and the B*C rows (b, c) of one
// expert form one row range, so each block loads its slice of the
// expert's weights once for all samples, and the strided view the model
// hands over (its dispatch buffer minus the dropped-token slot) is read
// as it lies: nothing is copied.  Dims need not be tile multiples.
//
// Shape of the kernel.  Grid (F / 64, B*C / 64, E); 256 threads, each
// owning a 4 x 4 tile of outputs spaced 16 rows / 16 columns apart (no
// shared-memory bank conflicts on the reads).  The contraction walks D in
// steps of 16 through two shared-memory tiles; every element is widened
// to float32 at the load and the products are float32 FMAs, so float32
// inputs keep true float32 accumulation (the 1e-5 relative bar) and bf16
// inputs accumulate exactly as the TPU kernel's preferred_element_type.
//
// What bounds it on an NVIDIA H100 SXM (data-sheet rates, 700 W power
// limit).  At granite-moe's decode (B*C = 64 rows per expert) the
// function is bound by bytes: the 63 MB of bf16 expert weights are read
// once.  At its prefill (B*C = 1024) it does 64 GFLOP per call, about 280
// flops per byte, near that card's bf16 ridge of 295.  This version
// reaches neither bound: it runs on the float32 FMA pipe of the CUDA
// cores (67 TFLOP/s peak on that card), with no tensor cores, no vector
// loads and no copy/compute overlap.  mma.sync / wgmma with TMA
// pipelining, and skipping empty capacity rows, are later work; the times
// are in PERF.md.
#include "common.cuh"

namespace {

using namespace fate;

constexpr int BM = 64;    // rows (b, c) of one expert per block
constexpr int BN = 64;    // output columns per block
constexpr int BK = 16;    // contraction depth per shared-memory stage
constexpr int NT = 256;   // a 16 x 16 grid of threads, 4 x 4 outputs each
constexpr int LOADS = BM * BK / NT;   // elements of each tile per thread

static_assert(BM * BK == BK * BN, "A and B tiles are loaded alike");

template <typename T>
__global__ void __launch_bounds__(NT)
moe_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ out, int C, int D, int F, int rows,
                int64_t x_sb, int64_t x_se, int64_t x_sc, int64_t x_sd,
                int64_t w_se, int64_t w_sd, int64_t w_sf,
                int64_t o_sb, int64_t o_se, int64_t o_sc) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n0 = blockIdx.x * BN;
  const int r0 = blockIdx.y * BM;
  const int e = blockIdx.z;
  const T* xe = x + (int64_t)e * x_se;
  const T* we = w + (int64_t)e * w_se;

  // the A elements this thread loads: row m of the tile, depth a_k
  int64_t a_row[LOADS];
  int a_m[LOADS], a_k[LOADS];
  bool a_ok[LOADS];
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int idx = tid + i * NT;
    a_m[i] = idx / BK;
    a_k[i] = idx % BK;
    const int r = r0 + a_m[i];
    a_ok[i] = r < rows;
    const int b = a_ok[i] ? r / C : 0;
    const int c = a_ok[i] ? r % C : 0;
    a_row[i] = (int64_t)b * x_sb + (int64_t)c * x_sc;
  }
  // the B elements: depth b_k, column b_n
  int b_k[LOADS], b_n[LOADS];
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int idx = tid + i * NT;
    b_k[i] = idx / BN;
    b_n[i] = idx % BN;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += BK) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int kx = k0 + a_k[i];
      As[a_k[i]][a_m[i]] =
          (a_ok[i] && kx < D) ? to_float<T>(xe[a_row[i] + (int64_t)kx * x_sd])
                              : 0.f;
      const int kw = k0 + b_k[i];
      const int n = n0 + b_n[i];
      Bs[b_k[i]][b_n[i]] =
          (kw < D && n < F)
              ? to_float<T>(we[(int64_t)kw * w_sd + (int64_t)n * w_sf])
              : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
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

  T* oe = out + (int64_t)e * o_se;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= rows) continue;
    const int b = r / C;
    const int c = r % C;
    T* orow = oe + (int64_t)b * o_sb + (int64_t)c * o_sc;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < F) orow[n] = from_float<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch_moe_gemm(const void* x, const void* w, void* out, int B, int E,
                    int C, int D, int F, long long x_sb, long long x_se,
                    long long x_sc, long long x_sd, long long w_se,
                    long long w_sd, long long w_sf, long long o_sb,
                    long long o_se, long long o_sc, cudaStream_t stream) {
  const int rows = B * C;
  const dim3 grid((F + BN - 1) / BN, (rows + BM - 1) / BM, E);
  moe_gemm_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), C, D, F, rows, x_sb, x_se, x_sc, x_sd, w_se,
      w_sd, w_sf, o_sb, o_se, o_sc);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it).  Strides are
// in elements; x and w may have any strides (each element is loaded on
// its own), out's last dimension has stride 1.  x [B, E, C, D],
// w [E, D, F], out [B, E, C, F].  Requires every dimension >= 1,
// B * C < 2^31 and E <= 65535.  Returns
// cudaGetLastError() after the launch (0 on success), -1 for arguments
// it does not take.  Launches on `stream`, does not synchronise,
// allocates nothing.
extern "C" int fate_moe_gemm(const void* x, const void* w, void* out, int B,
                             int E, int C, int D, int F, long long x_sb,
                             long long x_se, long long x_sc, long long x_sd,
                             long long w_se, long long w_sd, long long w_sf,
                             long long o_sb, long long o_se, long long o_sc,
                             int dtype, void* stream) {
  if (B < 1 || E < 1 || C < 1 || D < 1 || F < 1 || E > 65535) return -1;
  if ((long long)B * C >= (1LL << 31)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_moe_gemm<float>(x, w, out, B, E, C, D, F, x_sb, x_se, x_sc,
                                  x_sd, w_se, w_sd, w_sf, o_sb, o_se, o_sc, s);
  if (dtype == 1)
    return launch_moe_gemm<__nv_bfloat16>(x, w, out, B, E, C, D, F, x_sb,
                                          x_se, x_sc, x_sd, w_se, w_sd, w_sf,
                                          o_sb, o_se, o_sc, s);
  return -1;
}
