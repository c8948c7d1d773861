// Backward of the chunked Mamba2 (SSD) scan (K4b), for Hopper.  No TPU
// kernel corresponds to it: the Pallas kernel src/repro/kernels/
// mamba2_scan.py :: mamba2_scan has no backward, and the reference trains
// by differentiating the scan's XLA twin, src/repro/models/ssm.py ::
// _ssd_chunked.
//
// What it computes, per batch b and head h, for the forward of
// csrc/mamba2_scan.cu (S the [P, N] float32 state, a = -exp(a_log[h])):
//   S_t = exp(dt_t a) S_{t-1} + dt_t x_t b_t^T,    y_t = S_t c_t
// from dy (float32) and the final state's cotangent (zeros if absent):
// dx, db, dc (b and c shared by the heads, so their gradients are summed
// over the heads), ddt, da_log (summed over the batch and the sequence) and
// the initial state's cotangent dstate0.
//
// In chunks of L steps with cum the inclusive sums of dt a over the chunk
// (T = cum[L-1]), S0 the state before the chunk and dE the cotangent of
// the state after it, M_ij = exp(cum_i - cum_j) (c_i . b_j) and
// E_ij = exp(cum_i - cum_j) dt_j (dy_i . x_j) for j <= i (0 above):
//   dx_j = dt_j (sum_i M_ij dy_i + exp(T - cum_j) dE b_j)
//   dc_i = sum_h (sum_j E_ij b_j + exp(cum_i) S0^T dy_i)
//   db_j = sum_h (sum_i E_ij c_i + exp(T - cum_j) dt_j dE^T x_j)
//   ddt_j = sum_i Q_ij + exp(T - cum_j) b_j . (dE^T x_j) + a g_j
// with Q_ij = M_ij (dy_i . x_j), and g_t the gradient of dt_t a, the sum
// over the exponents that span step t, each term carrying the decays it
// spans (so every exponent formed is <= 0):
//   g_t = sum_{i>=t>j} dt_j Q_ij                       (the pairs)
//       + sum_{i>=t} exp(cum_i) c_i . (S0^T dy_i)     (S0 into y_i)
//       + sum_{j<t} exp(T - cum_j) dt_j b_j . (dE^T x_j)   (x_j into S_end)
//       + exp(T) <dE, S0>                             (S0 into S_end)
// and da_log = a sum over b and t of dt_t g_t.  The pairs' sum for every t
// is taken from R_ij = dt_j Q_ij by suffix sums down each column (C_j(t) =
// sum_{i>=t} R_ij), then the row sum of C(t) left of t: only additions of
// terms inside the rectangle, never a running difference of row and
// column sums, which cancels where the decay is strong (the form K5b met,
// csrc/rwkv6_scan_bwd.cu).  cum is scanned in float64, as K4's forward
// does: a difference of two prefix sums that reach about -100 over a
// chunk loses every decay weight's relative precision in float32.
//
// The chunked form is exact at any chunk length, so the kernels work in
// sub-chunks of L <= 64 steps (kernels/mamba2_scan.py :: bwd_chunk, 64 at
// the model's chunk of 128), whose boundary states they make themselves.
// The chunk-end states E_c and cotangents dE_c obey, exactly, with one
// scalar factor exp(T_c) <= 1 per (b, h, chunk):
//   E_c      = exp(T_c) E_{c-1} + A_c,  A_c = (w x)^T b, w_j = exp(T_c - cum_j) dt_j  (E_{-1} = state0)
//   dE_{c-1} = exp(T_c) dE_c + B_c,     B_c = (exp(cum) dy)^T c                     (dE_{NC-1} = dstate)
// So, in four launches:
//   1a. one block per (b * H + h, chunk) for both directions: the
//       chunk's cum (a warp's float64 scan), then A_c into states[c] and
//       B_c into dstates[c], each a [L, P]^T x [L, N] product, and exp(T_c)
//       into factors[c]: for bf16 at (64, 64) mamba2_bwd_local_mma_kernel
//       (mma.sync, w x and exp(cum) dy as two bf16 terms each), else
//       mamba2_bwd_local_kernel (float32 FMA in register tiles).
//   1b. mamba2_bwd_scan_kernel, one thread per (b * H + h, four entries
//       of the state), walks the chunks in place in a fixed order: forward
//       E_c = f_c E_{c-1} + A_c; backward B_c is read before dE_c
//       overwrites it, then dstate0.  SU chunks' loads in flight.
//   2.  the per-chunk gradients, one block per (group of HG heads, b,
//       chunk): the scores C B^T once for the group's heads, then head by
//       head from S0 (E_{c-1} or state0) and dE_c: the state terms S0^T dy,
//       dE^T x and dE b ([L, P] x [P, N] products), the pairs' dy . x with
//       their decays into M (for dx), E (for dc and db) and R (for g), the
//       column suffix sums, dx and ddt written, the chunk's term of da_log
//       written as a partial; db and dc summed over the group's heads in
//       registers, in head order, and written as the group's partial.
//       bf16 x, b, c at (P, N) = (64, 64): mamba2_bwd_mma_kernel, every
//       product on the tensor cores (mma.sync m16n8k16, bf16 operands,
//       float32 sums) from bf16 tiles in shared memory read by ldmatrix
//       (.trans for the transposed operands M^T, E^T and the [k][n]
//       tiles), x, b, c exact, dy, S0, dE, M and E as two bf16 terms each
//       (hi = bf16(v), lo = bf16(v - hi): a product of two float32 factors
//       takes hi.hi + hi.lo + lo.hi, H21); each of the 8 warps takes 16
//       rows and 32 columns of every [64, 64] product, the triangular ones
//       only up to the diagonal.  157,728 bytes of shared memory: one block
//       an SM.  float32 (and bf16 at (16, 8), SMOKE's dims):
//       mamba2_bwd_chunk_kernel, every product on the CUDA cores in float32
//       (FMA), x, b, c widened to float32 in shared memory.
//   3.  mamba2_bwd_sum_kernel: db and dc summed over the head groups, and
//       da_log over the batch and the chunks, each in increasing order.
// No atomics: a call's bits repeat.
//
// What bounds it.  At zamba2-2.7b's training microbatch (B 2, S 4096, H
// 80, P = N = 64, bf16 x, b, c, float32 dt and dy) the function moves about
// 345 MB (x, dx in bf16; dy float32; b, c, dt and their gradients), 0.103
// ms at an H100's 3.35 TB/s.  Its operations are about 2 x the forward's
// 16.3 GFLOP, far below the tensor cores' peak.  The design adds its own
// traffic (A and B, 168 MB each at sub-chunks of 64, written, scanned in
// place and read again; S0 and dE read again by the per-chunk kernel),
// about 1.1 GB in all; its times on an NVIDIA H100 are in PERF.md
// (chip_smoke.py's kernels phase, tools/kernel_probe.py
// mamba2-bwd-phases).
#include <type_traits>

#include "common.cuh"

namespace {

using namespace fate;
using bf16 = __nv_bfloat16;

constexpr int NT = 256;            // threads of every kernel (16 x 16 tiles)
constexpr int MAXL = 64;           // longest sub-chunk
constexpr int RM = MAXL / 16;      // tile rows a thread takes
constexpr int HG = 8;              // heads a block of the per-chunk pass takes
constexpr size_t SMEM_LIMIT = 232448;

// passes of the C entry (kernels/mamba2_scan.py mirrors them)
constexpr int PASS_STATES = 1, PASS_COTANGENTS = 2, PASS_CHUNKS = 4,
              PASS_SUMS = 8;

struct BwdArgs {
  const void *x, *b, *c;
  const float *dt, *a_log, *state0, *dy, *dstate;
  float *states, *dstates, *factors;
  void* dx;
  float *ddt, *db_part, *dc_part, *da_part;
  void *db, *dc;
  float *da_log, *dstate0;
  int B, S, H, L;
  int64_t x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss, dt_sb, dt_ss, dt_sh;
  int64_t y_sb, y_ss, y_sh;
  int passes;
  cudaStream_t stream;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One warp: cum[i] = sum_{k<=i} dt_k a in float64 and dts[i] = dt_i for
// rows i < L (0 past L, up to MAXL); cum[MAXL] = T = cum[L-1].  The same
// float products dt * a as K4's forward takes.
__device__ __forceinline__ void scan_cum(const float* dtb, int64_t dt_ss,
                                         int t0, int L, float a, double* cum,
                                         float* dts, int lane) {
  double carry = 0.0;
  for (int base = 0; base < MAXL; base += 32) {
    const int i = base + lane;
    const float d = i < L ? dtb[(int64_t)(t0 + i) * dt_ss] : 0.f;
    double v = (double)(d * a);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    v += carry;
    carry = __shfl_sync(0xffffffffu, v, 31);
    cum[i] = v;
    dts[i] = d;
  }
  if (lane == 0) cum[MAXL] = carry;
}

// Over the 32 lanes, the sum of x at lanes >= lane (suffix) or <= lane
// (prefix), in a fixed order; the array form scans K values together, so
// that their shuffles overlap
template <int K>
__device__ __forceinline__ void warp_suffix_sums(float (&x)[K], int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float y = __shfl_down_sync(0xffffffffu, x[k], off);
      if (lane + off < 32) x[k] += y;
    }
}

__device__ __forceinline__ float warp_suffix_sum(float x, int lane) {
  float v[1] = {x};
  warp_suffix_sums(v, lane);
  return v[0];
}

__device__ __forceinline__ float warp_prefix_sum(float x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

// rows i < L of a [L, W] operand (W a multiple of 4) into a float tile of
// row stride ST, widened from T, four elements a load; rows L .. MAXL-1
// zero
template <typename T, int W, int ST>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int t0, int L,
                                          int tid) {
  constexpr int W4 = W / 4;
  for (int idx = tid; idx < MAXL * W4; idx += NT) {
    const int i = idx / W4, n = 4 * (idx % W4);
    const float4 v = i < L ? load4<T>(src + (int64_t)(t0 + i) * row_stride + n)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    float* d = dst + i * ST + n;
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  }
}

// --- 1a. a chunk's contributions to its end state and cotangent ----------

template <int P, int N>
size_t local_smem() {
  return sizeof(double) * (MAXL + 2) +
         sizeof(float) * (MAXL + 2 * MAXL * P + 2 * MAXL * N);
}

// out[p][n] = sum_j X[j][p] Y[j][n] over the chunk's L rows in order:
// thread (ty, tx) takes rows 4 ty .. 4 ty + 3 of P and columns 4 tx .. 4 tx
// + 3 of N, each row of X and Y read as one 16-byte load (16 FMAs for two
// loads); threads past P or N idle
template <int P, int N>
__device__ __forceinline__ void local_product(const float* X, const float* Y,
                                              float* out, int L, int ty,
                                              int tx) {
  if (4 * ty >= P || 4 * tx >= N) return;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
#pragma unroll 4
  for (int j = 0; j < L; ++j) {
    const float4 xv = ld4(X + j * P + 4 * ty);
    const float4 yv = ld4(Y + j * N + 4 * tx);
    const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
    const float yr[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(xr[r], yr[q], acc[r][q]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
    *reinterpret_cast<float4*>(out + (4 * ty + r) * N + 4 * tx) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
}

// One block per (b * H + h, chunk) takes the directions the passes ask
// for: the chunk's cum once, then A_c = (w x)^T b into states[c] and
// B_c = (exp(cum) dy)^T c into dstates[c], and exp(T) into factors[c]
template <typename T, int P, int N>
__global__ void __launch_bounds__(NT) mamba2_bwd_local_kernel(BwdArgs a) {
  const int bh = blockIdx.x, cidx = blockIdx.y;
  const int H = a.H, L = a.L, NC = a.S / L;
  const int bb = bh / H, h = bh % H;
  const int t0 = cidx * L;
  const bool fwd = (a.passes & PASS_STATES) != 0;
  const bool bwd = (a.passes & PASS_COTANGENTS) != 0;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  extern __shared__ __align__(16) double smem_lc[];
  double* cum = smem_lc;                       // [MAXL + 1], + pad
  float* dts = reinterpret_cast<float*>(cum + MAXL + 2);
  float* xs = dts + MAXL;                      // [MAXL][P] x, then w x
                                               // (16-byte aligned rows)
  float* ys = xs + MAXL * P;                   // [MAXL][P] dy, then scaled
  float* bs = ys + MAXL * P;                   // [MAXL][N]
  float* cs = bs + MAXL * N;                   // [MAXL][N]

  const float av = -expf(a.a_log[h]);
  const float* dtb = a.dt + (int64_t)bb * a.dt_sb + (int64_t)h * a.dt_sh;
  if (fwd) {
    load_tile<T, P, P>(xs, static_cast<const T*>(a.x) + (int64_t)bb * a.x_sb +
                               (int64_t)h * a.x_sh, a.x_ss, t0, L, tid);
    load_tile<T, N, N>(bs, static_cast<const T*>(a.b) + (int64_t)bb * a.b_sb,
                       a.b_ss, t0, L, tid);
  }
  if (bwd) {
    load_tile<float, P, P>(ys, a.dy + (int64_t)bb * a.y_sb + (int64_t)h * a.y_sh,
                           a.y_ss, t0, L, tid);
    load_tile<T, N, N>(cs, static_cast<const T*>(a.c) + (int64_t)bb * a.c_sb,
                       a.c_ss, t0, L, tid);
  }
  if (tid < 32) scan_cum(dtb, a.dt_ss, t0, L, av, cum, dts, tid);
  __syncthreads();
  const double tot = cum[MAXL];
  for (int idx = tid; idx < L * P; idx += NT) {
    const int i = idx / P;
    if (fwd) xs[idx] *= expf((float)(tot - cum[i])) * dts[i];
    if (bwd) ys[idx] *= expf((float)cum[i]);
  }
  if (tid == 0) a.factors[(int64_t)bh * NC + cidx] = expf((float)tot);
  __syncthreads();
  const int64_t off = ((int64_t)bh * NC + cidx) * P * N;
  if (fwd) local_product<P, N>(xs, bs, a.states + off, L, ty, tx);
  if (bwd) local_product<P, N>(ys, cs, a.dstates + off, L, ty, tx);
}

// --- 1b. the chunk-end states and cotangents, an elementwise scan ---------

constexpr int SU = 8;              // chunks whose loads a thread keeps in flight

template <int P, int N>
__global__ void __launch_bounds__(NT) mamba2_bwd_scan_kernel(BwdArgs a,
                                                             int first_half) {
  constexpr int Q = P * N / 4;     // four-entry pieces of a state
  const int NC = a.S / a.L;
  const int64_t e = (int64_t)blockIdx.x * NT + threadIdx.x;
  if (e >= (int64_t)a.B * a.H * Q) return;
  const int bh = (int)(e / Q), q = (int)(e % Q);
  const bool fwd = first_half + (int)blockIdx.y == 0;
  const int64_t step_d = (int64_t)P * N;
  float* buf = (fwd ? a.states : a.dstates) + (int64_t)bh * NC * step_d + 4 * q;
  const float* f = a.factors + (int64_t)bh * NC;
  const float* init = fwd ? a.state0 : a.dstate;
  float4 cur = init != nullptr ? ld4(init + (int64_t)bh * step_d + 4 * q)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < NC; s0 += SU) {
    float4 x[SU];
    float fc[SU];
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      const int c = fwd ? s0 + u : NC - 1 - s0 - u;
      if (s0 + u < NC) {
        x[u] = ld4(buf + c * step_d);
        fc[u] = f[c];
      }
    }
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      if (s0 + u >= NC) break;
      const int c = fwd ? s0 + u : NC - 1 - s0 - u;
      float4* dst = reinterpret_cast<float4*>(buf + c * step_d);
      if (!fwd) *dst = cur;                 // dE_c; B_c was read above
      cur = make_float4(fmaf(fc[u], cur.x, x[u].x), fmaf(fc[u], cur.y, x[u].y),
                        fmaf(fc[u], cur.z, x[u].z), fmaf(fc[u], cur.w, x[u].w));
      if (fwd) *dst = cur;                  // E_c
    }
  }
  if (!fwd && a.dstate0 != nullptr)
    *reinterpret_cast<float4*>(a.dstate0 + (int64_t)bh * step_d + 4 * q) = cur;
}

// --- 2. the per-chunk gradients ---------------------------------------------

// Row strides (floats) of the per-chunk kernel's tiles: one float of pad,
// so that the 16 threads of a half-warp walking down a column hit 16 banks
template <int P, int N>
struct ChunkTile {
  static constexpr int PS = P + 1, NS = N + 1, LS = MAXL + 1;
  static constexpr int PQ = (P + 15) / 16, NQ = (N + 15) / 16;
  static constexpr int VEC = 7 * MAXL + 16 * MAXL + NT + 4;   // small arrays
  static constexpr size_t SMEM =
      sizeof(double) * (MAXL + 2) +
      sizeof(float) * ((size_t)VEC + 2 * MAXL * NS + 2 * MAXL * LS +
                       2 * MAXL * PS + 2 * P * NS);
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(NT, 1) mamba2_bwd_chunk_kernel(BwdArgs a) {
  using Tile = ChunkTile<P, N>;
  constexpr int PS = Tile::PS, NS = Tile::NS, LS = Tile::LS;
  constexpr int PQ = Tile::PQ, NQ = Tile::NQ;
  const int H = a.H, L = a.L, S = a.S, NC = S / L;
  const int grp = blockIdx.x, G = gridDim.x;
  const int bb = blockIdx.y / NC, cc = blockIdx.y % NC;
  const int t0 = cc * L;
  const int h0 = grp * HG, hn = min(HG, H - h0);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int warp = tid >> 5, lane = tid & 31;

  extern __shared__ __align__(16) double smem_ck[];
  double* cum = smem_ck;                         // [MAXL + 1], + pad
  float* dts = reinterpret_cast<float*>(cum + MAXL + 2);   // [MAXL] dt
  float* ue = dts + MAXL;          // [MAXL] exp(cum_i)
  float* we = ue + MAXL;           // [MAXL] exp(T - cum_j)
  float* s2 = we + MAXL;           // [MAXL] exp(cum_i) c_i . (S0^T dy_i)
  float* bx = s2 + MAXL;           // [MAXL] b_j . (dE^T x_j)
  float* qc = bx + MAXL;           // [MAXL] sum_i Q_ij
  float* dg = qc + MAXL;           // [MAXL] dt_t g_t
  float* cp = dg + MAXL;           // [16][MAXL] partial column sums of Q
  float* red = cp + 16 * MAXL;     // [NT] partial <dE, S0>, then the sum
  float* bs = red + NT + 4;        // [MAXL][NS]
  float* cs = bs + MAXL * NS;      // [MAXL][NS]
  float* gs = cs + MAXL * NS;      // [MAXL][LS] c_i . b_j, j <= i
  float* buf = gs + MAXL * LS;     // [MAXL][LS] M, then E, then R
  float* xs = buf + MAXL * LS;     // [MAXL][PS]
  float* ys = xs + MAXL * PS;      // [MAXL][PS] dy
  float* s0s = ys + MAXL * PS;     // [P][NS] S0
  float* des = s0s + P * NS;       // [P][NS] dE

  load_tile<T, N, NS>(bs, static_cast<const T*>(a.b) + (int64_t)bb * a.b_sb,
                      a.b_ss, t0, L, tid);
  load_tile<T, N, NS>(cs, static_cast<const T*>(a.c) + (int64_t)bb * a.c_sb,
                      a.c_ss, t0, L, tid);
  __syncthreads();
  // the scores c_i . b_j for j <= i < L, 0 elsewhere: once for the heads
  {
    float acc[RM][RM];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int q = 0; q < RM; ++q) acc[r][q] = 0.f;
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
        for (int q = 0; q <= r; ++q) acc[r][q] = fmaf(cv[r], bv[q], acc[r][q]);
    }
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int q = 0; q < RM; ++q) {
        const int i = ty + 16 * r, j = tx + 16 * q;
        gs[i * LS + j] = (q <= r && j <= i && i < L) ? acc[r][q] : 0.f;
      }
  }

  // db and dc of the group's heads, summed in head order: rows ty + 16 r,
  // columns tx + 16 q
  float dca[RM][NQ], dba[RM][NQ];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int q = 0; q < NQ; ++q) dca[r][q] = dba[r][q] = 0.f;

  for (int hh = 0; hh < hn; ++hh) {
    const int h = h0 + hh;
    const int bh = bb * H + h;
    const float av = -expf(a.a_log[h]);
    __syncthreads();   // the previous head is done with the per-head tiles
    load_tile<T, P, PS>(xs, static_cast<const T*>(a.x) + (int64_t)bb * a.x_sb +
                                (int64_t)h * a.x_sh, a.x_ss, t0, L, tid);
    load_tile<float, P, PS>(ys, a.dy + (int64_t)bb * a.y_sb + (int64_t)h * a.y_sh,
                            a.y_ss, t0, L, tid);
    {
      const float* s0 = cc > 0 ? a.states + ((int64_t)bh * NC + cc - 1) * P * N
                        : (a.state0 != nullptr ? a.state0 + (int64_t)bh * P * N
                                               : nullptr);
      const float* de = a.dstates + ((int64_t)bh * NC + cc) * P * N;
      for (int idx = tid; idx < P * N / 4; idx += NT) {
        const int p = 4 * idx / N, n = 4 * idx % N;
        const float4 sv = s0 != nullptr ? ld4(s0 + 4 * idx)
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 dv = ld4(de + 4 * idx);
        float* sd = s0s + p * NS + n;
        float* dd = des + p * NS + n;
        sd[0] = sv.x; sd[1] = sv.y; sd[2] = sv.z; sd[3] = sv.w;
        dd[0] = dv.x; dd[1] = dv.y; dd[2] = dv.z; dd[3] = dv.w;
      }
    }
    if (tid < 32)
      scan_cum(a.dt + (int64_t)bb * a.dt_sb + (int64_t)h * a.dt_sh, a.dt_ss, t0,
               L, av, cum, dts, lane);
    __syncthreads();
    const double tot = cum[MAXL];
    if (tid < MAXL) {
      ue[tid] = tid < L ? expf((float)cum[tid]) : 0.f;
      we[tid] = tid < L ? expf((float)(tot - cum[tid])) : 0.f;
    }
    {   // this thread's share of <dE, S0>
      float v = 0.f;
      for (int idx = tid; idx < P * N; idx += NT)
        v = fmaf(des[(idx / N) * NS + idx % N], s0s[(idx / N) * NS + idx % N], v);
      red[tid] = v;
    }
    __syncthreads();
    if (warp == 0) {   // <dE, S0> in a fixed order
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < NT / 32; ++k) v += red[lane + 32 * k];
      v = warp_sum(v);
      if (lane == 0) red[NT] = v;
    }

    // 1. the state terms, rows i (or j) = ty + 16 r
    float dxa[RM][PQ];
    {
      // S0^T dy_i: dc += exp(cum_i) (.), s2_i = exp(cum_i) c_i . (.)
      float acc[RM][NQ];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int q = 0; q < NQ; ++q) acc[r][q] = 0.f;
      for (int p = 0; p < P; ++p) {
        float yv[RM], sv[NQ];
#pragma unroll
        for (int r = 0; r < RM; ++r) yv[r] = ys[(ty + 16 * r) * PS + p];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int n = tx + 16 * q;
          sv[q] = n < N ? s0s[p * NS + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int q = 0; q < NQ; ++q) acc[r][q] = fmaf(yv[r], sv[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int i = ty + 16 * r;
        const float u = ue[i];
        float dot = 0.f;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int n = tx + 16 * q;
          const float v = u * acc[r][q];
          dca[r][q] += v;
          dot = fmaf(n < N ? cs[i * NS + n] : 0.f, v, dot);
        }
        dot = half_warp_sum(dot);
        if (tx == 0) s2[i] = dot;
      }
    }
    {
      // dE^T x_j: db += exp(T - cum_j) dt_j (.), bx_j = b_j . (.)
      float acc[RM][NQ];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int q = 0; q < NQ; ++q) acc[r][q] = 0.f;
      for (int p = 0; p < P; ++p) {
        float xv[RM], ev[NQ];
#pragma unroll
        for (int r = 0; r < RM; ++r) xv[r] = xs[(ty + 16 * r) * PS + p];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int n = tx + 16 * q;
          ev[q] = n < N ? des[p * NS + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int q = 0; q < NQ; ++q) acc[r][q] = fmaf(xv[r], ev[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int j = ty + 16 * r;
        const float w = we[j] * dts[j];
        float dot = 0.f;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int n = tx + 16 * q;
          dba[r][q] = fmaf(w, acc[r][q], dba[r][q]);
          dot = fmaf(n < N ? bs[j * NS + n] : 0.f, acc[r][q], dot);
        }
        dot = half_warp_sum(dot);
        if (tx == 0) bx[j] = dot;
      }
    }
    {
      // dE b_j: dx_j's state term exp(T - cum_j) (.), columns p = tx + 16 q
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int q = 0; q < PQ; ++q) dxa[r][q] = 0.f;
      for (int n = 0; n < N; ++n) {
        float bv[RM], ev[PQ];
#pragma unroll
        for (int r = 0; r < RM; ++r) bv[r] = bs[(ty + 16 * r) * NS + n];
#pragma unroll
        for (int q = 0; q < PQ; ++q) {
          const int p = tx + 16 * q;
          ev[q] = p < P ? des[p * NS + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int q = 0; q < PQ; ++q) dxa[r][q] = fmaf(bv[r], ev[q], dxa[r][q]);
      }
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int q = 0; q < PQ; ++q) dxa[r][q] *= we[ty + 16 * r];
    }

    // 2. the pairs: dy_i . x_j for j <= i, their decays, M into buf; E
    // kept in registers (in the place of dy . x), Q's column sums
    float pe[RM][RM];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int q = 0; q < RM; ++q) pe[r][q] = 0.f;
    for (int p = 0; p < P; ++p) {
      float yv[RM], xv[RM];
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        yv[r] = ys[(ty + 16 * r) * PS + p];
        xv[r] = xs[(tx + 16 * r) * PS + p];
      }
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int q = 0; q <= r; ++q) pe[r][q] = fmaf(yv[r], xv[q], pe[r][q]);
    }
    {
      float qcol[RM];
#pragma unroll
      for (int q = 0; q < RM; ++q) qcol[q] = 0.f;
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int q = 0; q < RM; ++q) {
          const int i = ty + 16 * r, j = tx + 16 * q;
          float m = 0.f, e = 0.f;
          if (q <= r && j <= i && i < L) {
            const float w = expf((float)(cum[i] - cum[j]));
            m = w * gs[i * LS + j];
            e = w * dts[j] * pe[r][q];
            qcol[q] = fmaf(m, pe[r][q], qcol[q]);
          }
          buf[i * LS + j] = m;
          pe[r][q] = e;
        }
#pragma unroll
      for (int q = 0; q < RM; ++q) cp[ty * MAXL + tx + 16 * q] = qcol[q];
    }
    __syncthreads();

    // 3. dx_j = dt_j (sum_i M_ij dy_i + exp(T - cum_j) dE b_j); Q's column
    // sums over the 16 row groups in order
    for (int i = 0; i < L; ++i) {
      float mv[RM], yv[PQ];
#pragma unroll
      for (int r = 0; r < RM; ++r) mv[r] = buf[i * LS + ty + 16 * r];
#pragma unroll
      for (int q = 0; q < PQ; ++q) {
        const int p = tx + 16 * q;
        yv[q] = p < P ? ys[i * PS + p] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int q = 0; q < PQ; ++q) dxa[r][q] = fmaf(mv[r], yv[q], dxa[r][q]);
    }
    {
      T* dxb = static_cast<T*>(a.dx) + ((int64_t)bb * S + t0) * H * P +
               (int64_t)h * P;
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int j = ty + 16 * r;
        if (j >= L) continue;
#pragma unroll
        for (int q = 0; q < PQ; ++q) {
          const int p = tx + 16 * q;
          if (p < P) dxb[(int64_t)j * H * P + p] = from_float<T>(dts[j] * dxa[r][q]);
        }
      }
    }
    if (tid < MAXL) {
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k) v += cp[k * MAXL + tid];
      qc[tid] = v;
    }
    __syncthreads();

    // 4. E into buf
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int q = 0; q < RM; ++q)
        buf[(ty + 16 * r) * LS + tx + 16 * q] = pe[r][q];
    __syncthreads();

    // 5. dc_i += sum_j E_ij b_j, db_j += sum_i E_ij c_i
    for (int k = 0; k < L; ++k) {
      float er[RM], ec[RM], bv[NQ], cv[NQ];
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        er[r] = buf[(ty + 16 * r) * LS + k];
        ec[r] = buf[k * LS + ty + 16 * r];
      }
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int n = tx + 16 * q;
        bv[q] = n < N ? bs[k * NS + n] : 0.f;
        cv[q] = n < N ? cs[k * NS + n] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          dca[r][q] = fmaf(er[r], bv[q], dca[r][q]);
          dba[r][q] = fmaf(ec[r], cv[q], dba[r][q]);
        }
    }
    __syncthreads();

    // 6. R_ij = dt_j Q_ij = E_ij (c_i . b_j) for j < i into buf, then its
    // suffix sums down each column: buf[t][j] = sum_{i>=t} R_ij, t > j
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int q = 0; q < RM; ++q) {
        const int i = ty + 16 * r, j = tx + 16 * q;
        buf[i * LS + j] = j < i ? pe[r][q] * gs[i * LS + j] : 0.f;
      }
    __syncthreads();
    if (tid < L) {
      float run = 0.f;
      for (int i = L - 1; i > tid; --i) {
        run += buf[i * LS + tid];
        buf[i * LS + tid] = run;
      }
    }
    __syncthreads();

    // 7. g_t and ddt_t, one thread a step
    if (tid < L) {
      const int t = tid;
      float f = 0.f, suf = 0.f, pre = 0.f;
      for (int j = 0; j < t; ++j) {
        f += buf[t * LS + j];
        pre = fmaf(we[j] * dts[j], bx[j], pre);
      }
      for (int i = L - 1; i >= t; --i) suf += s2[i];
      const float g = f + suf + pre + expf((float)tot) * red[NT];
      a.ddt[((int64_t)bb * S + t0 + t) * H + h] = qc[t] + we[t] * bx[t] + av * g;
      dg[t] = dts[t] * g;
    }
    __syncthreads();
    if (tid == 0) {
      float v = 0.f;
      for (int t = 0; t < L; ++t) v += dg[t];
      a.da_part[((int64_t)bb * NC + cc) * H + h] = av * v;
    }
  }

  // the group's partial db and dc
  float* dbp = a.db_part + (((int64_t)bb * G + grp) * S + t0) * N;
  float* dcp = a.dc_part + (((int64_t)bb * G + grp) * S + t0) * N;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int i = ty + 16 * r;
    if (i >= L) continue;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int n = tx + 16 * q;
      if (n < N) {
        dbp[(int64_t)i * N + n] = dba[r][q];
        dcp[(int64_t)i * N + n] = dca[r][q];
      }
    }
  }
}

// --- 2, bf16 x, b, c: the per-chunk gradients on the tensor cores ---------

// mma.sync m16n8k16 (bf16 operands, float32 sums).  Every operand tile is
// bf16 in shared memory, rows of RB elements (16 bytes of pad: ldmatrix
// without bank conflicts): x, b, c exact; dy, S0, dE and the pair matrices
// M and E as two terms each, hi = bf16(v) and lo = bf16(v - hi) (H21); a
// product of two float32 factors takes hi.hi + hi.lo + lo.hi, of a float32
// factor and exact x, b or c both terms.  Warp w takes the 16 rows 16 (w &
// 3) .. and the 32 columns 32 (w >> 2) .. of every [64, 64] product.
constexpr int RB = 72;

template <int P, int N>
struct MmaTile {
  static_assert(P == 64 && N == 64, "the mma kernel takes P = N = 64");
  static constexpr int TILE = MAXL * RB;       // one bf16 tile, elements
  static constexpr int NTILES = 13;   // b, c, x, dy (2), S0 (2), dE (2), M (2), E (2)
  static constexpr int LS = MAXL + 1;
  static constexpr int VEC = 12 * MAXL + NT + 4;   // small arrays
  static constexpr size_t SMEM = sizeof(double) * (MAXL + 2) +
                                 sizeof(float) * ((size_t)VEC + 2 * MAXL * LS) +
                                 2 * (size_t)NTILES * TILE;
};

// The A fragments of rows r0 .. r0 + 15, depth k0 .. k0 + 15, of a
// row-major tile (rows along M, depth contiguous)
__device__ __forceinline__ void frag_a(uint32_t (&f)[4], const bf16* t, int r0,
                                       int k0, int lane) {
  ldsm_x4(f, smem_addr(t + (r0 + (lane & 15)) * RB + k0 + 8 * (lane >> 4)));
}
// ... of a tile stored transposed (A[m][k] at t[k][m])
__device__ __forceinline__ void frag_a_t(uint32_t (&f)[4], const bf16* t,
                                         int m0, int k0, int lane) {
  ldsm_x4_trans(f, smem_addr(t + (k0 + (lane & 7) + 8 * (lane >> 4)) * RB + m0 +
                             8 * ((lane >> 3) & 1)));
}
// The B fragments of columns n0 .. n0 + 15 (two n8 tiles: f[0..1], f[2..3]),
// depth k0 .. k0 + 15, of a tile stored [n][k] (depth contiguous)
__device__ __forceinline__ void frag_b(uint32_t (&f)[4], const bf16* t, int n0,
                                       int k0, int lane) {
  ldsm_x4(f, smem_addr(t + (n0 + (lane & 7) + 8 * (lane >> 4)) * RB + k0 +
                       8 * ((lane >> 3) & 1)));
}
// ... of a tile stored [k][n]
__device__ __forceinline__ void frag_b_t(uint32_t (&f)[4], const bf16* t,
                                         int n0, int k0, int lane) {
  ldsm_x4_trans(f, smem_addr(t + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * RB +
                             n0 + 8 * (lane >> 4)));
}

// acc[0..3] (the warp's four n8 tiles of 32 columns from n0) += A B over
// depth k0 .. k0 + 15, A from frag (hi, and lo where A is split), B from
// tile(s) bh (and bl where B is split), by `load` (frag_b or frag_b_t)
template <bool SPLIT_A, bool SPLIT_B, typename LoadB>
__device__ __forceinline__ void mma_row(float (&acc)[4][4],
                                        const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4], LoadB load) {
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    uint32_t bh[4], bl[4];
    load(bh, bl, np);
    mma_bf16(acc[2 * np], ah, bh[0], bh[1]);
    mma_bf16(acc[2 * np + 1], ah, bh[2], bh[3]);
    if (SPLIT_B) {
      mma_bf16(acc[2 * np], ah, bl[0], bl[1]);
      mma_bf16(acc[2 * np + 1], ah, bl[2], bl[3]);
    }
    if (SPLIT_A) {
      mma_bf16(acc[2 * np], al, bh[0], bh[1]);
      mma_bf16(acc[2 * np + 1], al, bh[2], bh[3]);
    }
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[4][4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[t][r] = 0.f;
}

// a float32 [64][64] tile (row stride 64) as two bf16 terms, four
// elements a thread and step
__device__ __forceinline__ void split_tile(bf16* hi, bf16* lo, const float* src,
                                           int rows, int tid) {
  for (int idx = tid; idx < MAXL * 16; idx += NT) {
    const int i = idx >> 4, n = 4 * (idx & 15);
    const float4 v = i < rows ? ld4(src + i * 64 + n)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    uint32_t h0, l0, h1, l1;
    split_pack(v.x, v.y, h0, l0);
    split_pack(v.z, v.w, h1, l1);
    *reinterpret_cast<uint2*>(hi + i * RB + n) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(lo + i * RB + n) = make_uint2(l0, l1);
  }
}

// rows i < L of a bf16 [L, 64] operand into a tile by 16-byte cp.async
// copies, rows L .. MAXL - 1 zero
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src,
                                          int64_t row_stride, int t0, int L,
                                          int tid) {
  for (int idx = tid; idx < MAXL * 8; idx += NT) {
    const int i = idx >> 3, c = idx & 7;
    const bool ok = i < L;
    cp_async16(smem_addr(dst + i * RB + 8 * c),
               ok ? src + (int64_t)(t0 + i) * row_stride + 8 * c : src,
               ok ? 16 : 0);
  }
}

template <int P, int N>
__global__ void __launch_bounds__(NT, 1) mamba2_bwd_mma_kernel(BwdArgs a) {
  using Tile = MmaTile<P, N>;
  constexpr int LS = Tile::LS;
  const int H = a.H, L = a.L, S = a.S, NC = S / L;
  const int grp = blockIdx.x, G = gridDim.x;
  const int bb = blockIdx.y / NC, cc = blockIdx.y % NC;
  const int t0 = cc * L;
  const int h0 = grp * HG, hn = min(HG, H - h0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c0 = 2 * (lane & 3);
  const int rb = warp & 3, ch = warp >> 2;     // rows 16 rb .., columns 32 ch ..
  const int r0 = 16 * rb, n0 = 32 * ch;

  extern __shared__ __align__(16) double smem_mm[];
  double* cum = smem_mm;                         // [MAXL + 1], + pad
  float* dts = reinterpret_cast<float*>(cum + MAXL + 2);   // [MAXL] dt
  float* ue = dts + MAXL;          // [MAXL] exp(cum_i)
  float* we = ue + MAXL;           // [MAXL] exp(T - cum_j)
  float* s2p = we + MAXL;          // [2][MAXL] halves of s2
  float* bxp = s2p + 2 * MAXL;     // [2][MAXL] halves of bx
  float* qp = bxp + 2 * MAXL;      // [4][MAXL] row blocks' column sums of Q
  float* dg = qp + 4 * MAXL;       // [MAXL] dt_t g_t
  float* red = dg + MAXL;          // [NT] partial <dE, S0>, then the sum
  float* gs = red + NT + 4;        // [MAXL][LS] c_i . b_j, j <= i
  float* rs = gs + MAXL * LS;      // [MAXL][LS] R, then its suffix sums
  bf16* bs = reinterpret_cast<bf16*>(rs + MAXL * LS);
  bf16* cs = bs + Tile::TILE;
  bf16* xs = cs + Tile::TILE;
  bf16* yh = xs + Tile::TILE;      // dy, two terms
  bf16* yl = yh + Tile::TILE;
  bf16* sh = yl + Tile::TILE;      // S0 [p][n], two terms
  bf16* sl = sh + Tile::TILE;
  bf16* eh = sl + Tile::TILE;      // dE [p][n], two terms
  bf16* el = eh + Tile::TILE;
  bf16* mh = el + Tile::TILE;      // M [i][j], two terms
  bf16* ml = mh + Tile::TILE;
  bf16* xh = ml + Tile::TILE;      // E [i][j], two terms
  bf16* xl = xh + Tile::TILE;

  copy_tile(bs, static_cast<const bf16*>(a.b) + (int64_t)bb * a.b_sb, a.b_ss,
            t0, L, tid);
  copy_tile(cs, static_cast<const bf16*>(a.c) + (int64_t)bb * a.c_sb, a.c_ss,
            t0, L, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // the scores c_i . b_j for j <= i < L, 0 elsewhere: once for the heads
  {
    float acc[4][4];
    zero_acc(acc);
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t ah[4];
      frag_a(ah, cs, r0, 16 * kk, lane);
      mma_row<false, false>(acc, ah, ah, [&](uint32_t (&bh)[4], uint32_t (&)[4],
                                              int np) {
        frag_b(bh, bs, n0 + 16 * np, 16 * kk, lane);
      });
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = r0 + g + 8 * (r >> 1), j = n0 + 8 * t + c0 + (r & 1);
        gs[i * LS + j] = (j <= i && i < L) ? acc[t][r] : 0.f;
      }
  }

  // db and dc of the group's heads, summed in head order, in the layout of
  // the warp's C fragments: rows r0 + g (+ 8), columns n0 + 8 t + c0 (+ 1)
  float dca[4][4], dba[4][4];
  zero_acc(dca);
  zero_acc(dba);

  for (int hh = 0; hh < hn; ++hh) {
    const int h = h0 + hh;
    const int bh = bb * H + h;
    const float av = -expf(a.a_log[h]);
    __syncthreads();   // the previous head is done with the per-head tiles
    copy_tile(xs, static_cast<const bf16*>(a.x) + (int64_t)bb * a.x_sb +
                      (int64_t)h * a.x_sh, a.x_ss, t0, L, tid);
    cp_async_commit();
    {
      const float* yb = a.dy + (int64_t)bb * a.y_sb + (int64_t)h * a.y_sh;
      for (int idx = tid; idx < MAXL * 16; idx += NT) {
        const int i = idx >> 4, n = 4 * (idx & 15);
        const float4 v = i < L ? ld4(yb + (int64_t)(t0 + i) * a.y_ss + n)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        uint32_t h0v, l0v, h1v, l1v;
        split_pack(v.x, v.y, h0v, l0v);
        split_pack(v.z, v.w, h1v, l1v);
        *reinterpret_cast<uint2*>(yh + i * RB + n) = make_uint2(h0v, h1v);
        *reinterpret_cast<uint2*>(yl + i * RB + n) = make_uint2(l0v, l1v);
      }
    }
    const float* s0 = cc > 0 ? a.states + ((int64_t)bh * NC + cc - 1) * P * N
                      : (a.state0 != nullptr ? a.state0 + (int64_t)bh * P * N
                                             : nullptr);
    const float* de = a.dstates + ((int64_t)bh * NC + cc) * P * N;
    split_tile(eh, el, de, P, tid);
    {   // S0's terms and this thread's share of <dE, S0>
      float v = 0.f;
      for (int idx = tid; idx < MAXL * 16; idx += NT) {
        const int i = idx >> 4, n = 4 * (idx & 15);
        const float4 sv = s0 != nullptr ? ld4(s0 + i * 64 + n)
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 dv = ld4(de + i * 64 + n);
        v = fmaf(dv.x, sv.x, v);
        v = fmaf(dv.y, sv.y, v);
        v = fmaf(dv.z, sv.z, v);
        v = fmaf(dv.w, sv.w, v);
        uint32_t h0v, l0v, h1v, l1v;
        split_pack(sv.x, sv.y, h0v, l0v);
        split_pack(sv.z, sv.w, h1v, l1v);
        *reinterpret_cast<uint2*>(sh + i * RB + n) = make_uint2(h0v, h1v);
        *reinterpret_cast<uint2*>(sl + i * RB + n) = make_uint2(l0v, l1v);
      }
      red[tid] = v;
    }
    if (tid < 32)
      scan_cum(a.dt + (int64_t)bb * a.dt_sb + (int64_t)h * a.dt_sh, a.dt_ss, t0,
               L, av, cum, dts, lane);
    cp_async_wait<0>();
    __syncthreads();
    const double tot = cum[MAXL];
    if (tid < MAXL) {
      ue[tid] = tid < L ? expf((float)cum[tid]) : 0.f;
      we[tid] = tid < L ? expf((float)(tot - cum[tid])) : 0.f;
    }
    if (warp == 0) {   // <dE, S0> in a fixed order
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < NT / 32; ++k) v += red[lane + 32 * k];
      v = warp_sum(v);
      if (lane == 0) red[NT] = v;
    }
    __syncthreads();

    // 1. the state terms of this warp's rows and columns
    float dxa[4][4];
    {
      // S0^T dy_i: dc += exp(cum_i) (.), s2_i = exp(cum_i) c_i . (.)
      float acc[4][4];
      zero_acc(acc);
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk) {
        uint32_t ah[4], al[4];
        frag_a(ah, yh, r0, 16 * kk, lane);
        frag_a(al, yl, r0, 16 * kk, lane);
        mma_row<true, true>(acc, ah, al, [&](uint32_t (&bh)[4],
                                             uint32_t (&bl)[4], int np) {
          frag_b_t(bh, sh, n0 + 16 * np, 16 * kk, lane);
          frag_b_t(bl, sl, n0 + 16 * np, 16 * kk, lane);
        });
      }
      float dot[2] = {0.f, 0.f};
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = r0 + g + 8 * (r >> 1), n = n0 + 8 * t + c0 + (r & 1);
          const float v = ue[i] * acc[t][r];
          dca[t][r] += v;
          dot[r >> 1] = fmaf(__bfloat162float(cs[i * RB + n]), v, dot[r >> 1]);
        }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        dot[hr] += __shfl_xor_sync(0xffffffffu, dot[hr], 1);
        dot[hr] += __shfl_xor_sync(0xffffffffu, dot[hr], 2);
        if ((lane & 3) == 0) s2p[ch * MAXL + r0 + g + 8 * hr] = dot[hr];
      }
    }
    {
      // dE^T x_j: db += exp(T - cum_j) dt_j (.), bx_j = b_j . (.)
      float acc[4][4];
      zero_acc(acc);
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk) {
        uint32_t ax[4];
        frag_a(ax, xs, r0, 16 * kk, lane);
        mma_row<false, true>(acc, ax, ax, [&](uint32_t (&bh)[4],
                                              uint32_t (&bl)[4], int np) {
          frag_b_t(bh, eh, n0 + 16 * np, 16 * kk, lane);
          frag_b_t(bl, el, n0 + 16 * np, 16 * kk, lane);
        });
      }
      float dot[2] = {0.f, 0.f};
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = r0 + g + 8 * (r >> 1), n = n0 + 8 * t + c0 + (r & 1);
          dba[t][r] = fmaf(we[j] * dts[j], acc[t][r], dba[t][r]);
          dot[r >> 1] = fmaf(__bfloat162float(bs[j * RB + n]), acc[t][r],
                             dot[r >> 1]);
        }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        dot[hr] += __shfl_xor_sync(0xffffffffu, dot[hr], 1);
        dot[hr] += __shfl_xor_sync(0xffffffffu, dot[hr], 2);
        if ((lane & 3) == 0) bxp[ch * MAXL + r0 + g + 8 * hr] = dot[hr];
      }
    }
    {
      // dE b_j: dx_j's state term exp(T - cum_j) (.), columns p
      zero_acc(dxa);
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t ab[4];
        frag_a(ab, bs, r0, 16 * kk, lane);
        mma_row<false, true>(dxa, ab, ab, [&](uint32_t (&bh)[4],
                                              uint32_t (&bl)[4], int np) {
          frag_b(bh, eh, n0 + 16 * np, 16 * kk, lane);
          frag_b(bl, el, n0 + 16 * np, 16 * kk, lane);
        });
      }
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int r = 0; r < 4; ++r) dxa[t][r] *= we[r0 + g + 8 * (r >> 1)];
    }

    // 2. the pairs: dy_i . x_j (j <= i), their decays: M and E as two
    // terms, R = E (c_i . b_j) below the diagonal, Q's column sums
    {
      float acc[4][4];
      zero_acc(acc);
      const bool any = n0 <= r0 + 15;        // some tile on or below the diagonal
      if (any) {
#pragma unroll
        for (int kk = 0; kk < P / 16; ++kk) {
          uint32_t ah[4], al[4];
          frag_a(ah, yh, r0, 16 * kk, lane);
          frag_a(al, yl, r0, 16 * kk, lane);
          mma_row<true, false>(acc, ah, al, [&](uint32_t (&bh)[4],
                                                uint32_t (&)[4], int np) {
            frag_b(bh, xs, n0 + 16 * np, 16 * kk, lane);
          });
        }
      }
      float qcol[4][2];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float m[4], e[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = r0 + g + 8 * (r >> 1), j = n0 + 8 * t + c0 + (r & 1);
          float rr = 0.f;
          m[r] = e[r] = 0.f;
          if (j <= i && i < L) {
            const float w = expf((float)(cum[i] - cum[j]));
            const float gij = gs[i * LS + j];
            m[r] = w * gij;
            e[r] = w * dts[j] * acc[t][r];
            rr = j < i ? e[r] * gij : 0.f;
          }
          acc[t][r] *= m[r];           // Q
          rs[i * LS + j] = rr;
        }
        qcol[t][0] = acc[t][0] + acc[t][2];
        qcol[t][1] = acc[t][1] + acc[t][3];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int off = (r0 + g + 8 * hr) * RB + n0 + 8 * t + c0;
          uint32_t hv, lv;
          split_pack(m[2 * hr], m[2 * hr + 1], hv, lv);
          *reinterpret_cast<uint32_t*>(mh + off) = hv;
          *reinterpret_cast<uint32_t*>(ml + off) = lv;
          split_pack(e[2 * hr], e[2 * hr + 1], hv, lv);
          *reinterpret_cast<uint32_t*>(xh + off) = hv;
          *reinterpret_cast<uint32_t*>(xl + off) = lv;
        }
      }
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          float v = qcol[t][k];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0) qp[rb * MAXL + n0 + 8 * t + c0 + k] = v;
        }
    }
    __syncthreads();

    // 3. dx_j = dt_j (sum_i M_ij dy_i + exp(T - cum_j) dE b_j)
#pragma unroll
    for (int kk = 0; kk < MAXL / 16; ++kk) {
      if (kk < rb) continue;                 // M_ij = 0 for i < j
      uint32_t ah[4], al[4];
      frag_a_t(ah, mh, r0, 16 * kk, lane);
      frag_a_t(al, ml, r0, 16 * kk, lane);
      mma_row<true, true>(dxa, ah, al, [&](uint32_t (&bh)[4],
                                           uint32_t (&bl)[4], int np) {
        frag_b_t(bh, yh, n0 + 16 * np, 16 * kk, lane);
        frag_b_t(bl, yl, n0 + 16 * np, 16 * kk, lane);
      });
    }
    {
      bf16* dxb = static_cast<bf16*>(a.dx) + ((int64_t)bb * S + t0) * H * P +
                  (int64_t)h * P;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int j = r0 + g + 8 * hr;
        if (j >= L) continue;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          store2(dxb + (int64_t)j * H * P + n0 + 8 * t + c0,
                 dts[j] * dxa[t][2 * hr], dts[j] * dxa[t][2 * hr + 1]);
      }
    }
    // 4. dc_i += sum_j E_ij b_j; db_j += sum_i E_ij c_i
#pragma unroll
    for (int kk = 0; kk < MAXL / 16; ++kk) {
      if (kk <= rb) {                        // E_ij = 0 for j > i
        uint32_t ah[4], al[4];
        frag_a(ah, xh, r0, 16 * kk, lane);
        frag_a(al, xl, r0, 16 * kk, lane);
        mma_row<true, false>(dca, ah, al, [&](uint32_t (&bh)[4],
                                              uint32_t (&)[4], int np) {
          frag_b_t(bh, bs, n0 + 16 * np, 16 * kk, lane);
        });
      }
      if (kk >= rb) {
        uint32_t ah[4], al[4];
        frag_a_t(ah, xh, r0, 16 * kk, lane);
        frag_a_t(al, xl, r0, 16 * kk, lane);
        mma_row<true, false>(dba, ah, al, [&](uint32_t (&bh)[4],
                                              uint32_t (&)[4], int np) {
          frag_b_t(bh, cs, n0 + 16 * np, 16 * kk, lane);
        });
      }
    }
    // 5. R's suffix sums down each column, rs[t][j] = sum_{i>=t} R_ij (R
    // is 0 for i <= j), a warp a column at a time; then warp 0 takes s2's
    // suffix sums and s4's exclusive prefix sums (s4_j = exp(T - cum_j)
    // dt_j bx_j), each a fixed shuffle scan over its 64 rows
    {
      constexpr int CW = MAXL / (NT / 32);     // columns a warp scans together
      float lo[CW], hi[CW];
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const int j = warp + (NT / 32) * c;
        lo[c] = rs[lane * LS + j];
        hi[c] = rs[(lane + 32) * LS + j];
      }
      warp_suffix_sums(hi, lane);
      warp_suffix_sums(lo, lane);
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const int j = warp + (NT / 32) * c;
        lo[c] += __shfl_sync(0xffffffffu, hi[c], 0);
        rs[lane * LS + j] = lo[c];
        rs[(lane + 32) * LS + j] = hi[c];
      }
    }
    if (warp == 0) {
      float s2v[2], s4v[2], bxv[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = lane + 32 * k;
        s2v[k] = s2p[i] + s2p[MAXL + i];
        bxv[k] = bxp[i] + bxp[MAXL + i];
        s4v[k] = we[i] * dts[i] * bxv[k];
      }
      s2v[1] = warp_suffix_sum(s2v[1], lane);
      s2v[0] = warp_suffix_sum(s2v[0], lane) +
               __shfl_sync(0xffffffffu, s2v[1], 0);
      // exclusive: each lane takes its lower neighbour's value
      float e0 = __shfl_up_sync(0xffffffffu, s4v[0], 1);
      float e1 = __shfl_up_sync(0xffffffffu, s4v[1], 1);
      const float last0 = __shfl_sync(0xffffffffu, s4v[0], 31);
      if (lane == 0) { e0 = 0.f; e1 = last0; }
      e0 = warp_prefix_sum(e0, lane);
      e1 = warp_prefix_sum(e1, lane) + __shfl_sync(0xffffffffu, e0, 31);
      s2p[lane] = s2v[0];            // suf(t) = sum_{i>=t} s2_i
      s2p[lane + 32] = s2v[1];
      bxp[MAXL + lane] = bxv[0];     // bx_t
      bxp[MAXL + lane + 32] = bxv[1];
      bxp[lane] = e0;                // pre(t) = sum_{j<t} s4_j
      bxp[lane + 32] = e1;
    }
    __syncthreads();

    // 6. g_t and ddt_t: each warp takes rows warp, warp + 8, ..; F(t) =
    // sum_{j<t} rs[t][j] a fixed butterfly over the warp
    {
      constexpr int CW = MAXL / (NT / 32);     // rows a warp sums together
      float fr[CW];
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const int t = warp + (NT / 32) * c;
        fr[c] = (lane < t ? rs[t * LS + lane] : 0.f) +
                (lane + 32 < t ? rs[t * LS + lane + 32] : 0.f);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int c = 0; c < CW; ++c)
          fr[c] += __shfl_xor_sync(0xffffffffu, fr[c], off);
      for (int c = 0; c < CW; ++c) {
        const int t = warp + (NT / 32) * c;
        if (lane != 0 || t >= L) continue;
        const float f = fr[c];
        const float gt = f + s2p[t] + bxp[t] + expf((float)tot) * red[NT];
        const float qc = ((qp[t] + qp[MAXL + t]) + qp[2 * MAXL + t]) +
                         qp[3 * MAXL + t];
        a.ddt[((int64_t)bb * S + t0 + t) * H + h] =
            qc + we[t] * bxp[MAXL + t] + av * gt;
        dg[t] = dts[t] * gt;
      }
    }
    __syncthreads();
    if (warp == 0) {
      float v = (lane < L ? dg[lane] : 0.f) +
                (lane + 32 < L ? dg[lane + 32] : 0.f);
      v = warp_sum(v);
      if (lane == 0) a.da_part[((int64_t)bb * NC + cc) * H + h] = av * v;
    }
  }

  // the group's partial db and dc
  float* dbp = a.db_part + (((int64_t)bb * G + grp) * S + t0) * N;
  float* dcp = a.dc_part + (((int64_t)bb * G + grp) * S + t0) * N;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = r0 + g + 8 * hr;
    if (i >= L) continue;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int n = n0 + 8 * t + c0;
      *reinterpret_cast<float2*>(dbp + (int64_t)i * N + n) =
          make_float2(dba[t][2 * hr], dba[t][2 * hr + 1]);
      *reinterpret_cast<float2*>(dcp + (int64_t)i * N + n) =
          make_float2(dca[t][2 * hr], dca[t][2 * hr + 1]);
    }
  }
}

// 1a on the tensor cores, bf16 x, b, c at (P, N) = (64, 64): A_c =
// (w x)^T b and B_c = (exp(cum) dy)^T c as mma.sync products from bf16
// tiles, w x and exp(cum) dy as two terms each (b and c exact); warp w
// takes rows 16 (w & 3) .. of P and columns 32 (w >> 2) .. of N.  Six
// tiles, cum and dt: 56,080 bytes, up to four blocks an SM
constexpr int LOCAL_TILES = 6;

size_t local_mma_smem() {
  return sizeof(double) * (MAXL + 2) + sizeof(float) * MAXL +
         2 * (size_t)LOCAL_TILES * MAXL * RB;
}

template <int P, int N>
__global__ void __launch_bounds__(NT) mamba2_bwd_local_mma_kernel(BwdArgs a) {
  static_assert(P == 64 && N == 64, "the mma kernel takes P = N = 64");
  const int bh = blockIdx.x, cidx = blockIdx.y;
  const int H = a.H, L = a.L, NC = a.S / L;
  const int bb = bh / H, h = bh % H;
  const int t0 = cidx * L;
  const bool fwd = (a.passes & PASS_STATES) != 0;
  const bool bwd = (a.passes & PASS_COTANGENTS) != 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c0 = 2 * (lane & 3);
  const int r0 = 16 * (warp & 3), n0 = 32 * (warp >> 2);

  extern __shared__ __align__(16) double smem_lm[];
  double* cum = smem_lm;                       // [MAXL + 1], + pad
  float* dts = reinterpret_cast<float*>(cum + MAXL + 2);
  bf16* bs = reinterpret_cast<bf16*>(dts + MAXL);
  bf16* cs = bs + MAXL * RB;
  bf16* wh = cs + MAXL * RB;                   // w x [j][p], two terms
  bf16* wl = wh + MAXL * RB;
  bf16* uh = wl + MAXL * RB;                   // exp(cum) dy [i][p], two terms
  bf16* ul = uh + MAXL * RB;

  const float av = -expf(a.a_log[h]);
  if (fwd)
    copy_tile(bs, static_cast<const bf16*>(a.b) + (int64_t)bb * a.b_sb,
              a.b_ss, t0, L, tid);
  if (bwd)
    copy_tile(cs, static_cast<const bf16*>(a.c) + (int64_t)bb * a.c_sb,
              a.c_ss, t0, L, tid);
  cp_async_commit();
  if (tid < 32)
    scan_cum(a.dt + (int64_t)bb * a.dt_sb + (int64_t)h * a.dt_sh, a.dt_ss, t0,
             L, av, cum, dts, lane);
  __syncthreads();
  const double tot = cum[MAXL];
  const bf16* xb = static_cast<const bf16*>(a.x) + (int64_t)bb * a.x_sb +
                   (int64_t)h * a.x_sh;
  const float* yb = a.dy + (int64_t)bb * a.y_sb + (int64_t)h * a.y_sh;
  for (int idx = tid; idx < MAXL * 16; idx += NT) {
    const int i = idx >> 4, p = 4 * (idx & 15);
    const bool ok = i < L;
    uint32_t h0, l0, h1, l1;
    if (fwd) {
      const float w = ok ? expf((float)(tot - cum[i])) * dts[i] : 0.f;
      const float4 v = ok ? load4<bf16>(xb + (int64_t)(t0 + i) * a.x_ss + p)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      split_pack(w * v.x, w * v.y, h0, l0);
      split_pack(w * v.z, w * v.w, h1, l1);
      *reinterpret_cast<uint2*>(wh + i * RB + p) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(wl + i * RB + p) = make_uint2(l0, l1);
    }
    if (bwd) {
      const float u = ok ? expf((float)cum[i]) : 0.f;
      const float4 v = ok ? ld4(yb + (int64_t)(t0 + i) * a.y_ss + p)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      split_pack(u * v.x, u * v.y, h0, l0);
      split_pack(u * v.z, u * v.w, h1, l1);
      *reinterpret_cast<uint2*>(uh + i * RB + p) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(ul + i * RB + p) = make_uint2(l0, l1);
    }
  }
  if (tid == 0) a.factors[(int64_t)bh * NC + cidx] = expf((float)tot);
  cp_async_wait<0>();
  __syncthreads();
  const int64_t off = ((int64_t)bh * NC + cidx) * P * N;
#pragma unroll
  for (int dir = 0; dir < 2; ++dir) {
    if (dir == 0 ? !fwd : !bwd) continue;
    const bf16* th = dir == 0 ? wh : uh;
    const bf16* tl = dir == 0 ? wl : ul;
    const bf16* tb = dir == 0 ? bs : cs;
    float acc[4][4];
    zero_acc(acc);
#pragma unroll
    for (int kk = 0; kk < MAXL / 16; ++kk) {
      if (16 * kk >= L) break;                 // rows past L are zero
      uint32_t ah[4], al[4];
      frag_a_t(ah, th, r0, 16 * kk, lane);
      frag_a_t(al, tl, r0, 16 * kk, lane);
      mma_row<true, false>(acc, ah, al, [&](uint32_t (&bf)[4],
                                            uint32_t (&)[4], int np) {
        frag_b_t(bf, tb, n0 + 16 * np, 16 * kk, lane);
      });
    }
    float* out = (dir == 0 ? a.states : a.dstates) + off;
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<float2*>(out + (r0 + g + 8 * hr) * N + n0 + 8 * t +
                                   c0) =
            make_float2(acc[t][2 * hr], acc[t][2 * hr + 1]);
  }
}

// --- 3. the ordered sums -----------------------------------------------------

// db, dc [B, S, N] = the head groups' partials summed in increasing group
// order; da_log[h] = the chunks' partials summed over b, then the chunks,
// in increasing order
template <typename T>
__global__ void __launch_bounds__(NT) mamba2_bwd_sum_kernel(BwdArgs a, int N,
                                                            int G) {
  const int64_t e = (int64_t)blockIdx.x * NT + threadIdx.x;
  const int64_t sn = (int64_t)a.S * N, total = (int64_t)a.B * sn;
  if (e < total) {
    const int64_t bb = e / sn, rem = e % sn;
    float vb = 0.f, vc = 0.f;
    for (int g = 0; g < G; ++g) {
      vb += a.db_part[(bb * G + g) * sn + rem];
      vc += a.dc_part[(bb * G + g) * sn + rem];
    }
    static_cast<T*>(a.db)[e] = from_float<T>(vb);
    static_cast<T*>(a.dc)[e] = from_float<T>(vc);
  } else if (e < total + a.H) {
    const int h = (int)(e - total), NC = a.S / a.L;
    float v = 0.f;
    for (int k = 0; k < a.B * NC; ++k) v += a.da_part[(int64_t)k * a.H + h];
    a.da_log[h] = v;
  }
}

// --- launchers ---------------------------------------------------------------

template <int P, int N>
int launch_states_mma(const BwdArgs& a) {
  static unsigned local_set = 0;
  auto kern = mamba2_bwd_local_mma_kernel<P, N>;
  const size_t bytes = local_mma_smem();
  cudaError_t err = allow_smem(kern, (int)bytes, local_set);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(a.B * a.H, a.S / a.L), NT, bytes, a.stream>>>(a);
  return (int)cudaGetLastError();
}

// the chunks' contributions (on the tensor cores for bf16 at (64, 64)),
// then their scan
template <typename T, int P, int N>
int launch_states(const BwdArgs& a) {
  cudaError_t err;
  if constexpr (std::is_same_v<T, bf16> && P == 64 && N == 64) {
    const int rc = launch_states_mma<64, 64>(a);
    if (rc != 0) return rc;
  } else {
    static unsigned local_set = 0;
    auto kern = mamba2_bwd_local_kernel<T, P, N>;
    const size_t bytes = local_smem<P, N>();
    err = allow_smem(kern, (int)bytes, local_set);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3(a.B * a.H, a.S / a.L), NT, bytes, a.stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const bool fwd = (a.passes & PASS_STATES) != 0;
  const bool bwd = (a.passes & PASS_COTANGENTS) != 0;
  const int64_t pieces = (int64_t)a.B * a.H * P * N / 4;
  mamba2_bwd_scan_kernel<P, N>
      <<<dim3((unsigned)((pieces + NT - 1) / NT), fwd + bwd), NT, 0, a.stream>>>(
          a, fwd ? 0 : 1);
  return (int)cudaGetLastError();
}

template <typename T, int P, int N>
int launch_chunks(const BwdArgs& a) {
  static unsigned chunk_set = 0;
  auto kern = mamba2_bwd_chunk_kernel<T, P, N>;
  const size_t bytes = ChunkTile<P, N>::SMEM;
  cudaError_t err = allow_smem(kern, (int)bytes, chunk_set);
  if (err != cudaSuccess) return (int)err;
  const int G = (a.H + HG - 1) / HG;
  kern<<<dim3(G, a.B * (a.S / a.L)), NT, bytes, a.stream>>>(a);
  return (int)cudaGetLastError();
}

template <int P, int N>
int launch_chunks_mma(const BwdArgs& a) {
  static unsigned mma_set = 0;
  auto kern = mamba2_bwd_mma_kernel<P, N>;
  const size_t bytes = MmaTile<P, N>::SMEM;
  cudaError_t err = allow_smem(kern, (int)bytes, mma_set);
  if (err != cudaSuccess) return (int)err;
  const int G = (a.H + HG - 1) / HG;
  kern<<<dim3(G, a.B * (a.S / a.L)), NT, bytes, a.stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const BwdArgs& a, int P, int N, bool chunks) {
  if (P == 16 && N == 8)
    return chunks ? launch_chunks<T, 16, 8>(a) : launch_states<T, 16, 8>(a);
  if (P == 64 && N == 64)
    return chunks ? launch_chunks<T, 64, 64>(a) : launch_states<T, 64, 64>(a);
  return -1;
}

// The 4-element loads of x, b, c (bf16 or float32) and dy (float32):
// 16-byte aligned bases (the wrapper's rule, kernels/_build.py ::
// aligned16) and outer strides of whole 4 elements
bool aligned_rows(const BwdArgs& a) {
  auto rows = [](int64_t size, int64_t stride) {
    return size == 1 || stride % 4 == 0;
  };
  return base16(a.x) && base16(a.b) && base16(a.c) && base16(a.dy) &&
         rows(a.B, a.x_sb) && rows(a.S, a.x_ss) && rows(a.H, a.x_sh) &&
         rows(a.B, a.b_sb) && rows(a.S, a.b_ss) && rows(a.B, a.c_sb) &&
         rows(a.S, a.c_ss) && rows(a.B, a.y_sb) && rows(a.S, a.y_ss) &&
         rows(a.H, a.y_sh);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, of x, b, c and of dx, db, dc.  x and dy
// (float32) are [B, S, H, P], b and c [B, S, N], dt (float32) [B, S, H],
// all with the given strides (in elements; the last dimension of x, b, c
// and dy has stride 1); a_log is a contiguous float32 [H].  state0, dstate
// and dstate0 are contiguous float32 [B, H, P, N]; state0 and dstate may be
// null (zeros), dstate0 null (not written).  Written contiguous: dx [B, S,
// H, P] and db, dc [B, S, N] in the inputs' type, ddt [B, S, H] and
// da_log [H] float32.  Scratch, float32: states and dstates [B, H, S / L,
// P, N], the chunk-end states and cotangents; factors [B, H, S / L], the
// chunks' decay factors; db_part and dc_part [B, ceil(H / 8), S, N] and
// da_part [B, S / L, H], the partial sums.  passes: a mask of 1 (the
// states), 2 (the cotangents and dstate0; both state passes take the same
// two launches, the contributions and the scan, one grid slice per
// direction), 4 (the per-chunk gradients, which read both and write the
// partials) and 8 (the sums of db, dc and da_log, which read the
// partials).  Takes (P, N) in {(16, 8), (64, 64)}, 1 <= L <= 64 (the
// sub-chunk) and S % L == 0, 16-byte aligned bases of x, b, c, dy, the
// scratch, state0, dstate and dstate0, and outer strides of whole 4
// elements.  Returns cudaGetLastError() after the launches (0 on success),
// -1 for arguments it does not take.  Launches on `stream`, does not
// synchronise, allocates nothing.
extern "C" int fate_mamba2_scan_bwd(
    const void* x, const void* b, const void* c, const void* dt,
    const void* a_log, const void* state0, const void* dy, const void* dstate,
    void* states, void* dstates, void* factors, void* dx, void* ddt,
    void* db_part, void* dc_part, void* da_part, void* db, void* dc,
    void* da_log, void* dstate0, int B, int S, int H, int P, int N, int L,
    long long x_sb, long long x_ss, long long x_sh,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    long long dt_sb, long long dt_ss, long long dt_sh,
    long long y_sb, long long y_ss, long long y_sh, int dtype, int passes,
    void* stream) {
  if (B < 1 || H < 1 || S < 1 || L < 1 || L > MAXL || S % L != 0) return -1;
  if (passes < 1 || passes > 15 || (dtype != 0 && dtype != 1)) return -1;
  if (!((P == 16 && N == 8) || (P == 64 && N == 64))) return -1;
  const bool state_passes = (passes & (PASS_STATES | PASS_COTANGENTS)) != 0;
  auto ok16 = [](const void* p) { return p == nullptr || base16(p); };
  if ((passes & (PASS_STATES | PASS_CHUNKS)) && states == nullptr) return -1;
  if ((passes & (PASS_COTANGENTS | PASS_CHUNKS)) && dstates == nullptr)
    return -1;
  if (state_passes && factors == nullptr) return -1;
  if (!ok16(states) || !ok16(dstates) || !ok16(state0) || !ok16(dstate) ||
      !ok16(dstate0))
    return -1;
  if ((passes & PASS_CHUNKS) &&
      (!dx || !ddt || !db_part || !dc_part || !da_part))
    return -1;
  if ((passes & PASS_SUMS) &&
      (!db_part || !dc_part || !da_part || !db || !dc || !da_log))
    return -1;
  BwdArgs a{x, b, c,
            static_cast<const float*>(dt), static_cast<const float*>(a_log),
            static_cast<const float*>(state0), static_cast<const float*>(dy),
            static_cast<const float*>(dstate), static_cast<float*>(states),
            static_cast<float*>(dstates), static_cast<float*>(factors), dx,
            static_cast<float*>(ddt), static_cast<float*>(db_part),
            static_cast<float*>(dc_part), static_cast<float*>(da_part), db, dc,
            static_cast<float*>(da_log), static_cast<float*>(dstate0), B, S, H,
            L, x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss, dt_sb, dt_ss, dt_sh,
            y_sb, y_ss, y_sh, passes, static_cast<cudaStream_t>(stream)};
  if (!aligned_rows(a)) return -1;
  if (state_passes) {
    const int rc = dtype == 1 ? dispatch<bf16>(a, P, N, false)
                              : dispatch<float>(a, P, N, false);
    if (rc != 0) return rc;
  }
  if (passes & PASS_CHUNKS) {
    // bf16 at (64, 64): the tensor-core kernel (its 16-byte copies need
    // whole 16-byte strides of x, b and c); else the FMA kernel
    const bool mma = dtype == 1 && P == 64 && N == 64;
    if (mma && !(stride16(B, x_sb) && stride16(S, x_ss) && stride16(H, x_sh) &&
                 stride16(B, b_sb) && stride16(S, b_ss) && stride16(B, c_sb) &&
                 stride16(S, c_ss)))
      return -1;
    const int rc = mma ? launch_chunks_mma<64, 64>(a)
                   : dtype == 1 ? dispatch<bf16>(a, P, N, true)
                                : dispatch<float>(a, P, N, true);
    if (rc != 0) return rc;
  }
  if (passes & PASS_SUMS) {
    const int G = (H + HG - 1) / HG;
    const int64_t n = (int64_t)B * S * N + H;
    if (dtype == 1)
      mamba2_bwd_sum_kernel<bf16><<<(unsigned)((n + NT - 1) / NT), NT, 0,
                                    a.stream>>>(a, N, G);
    else
      mamba2_bwd_sum_kernel<float><<<(unsigned)((n + NT - 1) / NT), NT, 0,
                                     a.stream>>>(a, N, G);
    return (int)cudaGetLastError();
  }
  return 0;
}
