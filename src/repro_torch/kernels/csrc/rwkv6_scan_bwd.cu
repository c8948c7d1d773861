// Backward of the chunked RWKV6 scan (K5b), for Hopper.  No TPU kernel
// corresponds to it: the Pallas kernel src/repro/kernels/rwkv6_scan.py ::
// rwkv6_scan has no backward, and the reference trains by differentiating
// the scan's XLA twin, src/repro/models/rwkv.py :: _wkv_chunked.
//
// What it computes, per batch b and head h, for the forward of
// csrc/rwkv6_scan.cu (S the [D, D] float32 state, u = bonus[h], w clipped
// to [1e-8, 1]):
//   out_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t,  S_t = diag(w_t) S_{t-1} + k_t v_t^T
// from d out (float32) and the final state's cotangent dS_T (zeros if
// absent), with dS_t the gradient of the state after step t:
//   dS_{t-1} = diag(w_t) dS_t + r_t do_t^T            (dstate0 = dS_0)
//   dr_t = S_{t-1} do_t + u k_t (do_t . v_t)
//   dk_t = dS_t v_t + u r_t (do_t . v_t)
//   dv_t = dS_t^T k_t + (r_t . (u k_t)) do_t
//   dbonus = sum over b, t of r_t k_t (do_t . v_t)
//   dw = dlw / w where w lies in [1e-8, 1], else 0.
// The gradient of the log decays is taken chunk by chunk, term by term.
// For s in a chunk of L steps that starts from the state S0 and ends with
// the cotangent dE, lw_s enters every exponent that spans step s:
//   dlw_s = exp(tot) rowsum(dE * S0)                        (S0 into S_end)
//         + sum_{j<s} k_j exp(tot - ci_j) (dE v_j)          (k_j v_j^T into S_end)
//         + sum_{i>s} r_i exp(ce_i) (S0 do_i)                (S0 into out_i)
//         + sum_{j<s<i} r_i k_j exp(ce_i - ci_j) P_ij        (the pairs)
// with P_ij = do_i . v_j.  Every term carries the decays it spans, so under
// strong decay each is as small as dlw itself.  The identity dlw_s =
// sum_{t>s} r_t dr_t - sum_{t>=s} k_t dk_t + u r_s k_s P_ss +
// rowsum(dS_T * S_T) is shorter, but its terms do not decay: at w = 1e-6
// dlw is 1e-6 of them and float32 keeps no digit of it (the card tests'
// strong-decay cases failed with it, dw off by 76 % of its largest
// value).  The pairs' sum is a running sum over s of G_s = sum_{i>=s+2}
// Q_is - sum_{j<s} Q_{s+1,j} (Q_ij the pair's term: it enters after
// step j and leaves at step i), in which the pairs of neighbours (j = i -
// 1, no decay between them) never appear.  With X_i = sum_{j<=i-2}
// exp(ce_i - ci_j) k_j P_ij and Y_j = sum_{i>=j+2} exp(ce_i - ci_j) r_i
// P_ij (dr's and dk's pair sums without the neighbour), G_s = k_s Y_s -
// r_{s+1} X_{s+1}, since ce_{s+1} = ci_s: both come from P masked to
// j <= i - 2, and dr and dk add the neighbour's term to them; nothing is
// got by subtracting the neighbour from a sum that holds it (at w = 1e-6
// that difference keeps no digit).
//
// In chunks, with cum the inclusive sums of log2 w in the chunk (cum[0]
// = 0, ce_i = cum[i], ci_i = cum[i + 1], tot = cum[L]):
//   dr_i = exp(ce_i) (S0 do_i) + X_i + k_{i-1} P_{i,i-1} + u k_i P_ii
//   dk_j = exp(tot - ci_j) (dE v_j) + Y_j + r_{j+1} P_{j+1,j} + u r_j P_jj
//   dv_j = (k_j exp(tot - ci_j)) dE + sum_{i>j} score_ij do_i + diag_j do_j
// with the forward's scores score_ij = sum_k r_ik k_jk exp(ce_ik - ci_jk),
// diag_j = r_j . (u k_j).  Every exponent formed is a sum of log decays
// and <= 0 (differences of the cumulative sums are clamped at 0, as a
// scan's float32 sums need not fall monotonically), so strong decay (w =
// 1e-6) underflows to 0 and never overflows.
//
// The chunk-end states E_c (the state after chunk c) and cotangents dE_c
// obey, exactly, with every factor exp(x), x <= 0:
//   E_c      = exp(tot_c) E_{c-1} + A_c,  A_c = (k exp(tot_c - ci))^T v    (E_{-1} = state0)
//   dE_{c-1} = exp(tot_c) dE_c + B_c,     B_c = (r exp(ce))^T do          (dE_{NC-1} = dS_T)
// (exp(tot_c) scaling the rows).  So:
//   1a. rwkv6_bwd_local_kernel, one block per (chunk, b * H + h) for
//       both directions: the chunk's cumulative log decays once (a warp
//       scan, its channels interleaved), then A_c into states[c] and B_c into
//       dstates[c], each a [L, D]^T x [L, D] float32 FMA product, and the
//       factors exp(tot_c) into factors [B, H, NC, D]; w, k, v, r and d
//       out loaded four channels at a time, all in flight together.
//   1b. rwkv6_bwd_scan_kernel, one thread per (b * H + h, four entries of
//       a state row), walks the chunks in place in a fixed order:
//       forward E_c = f_c E_{c-1} + A_c; backward B_c is read before dE_c
//       overwrites it, then dstate0.  SU chunks' loads in flight, none of
//       which waits on the chain.
//   2. the per-chunk gradients, one block per (chunk, b, h), reading S0
//      (E_{c-1} or state0) and dE_c; dr, dk, dv in r's type, dw in
//      float32 and the chunk's partial dbonus.
//      bf16 r, k, v: rwkv6_bwd_mma_kernel, mma.sync m16n8k16 (bf16
//      operands, float32 sums).  r, k, v stay bf16 in shared memory (rows
//      padded by 16 bytes for ldmatrix), d out, S0 and dE as two bf16
//      terms each, hi = bf16(x) and lo = bf16(x - hi) (16 bits of the
//      mantissa; a product of two float32 factors takes hi.hi + hi.lo +
//      lo.hi, of a float32 factor and exact bf16 v both terms).  On the
//      tensor cores: do S0^T (dr's state term), v dE^T (dk's), (k
//      exp(tot - ci)) dE and scores^T do (dv), P = do v^T, the scores
//      below the diagonal 8 x 8 blocks, and X and Y below them.  There a
//      pair's weight is factored through the boundary row e of its block,
//      exp(ce_i - ci_j) = exp(ce_i - ce_e) exp(ce_e - ci_j) for j < e <=
//      i, both factors <= 1, so a factor underflows only where the true
//      weight does: X through the first row of i's 16-row sub-chunk, Y
//      through the first row after j's, and within a sub-chunk its rows 8
//      .. 15 against its rows 0 .. 7 through row 8.  The diagonal 8 x 8
//      blocks go pair by pair in float32, one thread per (block,
//      channel), each pair's exponential taken once and used for its
//      score, X and Y; the scores' sums over the channels are a fixed
//      butterfly within each warp, then the warps in order.  Last, each
//      channel's rows in runs over MT / D threads (lanes on consecutive
//      channels): dr, dk, and the decay's terms in registers, the runs'
//      sums passed in order, then dw.  101,920 bytes of shared memory at
//      D = 64, L = 32 (two blocks an SM), 128 registers.
//      float32 r, k, v: rwkv6_bwd_chunk_kernel, the FMA kernel of the first
//      port (every operand in float32 shared memory, the [L, D] x [D, D]
//      products in register tiles), for the float32 sweep's 1e-4 bars.
//   3. rwkv6_bwd_bonus_kernel: dbonus[h] = the partials summed over b and
//      the chunks in increasing order.
// No atomics: a call's bits repeat.
//
// What bounds it.  At rwkv6-3b's training microbatch (B 2, S 4096, H 40,
// D 64, L 32, bf16 r, k, v, float32 w and d out) the function moves about
// 503 MB (r, k, v, dr, dk, dv in bf16; w, d out, dw in float32), 0.1506
// ms at an H100's 3.35 TB/s.  The design adds its own traffic: A and B
// (168 MB each) written, read and overwritten by the scan as E and dE,
// which the chunk kernel reads again, about 1.3 GB in all.  Its
// operations (chip_smoke.rwkv_bwd_flops) are tensor-core products and
// float32 FMA, far below either peak.  On an NVIDIA H100 80GB HBM3 at
// 700 W (tools/kernel_probe.py rwkv6-bwd-phases) a call takes 1.31 ms
// against the first design's 3.726 (whose walk over every chunk's loaded
// tiles took 1.54): the contributions 0.262, the scan 0.251 (672 MB
// at 2.7 TB/s), the bf16 chunk kernel 0.778, the dbonus sum 0.017.  The
// chunk kernel's steps are chains of shared-memory loads, exponentials
// and barriers at 16 warps an SM; cutting one step at a time prices the
// last (dr, dk, dw) at 0.17 ms, X and Y at 0.10, the products with S0
// at 0.08, dv and the diagonal pairs at 0.05 each.
#include "common.cuh"

namespace {

using namespace fate;
using bf16 = __nv_bfloat16;

constexpr int NT = 256;            // threads of every kernel but the last
constexpr size_t SMEM_LIMIT = 232448;

// passes of the C entry (kernels/rwkv6_scan.py mirrors them)
constexpr int PASS_STATES = 1, PASS_COTANGENTS = 2, PASS_CHUNKS = 4,
              PASS_BONUS = 8;

__device__ __forceinline__ float log2_clip(float w) {
  return log2f(fminf(fmaxf(w, 1e-8f), 1.f));
}

// MUFU's base-2 exponential (.approx.ftz): one instruction, relative error
// below 2^-22
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

struct BwdArgs {
  const void *r, *k, *v;
  const float *w, *bonus, *state0, *dout, *dstate;
  float *states, *dstates, *factors;
  void *dr, *dk, *dv;
  float *dw, *dbonus_part, *dbonus, *dstate0;
  int B, S, H, L;
  int64_t r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int64_t w_sb, w_ss, w_sh, o_sb, o_ss, o_sh;
  int passes;
  cudaStream_t stream;
};

// The inclusive sums of NCH channels' log2 decays over the chunk, in
// place, channels m0 + q mstep: cum[(i + 1) * stride + m] for rows i < lp
// holds lw_i on entry (0 past the chunk) and cum[i + 1] on return.  One
// warp: a Hillis-Steele scan over each 32 rows, the carry added after it,
// for all its channels at once (their shuffles independent of each other).
template <int NCH>
__device__ __forceinline__ void scan_channels(float* cum, int stride, int lp,
                                              int lane, int m0, int mstep) {
  float carry[NCH];
#pragma unroll
  for (int q = 0; q < NCH; ++q) carry[q] = 0.f;
  for (int r0 = 0; r0 < lp; r0 += 32) {
    const int row = r0 + lane;
    float x[NCH];
#pragma unroll
    for (int q = 0; q < NCH; ++q)
      x[q] = row < lp ? cum[(row + 1) * stride + m0 + q * mstep] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1)
#pragma unroll
      for (int q = 0; q < NCH; ++q) {
        const float y = __shfl_up_sync(0xffffffffu, x[q], o);
        if (lane >= o) x[q] += y;
      }
#pragma unroll
    for (int q = 0; q < NCH; ++q) {
      x[q] += carry[q];
      if (row < lp) cum[(row + 1) * stride + m0 + q * mstep] = x[q];
      carry[q] = __shfl_sync(0xffffffffu, x[q], 31);
    }
  }
}

// --- 1a. a chunk's contributions to its end state and cotangent ----------

constexpr int LU = 2;              // 4-channel pieces a thread loads at once

// X and Y tiles of each direction, [L][D] floats each, and cum
size_t local_smem(int D, int L, int dirs) {
  return sizeof(float) * (2 * (size_t)dirs * L * D + (size_t)(L + 1) * (D + 1));
}

// N consecutive floats (p aligned to 4 N bytes, N a power of two up to 8)
template <int N>
__device__ __forceinline__ void load_row(float (&x)[N], const float* p) {
  if constexpr (N >= 4) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 v = ld4(p + 4 * q);
      x[4 * q] = v.x; x[4 * q + 1] = v.y; x[4 * q + 2] = v.z; x[4 * q + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = p[0];
  }
}

template <int N>
__device__ __forceinline__ void store_row(float* p, const float (&x)[N]) {
  if constexpr (N >= 4) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      *reinterpret_cast<float4*>(p + 4 * q) =
          make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    p[0] = x[0];
  }
}

// out = X^T Y over the chunk's L steps in order: thread (tm, tn) of 16 x
// 16 takes rows TT tm .. + TT - 1 of the [D, D] result and the same
// columns of tn
template <int D>
__device__ __forceinline__ void local_product(const float* X, const float* Y,
                                              float* out, int L, int tid) {
  constexpr int TT = D / 16;
  const int tm = tid >> 4, tn = tid & 15;
  float acc[TT][TT];
#pragma unroll
  for (int p = 0; p < TT; ++p)
#pragma unroll
    for (int q = 0; q < TT; ++q) acc[p][q] = 0.f;
  for (int j = 0; j < L; ++j) {
    float xr[TT], yr[TT];
    load_row(xr, X + j * D + TT * tm);
    load_row(yr, Y + j * D + TT * tn);
#pragma unroll
    for (int p = 0; p < TT; ++p)
#pragma unroll
      for (int q = 0; q < TT; ++q) acc[p][q] = fmaf(xr[p], yr[q], acc[p][q]);
  }
#pragma unroll
  for (int p = 0; p < TT; ++p) store_row(out + (TT * tm + p) * D + TT * tn, acc[p]);
}

// One block per (chunk, b * H + h) takes the directions the passes ask
// for: the chunk's cumulative log decays once, then A_c = (k exp(tot -
// ci))^T v into states[c] and B_c = (r exp(ce))^T do into dstates[c], and
// the factors exp(tot) into factors[c].  Every load of a piece of 4
// channels (16-byte rows: the 16-byte rule) issued before any is used.
// Four blocks an SM below D = 128 (at most 64 registers a thread)
template <int D, typename T>
__global__ void __launch_bounds__(NT, D >= 128 ? 1 : 4)
rwkv6_bwd_local_kernel(BwdArgs a) {
  constexpr int CP = D + 1;        // row stride of cum: conflict-free scans
  constexpr int D4 = D / 4;
  const int L = a.L, H = a.H;
  const int NC = a.S / L;
  const int c = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const bool fwd = (a.passes & PASS_STATES) != 0;
  const bool bwd = (a.passes & PASS_COTANGENTS) != 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = c * L;

  extern __shared__ __align__(16) float smem_lc[];
  float* KX = smem_lc;                          // [L][D] k, then scaled
  float* VY = KX + (fwd ? L * D : 0);           // [L][D] v
  float* RX = VY + (fwd ? L * D : 0);           // [L][D] r, then scaled
  float* DY = RX + (bwd ? L * D : 0);           // [L][D] d out
  float* cum = DY + (bwd ? L * D : 0);          // [L + 1][CP] log2 w, summed

  const T* kb = static_cast<const T*>(a.k) + (int64_t)b * a.k_sb + (int64_t)h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + (int64_t)b * a.v_sb + (int64_t)h * a.v_sh;
  const T* rb = static_cast<const T*>(a.r) + (int64_t)b * a.r_sb + (int64_t)h * a.r_sh;
  const float* ob = a.dout + (int64_t)b * a.o_sb + (int64_t)h * a.o_sh;
  const float* wb = a.w + (int64_t)b * a.w_sb + (int64_t)h * a.w_sh;

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int base = tid; base < L * D4; base += LU * NT) {
    float4 xk[LU], xv[LU], xr[LU], xo[LU], xw[LU];
#pragma unroll
    for (int u = 0; u < LU; ++u) {
      const int idx = base + u * NT, i = idx / D4, n = 4 * (idx % D4);
      const bool ok = idx < L * D4;
      const int64_t t = t0 + i;
      xw[u] = ok ? ld4(wb + t * a.w_ss + n) : zero;
      xk[u] = ok && fwd ? load4<T>(kb + t * a.k_ss + n) : zero;
      xv[u] = ok && fwd ? load4<T>(vb + t * a.v_ss + n) : zero;
      xr[u] = ok && bwd ? load4<T>(rb + t * a.r_ss + n) : zero;
      xo[u] = ok && bwd ? ld4(ob + t * a.o_ss + n) : zero;
    }
#pragma unroll
    for (int u = 0; u < LU; ++u) {
      const int idx = base + u * NT, i = idx / D4, n = 4 * (idx % D4);
      if (idx >= L * D4) continue;
      float* cw = cum + (i + 1) * CP + n;
      cw[0] = log2_clip(xw[u].x);
      cw[1] = log2_clip(xw[u].y);
      cw[2] = log2_clip(xw[u].z);
      cw[3] = log2_clip(xw[u].w);
      if (fwd) {
        *reinterpret_cast<float4*>(KX + i * D + n) = xk[u];
        *reinterpret_cast<float4*>(VY + i * D + n) = xv[u];
      }
      if (bwd) {
        *reinterpret_cast<float4*>(RX + i * D + n) = xr[u];
        *reinterpret_cast<float4*>(DY + i * D + n) = xo[u];
      }
    }
  }
  if (tid < D) cum[tid] = 0.f;
  __syncthreads();
  scan_channels<D / (NT / 32)>(cum, CP, L, lane, warp, NT / 32);
  __syncthreads();
  // forward: k_j exp(tot - ci_j); backward: r_i exp(ce_i)
  for (int idx = tid; idx < L * D; idx += NT) {
    const int i = idx / D, m = idx % D;
    if (fwd) KX[idx] *= exp2f(fminf(cum[L * CP + m] - cum[(i + 1) * CP + m], 0.f));
    if (bwd) RX[idx] *= exp2f(cum[i * CP + m]);
  }
  for (int m = tid; m < D; m += NT)
    a.factors[((int64_t)bh * NC + c) * D + m] = exp2f(cum[L * CP + m]);
  __syncthreads();
  const int64_t off = ((int64_t)bh * NC + c) * D * D;
  if (fwd) local_product<D>(KX, VY, a.states + off, L, tid);
  if (bwd) local_product<D>(RX, DY, a.dstates + off, L, tid);
}

// --- 1b. the chunk-end states and cotangents, an elementwise scan ---------

constexpr int SU = 8;              // chunks whose loads a thread keeps in flight

template <int D>
__global__ void __launch_bounds__(NT)
rwkv6_bwd_scan_kernel(BwdArgs a, int first_half) {
  constexpr int Q = D * D / 4;     // four-entry pieces of a state
  const int NC = a.S / a.L;
  const int64_t e = (int64_t)blockIdx.x * NT + threadIdx.x;
  if (e >= (int64_t)a.B * a.H * Q) return;
  const int bh = (int)(e / Q), q = (int)(e % Q);
  const int m = 4 * q / D;                  // the state row of the piece
  const bool fwd = first_half + (int)blockIdx.y == 0;
  const int64_t step_d = (int64_t)D * D;
  float* buf = (fwd ? a.states : a.dstates) + (int64_t)bh * NC * step_d + 4 * q;
  const float* f = a.factors + (int64_t)bh * NC * D + m;
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
        fc[u] = f[(int64_t)c * D];
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

// --- 2, float32 r, k, v: the per-chunk gradients on the CUDA cores --------

// Row stride (floats) of the per-chunk kernel's [., D] tiles: 16-byte
// rows for its float4 loads; rows 4 banks apart, so that the eight rows a
// quarter warp loads in one 16-byte access meet no bank twice.
__host__ __device__ constexpr int tile_stride(int D) { return D + 4; }

size_t chunk_smem(int D, int L) {
  const size_t dp = tile_stride(D);
  return sizeof(float) * (6 * (size_t)L * dp + (size_t)(L + 1) * dp +
                          (size_t)D * dp + 2 * (size_t)L * (L + 1) +
                          2 * (size_t)D);
}

// [L, D] = [L, D] x [D, D] products of the per-chunk kernel in registers:
// thread (ti, tm) of 16 x 16 takes rows ti + 16 s and, in rows_by_rows,
// columns tm + 16 r; in rows_by_cols the column groups 4 (tm + 16 r) .. + 3.
// Operands come in 16-byte loads: each feeds 4 (rows) x D / 16 FMAs.
template <int D>
struct Tiles {
  static constexpr int DP = tile_stride(D);
  static constexpr int IQ = 4;              // rows a thread takes at L = 64
  static constexpr int MQ = D / 16;         // columns in rows_by_rows
  static constexpr int KG = (D / 4 + 15) / 16;   // column groups, rows_by_cols

  // epi(i, m, sum_c A[i][c] B[m][c]), the sum over c in increasing order
  template <typename Epi>
  __device__ static void rows_by_rows(const float* A, const float* B, int L,
                                      int tid, Epi epi) {
    const int ti = tid >> 4, tm = tid & 15;
    float acc[IQ][MQ];
#pragma unroll
    for (int s = 0; s < IQ; ++s)
#pragma unroll
      for (int r = 0; r < MQ; ++r) acc[s][r] = 0.f;
    for (int c = 0; c < D; c += 4) {
      float4 bv[MQ];
#pragma unroll
      for (int r = 0; r < MQ; ++r)
        bv[r] = *reinterpret_cast<const float4*>(B + (tm + 16 * r) * DP + c);
#pragma unroll
      for (int s = 0; s < IQ; ++s) {
        const int i = ti + 16 * s;
        if (i >= L) continue;
        const float4 av = *reinterpret_cast<const float4*>(A + i * DP + c);
#pragma unroll
        for (int r = 0; r < MQ; ++r) {
          acc[s][r] = fmaf(av.x, bv[r].x, acc[s][r]);
          acc[s][r] = fmaf(av.y, bv[r].y, acc[s][r]);
          acc[s][r] = fmaf(av.z, bv[r].z, acc[s][r]);
          acc[s][r] = fmaf(av.w, bv[r].w, acc[s][r]);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < IQ; ++s)
#pragma unroll
      for (int r = 0; r < MQ; ++r)
        if (ti + 16 * s < L) epi(ti + 16 * s, tm + 16 * r, acc[s][r]);
  }

  // epi(i, c4, {sum_m A[i][m] B[m][c4 + k]} for k < 4), the sums over m in
  // increasing order
  template <typename Epi>
  __device__ static void rows_by_cols(const float* A, const float* B, int L,
                                      int tid, Epi epi) {
    const int ti = tid >> 4, tm = tid & 15;
    float4 acc[IQ][KG];
#pragma unroll
    for (int s = 0; s < IQ; ++s)
#pragma unroll
      for (int k = 0; k < KG; ++k) acc[s][k] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int m = 0; m < D; m += 4) {
      float4 av[IQ];
#pragma unroll
      for (int s = 0; s < IQ; ++s) {
        const int i = ti + 16 * s;
        av[s] = i < L ? *reinterpret_cast<const float4*>(A + i * DP + m)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < KG; ++k) {
        const int c4 = 4 * (tm + 16 * k);
        if (c4 >= D) continue;
        float4 bv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          bv[e] = *reinterpret_cast<const float4*>(B + (m + e) * DP + c4);
#pragma unroll
        for (int s = 0; s < IQ; ++s) {
          const float a4[4] = {av[s].x, av[s].y, av[s].z, av[s].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[s][k].x = fmaf(a4[e], bv[e].x, acc[s][k].x);
            acc[s][k].y = fmaf(a4[e], bv[e].y, acc[s][k].y);
            acc[s][k].z = fmaf(a4[e], bv[e].z, acc[s][k].z);
            acc[s][k].w = fmaf(a4[e], bv[e].w, acc[s][k].w);
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < IQ; ++s)
#pragma unroll
      for (int k = 0; k < KG; ++k)
        if (ti + 16 * s < L && 4 * (tm + 16 * k) < D)
          epi(ti + 16 * s, 4 * (tm + 16 * k), acc[s][k]);
  }
};

template <int D>
__global__ void __launch_bounds__(NT)
rwkv6_bwd_chunk_kernel(BwdArgs a) {
  using Tl = Tiles<D>;
  using T = float;
  constexpr int DP = Tl::DP;
  const int L = a.L, H = a.H, S = a.S;
  const int NC = S / L;
  const int LP = L + 1;                     // row stride of P and the scores
  const int c = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int t0 = c * L;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) float smem_ch[];
  float* R = smem_ch;                       // [L][DP]
  float* K = R + L * DP;                    // [L][DP]
  float* V = K + L * DP;                    // [L][DP] v, then k exp(tot - ci)
  float* DO = V + L * DP;                   // [L][DP] d out
  float* DR = DO + L * DP;                  // [L][DP] dr's S0 term, then r * it
  float* DK = DR + L * DP;                  // [L][DP] dk's dE term, then dlw's
  float* cum = DK + L * DP;                 // [L + 1][DP]
  float* SB = cum + (L + 1) * DP;           // [D][DP] S0, then dE
  float* P = SB + D * DP;                   // [L][LP] do_i . v_j, j <= i
  float* SC = P + L * LP;                   // [L][LP] scores, j <= i
  float* U = SC + L * LP;                   // [D] bonus
  float* RS = U + D;                        // [D] rowsum(dE * S0)

  const T* rb = static_cast<const T*>(a.r) + (int64_t)b * a.r_sb + (int64_t)h * a.r_sh;
  const T* kb = static_cast<const T*>(a.k) + (int64_t)b * a.k_sb + (int64_t)h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + (int64_t)b * a.v_sb + (int64_t)h * a.v_sh;
  const float* wb = a.w + (int64_t)b * a.w_sb + (int64_t)h * a.w_sh;
  const float* ob = a.dout + (int64_t)b * a.o_sb + (int64_t)h * a.o_sh;
  // the gradients are contiguous [B, S, H, D]
  const int64_t g_ss = (int64_t)H * D;
  const int64_t g_off = (int64_t)b * S * g_ss + (int64_t)h * D;
  T* drb = static_cast<T*>(a.dr) + g_off;
  T* dkb = static_cast<T*>(a.dk) + g_off;
  T* dvb = static_cast<T*>(a.dv) + g_off;
  float* dwb = a.dw + g_off;
  const float* E = a.states + (int64_t)bh * NC * D * D;    // [NC][D][D]
  const float* dE = a.dstates + (int64_t)bh * NC * D * D;
  const float* S0 = c > 0 ? E + (int64_t)(c - 1) * D * D
                          : a.state0 != nullptr ? a.state0 + (int64_t)bh * D * D
                                                : nullptr;

  // 1. the tiles, log2 w, S0, the bonus
  for (int idx = tid; idx < L * D; idx += NT) {
    const int i = idx / D, m = idx % D;
    const int64_t t = t0 + i;
    R[i * DP + m] = to_float(rb[t * a.r_ss + m]);
    K[i * DP + m] = to_float(kb[t * a.k_ss + m]);
    V[i * DP + m] = to_float(vb[t * a.v_ss + m]);
    DO[i * DP + m] = ob[t * a.o_ss + m];
    cum[(i + 1) * DP + m] = log2_clip(wb[t * a.w_ss + m]);
  }
  for (int idx = tid; idx < D * D; idx += NT)
    SB[(idx / D) * DP + idx % D] = S0 != nullptr ? S0[idx] : 0.f;
  for (int m = tid; m < D; m += NT) U[m] = a.bonus[(int64_t)h * D + m];
  __syncthreads();
  if (tid < D) {
    float run = 0.f;
    cum[tid] = 0.f;
    for (int i = 1; i <= L; ++i) {
      run += cum[i * DP + tid];
      cum[i * DP + tid] = run;
    }
  }
  __syncthreads();

  // 2. P, the scores (the bonus term on the diagonal), dr's S0 term
  for (int idx = tid; idx < L * L; idx += NT) {
    const int i = idx / L, j = idx % L;
    if (j > i) continue;
    float p = 0.f, s = 0.f;
    for (int m = 0; m < D; m += 4) {
      const float4 d4 = *reinterpret_cast<const float4*>(DO + i * DP + m);
      const float4 v4 = *reinterpret_cast<const float4*>(V + j * DP + m);
      const float4 r4 = *reinterpret_cast<const float4*>(R + i * DP + m);
      const float4 k4 = *reinterpret_cast<const float4*>(K + j * DP + m);
      p = fmaf(d4.x, v4.x, p);
      p = fmaf(d4.y, v4.y, p);
      p = fmaf(d4.z, v4.z, p);
      p = fmaf(d4.w, v4.w, p);
      float4 f;
      if (j < i) {
        const float4 e4 = *reinterpret_cast<const float4*>(cum + i * DP + m);
        const float4 c4 = *reinterpret_cast<const float4*>(cum + (j + 1) * DP + m);
        f = make_float4(exp2f(e4.x - c4.x), exp2f(e4.y - c4.y),
                        exp2f(e4.z - c4.z), exp2f(e4.w - c4.w));
      } else {
        f = *reinterpret_cast<const float4*>(U + m);
      }
      s = fmaf(r4.x * k4.x, f.x, s);
      s = fmaf(r4.y * k4.y, f.y, s);
      s = fmaf(r4.z * k4.z, f.z, s);
      s = fmaf(r4.w * k4.w, f.w, s);
    }
    P[i * LP + j] = p;
    SC[i * LP + j] = s;
  }
  Tl::rows_by_rows(DO, SB, L, tid, [&](int i, int m, float x) {
    DR[i * DP + m] = exp2f(cum[i * DP + m]) * x;
  });
  __syncthreads();   // every read of S0 is done

  // 3. dE_c, the cotangent of the chunk's end state; dk's dE term
  const float* dEc = dE + (int64_t)c * D * D;
  for (int idx = tid; idx < D * D; idx += NT)
    SB[(idx / D) * DP + idx % D] = dEc[idx];
  __syncthreads();
  Tl::rows_by_rows(V, SB, L, tid, [&](int i, int m, float x) {
    DK[i * DP + m] = exp2f(cum[L * DP + m] - cum[(i + 1) * DP + m]) * x;
  });
  {
    const int warp = tid >> 5, lane = tid & 31;
    for (int m = warp; m < D; m += NT / 32) {
      float x = 0.f;
      if (S0 != nullptr)
        for (int col = lane; col < D; col += 32)
          x = fmaf(SB[m * DP + col], S0[m * D + col], x);
      x = warp_sum(x);
      if (lane == 0) RS[m] = x;
    }
  }
  __syncthreads();

  // 4. dr and dk whole; for dlw: r_i exp(ce_i) (S0 do_i) into DR,
  // k_i exp(tot - ci_i) (dE v_i) + G_i into DK
  for (int idx = tid; idx < L * D; idx += NT) {
    const int i = idx / D, m = idx % D;
    const float ce = cum[i * DP + m], ci = cum[(i + 1) * DP + m];
    const float pii = P[i * LP + i];
    const float drs0 = DR[i * DP + m];
    float intra = 0.f;
    for (int j = 0; j < i; ++j)
      intra = fmaf(exp2f(ce - cum[(j + 1) * DP + m]) * K[j * DP + m],
                   P[i * LP + j], intra);
    drb[(int64_t)(t0 + i) * g_ss + m] =
        from_float<T>(fmaf(U[m] * K[i * DP + m], pii, drs0 + intra));
    DR[i * DP + m] = R[i * DP + m] * drs0;
    const float dkde = DK[i * DP + m];
    // the neighbour t = i + 1 (its weight exp(ce_{i+1} - ci_i) is 1) apart
    // from the later steps, whose pairs span a decay
    float near = 0.f, far = 0.f, row = 0.f;
    if (i + 1 < L) {
      near = R[(i + 1) * DP + m] * P[(i + 1) * LP + i];
      for (int t = i + 2; t < L; ++t)
        far = fmaf(exp2f(cum[t * DP + m] - ci) * R[t * DP + m], P[t * LP + i],
                   far);
      for (int j = 0; j < i; ++j)
        row = fmaf(exp2f(ci - cum[(j + 1) * DP + m]) * K[j * DP + m],
                   P[(i + 1) * LP + j], row);
      row *= R[(i + 1) * DP + m];
    }
    dkb[(int64_t)(t0 + i) * g_ss + m] =
        from_float<T>(fmaf(U[m] * R[i * DP + m], pii, dkde + (near + far)));
    DK[i * DP + m] = K[i * DP + m] * (dkde + far) - row;
  }
  __syncthreads();   // every read of v is done

  // 5. v's tile becomes k exp(tot - ci)
  for (int idx = tid; idx < L * D; idx += NT) {
    const int i = idx / D, m = idx % D;
    V[i * DP + m] = K[i * DP + m] *
                    exp2f(cum[L * DP + m] - cum[(i + 1) * DP + m]);
  }
  __syncthreads();

  // 6. dv; then per channel the log decays' gradient, dw and the bonus's
  // partial, in reverse step order
  Tl::rows_by_cols(V, SB, L, tid, [&](int j, int c4, float4 acc) {
    for (int t = j; t < L; ++t) {
      const float sc = SC[t * LP + j];
      const float4 d4 = *reinterpret_cast<const float4*>(DO + t * DP + c4);
      acc.x = fmaf(sc, d4.x, acc.x);
      acc.y = fmaf(sc, d4.y, acc.y);
      acc.z = fmaf(sc, d4.z, acc.z);
      acc.w = fmaf(sc, d4.w, acc.w);
    }
    T* dst = dvb + (int64_t)(t0 + j) * g_ss + c4;
    dst[0] = from_float<T>(acc.x);
    dst[1] = from_float<T>(acc.y);
    dst[2] = from_float<T>(acc.z);
    dst[3] = from_float<T>(acc.w);
  });
  for (int m = tid; m < D; m += NT) {
    float run = 0.f;   // DR becomes its suffix sums over i > s
    for (int s = L - 1; s >= 0; --s) {
      const float x = DR[s * DP + m];
      DR[s * DP + m] = run;
      run += x;
    }
    const float a0 = exp2f(cum[L * DP + m]) * RS[m];
    float acc = 0.f, bon = 0.f;
    for (int s = 0; s < L; ++s) {
      const float dlw = (a0 + acc) + DR[s * DP + m];
      acc += DK[s * DP + m];
      const float wv = wb[(int64_t)(t0 + s) * a.w_ss + m];
      dwb[(int64_t)(t0 + s) * g_ss + m] =
          wv >= 1e-8f && wv <= 1.f ? dlw / wv : 0.f;
      bon = fmaf(R[s * DP + m] * K[s * DP + m], P[s * LP + s], bon);
    }
    a.dbonus_part[(((int64_t)b * NC + c) * H + h) * D + m] = bon;
  }
}

// --- 2, bf16 r, k, v: the per-chunk gradients on the tensor cores ---------

constexpr int MT = 256;            // threads of the mma chunk kernel
constexpr int MW = MT / 32;
constexpr int PART = 40;           // a channel group's partial sums of one
                                   // 8-row block: 28 pairs, 4 spare, 8 diagonals

template <int D>
struct MmaBwd {
  static constexpr int RS = D + 8;               // row stride of the bf16 tiles
                                                 // and of cum and the [Lp, D]
                                                 // float sums (16-byte pads)
  static constexpr int NCOL = D < 32 ? D : 32;   // columns of a product unit
  static constexpr int CU = D / NCOL;            // units across D
  static constexpr int G = D < 32 ? D : 32;      // lanes of a channel group
  static constexpr int GROUPS = D / G;
};

// Byte offsets of the block's shared memory (kernels/rwkv6_scan.py ::
// bwd_smem_bytes mirrors it), Lp = L rounded up to 16.
struct BwdLayout {
  int lp;
  size_t rkv, dot, sb, cum, p, sc, acc, bonus, rsum, part, sums, total;
};

inline __host__ __device__ BwdLayout bwd_layout(int D, int L) {
  BwdLayout m;
  m.lp = (L + 15) / 16 * 16;
  const size_t rs = D + 8, lp = m.lp, scs = m.lp + 4;
  const size_t groups = D < 32 ? 1 : D / 32;
  m.rkv = 0;                                   // 3 x [Lp][RS] bf16: r, k, v
  m.dot = m.rkv + 2 * 3 * lp * rs;             // 2 x [Lp][RS] bf16: d out's terms
  m.sb = m.dot + 2 * 2 * lp * rs;              // 2 x [D][RS] bf16: S0's, then dE's
  m.cum = m.sb + 2 * 2 * (size_t)D * rs;       // [Lp + 1][RS] float
  m.p = m.cum + 4 * (lp + 1) * rs;             // [Lp][Lp + 4] float: P
  m.sc = m.p + 4 * lp * scs;                   // [Lp][Lp + 4] float: scores
  m.acc = m.sc + 4 * lp * scs;                 // 4 x [Lp][RS] float
  m.bonus = m.acc + 4 * 4 * lp * rs;           // [D] float
  m.rsum = m.bonus + 4 * (size_t)D;            // [D] float
  m.part = m.rsum + 4 * (size_t)D;             // [Lp / 8][groups][PART] float
  m.sums = m.part + 4 * (lp / 8) * groups * PART;  // [3][MT] float
  m.total = m.sums + 4 * 3 * (size_t)MT;
  return m;
}

// Sum each of N values over the G lanes of a group (xor offsets below G,
// so a group never leaves its half-warp at G = 16) as a butterfly that
// halves the values a lane holds at each level: afterwards a lane holds
// value ((lane & (G - 1)) * N / G) + q for q < N / G where N >= G, else
// value (lane & (G - 1)) / (G / N), as do G / N lanes.  A fixed order.
template <int N, int O>
__device__ __forceinline__ void reduce_scatter(float* v, int lane) {
  if constexpr (N >= 2) {
    constexpr int HN = N / 2;
    const bool upper = (lane & O) != 0;
#pragma unroll
    for (int q = 0; q < HN; ++q) {
      const float send = upper ? v[q] : v[q + HN];
      const float keep = upper ? v[q + HN] : v[q];
      v[q] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
  }
  if constexpr (O > 1) reduce_scatter<(N >= 2 ? N / 2 : 1), O / 2>(v, lane);
}

// c += a . b for split float32 factors: hi.hi + hi.lo + lo.hi
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_bf16(c, al, bh0, bh1);
  mma_bf16(c, ah, bl0, bl1);
  mma_bf16(c, ah, bh0, bh1);
}

__device__ __forceinline__ float bf(const bf16* p) { return __bfloat162float(*p); }

template <int D>
__global__ void __launch_bounds__(MT, 2)
rwkv6_bwd_mma_kernel(BwdArgs a) {
  using M = MmaBwd<D>;
  constexpr int RS = M::RS, NCOL = M::NCOL, CU = M::CU, G = M::G;
  constexpr int GROUPS = M::GROUPS;
  constexpr int NTL = NCOL / 8;             // n-tiles of a unit
  constexpr int D4 = D / 4;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;                  // fragment row (and row + 8)
  const int col0 = 2 * (lane & 3);          // fragment columns col0, col0 + 1
  const int L = a.L, H = a.H, S = a.S;
  const int NC = S / L;
  const int c = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int t0 = c * L;

  const BwdLayout lay = bwd_layout(D, L);
  const int LP = lay.lp, NSUB = LP / 16, NB8 = LP / 8, SCS = LP + 4;
  extern __shared__ __align__(16) float smem_mm[];
  uint8_t* base = reinterpret_cast<uint8_t*>(smem_mm);
  bf16* R = reinterpret_cast<bf16*>(base + lay.rkv);        // [Lp][RS]
  bf16* K = R + LP * RS;
  bf16* V = K + LP * RS;
  bf16* DOH = reinterpret_cast<bf16*>(base + lay.dot);      // [Lp][RS]
  bf16* DOL = DOH + LP * RS;
  bf16* SBH = reinterpret_cast<bf16*>(base + lay.sb);       // [D][RS]
  bf16* SBL = SBH + D * RS;
  float* cum = reinterpret_cast<float*>(base + lay.cum);    // [Lp + 1][RS]
  float* P = reinterpret_cast<float*>(base + lay.p);        // [Lp][SCS]
  float* SC = reinterpret_cast<float*>(base + lay.sc);      // [Lp][SCS]
  float* DRA = reinterpret_cast<float*>(base + lay.acc);    // [Lp][RS] each:
  float* DKA = DRA + LP * RS;               // exp(ce) (S0 do), exp(tot - ci) (dE v),
  float* XA = DKA + LP * RS;                // X, Y
  float* YA = XA + LP * RS;
  float* U = reinterpret_cast<float*>(base + lay.bonus);    // [D]
  float* RSM = reinterpret_cast<float*>(base + lay.rsum);   // [D] rowsum(dE * S0)
  float* PARTS = reinterpret_cast<float*>(base + lay.part);
  float* SUMS = reinterpret_cast<float*>(base + lay.sums);  // [3][MT]

  const bf16* rb = static_cast<const bf16*>(a.r) + (int64_t)b * a.r_sb + (int64_t)h * a.r_sh;
  const bf16* kb = static_cast<const bf16*>(a.k) + (int64_t)b * a.k_sb + (int64_t)h * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + (int64_t)b * a.v_sb + (int64_t)h * a.v_sh;
  const float* wb = a.w + (int64_t)b * a.w_sb + (int64_t)h * a.w_sh;
  const float* ob = a.dout + (int64_t)b * a.o_sb + (int64_t)h * a.o_sh;
  const int64_t g_ss = (int64_t)H * D;
  const int64_t g_off = (int64_t)b * S * g_ss + (int64_t)h * D;
  bf16* drb = static_cast<bf16*>(a.dr) + g_off;
  bf16* dkb = static_cast<bf16*>(a.dk) + g_off;
  bf16* dvb = static_cast<bf16*>(a.dv) + g_off;
  float* dwb = a.dw + g_off;
  const float* E = a.states + (int64_t)bh * NC * D * D;
  const float* S0 = c > 0 ? E + (int64_t)(c - 1) * D * D
                          : a.state0 != nullptr ? a.state0 + (int64_t)bh * D * D
                                                : nullptr;
  const float* dEc = a.dstates + ((int64_t)bh * NC + c) * D * D;

  // ldmatrix addresses: A [16 x 16] from a row-major tile at (r0, k0); two
  // n-tiles of B from a tile stored [n][k] (b0, b1 of n0, then of n0 + 8);
  // the same from a tile stored [k][n], transposed
  auto lda = [&](uint32_t (&fr)[4], const bf16* tile, int r0, int k0) {
    ldsm_x4(fr, smem_addr(tile + (r0 + (lane & 15)) * RS + k0 + 8 * (lane >> 4)));
  };
  auto ldb = [&](uint32_t (&fr)[4], const bf16* tile, int n0, int k0) {
    ldsm_x4(fr, smem_addr(tile + (n0 + (lane & 7) + 8 * (lane >> 4)) * RS + k0 +
                          8 * ((lane >> 3) & 1)));
  };
  auto ldbt = [&](uint32_t (&fr)[4], const bf16* tile, int k0, int n0) {
    ldsm_x4_trans(fr, smem_addr(tile + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * RS +
                                n0 + 8 * (lane >> 4)));
  };
  auto split4 = [&](bf16* hi, bf16* lo, float4 x) {
    uint32_t h01, l01, h23, l23;
    split_pack(x.x, x.y, h01, l01);
    split_pack(x.z, x.w, h23, l23);
    *reinterpret_cast<uint2*>(hi) = make_uint2(h01, h23);
    *reinterpret_cast<uint2*>(lo) = make_uint2(l01, l23);
  };

  // 0. r, k, v by 16-byte copies (rows at or past L zero-filled); d out
  // and S0 as two bf16 terms; log2 w into cum's rows 1 .. Lp (0 past L);
  // the bonus; rowsum(dE * S0); dE's loads started where they fit in
  // registers
  {
    constexpr int DC = D / 8;
    const int cc = tid % DC;
#pragma unroll
    for (int which = 0; which < 3; ++which) {
      const bf16* src = which == 0 ? rb : which == 1 ? kb : vb;
      const int64_t ss = which == 0 ? a.r_ss : which == 1 ? a.k_ss : a.v_ss;
      for (int i = tid / DC; i < LP; i += MT / DC) {
        const bool ok = i < L;
        cp_async16(smem_addr(R + (which * LP + i) * RS + 8 * cc),
                   ok ? src + (int64_t)(t0 + i) * ss + 8 * cc : rb, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  }
  // d out and w: pieces of 4 channels, at most NQ a thread (Lp * D / 4 <=
  // 4 * MT wherever the shared memory fits); S0 and dE in batches of SQ
  // pieces, all of a batch's loads in flight before any is used; dE kept
  // in registers for step 3 where one batch takes it (D <= 64)
  constexpr int NQ = 4;
  constexpr int PRE = (D * D4 + MT - 1) / MT;
  constexpr bool KEEP = PRE <= 4;
  constexpr int SQ = KEEP ? PRE : 4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 xo[NQ], xw[NQ], sv[SQ], dpre[SQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int idx = tid + q * MT, i = idx / D4, n = 4 * (idx % D4);
    const bool ok = idx < LP * D4 && i < L;
    xo[q] = ok ? ld4(ob + (int64_t)(t0 + i) * a.o_ss + n) : zero;
    xw[q] = ok ? ld4(wb + (int64_t)(t0 + i) * a.w_ss + n)
               : make_float4(1.f, 1.f, 1.f, 1.f);
  }
  auto load_states = [&](int q0) {
#pragma unroll
    for (int q = 0; q < SQ; ++q) {
      const int idx = tid + (q0 + q) * MT, m = idx / D4, n = 4 * (idx % D4);
      const bool ok = idx < D * D4;
      sv[q] = ok && S0 != nullptr ? ld4(S0 + m * D + n) : zero;
      dpre[q] = ok && (KEEP || S0 != nullptr) ? ld4(dEc + m * D + n) : zero;
    }
  };
  // S0's terms, and rowsum(dE * S0): a row's D / 4 pieces lie in as many
  // consecutive lanes, summed by a butterfly
  auto use_states = [&](int q0) {
#pragma unroll
    for (int q = 0; q < SQ; ++q) {
      const int idx = tid + (q0 + q) * MT, m = idx / D4, n = 4 * (idx % D4);
      const bool ok = idx < D * D4;
      if (ok) split4(SBH + m * RS + n, SBL + m * RS + n, sv[q]);
      float part = fmaf(sv[q].w, dpre[q].w, fmaf(sv[q].z, dpre[q].z,
                   fmaf(sv[q].y, dpre[q].y, sv[q].x * dpre[q].x)));
#pragma unroll
      for (int o = D4 / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (ok && (lane & (D4 - 1)) == 0) RSM[m] = part;
    }
  };
  load_states(0);
  for (int i = tid; i < LP * SCS; i += MT) SC[i] = 0.f;
  for (int m = tid; m < D; m += MT) {
    U[m] = a.bonus[(int64_t)h * D + m];
    cum[m] = 0.f;
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int idx = tid + q * MT, i = idx / D4, n = 4 * (idx % D4);
    if (idx >= LP * D4) continue;
    split4(DOH + i * RS + n, DOL + i * RS + n, xo[q]);
    *reinterpret_cast<float4*>(cum + (i + 1) * RS + n) =
        make_float4(log2_clip(xw[q].x), log2_clip(xw[q].y),
                    log2_clip(xw[q].z), log2_clip(xw[q].w));
  }
  use_states(0);
  for (int q0 = SQ; q0 < PRE; q0 += SQ) {
    load_states(q0);
    use_states(q0);
  }
  cp_async_wait<0>();
  __syncthreads();

  // 1. cum[i + 1] = sum_{s <= i} log2 w_s, warp scans (D / 8 channels each)
  scan_channels<D / MW>(cum, RS, LP, lane, warp, MW);
  __syncthreads();

  // 2. with S0: DRA = exp(ce) (do S0^T); P = do v^T on and below the
  // diagonal 16 x 16 blocks; the scores below the diagonal 8 x 8 blocks
  // (the forward's units: 16 x 16 blocks of row sub-chunk a against column
  // sub-chunk c < a through row 16 a, each sub-chunk's rows 8 .. 15
  // against its rows 0 .. 7 through row 16 a + 8)
  {
    const int nDR = NSUB * CU, nP = NSUB * (NSUB + 1) / 2;
    const int nSF = NSUB * (NSUB - 1) / 2;
    for (int u = warp; u < nDR + nP + nSF + NSUB; u += MW) {
      if (u < nDR) {
        const int a0 = 16 * (u / CU), n0 = NCOL * (u % CU);
        float acc[NTL][4] = {};
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t ah[4], al[4];
          lda(ah, DOH, a0, 16 * kk);
          lda(al, DOL, a0, 16 * kk);
#pragma unroll
          for (int pd = 0; pd < NTL / 2; ++pd) {
            uint32_t bh[4], bl[4];
            ldb(bh, SBH, n0 + 16 * pd, 16 * kk);
            ldb(bl, SBL, n0 + 16 * pd, 16 * kk);
            mma3(acc[2 * pd], ah, al, bh[0], bh[1], bl[0], bl[1]);
            mma3(acc[2 * pd + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int i = a0 + g + 8 * hr, m = n0 + 8 * nt + col0;
            const float2 ce = *reinterpret_cast<const float2*>(cum + i * RS + m);
            *reinterpret_cast<float2*>(DRA + i * RS + m) =
                make_float2(exp2_approx(ce.x) * acc[nt][2 * hr],
                            exp2_approx(ce.y) * acc[nt][2 * hr + 1]);
          }
      } else if (u < nDR + nP) {
        int q = u - nDR, sa = 0;
        while (q > sa) { q -= sa + 1; ++sa; }
        const int a0 = 16 * sa, c0 = 16 * q;
        float acc[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t ah[4], al[4], bv[4];
          lda(ah, DOH, a0, 16 * kk);
          lda(al, DOL, a0, 16 * kk);
          ldb(bv, V, c0, 16 * kk);
          mma_bf16(acc[0], al, bv[0], bv[1]);
          mma_bf16(acc[0], ah, bv[0], bv[1]);
          mma_bf16(acc[1], al, bv[2], bv[3]);
          mma_bf16(acc[1], ah, bv[2], bv[3]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
            *reinterpret_cast<float2*>(P + (a0 + g + 8 * hr) * SCS + c0 + 8 * nt + col0) =
                make_float2(acc[nt][2 * hr], acc[nt][2 * hr + 1]);
      } else {
        const int su = u - nDR - nP;
        int e, c0, nnt;
        bool half;
        if (su < nSF) {
          int sa = 1, sc = su;
          while (sc >= sa) { sc -= sa; ++sa; }
          e = 16 * sa; c0 = 16 * sc; nnt = 2; half = false;
        } else {
          e = 16 * (su - nSF) + 8; c0 = e - 8; nnt = 1; half = true;
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
                *reinterpret_cast<const __nv_bfloat162*>(R + i * RS + kc));
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
                  *reinterpret_cast<const __nv_bfloat162*>(K + j * RS + kc));
              const float2 ci = *reinterpret_cast<const float2*>(cum + (j + 1) * RS + kc);
              const float2 e0 = *reinterpret_cast<const float2*>(cum + e * RS + kc);
              split_pack(kv.x * exp2_approx(fminf(e0.x - ci.x, 0.f)),
                         kv.y * exp2_approx(fminf(e0.y - ci.y, 0.f)), bh[hf], bl[hf]);
            }
            mma3(s[nt], ah, al, bh[0], bh[1], bl[0], bl[1]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
            if (nt < nnt && !(half && hr))
              *reinterpret_cast<float2*>(SC + (e + g + 8 * hr) * SCS + c0 + 8 * nt + col0) =
                  make_float2(s[nt][2 * hr], s[nt][2 * hr + 1]);
      }
    }
  }
  __syncthreads();   // every read of S0's terms is done

  // 3. dE's terms over S0's
  if constexpr (KEEP) {
#pragma unroll
    for (int q = 0; q < PRE; ++q) {
      const int idx = tid + q * MT;
      if (idx < D * D4)
        split4(SBH + (idx / D4) * RS + 4 * (idx % D4),
               SBL + (idx / D4) * RS + 4 * (idx % D4), dpre[q]);
    }
  } else {
    for (int idx = tid; idx < D * D4; idx += MT) {
      const int m = idx / D4, n = 4 * (idx % D4);
      split4(SBH + m * RS + n, SBL + m * RS + n, ld4(dEc + m * D + n));
    }
  }
  __syncthreads();

  // 4. DKA = exp(tot - ci) (v dE^T); X (rows i of a sub-chunk) and Y (rows
  // j) from P masked to j <= i - 2, the factors built in registers
  {
    // units of 16 rows and 16 columns: three kinds spread over the warps
    constexpr int C4 = D / 16;
    const int nU = NSUB * C4;
    for (int u = warp; u < 3 * nU; u += MW) {
      const int kind = u % 3, v = u / 3;
      const int s = v / C4, s0 = 16 * s, n0 = 16 * (v % C4);
      if (kind == 0) {
        float acc[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t av[4], bh[4], bl[4];
          lda(av, V, s0, 16 * kk);
          ldb(bh, SBH, n0, 16 * kk);
          ldb(bl, SBL, n0, 16 * kk);
          mma_bf16(acc[0], av, bl[0], bl[1]);
          mma_bf16(acc[0], av, bh[0], bh[1]);
          mma_bf16(acc[1], av, bl[2], bl[3]);
          mma_bf16(acc[1], av, bh[2], bh[3]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int j = s0 + g + 8 * hr, m = n0 + 8 * nt + col0;
            const float2 tot = *reinterpret_cast<const float2*>(cum + LP * RS + m);
            const float2 ci = *reinterpret_cast<const float2*>(cum + (j + 1) * RS + m);
            *reinterpret_cast<float2*>(DKA + j * RS + m) = make_float2(
                exp2_approx(fminf(tot.x - ci.x, 0.f)) * acc[nt][2 * hr],
                exp2_approx(fminf(tot.y - ci.y, 0.f)) * acc[nt][2 * hr + 1]);
          }
        continue;
      }
      const bool is_x = kind == 1;
      // the boundary rows: X's whole part through s0 (columns j < s0), Y's
      // through s0 + 16 (rows i >= s0 + 16); the halves through s0 + 8
      const int ef = is_x ? s0 : s0 + 16, eh = s0 + 8;
      float accF[2][4] = {}, accH[2][4] = {};
      const int k_lo = is_x ? 0 : s + 1, k_hi = is_x ? s : NSUB;
      for (int kq = k_lo; kq < k_hi; ++kq) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = s0 + g + 8 * (q & 1);
          const int kx = 16 * kq + col0 + 8 * (q >> 1);
          float p0, p1;
          if (is_x) {        // P'[row][kx], P'[row][kx + 1]
            const float2 pv = *reinterpret_cast<const float2*>(P + row * SCS + kx);
            p0 = kx <= row - 2 ? pv.x : 0.f;
            p1 = kx + 1 <= row - 2 ? pv.y : 0.f;
          } else {           // P'[kx][row], P'[kx + 1][row]
            p0 = row <= kx - 2 ? P[kx * SCS + row] : 0.f;
            p1 = row <= kx - 1 ? P[(kx + 1) * SCS + row] : 0.f;
          }
          split_pack(p0, p1, ah[q], al[q]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int m = n0 + 8 * nt + g;
          const float ee = cum[ef * RS + m];
          uint32_t bh[2], bl[2];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int kx = 16 * kq + col0 + 8 * hf;
            float f0, f1;
            if (is_x) {      // k_j exp(ce_e - ci_j)
              f0 = bf(K + kx * RS + m) * exp2_approx(fminf(ee - cum[(kx + 1) * RS + m], 0.f));
              f1 = bf(K + (kx + 1) * RS + m) *
                   exp2_approx(fminf(ee - cum[(kx + 2) * RS + m], 0.f));
            } else {         // r_i exp(ce_i - ce_e)
              f0 = bf(R + kx * RS + m) * exp2_approx(fminf(cum[kx * RS + m] - ee, 0.f));
              f1 = bf(R + (kx + 1) * RS + m) *
                   exp2_approx(fminf(cum[(kx + 1) * RS + m] - ee, 0.f));
            }
            split_pack(f0, f1, bh[hf], bl[hf]);
          }
          mma3(accF[nt], ah, al, bh[0], bh[1], bl[0], bl[1]);
        }
      }
      {
        // X: rows s0 + 8 + g against columns s0 + col0 (+ 1); Y: rows s0 +
        // g against rows s0 + 8 + col0 (+ 1); 8 deep, the rest zero
        uint32_t ah[4] = {0u, 0u, 0u, 0u}, al[4] = {0u, 0u, 0u, 0u};
        const int row = is_x ? eh + g : s0 + g;
        const int kx = (is_x ? s0 : eh) + col0;
        float p0, p1;
        if (is_x) {
          const float2 pv = *reinterpret_cast<const float2*>(P + row * SCS + kx);
          p0 = kx <= row - 2 ? pv.x : 0.f;
          p1 = kx + 1 <= row - 2 ? pv.y : 0.f;
        } else {
          p0 = row <= kx - 2 ? P[kx * SCS + row] : 0.f;
          p1 = row <= kx - 1 ? P[(kx + 1) * SCS + row] : 0.f;
        }
        split_pack(p0, p1, ah[0], al[0]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int m = n0 + 8 * nt + g;
          const float ee = cum[eh * RS + m];
          float f0, f1;
          if (is_x) {
            f0 = bf(K + kx * RS + m) * exp2_approx(fminf(ee - cum[(kx + 1) * RS + m], 0.f));
            f1 = bf(K + (kx + 1) * RS + m) *
                 exp2_approx(fminf(ee - cum[(kx + 2) * RS + m], 0.f));
          } else {
            f0 = bf(R + kx * RS + m) * exp2_approx(fminf(cum[kx * RS + m] - ee, 0.f));
            f1 = bf(R + (kx + 1) * RS + m) *
                 exp2_approx(fminf(cum[(kx + 1) * RS + m] - ee, 0.f));
          }
          uint32_t bh0, bl0;
          split_pack(f0, f1, bh0, bl0);
          mma3(accH[nt], ah, al, bh0, 0u, bl0, 0u);
        }
      }
      // scale by the factor on the other side of each boundary and store
      const bool whole = is_x ? s > 0 : s + 1 < NSUB;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = s0 + g + 8 * hr, m = n0 + 8 * nt + col0;
          float out[2];
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const float cr = is_x ? cum[row * RS + m + x] : cum[(row + 1) * RS + m + x];
            const float cf = cum[ef * RS + m + x], chh = cum[eh * RS + m + x];
            float y = whole ? exp2_approx(fminf(is_x ? cr - cf : cf - cr, 0.f)) *
                                  accF[nt][2 * hr + x]
                            : 0.f;
            if (hr == (is_x ? 1 : 0))
              y += exp2_approx(fminf(is_x ? cr - chh : chh - cr, 0.f)) * accH[nt][x];
            out[x] = y;
          }
          *reinterpret_cast<float2*>((is_x ? XA : YA) + row * RS + m) =
              make_float2(out[0], out[1]);
        }
    }
  }
  __syncthreads();

  // 5. the diagonal 8 x 8 blocks, pair by pair in float32: one thread per
  // (block, channel) takes each pair's exponential once, for its score
  // (summed over the channels below), X and Y (pairs two or more apart)
  for (int base = 32 * warp; base < NB8 * D; base += MT) {
    const int it = base + lane, b8 = it / D, m = it % D, i0 = 8 * b8;
    float rr[8], kk[8], cu[9];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      rr[q] = bf(R + (i0 + q) * RS + m);
      kk[q] = bf(K + (i0 + q) * RS + m);
    }
#pragma unroll
    for (int q = 0; q < 9; ++q) cu[q] = cum[(i0 + q) * RS + m];
    float xs[8] = {}, ys[8] = {}, sp[32], sd[8];
#pragma unroll
    for (int ii = 1; ii < 8; ++ii)
#pragma unroll
      for (int jj = 0; jj < ii; ++jj) {
        const float e = exp2_approx(fminf(cu[ii] - cu[jj + 1], 0.f));
        sp[ii * (ii - 1) / 2 + jj] = rr[ii] * kk[jj] * e;
        if (ii - jj >= 2) {
          const float pij = P[(i0 + ii) * SCS + i0 + jj];
          xs[ii] = fmaf(e * kk[jj], pij, xs[ii]);
          ys[jj] = fmaf(e * rr[ii], pij, ys[jj]);
        }
      }
#pragma unroll
    for (int q = 28; q < 32; ++q) sp[q] = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) sd[q] = rr[q] * U[m] * kk[q];
    reduce_scatter<32, G / 2>(sp, lane);
    reduce_scatter<8, G / 2>(sd, lane);
    float* part = PARTS + (b8 * GROUPS + m / G) * PART;
    const int gl = lane & (G - 1);
#pragma unroll
    for (int q = 0; q < 32 / G; ++q) part[gl * (32 / G) + q] = sp[q];
    if ((gl & (G / 8 - 1)) == 0) part[32 + gl / (G / 8)] = sd[0];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      XA[(i0 + q) * RS + m] += xs[q];
      YA[(i0 + q) * RS + m] += ys[q];
    }
  }
  __syncthreads();

  // 6. the diagonal blocks' scores: the channel groups' sums in order
  for (int idx = tid; idx < NB8 * 36; idx += MT) {
    const int b8 = idx / 36, q = idx % 36, i0 = 8 * b8;
    int slot, i, j;
    if (q < 28) {
      int ii = 1, jj = q;
      while (jj >= ii) { jj -= ii; ++ii; }
      slot = q; i = i0 + ii; j = i0 + jj;
    } else {
      slot = 4 + q; i = j = i0 + q - 28;
    }
    float s = 0.f;
#pragma unroll
    for (int gr = 0; gr < GROUPS; ++gr) s += PARTS[(b8 * GROUPS + gr) * PART + slot];
    SC[i * SCS + j] = s;
  }
  __syncthreads();

  // 7. dv = (k exp(tot - ci)) dE + scores^T do, per unit of 16 rows and
  // NCOL columns: the factor built in registers, dE's and d out's terms
  // through ldmatrix.trans
  for (int u = warp; u < NSUB * CU; u += MW) {
    const int s = u / CU, s0 = 16 * s, n0 = NCOL * (u % CU);
    float acc[NTL][4] = {};
#pragma unroll
    for (int km = 0; km < D / 16; ++km) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = s0 + g + 8 * (q & 1);
        const int mm = 16 * km + col0 + 8 * (q >> 1);
        const float2 kv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(K + j * RS + mm));
        const float2 tot = *reinterpret_cast<const float2*>(cum + LP * RS + mm);
        const float2 ci = *reinterpret_cast<const float2*>(cum + (j + 1) * RS + mm);
        split_pack(kv.x * exp2_approx(fminf(tot.x - ci.x, 0.f)),
                   kv.y * exp2_approx(fminf(tot.y - ci.y, 0.f)), ah[q], al[q]);
      }
#pragma unroll
      for (int pd = 0; pd < NTL / 2; ++pd) {
        uint32_t bh[4], bl[4];
        ldbt(bh, SBH, 16 * km, n0 + 16 * pd);
        ldbt(bl, SBL, 16 * km, n0 + 16 * pd);
        mma3(acc[2 * pd], ah, al, bh[0], bh[1], bl[0], bl[1]);
        mma3(acc[2 * pd + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
      }
    }
    for (int ki = s; ki < NSUB; ++ki) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = s0 + g + 8 * (q & 1);
        const int i = 16 * ki + col0 + 8 * (q >> 1);
        split_pack(SC[i * SCS + j], SC[(i + 1) * SCS + j], ah[q], al[q]);
      }
#pragma unroll
      for (int pd = 0; pd < NTL / 2; ++pd) {
        uint32_t bh[4], bl[4];
        ldbt(bh, DOH, 16 * ki, n0 + 16 * pd);
        ldbt(bl, DOL, 16 * ki, n0 + 16 * pd);
        mma3(acc[2 * pd], ah, al, bh[0], bh[1], bl[0], bl[1]);
        mma3(acc[2 * pd + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int j = s0 + g + 8 * hr;
      if (j >= L) continue;
      bf16* drow = dvb + (int64_t)(t0 + j) * g_ss + n0 + col0;
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt)
        store2(drow + 8 * nt, acc[nt][2 * hr], acc[nt][2 * hr + 1]);
    }
  }
  // 8. per channel, NP threads a channel (lanes on consecutive channels),
  // each a run of SL steps: dr and dk whole, and in registers the run's
  // terms of dlw (r_i exp(ce_i) (S0 do_i) and k_i (exp(tot - ci_i) (dE
  // v_i) + Y_i) - r_{i+1} X_{i+1}) and w; the runs' sums of both terms and
  // of dbonus's partial pass through SUMS and are summed in order; then
  // dlw, dw and dbonus's partial
  {
    constexpr int NP = MT / D;
    constexpr int SLM = (D >= 128 ? 32 : 64) / NP;   // L <= 32 at D = 128
    const int m = tid % D, part = tid / D;
    const int SL = (L + NP - 1) / NP;
    const int s_lo = min(L, part * SL), s_hi = min(L, s_lo + SL);
    const float um = U[m];
    float wq[SLM], xr[SLM], xk[SLM];
#pragma unroll
    for (int q = 0; q < SLM; ++q)
      wq[q] = s_lo + q < s_hi ? wb[(int64_t)(t0 + s_lo + q) * a.w_ss + m] : 1.f;
    float sdr = 0.f, sdk = 0.f, bon = 0.f;
#pragma unroll
    for (int q = 0; q < SLM; ++q) {
      const int i = s_lo + q;
      xr[q] = xk[q] = 0.f;
      if (i >= s_hi) continue;
      const float ri = bf(R + i * RS + m), ki = bf(K + i * RS + m);
      const float pii = P[i * SCS + i];
      const float drs = DRA[i * RS + m], dks = DKA[i * RS + m];
      const float x = XA[i * RS + m], y = YA[i * RS + m];
      const float nr = i > 0 ? bf(K + (i - 1) * RS + m) * P[i * SCS + i - 1] : 0.f;
      float nk = 0.f, row = 0.f;
      if (i + 1 < L) {
        const float r1 = bf(R + (i + 1) * RS + m);
        nk = r1 * P[(i + 1) * SCS + i];
        row = r1 * XA[(i + 1) * RS + m];
      }
      drb[(int64_t)(t0 + i) * g_ss + m] =
          __float2bfloat16_rn(fmaf(um * ki, pii, (drs + x) + nr));
      dkb[(int64_t)(t0 + i) * g_ss + m] =
          __float2bfloat16_rn(fmaf(um * ri, pii, (dks + y) + nk));
      xr[q] = ri * drs;
      xk[q] = ki * (dks + y) - row;
      bon = fmaf(ri * ki, pii, bon);
      sdr += xr[q];
      sdk += xk[q];
    }
    SUMS[part * D + m] = sdr;
    SUMS[(NP + part) * D + m] = sdk;
    SUMS[(2 * NP + part) * D + m] = bon;
    __syncthreads();
    float before = 0.f, after = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      if (p < part) before += SUMS[(NP + p) * D + m];
      if (p > part) after += SUMS[p * D + m];
    }
    float run = after;               // xr becomes its suffix sums over i > s
#pragma unroll
    for (int q = SLM - 1; q >= 0; --q) {
      const float x = xr[q];
      xr[q] = run;
      run += x;
    }
    const float a0 = exp2f(cum[LP * RS + m]) * RSM[m];
    float acc = before;
#pragma unroll
    for (int q = 0; q < SLM; ++q) {
      const int s = s_lo + q;
      if (s >= s_hi) break;
      const float dlw = (a0 + acc) + xr[q];
      acc += xk[q];
      dwb[(int64_t)(t0 + s) * g_ss + m] =
          wq[q] >= 1e-8f && wq[q] <= 1.f ? __fdividef(dlw, wq[q]) : 0.f;
    }
    if (part == 0) {
      float tot = 0.f;
#pragma unroll
      for (int p = 0; p < NP; ++p) tot += SUMS[(2 * NP + p) * D + m];
      a.dbonus_part[(((int64_t)b * NC + c) * H + h) * D + m] = tot;
    }
  }
}

// --- 3. dbonus: the partials summed in a fixed order ----------------------

__global__ void rwkv6_bwd_bonus_kernel(const float* __restrict__ part,
                                       float* __restrict__ dbonus, int n,
                                       int H, int D) {
  const int h = blockIdx.x;
  for (int m = threadIdx.x; m < D; m += blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < n; ++p) s += part[((int64_t)p * H + h) * D + m];
    dbonus[(int64_t)h * D + m] = s;
  }
}

// --- launches ---------------------------------------------------------------

// both state launches for the directions the passes ask for
template <int D, typename T>
int launch_states(const BwdArgs& a) {
  static unsigned local_set = 0;
  auto local = rwkv6_bwd_local_kernel<D, T>;
  cudaError_t err = allow_smem(local, (int)SMEM_LIMIT, local_set);
  if (err != cudaSuccess) return (int)err;
  const int dirs = ((a.passes & PASS_STATES) != 0) + ((a.passes & PASS_COTANGENTS) != 0);
  const int first = (a.passes & PASS_STATES) ? 0 : 1;
  const int nc = a.S / a.L;
  local<<<dim3(nc, a.B * a.H), NT, local_smem(D, a.L, dirs), a.stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t pieces = (int64_t)a.B * a.H * D * D / 4;
  rwkv6_bwd_scan_kernel<D><<<dim3((unsigned)((pieces + NT - 1) / NT), dirs), NT, 0,
                             a.stream>>>(a, first);
  return (int)cudaGetLastError();
}

template <int D>
int launch_chunk_fma(const BwdArgs& a) {
  static unsigned chunk_set = 0;
  auto kern = rwkv6_bwd_chunk_kernel<D>;
  cudaError_t err = allow_smem(kern, (int)SMEM_LIMIT, chunk_set);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(a.S / a.L, a.B * a.H), NT, chunk_smem(D, a.L), a.stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_chunk_mma(const BwdArgs& a) {
  static unsigned mma_set = 0;
  auto kern = rwkv6_bwd_mma_kernel<D>;
  cudaError_t err = allow_smem(kern, (int)SMEM_LIMIT, mma_set);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(a.S / a.L, a.B * a.H), MT, bwd_layout(D, a.L).total, a.stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int states_for(const BwdArgs& a, int D) {
  switch (D) {
    case 16: return launch_states<16, T>(a);
    case 32: return launch_states<32, T>(a);
    case 64: return launch_states<64, T>(a);
    case 128: return launch_states<128, T>(a);
    default: return -1;
  }
}

int chunks_for(const BwdArgs& a, int D, bool bf16_in) {
  if (bf16_in) {
    switch (D) {
      case 16: return launch_chunk_mma<16>(a);
      case 32: return launch_chunk_mma<32>(a);
      case 64: return launch_chunk_mma<64>(a);
      case 128: return launch_chunk_mma<128>(a);
      default: return -1;
    }
  }
  switch (D) {
    case 16: return launch_chunk_fma<16>(a);
    case 32: return launch_chunk_fma<32>(a);
    case 64: return launch_chunk_fma<64>(a);
    case 128: return launch_chunk_fma<128>(a);
    default: return -1;
  }
}

// The 16-byte rule (common.cuh) of the contributions' and the mma chunk
// kernel's loads of 4 (float32) or 8 (bf16) channels: 16-byte aligned
// bases of r, k, v, w and d out, and outer strides of whole 16 bytes
bool aligned_rows(const BwdArgs& a, bool bf16_in) {
  auto rows = [&](int64_t size, int64_t stride) {
    return size == 1 || stride % (bf16_in ? 8 : 4) == 0;
  };
  auto stride4 = [](int64_t size, int64_t stride) {
    return size == 1 || stride % 4 == 0;
  };
  return base16(a.r) && base16(a.k) && base16(a.v) && base16(a.w) &&
         base16(a.dout) &&
         rows(a.B, a.r_sb) && rows(a.S, a.r_ss) && rows(a.H, a.r_sh) &&
         rows(a.B, a.k_sb) && rows(a.S, a.k_ss) && rows(a.H, a.k_sh) &&
         rows(a.B, a.v_sb) && rows(a.S, a.v_ss) && rows(a.H, a.v_sh) &&
         stride4(a.B, a.w_sb) && stride4(a.S, a.w_ss) && stride4(a.H, a.w_sh) &&
         stride4(a.B, a.o_sb) && stride4(a.S, a.o_ss) && stride4(a.H, a.o_sh);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, of r, k, v and of dr, dk, dv.  r, k,
// v, w (float32) and dout (float32) are [B, S, H, D] with the given
// strides (in elements; the last dimension has stride 1); dr, dk, dv, dw
// (float32) are written contiguous [B, S, H, D].  bonus [H, D], state0,
// dstate and dstate0 [B, H, D, D] are contiguous float32; state0 and
// dstate may be null (zeros), dstate0 null (not written).  states and
// dstates are [B, H, S / L, D, D] float32 scratch: the chunk-end states
// and cotangents; factors [B, H, S / L, D] float32 scratch, the chunks'
// decay factors; dbonus_part [B, S / L, H, D] float32 scratch; dbonus
// [H, D] float32.  passes: a mask of 1 (the states), 2 (the cotangents
// and dstate0; both state passes take the same two launches, the
// contributions and the scan, one grid slice per direction), 4 (the
// per-chunk gradients, which read both) and 8 (the sum of dbonus, which
// reads the partials).  Requires S % L == 0, 1 <= L <= 64, the launched
// per-chunk kernel's shared memory (bwd_layout for bf16, chunk_smem for
// float32) within the card's 227 KB, 16-byte aligned bases of the
// states, factors, state0, dstate and dstate0, and the 16-byte rule of
// aligned_rows for the state passes and bf16's per-chunk pass.  Returns cudaGetLastError() after the
// launches (0 on success), -1 for arguments it does not take.  Launches
// on `stream`, does not synchronise, allocates nothing.
extern "C" int fate_rwkv6_scan_bwd(
    const void* r, const void* k, const void* v, const void* w,
    const void* bonus, const void* state0, const void* dout,
    const void* dstate, void* states, void* dstates, void* factors, void* dr,
    void* dk, void* dv, void* dw, void* dbonus_part, void* dbonus,
    void* dstate0, int B, int S, int H, int D, int L,
    long long r_sb, long long r_ss, long long r_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long w_sb, long long w_ss, long long w_sh,
    long long o_sb, long long o_ss, long long o_sh, int dtype, int passes,
    void* stream) {
  if (B < 1 || H < 1 || S < 1 || L < 1 || L > 64 || S % L != 0) return -1;
  if (passes < 1 || passes > 15 || (dtype != 0 && dtype != 1)) return -1;
  if (D != 16 && D != 32 && D != 64 && D != 128) return -1;
  const bool state_passes = (passes & (PASS_STATES | PASS_COTANGENTS)) != 0;
  const size_t chunk_bytes = dtype == 1 ? bwd_layout(D, L).total : chunk_smem(D, L);
  if ((passes & PASS_CHUNKS) && chunk_bytes > SMEM_LIMIT) return -1;
  if (state_passes && local_smem(D, L, 2) > SMEM_LIMIT) return -1;
  if ((passes & (PASS_STATES | PASS_CHUNKS)) && states == nullptr) return -1;
  if ((passes & (PASS_COTANGENTS | PASS_CHUNKS)) && dstates == nullptr)
    return -1;
  if (state_passes &&
      (factors == nullptr || !base16(factors) ||
       (states != nullptr && !base16(states)) ||
       (dstates != nullptr && !base16(dstates)) ||
       (state0 != nullptr && !base16(state0)) ||
       (dstate != nullptr && !base16(dstate)) ||
       (dstate0 != nullptr && !base16(dstate0))))
    return -1;
  if ((passes & PASS_CHUNKS) &&
      (!dr || !dk || !dv || !dw || !dbonus_part || !bonus))
    return -1;
  if ((passes & PASS_BONUS) && (!dbonus_part || !dbonus)) return -1;
  BwdArgs a{r, k, v,
            static_cast<const float*>(w), static_cast<const float*>(bonus),
            static_cast<const float*>(state0), static_cast<const float*>(dout),
            static_cast<const float*>(dstate), static_cast<float*>(states),
            static_cast<float*>(dstates), static_cast<float*>(factors), dr, dk,
            dv, static_cast<float*>(dw), static_cast<float*>(dbonus_part),
            static_cast<float*>(dbonus), static_cast<float*>(dstate0), B, S, H,
            L, r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
            w_sb, w_ss, w_sh, o_sb, o_ss, o_sh, passes,
            static_cast<cudaStream_t>(stream)};
  const bool mma = dtype == 1 && (passes & PASS_CHUNKS);
  if ((state_passes || mma) && !aligned_rows(a, dtype == 1)) return -1;
  if (mma && (!base16(states) || !base16(dstates) ||
              (state0 != nullptr && !base16(state0))))
    return -1;
  if (state_passes) {
    const int rc = dtype == 1 ? states_for<bf16>(a, D) : states_for<float>(a, D);
    if (rc != 0) return rc;
  }
  if (passes & PASS_CHUNKS) {
    const int rc = chunks_for(a, D, dtype == 1);
    if (rc != 0) return rc;
  }
  if (passes & PASS_BONUS) {
    rwkv6_bwd_bonus_kernel<<<H, D, 0, a.stream>>>(
        a.dbonus_part, a.dbonus, B * (S / L), H, D);
    return (int)cudaGetLastError();
  }
  return 0;
}
