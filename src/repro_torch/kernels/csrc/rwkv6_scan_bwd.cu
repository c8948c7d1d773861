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
// 1, no decay between them) never appear.  The suffix and prefix sums run
// in fixed order over the chunk's steps; no sum spans chunks.
//
// In chunks, with cum the inclusive sums of log2 w in the chunk (cum[0]
// = 0, ce_i = cum[i], ci_i = cum[i + 1], tot = cum[L]):
//   dr_i = exp(ce_i) (S0 do_i) + sum_{j<i} exp(ce_i - ci_j) k_j P_ij + u k_i P_ii
//   dk_j = exp(tot - ci_j) (dE v_j) + sum_{i>j} exp(ce_i - ci_j) r_i P_ij + u r_j P_jj
//   dv_j = (k_j exp(tot - ci_j)) dE + sum_{i>j} score_ij do_i + diag_j do_j
// with P_ij = do_i . v_j and the forward's scores score_ij = sum_k r_ik
// k_jk exp(ce_ik - ci_jk), diag_j = r_j . (u k_j).  Every exponent
// formed is a sum of log decays and <= 0 (cum never rises in float32
// either), so strong decay (w = 1e-6) underflows to 0 and never overflows.
//
// Three kernels, in the order the C entry launches them:
//   1. rwkv6_bwd_states_kernel, split by value column (S[:, j] needs only
//      v[:, j], dS[:, j] only do[:, j]): blocks of CB = 16 columns, grid
//      (D / 16, B * H, 2).  z = 0 walks the chunks forward and writes each
//      chunk's end state E_c = S after the chunk; z = 1 walks them
//      backward and writes each chunk's end cotangent dE_c, then dstate0.
//      Per chunk: the [L, D] tile of k (or r) and w, loaded four a thread
//      at a time, one thread per channel takes the cumulative sums, the
//      tile is scaled in place by exp(tot - ci) (or exp(ce)), each thread
//      updates its D * 16 / 256 state entries held in registers.  Held to
//      five blocks an SM, so that both passes run in one wave.
//   2. rwkv6_bwd_chunk_kernel, one block per (chunk, b, h): reads S0 (E_{c-1}
//      or state0) and dE_c; writes dr, dk, dv in r's type, dw in
//      float32 and the chunk's partial dbonus.  Every operand in float32
//      shared memory (rows of D + 4 floats), FMA on the CUDA cores: the
//      three [L, D] x [D, D] products (S0 do, dE v, (k exp(tot - ci)) dE)
//      in register tiles fed by 16-byte loads (Tiles); each pair's
//      exponential taken where it is used (scores, dr, dk, the pairs'
//      share of dlw: four times).
//   3. rwkv6_bwd_bonus_kernel: dbonus[h] = the partials summed over b and
//      the chunks in increasing order.
// No atomics: a call's bits repeat.
//
// What bounds it.  At rwkv6-3b's training microbatch (B 2, S 4096, H 40,
// D 64, L 32, bf16 r, k, v, float32 w and d out) the function moves about
// 503 MB (r, k, v, dr, dk, dv in bf16; w, d out, dw in float32), 0.15 ms
// at an H100's 3.35 TB/s.  This design adds its own traffic: E and dE,
// 168 MB each, written by kernel 1 and read by kernel 2.  Its operations
// (chip_smoke.rwkv_bwd_flops: 20.5 G, the [D, D] products, the pairs and
// their exponentials) take 0.31 ms at the 67 TFLOP/s of float32 FMA.  What
// holds it instead (tools/kernel_probe.py rwkv6-bwd-phases, NVIDIA H100
// 80GB HBM3 at 700 W: 3.86 ms a call) is kernel 1's walk over 128 chunks,
// 8.0 us a chunk (1.03 ms a pass, 1.54 ms for both in their one launch),
// and kernel 2's shared-memory loads of the pair terms (2.30 ms).  A first
// design: float32 FMA for bf16 inputs too, no tensor cores, no copy
// overlap.
#include "common.cuh"

namespace {

using namespace fate;
using bf16 = __nv_bfloat16;

constexpr int NT = 256;            // threads of every kernel but the last
constexpr int CB = 16;             // value columns of a states block
constexpr size_t SMEM_LIMIT = 232448;

// passes of the C entry (kernels/rwkv6_scan.py mirrors them)
constexpr int PASS_STATES = 1, PASS_COTANGENTS = 2, PASS_CHUNKS = 4,
              PASS_BONUS = 8;

__device__ __forceinline__ float log2_clip(float w) {
  return log2f(fminf(fmaxf(w, 1e-8f), 1.f));
}

struct BwdArgs {
  const void *r, *k, *v;
  const float *w, *bonus, *state0, *dout, *dstate;
  float *states, *dstates;
  void *dr, *dk, *dv;
  float *dw, *dbonus_part, *dbonus, *dstate0;
  int B, S, H, L;
  int64_t r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int64_t w_sb, w_ss, w_sh, o_sb, o_ss, o_sh;
  int passes;
  cudaStream_t stream;
};

// Row stride (floats) of the per-chunk kernel's [., D] tiles: 16-byte
// rows for its float4 loads; rows 4 banks apart, so that the eight rows a
// quarter warp loads in one 16-byte access meet no bank twice.
__host__ __device__ constexpr int tile_stride(int D) { return D + 4; }

size_t states_smem(int D, int L) {
  return sizeof(float) *
         ((size_t)L * (D + 1) + (size_t)L * CB + (size_t)(L + 1) * (D + 1));
}

size_t chunk_smem(int D, int L) {
  const size_t dp = tile_stride(D);
  return sizeof(float) * (6 * (size_t)L * dp + (size_t)(L + 1) * dp +
                          (size_t)D * dp + 2 * (size_t)L * (L + 1) +
                          2 * (size_t)D);
}

// --- 1. the chunk-end states and cotangents, by value column --------------

// Five blocks an SM (at most 51 registers a thread): the grid of both
// passes at rwkv6-3b's training microbatch, 4 x 80 x 2 = 640 blocks, then
// runs in one wave on 132 SMs, each block walking its 128 chunks once.
constexpr int STATE_BLOCKS = 5;
constexpr int LB = 4;              // loads a thread keeps in flight

template <int D, typename T>
__global__ void __launch_bounds__(NT, STATE_BLOCKS)
rwkv6_bwd_states_kernel(BwdArgs a, int first_half) {
  constexpr int DP = D + 1;
  constexpr int PER = D * CB / NT >= 1 ? D * CB / NT : 1;
  const int L = a.L, H = a.H;
  const int NC = a.S / L;
  const int c0 = blockIdx.x * CB;           // this block's value columns
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const bool fwd = first_half + (int)blockIdx.z == 0;
  const int tid = threadIdx.x;

  extern __shared__ float smem_st[];
  float* X = smem_st;                       // [L][DP] k or r, then scaled
  float* Y = X + L * DP;                    // [L][CB] v or d out columns
  float* cum = Y + L * CB;                  // [L + 1][DP] log2 w, summed

  // x: k (forward) or r (backward); y: v or d out
  const T* xb = static_cast<const T*>(fwd ? a.k : a.r) +
                (int64_t)b * (fwd ? a.k_sb : a.r_sb) +
                (int64_t)h * (fwd ? a.k_sh : a.r_sh);
  const int64_t x_ss = fwd ? a.k_ss : a.r_ss;
  const T* vb = static_cast<const T*>(a.v) + (int64_t)b * a.v_sb +
                (int64_t)h * a.v_sh;
  const float* ob = a.dout + (int64_t)b * a.o_sb + (int64_t)h * a.o_sh;
  const float* wb = a.w + (int64_t)b * a.w_sb + (int64_t)h * a.w_sh;
  float* outb = (fwd ? a.states : a.dstates) + (int64_t)bh * NC * D * D;

  // the thread's entries (m, c0 + col) of the [D, D] state, in registers
  const float* init = fwd ? a.state0 : a.dstate;
  float st[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int e = tid + NT * q;
    st[q] = 0.f;
    if (e < D * CB && init != nullptr)
      st[q] = init[(int64_t)bh * D * D + (e / CB) * D + c0 + e % CB];
  }
  if (tid < D) cum[tid] = 0.f;

  for (int step = 0; step < NC; ++step) {
    const int c = fwd ? step : NC - 1 - step;
    const int t0 = c * L;
    if (!fwd) {   // dE_c: the cotangent of the state after chunk c
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int e = tid + NT * q;
        if (e < D * CB)
          outb[(int64_t)c * D * D + (e / CB) * D + c0 + e % CB] = st[q];
      }
    }
    __syncthreads();   // the previous chunk is done with the tiles
    // loads in batches of LB a thread, all in flight before their stores
    for (int base = tid; base < L * D; base += LB * NT) {
      float xv[LB], wv[LB];
#pragma unroll
      for (int u = 0; u < LB; ++u) {
        const int idx = base + u * NT, i = idx / D, m = idx % D;
        xv[u] = idx < L * D ? to_float(xb[(int64_t)(t0 + i) * x_ss + m]) : 0.f;
        wv[u] = idx < L * D ? wb[(int64_t)(t0 + i) * a.w_ss + m] : 1.f;
      }
#pragma unroll
      for (int u = 0; u < LB; ++u) {
        const int idx = base + u * NT, i = idx / D, m = idx % D;
        if (idx < L * D) {
          X[i * DP + m] = xv[u];
          cum[(i + 1) * DP + m] = log2_clip(wv[u]);
        }
      }
    }
    for (int base = tid; base < L * CB; base += LB * NT) {
      float yv[LB];
#pragma unroll
      for (int u = 0; u < LB; ++u) {
        const int idx = base + u * NT, i = idx / CB, col = c0 + idx % CB;
        yv[u] = idx >= L * CB ? 0.f
                : fwd ? to_float(vb[(int64_t)(t0 + i) * a.v_ss + col])
                      : ob[(int64_t)(t0 + i) * a.o_ss + col];
      }
#pragma unroll
      for (int u = 0; u < LB; ++u)
        if (base + u * NT < L * CB) Y[base + u * NT] = yv[u];
    }
    __syncthreads();
    if (tid < D) {
      float run = 0.f;
      for (int i = 1; i <= L; ++i) {
        run += cum[i * DP + tid];
        cum[i * DP + tid] = run;
      }
    }
    __syncthreads();
    // forward: k_j exp(tot - ci_j); backward: r_i exp(ce_i)
    for (int idx = tid; idx < L * D; idx += NT) {
      const int i = idx / D, m = idx % D;
      const float ex = fwd ? cum[L * DP + m] - cum[(i + 1) * DP + m]
                           : cum[i * DP + m];
      X[i * DP + m] *= exp2f(ex);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = tid + NT * q;
      if (e >= D * CB) continue;
      const int m = e / CB, col = e % CB;
      float s = st[q] * exp2f(cum[L * DP + m]);
      for (int i = 0; i < L; ++i) s = fmaf(X[i * DP + m], Y[i * CB + col], s);
      st[q] = s;
      if (fwd) outb[(int64_t)c * D * D + m * D + c0 + col] = s;
    }
  }
  if (!fwd && a.dstate0 != nullptr) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = tid + NT * q;
      if (e < D * CB)
        a.dstate0[(int64_t)bh * D * D + (e / CB) * D + c0 + e % CB] = st[q];
    }
  }
}

// --- 2. the per-chunk gradients -------------------------------------------

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

template <int D, typename T>
__global__ void __launch_bounds__(NT)
rwkv6_bwd_chunk_kernel(BwdArgs a) {
  using Tl = Tiles<D>;
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

template <int D, typename T>
int launch_bwd(const BwdArgs& a) {
  static unsigned states_set = 0, chunk_set = 0;
  const int nc = a.S / a.L;
  if (a.passes & (PASS_STATES | PASS_COTANGENTS)) {
    auto kern = rwkv6_bwd_states_kernel<D, T>;
    cudaError_t err = allow_smem(kern, (int)SMEM_LIMIT, states_set);
    if (err != cudaSuccess) return (int)err;
    const int both = (a.passes & 3) == 3;
    dim3 grid((D + CB - 1) / CB, a.B * a.H, both ? 2 : 1);
    kern<<<grid, NT, states_smem(D, a.L), a.stream>>>(
        a, (a.passes & PASS_STATES) ? 0 : 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (a.passes & PASS_CHUNKS) {
    auto kern = rwkv6_bwd_chunk_kernel<D, T>;
    cudaError_t err = allow_smem(kern, (int)SMEM_LIMIT, chunk_set);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3(nc, a.B * a.H), NT, chunk_smem(D, a.L), a.stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (a.passes & PASS_BONUS) {
    rwkv6_bwd_bonus_kernel<<<a.H, D, 0, a.stream>>>(
        a.dbonus_part, a.dbonus, a.B * nc, a.H, D);
    return (int)cudaGetLastError();
  }
  return 0;
}

template <typename T>
int dispatch(const BwdArgs& a, int D) {
  switch (D) {
    case 16: return launch_bwd<16, T>(a);
    case 32: return launch_bwd<32, T>(a);
    case 64: return launch_bwd<64, T>(a);
    case 128: return launch_bwd<128, T>(a);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, of r, k, v and of dr, dk, dv.  r, k,
// v, w (float32) and dout (float32) are [B, S, H, D] with the given
// strides (in elements; the last dimension has stride 1); dr, dk, dv, dw
// (float32) are written contiguous [B, S, H, D].  bonus [H, D], state0,
// dstate and dstate0 [B, H, D, D] are contiguous float32; state0 and
// dstate may be null (zeros), dstate0 null (not written).  states and
// dstates are [B, H, S / L, D, D] float32 scratch: the chunk-end states
// and cotangents; dbonus_part [B, S / L, H, D] float32 scratch; dbonus
// [H, D] float32.  passes: a mask of 1 (the states), 2 (the cotangents
// and dstate0), 4 (the per-chunk gradients, which read both) and 8 (the
// sum of dbonus, which reads the partials).  Requires S % L == 0,
// 1 <= L <= 64 and the chunk kernel's shared memory (chunk_smem) within
// the card's 227 KB.  Returns cudaGetLastError() after the launches (0 on
// success), -1 for arguments it does not take.  Launches on `stream`,
// does not synchronise, allocates nothing.
extern "C" int fate_rwkv6_scan_bwd(
    const void* r, const void* k, const void* v, const void* w,
    const void* bonus, const void* state0, const void* dout,
    const void* dstate, void* states, void* dstates, void* dr, void* dk,
    void* dv, void* dw, void* dbonus_part, void* dbonus, void* dstate0,
    int B, int S, int H, int D, int L,
    long long r_sb, long long r_ss, long long r_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long w_sb, long long w_ss, long long w_sh,
    long long o_sb, long long o_ss, long long o_sh, int dtype, int passes,
    void* stream) {
  if (B < 1 || H < 1 || S < 1 || L < 1 || L > 64 || S % L != 0) return -1;
  if (passes < 1 || passes > 15) return -1;
  if ((passes & PASS_CHUNKS) && chunk_smem(D, L) > SMEM_LIMIT) return -1;
  if ((passes & (PASS_STATES | PASS_CHUNKS)) && states == nullptr) return -1;
  if ((passes & (PASS_COTANGENTS | PASS_CHUNKS)) && dstates == nullptr)
    return -1;
  if ((passes & PASS_CHUNKS) &&
      (!dr || !dk || !dv || !dw || !dbonus_part || !bonus))
    return -1;
  if ((passes & PASS_BONUS) && (!dbonus_part || !dbonus)) return -1;
  BwdArgs a{r, k, v,
            static_cast<const float*>(w), static_cast<const float*>(bonus),
            static_cast<const float*>(state0), static_cast<const float*>(dout),
            static_cast<const float*>(dstate), static_cast<float*>(states),
            static_cast<float*>(dstates), dr, dk, dv, static_cast<float*>(dw),
            static_cast<float*>(dbonus_part), static_cast<float*>(dbonus),
            static_cast<float*>(dstate0), B, S, H, L,
            r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
            w_sb, w_ss, w_sh, o_sb, o_ss, o_sh, passes,
            static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch<float>(a, D);
  if (dtype == 1) return dispatch<bf16>(a, D);
  return -1;
}
