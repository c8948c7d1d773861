// K3's gradients for Hopper as one persistent, warp-specialised grouped
// GEMM: the input gradient dx[b, e] = dy[b, e] . w[e]^T and the weight
// gradient dw[e] = sum over b of x[b, e]^T . dy[b, e], float32 sums rounded
// to bf16 once, at the store.  Replaces no TPU kernel: the reference
// differentiates the einsums of src/repro/models/moe.py:104-109 (its Pallas
// grouped GEMM, src/repro/kernels/moe_gemm.py, has no backward).  It takes
// the place of the first design of both gradients (csrc/moe_gemm.cu with w
// read K-major, and csrc/moe_gemm_bwd.cu), which stays as the route of
// operands a tensor map cannot describe (kernels/moe_gemm.py :: grad_plan).
//
// What it computes.  x [B, E, C, D] (the forward's input: the MoE layer's
// dispatch view, or the hidden activations before the down projection), w
// [E, D, F], dy [B, E, C, F] (the gradient of the forward's output) ->
// dx [B, E, C, D] (layout DX) or dw [E, D, F] (layout DW).  Layout FWD is
// K3's forward, x [B, E, C, D] . w [E, D, F] -> [B, E, C, F], on the same
// mainloop: tools/kernel_probe.py moe-grad-phases times it for
// comparison; the port's forward stays on csrc/moe_gemm.cu.
//
// What bounds it on an NVIDIA H100 SXM (data-sheet rates, 700 W).  At
// granite-moe's training microbatch (B = 2, C = 1024, 40 experts, d_model
// 1536, d_expert 512) each call does 128.8 GFLOP (2 E B C D F); it moves
// 399 MB once (dX of the gate / up projection: dy 84 MB, w 63 MB, dx 252
// MB), about 323 flops per byte, above the card's bf16 ridge (295):
// operations bound all four shapes (0.130 ms at 989 TFLOP/s).
//
// The design.  One block per SM (the grid, min(tiles, SMs), is chosen in
// Python) walks output tiles t = blockIdx.x, + gridDim.x, ... in the order
// expert, row tile, column tile, so that at any time the card works on one
// or two experts and their B operand stays in L2.  A tile is 128 x 256:
// rows of dx (the (b, c) rows of one sample: a row tile never crosses a
// sample, rows past C are zero-filled by the loads and clipped by the
// store) or of dw (its D rows); columns along D (dX) or F (dW).  Depth
// goes in stages of 64 elements, one 128-byte swizzled line: the
// contraction F for dX, the (b, c) rows for dW, walked sample by sample in
// 64-row stages that never cross a sample (rows past C read as zeros and
// add exact zeros, so every output sums the same terms in increasing (b, c)
// order).  384 threads in three warpgroups:
//   - warpgroup 2, the producer, gives up its registers (setmaxnreg 40);
//     one thread issues the TMA loads (cp.async.bulk.tensor, 4-d tensor
//     maps over the operands as they lie, the dispatch view's strides
//     included, 128-byte swizzle) of every stage of every tile into a ring
//     of 4 stages, each with a full and an empty mbarrier.  The ring's
//     index and phase run on across tiles, so the next tile's first stages
//     load while the consumers store the last one.
//   - warpgroups 0 and 1, the consumers (setmaxnreg 232), own 64 rows of
//     the tile each and issue wgmma.mma_async m64n256k16 (128 float32
//     accumulators a thread) on the stages that have arrived, one group in
//     flight while the next stage is awaited; each warp releases a stage
//     once its products have read it.  Then each rounds its 64 x 256 rows
//     to bf16 once, stages them with stmatrix in 64-column pieces in the
//     store's swizzle (two 8 KB buffers a warpgroup) and one thread writes
//     each piece with a TMA store (cp.async.bulk.tensor, clipped at the
//     tensor's edges), waiting for a buffer's store to have read it before
//     the buffer is written again.
// Operands: dX: A = dy, K-major (F contiguous), boxes of 64 x 128 rows;
// B = w[e] as it lies, [D, F] with F contiguous, K-major too (transpose bit
// clear), boxes of 64 x 256 lines.  dW: A = x^T through the transpose bit
// (D contiguous), two 64 x 64 boxes; B = dy, MN-major (F contiguous), four
// 64 x 64 boxes.  FWD: A as dX's (x), B = w MN-major as dW's B.
//
// Shared memory: 4 stages x (16 KB of A + 32 KB of B) = 192 KB, 32 KB of
// store buffers, 64 bytes of barriers, 1 KB of alignment slack: 230,464 of
// the 232,448 bytes a block may have.
//
// Tiles at granite's training shapes, against 132 SMs:
//   dX gate / up (dy [2,40,1024,512], w [40,1536,512]): 16 row tiles x 6
//     column tiles x 40 = 3,840 tiles, 29.1 waves, 8 stages each;
//   dX down (dy [2,40,1024,1536], w [40,512,1536]): 16 x 2 x 40 = 1,280,
//     9.7 waves, 24 stages;
//   dW gate / up (x [2,40,1024,1536], dy [2,40,1024,512]): 12 x 2 x 40 =
//     960, 7.3 waves, 32 stages;
//   dW down (x [2,40,1024,512], dy [2,40,1024,1536]): 4 x 6 x 40 = 960,
//     7.3 waves, 32 stages.
//
// Guarantees: no split over the contraction and no atomic (nothing here
// adds into device memory), so two calls give the same bits; nothing is
// allocated; the entry returns cudaGetLastError().
//
// Measured (an H100 80GB HBM3 at its 700 W limit, tools/kernel_probe.py
// moe-grad-phases): 0.187-0.205 ms a call at the four shapes, the batched
// torch.matmul's time within 8 %, against 0.32-0.50 ms for the first
// design.  Under this kernel and the library alike the card holds its SM
// clock at 1.35-1.5 GHz at about 690 W, where the tensor cores' rate is
// about 0.17 ms for these 128.8 GFLOP.  Storing the accumulators straight
// from registers, unstaged, took 0.03-0.16 ms more a call.  Left undone:
// the gate and up projections' gradients in one call, TMA multicast of
// the shared operand across a cluster, and an epilogue that overlaps the
// other warpgroup's products.
#include <cuda.h>   // CUtensorMap (types only: the encoder is fetched at run time)

#include "common.cuh"

namespace {

using namespace fate;
using bf16 = __nv_bfloat16;

constexpr int DX = 0, DW = 1, FWD = 2;   // the layouts

constexpr int BM = 128;        // output rows per tile: two consumers of 64
constexpr int BN = 256;        // output columns per tile: the wgmma's N
constexpr int BK = 64;         // depth per stage: one 128-byte line
constexpr int STAGES = 4;      // the ring
constexpr int EPI_BUFS = 2;    // 64 x 64 store buffers per consumer warpgroup
constexpr int THREADS = 384;   // two consumer warpgroups, one producer
constexpr int CONSUMER_WARPS = 8;
constexpr int BLOCK64 = 64 * 64 * 2;           // 64 lines of 64 elements
constexpr int A_BYTES = BM * BK * 2;           // 16 KB
constexpr int B_BYTES = BN * BK * 2;           // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int EPI_OFF = STAGES * STAGE_BYTES;  // store buffers
constexpr int BAR_OFF = EPI_OFF + 2 * EPI_BUFS * BLOCK64;  // full, empty
constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;   // + alignment slack
static_assert(SMEM <= 232448, "shared memory of one block");

// The walk and its extents, derived by the launcher (and checked against
// the plan Python computed).
struct Walk {
  int tiles;        // E * row_tiles * col_tiles
  int per_expert;   // row_tiles * col_tiles
  int col_tiles;
  int c_tiles;      // DX / FWD: row tiles per sample; DW: stages per sample
  int k_stages;     // depth stages per tile
  int rows;         // extent of the output's row dim: C (DX / FWD) or D
  int cols;         // extent of the output's column dim
};

struct Tile {
  int e, b, row0, n0;   // expert, sample (DX / FWD), first row, first column
};

template <int L>
__device__ __forceinline__ Tile tile_of(const Walk& w, int t) {
  Tile x;
  x.e = t / w.per_expert;
  const int r = t - x.e * w.per_expert;
  const int rt = r / w.col_tiles;
  x.n0 = (r - rt * w.col_tiles) * BN;
  if (L == DW) {
    x.b = 0;
    x.row0 = rt * BM;
  } else {
    x.b = rt / w.c_tiles;
    x.row0 = (rt - x.b * w.c_tiles) * BM;
  }
  return x;
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// A box of shared memory into a 4-d tensor map's tensor (coordinates
// innermost first), as one bulk group of this thread; elements outside the
// tensor are not written.
__device__ __forceinline__ void tma_store_4d(const void* map, uint32_t src,
                                             int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(map),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from registers (the mma fragment layout: lane l
// holds row l / 4, columns 2 (l % 4) and + 1 of each) to the rows whose
// addresses lanes 8 i .. 8 i + 7 give for matrix i.
__device__ __forceinline__ void stsm_x4(uint32_t addr, uint32_t r0,
                                        uint32_t r1, uint32_t r2,
                                        uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(addr),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

// d[64 x 256] += A[64 x 16] . B[16 x 256], both from shared memory,
// float32 accumulators; TA / TB the transpose bits (1 = MN-major).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// The producer's copies of depth stage k of tile x into the stage at sa
// (A) and sb = sa + A_BYTES (B), completing on `full`.  Each box is 64
// elements (128 bytes) wide; 64-line boxes lie BLOCK64 apart.
template <int L>
__device__ __forceinline__ void load_stage(uint32_t sa, uint64_t* full,
                                           const CUtensorMap* ta,
                                           const CUtensorMap* tb,
                                           const Walk& w, const Tile& x,
                                           int k) {
  const uint32_t sb = sa + A_BYTES;
  if (L == DW) {
    // the (b, c) rows of stage k: sample kb, slots kc .. kc + 63
    const int kb = k / w.c_tiles;
    const int kc = (k - kb * w.c_tiles) * BK;
#pragma unroll
    for (int j = 0; j < BM / 64; ++j)
      tma_load_4d(sa + j * BLOCK64, ta, full, x.row0 + 64 * j, kc, x.e, kb);
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      tma_load_4d(sb + j * BLOCK64, tb, full, x.n0 + 64 * j, kc, x.e, kb);
  } else {
    // A: 128 rows of sample b from row0, depth k * 64 ..
    tma_load_4d(sa, ta, full, k * BK, x.row0, x.e, x.b);
    if (L == DX) {
      // w[e] rows n0 .. n0 + 255 (the output columns d), depth along F
      tma_load_4d(sb, tb, full, k * BK, x.n0, x.e, 0);
    } else {
#pragma unroll
      for (int j = 0; j < BN / 64; ++j)
        tma_load_4d(sb + j * BLOCK64, tb, full, x.n0 + 64 * j, k * BK, x.e,
                    0);
    }
  }
}

// One stage's products for the consumer warpgroup cw (its 64 rows).
// K-major: 64 lines of 64 depth elements, 8-line groups 1024 bytes apart,
// a k16 step 32 bytes along the line.  MN-major: lines of 64 rows or
// columns, 64-wide blocks BLOCK64 apart, a k16 step 16 lines (2048 bytes).
template <int L>
__device__ __forceinline__ void mma_stage(float (&acc)[128], uint32_t sa,
                                          int cw) {
  const uint32_t sb = sa + A_BYTES;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    if (L == DX) {
      wgmma_m64n256k16<0, 0>(acc, sw128_desc(sa + cw * BLOCK64 + kk * 32, 16,
                                             1024),
                             sw128_desc(sb + kk * 32, 16, 1024));
    } else if (L == FWD) {
      wgmma_m64n256k16<0, 1>(acc, sw128_desc(sa + cw * BLOCK64 + kk * 32, 16,
                                             1024),
                             sw128_desc(sb + kk * 2048, BLOCK64, 1024));
    } else {
      wgmma_m64n256k16<1, 1>(
          acc, sw128_desc(sa + cw * BLOCK64 + kk * 2048, BLOCK64, 1024),
          sw128_desc(sb + kk * 2048, BLOCK64, 1024));
    }
  }
}

// The consumer warpgroup cw's 64 rows of tile x, rounded to bf16, through
// its two store buffers (8 KB each at `bufs`) in 64-column pieces; `n_st`
// counts the pieces it has stored (which buffer is next).  Accumulator
// layout of m64nNk16: thread (warp w, lane l) holds rows 16 w + l / 4 (+ 8)
// and columns 8 j + 2 (l % 4) (+ 1) of every 8-column group j, as
// acc[4 j + 2 half + (0, 1)].
template <int L>
__device__ __forceinline__ void store_tile(const float (&acc)[128],
                                           const CUtensorMap* tout,
                                           uint32_t bufs, const Walk& w,
                                           const Tile& x, int cw, int warp,
                                           int lane, int& n_st) {
  const int row0 = x.row0 + 64 * cw;
  if (row0 >= w.rows) return;          // all of this warpgroup's rows clip
  const bool leader = (warp | lane) == 0;
  // lane l gives the address of row l % 8 of matrix l / 8: (half, group)
  // = (l / 8 % 2, l / 16) of the pair of 8-column groups each stmatrix takes
  const int i = lane & 7;
  const int line = 16 * warp + 8 * ((lane >> 3) & 1) + i;
  const int g1 = lane >> 4;
#pragma unroll
  for (int q = 0; q < BN / 64; ++q) {
    if (x.n0 + 64 * q >= w.cols) break;   // this piece and the next clip
    const uint32_t buf = bufs + (n_st % EPI_BUFS) * BLOCK64;
    if (leader) bulk_wait_read<EPI_BUFS - 1>();   // its last store read it
    bar_sync(1 + cw, 128);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int j = 8 * q + 2 * p;        // groups j, j + 1 of the tile
      const int gl = 2 * p + g1;          // this lane's group in the piece
      stsm_x4(buf + line * 128 + ((gl ^ i) << 4),
              pack_bf16(acc[4 * j], acc[4 * j + 1]),
              pack_bf16(acc[4 * j + 2], acc[4 * j + 3]),
              pack_bf16(acc[4 * j + 4], acc[4 * j + 5]),
              pack_bf16(acc[4 * j + 6], acc[4 * j + 7]));
    }
    fence_proxy_async();                  // visible to the bulk store
    bar_sync(1 + cw, 128);
    if (leader) {
      if (L == DW)
        tma_store_4d(tout, buf, x.n0 + 64 * q, row0, x.e, 0);
      else
        tma_store_4d(tout, buf, x.n0 + 64 * q, row0, x.e, x.b);
    }
    ++n_st;
  }
}

template <int L>
__global__ void __launch_bounds__(THREADS, 1)
moe_grad_tma_kernel(const __grid_constant__ CUtensorMap ta,
                    const __grid_constant__ CUtensorMap tb,
                    const __grid_constant__ CUtensorMap tout, const Walk w) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // the swizzle atom's size
  uint8_t* sm = smem_raw + (base - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + BAR_OFF);
  uint64_t* empty = full + STAGES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x >> 5) & 3, 0);
  const int lane = threadIdx.x & 31;

  if (wg == 2) {
    // the producer: one thread issues every load of the block's tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 0 && lane == 0) {
      int stage = 0, phase = 0;
      for (int t = blockIdx.x; t < w.tiles; t += gridDim.x) {
        const Tile x = tile_of<L>(w, t);
        for (int k = 0; k < w.k_stages; ++k) {
          mbar_wait(&empty[stage], phase ^ 1);   // the consumers freed it
          mbar_expect_tx(&full[stage], STAGE_BYTES);
          load_stage<L>(base + stage * STAGE_BYTES, &full[stage], &ta, &tb,
                        w, x, k);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // the consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of a tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const uint32_t bufs = base + EPI_OFF + wg * EPI_BUFS * BLOCK64;
    int stage = 0, phase = 0, n_st = 0;
    float acc[128];
    for (int t = blockIdx.x; t < w.tiles; t += gridDim.x) {
      const Tile x = tile_of<L>(w, t);
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      int held = -1;                 // the stage the group in flight reads
      for (int k = 0; k < w.k_stages; ++k) {
        mbar_wait(&full[stage], phase);
        wgmma_fence();
        mma_stage<L>(acc, base + stage * STAGE_BYTES, wg);
        wgmma_commit();
        wgmma_wait<1>();             // the previous stage's products are done
        if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
        held = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(&empty[held]);
      store_tile<L>(acc, &tout, bufs, w, x, wg, warp, lane, n_st);
    }
    if ((warp | lane) == 0) bulk_wait_all();   // every store has landed
  }
}

// cuTensorMapEncodeTiled, from the driver at run time (the library links
// only the runtime)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map of a bf16 tensor with sizes `dims` (innermost first, unit stride
// there) and element strides `st` of dims 1-3, read or written in boxes of
// 64 x `rows` elements in the 128-byte swizzle; elements outside it read as
// zeros.  A dim of size 1 never moves the address: its stride is replaced
// by a packed one (the map wants every stride a multiple of 16 bytes).
bool bf16_map(CUtensorMap* map, const void* ptr, const int64_t dims[4],
              const int64_t st[3], int rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  cuuint64_t gd[4], gs[3];
  for (int i = 0; i < 4; ++i) gd[i] = (cuuint64_t)dims[i];
  for (int i = 0; i < 3; ++i) {
    const cuuint64_t packed = i == 0 ? (gd[0] * 2 + 15) / 16 * 16
                                     : gs[i - 1] * gd[i];
    gs[i] = gd[i + 1] == 1 ? packed : (cuuint64_t)st[i] * 2;
  }
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), gd, gs, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct GradLaunch {
  const void* a;
  const void* b;
  void* out;
  int B, E, C, D, F;
  int64_t a_sb, a_se, a_sc, b_sb, b_se, b_sc;
  int grid;
  Walk w;
  cudaStream_t stream;
};

// The three maps of layout L: A, B and the output (contiguous).
template <int L>
bool grad_maps(const GradLaunch& a, CUtensorMap* ta, CUtensorMap* tb,
               CUtensorMap* to) {
  const int64_t sa[3] = {a.a_sc, a.a_se, a.a_sb};
  const int64_t sb[3] = {a.b_sc, a.b_se, a.b_sb};
  if (L == DW) {
    const int64_t xd[4] = {a.D, a.C, a.E, a.B}, yd[4] = {a.F, a.C, a.E, a.B};
    const int64_t od[4] = {a.F, a.D, a.E, 1};
    const int64_t os[3] = {a.F, (int64_t)a.D * a.F, 0};
    return bf16_map(ta, a.a, xd, sa, 64) && bf16_map(tb, a.b, yd, sb, 64) &&
           bf16_map(to, a.out, od, os, 64);
  }
  // DX: A = dy (F wide), B = w [E, D, F] (rows d), out [B, E, C, D];
  // FWD: A = x (D wide), B = w (rows along D), out [B, E, C, F]
  const int64_t ak = L == DX ? a.F : a.D, n = L == DX ? a.D : a.F;
  const int64_t ad[4] = {ak, a.C, a.E, a.B};
  const int64_t wd[4] = {a.F, a.D, a.E, 1};
  const int64_t od[4] = {n, a.C, a.E, a.B};
  const int64_t os[3] = {n, (int64_t)a.C * n, (int64_t)a.E * a.C * n};
  return bf16_map(ta, a.a, ad, sa, BM) &&
         bf16_map(tb, a.b, wd, sb, L == DX ? BN : 64) &&
         bf16_map(to, a.out, od, os, 64);
}

template <int L>
int launch_grad(const GradLaunch& a) {
  static unsigned smem_set = 0;
  auto kern = moe_grad_tma_kernel<L>;
  cudaError_t err = allow_smem(kern, SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap ta, tb, to;
  if (!grad_maps<L>(a, &ta, &tb, &to)) return -1;
  kern<<<a.grid, THREADS, SMEM, a.stream>>>(ta, tb, to, a.w);
  return (int)cudaGetLastError();
}

int cdiv(int64_t n, int d) { return (int)((n + d - 1) / d); }

}  // namespace

// layout: 0 = dX (a = dy [B, E, C, F], b = w [E, D, F] -> out [B, E, C,
// D]), 1 = dW (a = x [B, E, C, D], b = dy [B, E, C, F] -> out [E, D, F]),
// 2 = K3's forward (a = x, b = w -> out [B, E, C, F]).  Strides are in
// elements, those of a's and b's (sample, expert, slot) dims (for w: 0,
// expert, row); each operand's last dim has unit stride, every other a
// whole 16 bytes unless its size is 1, D and F are multiples of 8, the
// bases 16-byte aligned, out contiguous (kernels/moe_gemm.py :: grad_plan
// sends anything else to the first design).  grid: blocks of the
// persistent walk (1 .. tiles); row_tiles, col_tiles, k_stages: the plan's
// counts, refused with -1 unless they are this file's.  Returns
// cudaGetLastError() after the launch (0 on success), -1 for arguments it
// does not take.  Launches on `stream`, does not synchronise, allocates
// nothing.
extern "C" int fate_moe_gemm_grad(const void* a_ptr, const void* b_ptr,
                                  void* out,
                                  int B, int E, int C, int D, int F,
                                  long long a_sb, long long a_se,
                                  long long a_sc, long long b_sb,
                                  long long b_se, long long b_sc, int layout,
                                  int grid, int row_tiles, int col_tiles,
                                  int k_stages, void* stream) {
  if (B < 1 || E < 1 || C < 1 || D < 1 || F < 1 || D % 8 || F % 8 ||
      layout < DX || layout > FWD || grid < 1)
    return -1;
  const int64_t rows = layout == DW ? D : C;
  const int64_t cols = layout == DX ? D : F;
  const int c_tiles = layout == DW ? cdiv(C, BK) : cdiv(C, BM);
  Walk w;
  w.col_tiles = cdiv(cols, BN);
  const int64_t rt = layout == DW ? cdiv(D, BM) : (int64_t)B * c_tiles;
  const int64_t kt = layout == DW ? (int64_t)B * c_tiles
                                  : cdiv(layout == DX ? F : D, BK);
  const int64_t tiles = (int64_t)E * rt * w.col_tiles;
  if (rt != row_tiles || w.col_tiles != col_tiles || kt != k_stages ||
      tiles >= (1ll << 31) || grid > tiles)
    return -1;
  w.tiles = (int)tiles;
  w.per_expert = (int)rt * w.col_tiles;
  w.c_tiles = c_tiles;
  w.k_stages = (int)kt;
  w.rows = (int)rows;
  w.cols = (int)cols;
  const GradLaunch a{a_ptr, b_ptr, out, B, E, C, D, F, a_sb, a_se, a_sc,
                     b_sb, b_se, b_sc, grid, w,
                     static_cast<cudaStream_t>(stream)};
  if (layout == DX) return launch_grad<DX>(a);
  if (layout == DW) return launch_grad<DW>(a);
  return launch_grad<FWD>(a);
}
