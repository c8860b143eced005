// B7: fused softmax cross-entropy over the vocabulary projection, forward and
// backward, with the (N, V) logits never written to device memory.
//
// Replaces neuralmonkey_tpu/ops/fused_xent.py `_fwd_kernel` (called by
// `_fwd_pallas`), `_bwd_dx_kernel` and `_bwd_dw_kernel` (called by
// `_bwd_pallas`). With logits t = x W + b for x (N, D), W (D, V), or the tied
// table W^T (V, D) when `transposed`, and targets y (N):
//   forward:   lse = logsumexp_v t, lab = t[y], lsum = sum_v t, and
//              nll = -(lab - lse), or with label smoothing eps
//              nll = -((1 - eps) (lab - lse) + eps (lsum / V - lse))
//              (`_nll_from_parts`);
//   backward:  dl = g (softmax(t) - (1 - eps) onehot(y) - eps / V), folded into
//              dx = dl W^T, dW = x^T dl, db = sum_n dl, recomputing t.
// Columns past V (a vocabulary that is not a multiple of the 128-column tile)
// are masked out of every sum rather than padded.
//
// What bounds it on the H100: the products (2 N D V flops per logit pass: 94
// GFLOP at N = 3072, D = 512, V = 30000), not bytes; the inputs are 3 + 61 MB.
// The TPU ran one sequential grid with the online log-sum-exp carried in
// scratch; Hopper blocks run in no order, so:
//   - xent_fwd: one block per (128-row, 128-column) tile computes the logit tile
//     on the tensor cores in 3xTF32 with K3's routine (tc::tile_product, see
//     below; two blocks an SM) and writes per-row partials over the columns
//     below V (tile max, sum of exp(t - max), label logit, logit sum), the
//     four column warps meeting in shared memory in a fixed order, into (N, R)
//     scratch; a second small kernel folds the R partials of each row into lse
//     and nll (K3's pattern). Row tiles run in blockIdx.x, so the blocks that
//     share a W tile run together and W (61 MB, more than the 50 MB L2)
//     leaves device memory about once. The first design computed the tile on
//     the SIMT units, and was slower than the plain version's cuBLAS product.
//   - xent_bwd_dx: a block owns a 128-row tile and every column of D, and walks
//     a contiguous chunk of the vocabulary tiles. For each vocabulary tile it
//     computes the logit tile once, turns it into dl and keeps dl in shared
//     memory (tc::dl_tile); for every two tiles it adds dl W^T to its
//     partial dx 128 columns of D at a time, each 128 x 128 sum in the
//     warps' registers, added into the block's own rows of an (S, N, D)
//     scratch (the chunk's first pair writes, the later ones add). So each logit tile is computed
//     once, where the first design recomputed it once per 128 columns of D.
//     Both products run on the tensor cores, mma.sync m16n8k8 in TF32 with
//     each float32 operand split in two TF32 parts and three products kept
//     (3xTF32), which holds float32 accuracy; operands arrive by cp.async in
//     double-buffered 32-deep stages (tc_product.cuh, shared with K3). The
//     vocabulary is cut into S chunks so that the grid, (row tiles, S), is
//     two blocks for each SM (the plan:
//     ops/fused_xent.py `dx_plan`); a second small kernel sums the S partials
//     of each entry in the fixed order 0 .. S-1 (with S = 1 the blocks write
//     dx itself). No atomics: dx does not change from run to run.
//   - xent_bwd_dw: the same with the roles of rows and vocabulary swapped. A
//     block owns a 128-column vocabulary tile and every row of D, and walks
//     a contiguous chunk of the row tiles. For each row tile it computes the
//     logit tile once and keeps dl in shared memory (tc::dl_tile, the same
//     routine as dx's, with the dl rows of two row tiles one above the other:
//     the B operand of x^T dl and the rows of db); for every two tiles it adds
//     x^T dl to its partial dW 128 rows of D at a time, each 128 x 128 sum in
//     the warps' registers (3xTF32 mma.sync, x^T staged by cp.async as
//     [m][d] and read k-major), added into the block's own columns of dW, or
//     of an (S, dW) scratch when the rows are cut into S chunks (the plan:
//     ops/fused_xent.py `dw_plan`; a fold sums the S planes in the order
//     0 .. S-1). db sums the block's columns of dl in one fixed row order. So
//     each logit tile is computed once, where the first design recomputed it
//     once per 128 rows of D on the CUDA cores; no atomics: dW and db do not
//     change from run to run.
// The bf16-W instances (the bf16 compute policy, where the JAX package widens
// the bf16 use-site table beside float32 states and runs its float32
// kernels) compute the same function with W read as bf16, half its bytes.
// x, dx, dW (rounded to bf16 by the wrapper) and db stay float32.
//   - the widened instances (nm_xent_fwd_bf16w_widened and
//     nm_xent_bwd_{dx,dw}_bf16w_widened, kept for a W whose bf16 rows do not
//     start on 16-byte boundaries: D % 8 != 0 tied, V % 8 != 0 untied; the
//     wrapper's shape gate, ops/fused_xent.py `wgmma_takes`): the float32
//     designs above with each W tile widened as it is staged
//     (tc::load_widen, plain loads) and two TF32 passes for a product with W.
//   - nm_xent_fwd_bf16w: the logit tiles of the backward below, with the
//     forward's partials in their epilogue. A block owns 128 rows (a
//     product warpgroup 64, as 64 x 256 float32 sums) and walks a chunk of
//     256-column vocabulary tiles, each tile over D in 32-deep stages of x's
//     three parts (128 x 32) and W (256 x 32) through a 5-stage TMA ring;
//     x W in three bf16 passes. With no dl W^T stage, a block has the
//     registers for 128 rows and 256 columns, so each W tile is read by 24
//     row blocks at the smoke's N, and each stage's 40 KB feed 6.3 MFLOP,
//     twice what a stage of the dx kernel's 64 x 128 logit tile feeds: half
//     the L2 traffic a flop. Each thread keeps the running max,
//     rescaled sum, label logit and logit sum of its two rows over its
//     columns; the four lanes of a row meet once, at the end, and write one
//     partial per (row, chunk), folded by xent_fold_kernel. The chunks: the
//     plan (ops/fused_xent.py `wgmma_fwd_plan`) takes the fewest that give
//     the shortest walk in waves of one block an SM; no atomics, so the
//     forward does not change from run to run.
//   - nm_xent_bwd_dx_bf16w and nm_xent_bwd_dw_bf16w: products on Hopper's
//     warpgroup instructions (wgmma_xent.cuh). W reaches shared memory as
//     bf16, as it lies, by TMA copies into a ring of stages (4 for dx, 6 for
//     dW) shared with x's bf16 parts (a first small kernel splits x into
//     three bf16 planes, exactly). A block is three warpgroups: two run the
//     products, reading both operands from shared memory (wgmma.mma_async,
//     float32 sums in registers), and one thread of the third issues the
//     copies, a stage's "full" mbarrier telling the products it has landed
//     and its "empty" one telling the copier the products are done with it.
//     x W and dl W^T take three bf16 passes each (0.75 of two TF32 passes'
//     time), x^T dl six (three TF32 passes' time); each stage's products
//     run while the next one's are issued, one group behind.
//       dx: a block owns 64 rows and 512 columns of D (a warpgroup each 256,
//       64 x 256 sums in registers for the whole walk) and walks a chunk of
//       128-column vocabulary tiles. For each: the logit tile, each
//       warpgroup 64 of its columns (64 x 64 sums), over D in 64-deep
//       stages; dl, split in three bf16 parts, into shared memory; then dl
//       W^T over the tile's 128 vocabulary rows in 32-row stages of W (32 x
//       512). The chunk's partial goes to the block's rows of an (S, N, D)
//       scratch (dx itself when S = 1), folded in the order 0 .. S-1.
//       dW: a block owns 64 vocabulary columns and 512 rows of D (a
//       warpgroup each 256: dW^T's 64 x 256 sums in registers) and walks a
//       chunk of 128-row tiles: the logit tile, each warpgroup 64 of its
//       rows, over D in 32-deep stages; dl's parts into shared memory, and
//       db's column sums in registers; then dl^T x over the tile's rows, a
//       stage one 16-row slice of one of x's parts (16 x 512). Partials of
//       S chunks go to an (S, dW) scratch and are folded as dx's.
//     Either kernel computes each logit tile once for each 512 columns of D
//     (once at D <= 512); no atomics, so dx, dW and db do not change from
//     run to run.
#include <algorithm>

#include "tc_product.cuh"
#include "tma.cuh"
#include "wgmma_xent.cuh"

namespace {

// one warp per row: fold the R partials into lse and nll
__global__ void xent_fold_kernel(const float* __restrict__ pmax, const float* __restrict__ psum,
                                 const float* __restrict__ plab,
                                 const float* __restrict__ plsum, float* __restrict__ lse,
                                 float* __restrict__ nll, int N, int R, int V, float eps) {
  const int n = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (n >= N) return;
  const size_t row = static_cast<size_t>(n) * R;
  float mx = -INFINITY;
  for (int r = lane; r < R; r += 32) mx = fmaxf(mx, pmax[row + r]);
  mx = nm::warp_max(mx);
  float s = 0.f, lab = 0.f, ls = 0.f;
  for (int r = lane; r < R; r += 32) {
    s += psum[row + r] * expf(pmax[row + r] - mx);
    lab += plab[row + r];
    ls += plsum[row + r];
  }
  s = nm::warp_sum(s);
  lab = nm::warp_sum(lab);
  ls = nm::warp_sum(ls);
  if (lane == 0) {
    const float l = mx + logf(s);
    lse[n] = l;
    nll[n] = eps != 0.f ? -((1.0f - eps) * (lab - l) + eps * (ls / V - l)) : -(lab - l);
  }
}

// ---------------------------------------------------------------------------
// The backward on the tensor cores: 3xTF32 mma.sync products (tc_product.cuh).
namespace tc {

using namespace nm::tc;

// the forward: the two operand stages of tile_product; the epilogue's per-row
// partials reuse the first of them
constexpr size_t kFwdSmem = sizeof(float) * 2 * kStage;
constexpr int kPair = 2;         // vocabulary tiles whose dl is added in one pass
constexpr int kLdDl = kPair * kN + 4;  // dx: dl[m][v] of both tiles side by side
constexpr size_t kSmem = sizeof(float) * (2 * kStage + kM * kLdDl);
// dW: dl[m][v] of two row tiles, one above the other; a row stride of 8 mod
// 32 puts the B operand's [k][n] reads in distinct banks
constexpr int kLdDlW = kN + 8;
constexpr size_t kSmemW = sizeof(float) * (2 * kStage + kPair * kM * kLdDlW);

// The dl step of the backward: the logit tile t = x W (rows m0.., vocabulary
// columns n0..) computed once on the tensor cores over depth D (tile_product),
// turned into dl = g (softmax - (1 - eps) onehot - eps / V)
// (zero outside N x V) and stored as dls[m][v] (row stride kLd): the A
// operand of dl W^T for dx, and the B operand of x^T dl for dW. `stages` is
// free on return; `dls` is complete after the caller's next __syncthreads().
template <bool kWT, int kLd = kLdDl, typename TW = float>
__device__ __forceinline__ void dl_tile(const float* __restrict__ x, const TW* __restrict__ w,
                                        const float* __restrict__ bias,
                                        const int* __restrict__ targets,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ g, int N, int D, int V, int m0,
                                        int n0, float eps, bool vec, float* stages, float* dls) {
  float acc[4][4][4] = {};
  tile_product<kWT, TW>(x, w, N, D, V, m0, n0, vec, stages, acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4 * 64, wn = warp % 4 * 32;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wm + mi * 16 + lane / 4 + 8 * h, gm = m0 + row;
      const bool row_ok = gm < N;
      const int target = row_ok ? targets[gm] : -1;
      const float l = row_ok ? lse[gm] : 0.f;
      const float gr = row_ok ? g[gm] : 0.f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = wn + ni * 8 + 2 * (lane % 4) + j, gn = n0 + col;
          float d = 0.f;
          if (row_ok && gn < V) {
            d = expf(acc[mi][ni][2 * h + j] + bias[gn] - l) - (gn == target ? 1.0f - eps : 0.f);
            if (eps != 0.f) d -= eps / V;
            d *= gr;
          }
          dls[row * kLd + col] = d;
        }
    }
}

// The partial dx of rows m0 .. m0 + 128 over vocabulary tiles t0 .. t1, every
// column of D, into `part` (N, D): each logit tile computed once (dl_tile),
// two tiles' dl side by side, then dl W^T over both added to the block's
// own rows of `part`, 128 columns of D at a time, each 128 x 128 sum in the
// warps' registers, started at 0 by the chunk's first pair and from the
// partial (loaded before the products) by the later ones: one read and one
// write of the partial for every two tiles
template <bool kWT, typename TW>
__device__ __forceinline__ void xent_bwd_dx(const float* __restrict__ x,
                                            const TW* __restrict__ w,
                                            const float* __restrict__ bias,
                                            const int* __restrict__ targets,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ g,
                                            float* __restrict__ part, int N, int D, int V,
                                            int t0, int t1, float eps, bool vec, float* smem) {
  float* stages = smem;
  float* dls = smem + 2 * kStage;
  const int m0 = blockIdx.x * kM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4 * 64, wn = warp % 4 * 32;
  const int passes = (D + kN - 1) / kN;
  // stage s of pass chunk i: W(d0 .., n0 + v0 ..) as B = W^T, [n = d][k = v]
  // from W (D, V), or [k = v][n = d] from the tied W^T (V, D)
  auto stage_in = [&](int s, int i, int n0, int vchunks) {
    const int d0 = (i / vchunks) * kN, v0 = n0 + (i % vchunks) * kKC;
    float* st = stages + s * kStage;
    if (kWT)
      load_w(st, kLdN, w + static_cast<size_t>(v0) * D + d0, D, kKC, kN, V - v0, D - d0, vec);
    else
      load_w(st, kLdK, w + static_cast<size_t>(d0) * V + v0, V, kN, kKC, D - d0, V - v0, vec);
  };
  for (int tile = t0; tile < t1; tile += kPair) {
    const int n0 = tile * kN, pair = min(kPair, t1 - tile);
    for (int h = 0; h < pair; ++h)
      dl_tile<kWT, kLdDl, TW>(x, w, bias, targets, lse, g, N, D, V, m0, n0 + h * kN, eps, vec,
                              stages, dls + h * kN);
    const int vchunks = pair * (kN / kKC);
    const int chunks = passes * vchunks;
    stage_in(0, 0, n0, vchunks);
    float out[4][4][4];
    for (int i = 0; i < chunks; ++i) {
      const int d0 = (i / vchunks) * kN, v0 = (i % vchunks) * kKC;
      if (v0 == 0) {
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int gm = m0 + wm + mi * 16 + lane / 4 + 8 * (e / 2);
              const int gd = d0 + wn + ni * 8 + 2 * (lane % 4) + e % 2;
              out[mi][ni][e] = (tile == t0 || gm >= N || gd >= D)
                                   ? 0.f
                                   : part[static_cast<size_t>(gm) * D + gd];
            }
      }
      if (i + 1 < chunks) {
        stage_in((i + 1) & 1, i + 1, n0, vchunks);
        nm::cp_async_wait<1>();
      } else {
        nm::cp_async_wait<0>();
      }
      __syncthreads();  // the stage, and at i = 0 dl, complete
      warp_product<!kWT, false, kLdN, !std::is_same<TW, float>::value>(
          dls + v0, kLdDl, stages + (i & 1) * kStage, kKC, out);
      __syncthreads();
      if (v0 + kKC == pair * kN) {
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int gm = m0 + wm + mi * 16 + lane / 4 + 8 * (e / 2);
              const int gd = d0 + wn + ni * 8 + 2 * (lane % 4) + e % 2;
              if (gm < N && gd < D) part[static_cast<size_t>(gm) * D + gd] = out[mi][ni][e];
            }
      }
    }
  }
}

// The partial dW of vocabulary columns n0 .. n0 + 128 over row tiles t0 ..
// t1, every row of D, into `part` (dW's layout), and the same columns of db
// into `pdb`: each logit tile computed once (dl_tile), two row tiles' dl one
// above the other, then x^T dl over both added to the block's own columns of
// `part`, 128 rows of D at a time, each 128 x 128 sum in the warps'
// registers, started at 0 by the chunk's first pair and from the partial
// (loaded before the products) by the later ones: one read and one write of
// the partial for every two tiles. db sums the block's columns of dl in one
// fixed row order.
template <bool kWT, typename TW>
__device__ __forceinline__ void xent_bwd_dw(const float* __restrict__ x,
                                            const TW* __restrict__ w,
                                            const float* __restrict__ bias,
                                            const int* __restrict__ targets,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ g,
                                            float* __restrict__ part, float* __restrict__ pdb,
                                            int N, int D, int V, int t0, int t1, float eps,
                                            bool vec, float* smem) {
  float* stages = smem;
  float* dls = smem + 2 * kStage;
  const int n0 = blockIdx.x * kN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4 * 64, wn = warp % 4 * 32;
  const int passes = (D + kM - 1) / kM;
  // db: thread (half, col) sums column col of the pair's tile `half`
  const int col = threadIdx.x % kN, half = threadIdx.x / kN;
  float bsum = 0.f;
  // stage s of pass chunk i: x(m0 + k0 .., d0 ..) as A = x^T, [k = m][m = d]
  auto stage_in = [&](int s, int i, int m0, int mchunks) {
    const int d0 = (i / mchunks) * kM, k0 = m0 + (i % mchunks) * kKC;
    // rows past N are zero-filled; their source stays inside x
    load(stages + s * kStage, kLdN, k0 < N ? x + static_cast<size_t>(k0) * D + d0 : x, D, kKC,
         kM, N - k0, D - d0, vec);
  };
  for (int tile = t0; tile < t1; tile += kPair) {
    const int m0 = tile * kM, pair = min(kPair, t1 - tile);
    for (int h = 0; h < pair; ++h)
      dl_tile<kWT, kLdDlW, TW>(x, w, bias, targets, lse, g, N, D, V, m0 + h * kM, n0, eps,
                               vec, stages, dls + h * kM * kLdDlW);
    const int mchunks = pair * (kM / kKC);
    const int chunks = passes * mchunks;
    stage_in(0, 0, m0, mchunks);
    float out[4][4][4];
    for (int i = 0; i < chunks; ++i) {
      const int d0 = (i / mchunks) * kM, k0 = (i % mchunks) * kKC;
      if (k0 == 0) {
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int gd = d0 + wm + mi * 16 + lane / 4 + 8 * (e / 2);
              const int gn = n0 + wn + ni * 8 + 2 * (lane % 4) + e % 2;
              out[mi][ni][e] =
                  (tile == t0 || gd >= D || gn >= V)
                      ? 0.f
                      : part[kWT ? static_cast<size_t>(gn) * D + gd
                                 : static_cast<size_t>(gd) * V + gn];
            }
      }
      if (i + 1 < chunks) {
        stage_in((i + 1) & 1, i + 1, m0, mchunks);
        nm::cp_async_wait<1>();
      } else {
        nm::cp_async_wait<0>();
      }
      __syncthreads();  // the stage, and at i = 0 dl, complete
      if (i == 0 && half < pair)
        for (int m = 0; m < kM; ++m) bsum += dls[(half * kM + m) * kLdDlW + col];
      warp_product<false, true, kLdDlW>(stages + (i & 1) * kStage, kLdN, dls + k0 * kLdDlW, kKC,
                                        out);
      __syncthreads();
      if (k0 + kKC == pair * kM) {
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int gd = d0 + wm + mi * 16 + lane / 4 + 8 * (e / 2);
              const int gn = n0 + wn + ni * 8 + 2 * (lane % 4) + e % 2;
              if (gd < D && gn < V)
                part[kWT ? static_cast<size_t>(gn) * D + gd : static_cast<size_t>(gd) * V + gn] =
                    out[mi][ni][e];
            }
      }
    }
  }
  // db: the first tiles' sums, then the second tiles'
  if (half == 1) stages[col] = bsum;
  __syncthreads();
  if (half == 0 && n0 + col < V) pdb[n0 + col] = bsum + stages[col];
}

}  // namespace tc

// The forward's per-row partials of one 128 x 128 logit tile, computed on the
// tensor cores (tc::tile_product, as K3 does) and reduced over the tile's
// columns below V: the tile maximum, the sum of exp(t - max), the label logit
// and the logit sum. Grid (row tiles, vocabulary tiles): the blocks that
// share a W tile are neighbours in launch order, so they run together and W
// leaves device memory about once.
template <typename TW>
__global__ void __launch_bounds__(tc::kThreads, 2)
xent_fwd_kernel(const float* __restrict__ x, const TW* __restrict__ w,
                const float* __restrict__ bias, const int* __restrict__ targets,
                float* __restrict__ pmax, float* __restrict__ psum,
                float* __restrict__ plab, float* __restrict__ plsum,
                int N, int D, int V, int transposed) {
  extern __shared__ float4 smem4[];
  float* stages = reinterpret_cast<float*>(smem4);
  const int m0 = blockIdx.x * tc::kM;
  const int n0 = blockIdx.y * tc::kN;
  const int R = gridDim.y;
  // 16-byte copies need every row of x and W to start 16-byte aligned
  const bool vec = (D & 3) == 0 && (transposed || (V & 3) == 0) &&
                   ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(w)) & 15) == 0;
  float acc[4][4][4] = {};
  if (transposed)
    tc::tile_product<true, TW>(x, w, N, D, V, m0, n0, vec, stages, acc);
  else
    tc::tile_product<false, TW>(x, w, N, D, V, m0, n0, vec, stages, acc);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4 * 64, wn = warp % 4 * 32;
  // [kM][4 column warps][max, sum, label, logit sum]: the stages are free
  float* part = stages;
  // this lane's columns are col0 + ni * 8 + j; those below V are valid
  const int col0 = n0 + wn + 2 * (lane % 4), valid = V - col0;
  float bv[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) bv[ni][j] = ni * 8 + j < valid ? bias[col0 + ni * 8 + j] : 0.f;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wm + mi * 16 + lane / 4 + 8 * h, gm = m0 + row;
      // the label's offset from col0; this lane holds offsets ni * 8 + j, a
      // row past N none
      const int label = (gm < N ? targets[gm] : -1) - col0;
      float mx = -INFINITY;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          acc[mi][ni][2 * h + j] += bv[ni][j];
          if (ni * 8 + j < valid) mx = fmaxf(mx, acc[mi][ni][2 * h + j]);
        }
      // the 4 lanes that share a row hold its 32 columns of this warp
      mx = fmaxf(mx, __shfl_xor_sync(nm::kFullMask, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(nm::kFullMask, mx, 2));
      float s = 0.f, lab = 0.f, ls = 0.f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float t = acc[mi][ni][2 * h + j];
          if (ni * 8 + j < valid) {
            s += expf(t - mx);
            ls += t;
            if (label == ni * 8 + j) lab = t;
          }
        }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        s += __shfl_xor_sync(nm::kFullMask, s, off);
        lab += __shfl_xor_sync(nm::kFullMask, lab, off);
        ls += __shfl_xor_sync(nm::kFullMask, ls, off);
      }
      if (lane % 4 == 0)
        *reinterpret_cast<float4*>(part + (row * 4 + warp % 4) * 4) = make_float4(mx, s, lab, ls);
    }
  __syncthreads();
  // one thread a row: the block's maximum over its columns, and the four
  // warps' sums (rescaled to it), labels and logit sums, in warp order; a
  // warp with no column below V has max -inf and adds nothing
  const int row = threadIdx.x;
  if (row < tc::kM && m0 + row < N) {
    const float4* p = reinterpret_cast<const float4*>(part) + row * 4;
    const float mx = fmaxf(fmaxf(p[0].x, p[1].x), fmaxf(p[2].x, p[3].x));
    float s = 0.f, lab = 0.f, ls = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (p[q].x != -INFINITY) s += p[q].y * expf(p[q].x - mx);
      lab += p[q].z;
      ls += p[q].w;
    }
    const size_t at = static_cast<size_t>(m0 + row) * R + blockIdx.y;
    pmax[at] = mx;
    psum[at] = s;
    plab[at] = lab;
    plsum[at] = ls;
  }
}

// grid (row tiles, S): block (r, s) walks vocabulary tiles s * tiles_per_chunk ..
// into plane s of `part` (S, N, D)
template <typename TW>
__global__ void __launch_bounds__(tc::kThreads, 1)
xent_bwd_dx_kernel(const float* __restrict__ x, const TW* __restrict__ w,
                   const float* __restrict__ bias, const int* __restrict__ targets,
                   const float* __restrict__ lse, const float* __restrict__ g,
                   float* __restrict__ part, int N, int D, int V, int transposed,
                   int tiles_per_chunk, float eps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int R = (V + tc::kN - 1) / tc::kN;
  const int t0 = blockIdx.y * tiles_per_chunk, t1 = min(R, t0 + tiles_per_chunk);
  float* p = part + static_cast<size_t>(blockIdx.y) * N * D;
  // 16-byte copies need every row of x and W to start 16-byte aligned
  const bool vec = (D & 3) == 0 && (transposed || (V & 3) == 0) &&
                   ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(w)) & 15) == 0;
  if (transposed)
    tc::xent_bwd_dx<true, TW>(x, w, bias, targets, lse, g, p, N, D, V, t0, t1, eps, vec, smem);
  else
    tc::xent_bwd_dx<false, TW>(x, w, bias, targets, lse, g, p, N, D, V, t0, t1, eps, vec, smem);
}

// grid (vocabulary tiles, S): block (c, s) walks row tiles s * tiles_per_chunk ..
// into plane s of `part` (S, dW) and of `pdb` (S, V)
template <typename TW>
__global__ void __launch_bounds__(tc::kThreads, 1)
xent_bwd_dw_kernel(const float* __restrict__ x, const TW* __restrict__ w,
                   const float* __restrict__ bias, const int* __restrict__ targets,
                   const float* __restrict__ lse, const float* __restrict__ g,
                   float* __restrict__ part, float* __restrict__ pdb, int N, int D, int V,
                   int transposed, int tiles_per_chunk, float eps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int R = (N + tc::kM - 1) / tc::kM;
  const int t0 = blockIdx.y * tiles_per_chunk, t1 = min(R, t0 + tiles_per_chunk);
  float* p = part + static_cast<size_t>(blockIdx.y) * D * V;
  float* pb = pdb + static_cast<size_t>(blockIdx.y) * V;
  const bool vec = (D & 3) == 0 && (transposed || (V & 3) == 0) &&
                   ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(w)) & 15) == 0;
  if (transposed)
    tc::xent_bwd_dw<true, TW>(x, w, bias, targets, lse, g, p, pb, N, D, V, t0, t1, eps, vec,
                              smem);
  else
    tc::xent_bwd_dw<false, TW>(x, w, bias, targets, lse, g, p, pb, N, D, V, t0, t1, eps, vec,
                               smem);
}

// out = the sum of the S partials (S, count), in the order 0 .. S-1
__global__ void fold_kernel(const float* __restrict__ part, float* __restrict__ out, size_t count,
                            int S) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < count;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float sum = part[i];
    for (int s = 1; s < S; ++s) sum += part[s * count + i];
    out[i] = sum;
  }
}

int fold(const float* part, float* out, size_t count, int S, cudaStream_t stream) {
  constexpr int kFoldThreads = 256;
  const int blocks = static_cast<int>(std::min<size_t>((count + kFoldThreads - 1) / kFoldThreads,
                                                       size_t{1} << 16));
  fold_kernel<<<blocks, kFoldThreads, 0, stream>>>(part, out, count, S);
  return nm::launch_status();
}

// the shapes and the chunking of the vocabulary (dx) or rows (dW): S chunks
// of tiles_per_chunk tiles cover the R tiles, none empty
bool bad_chunks(int N, int D, int V, int R, int splits, int tiles_per_chunk,
                const void* scratch) {
  return N < 1 || D < 1 || V < 1 || splits < 1 || tiles_per_chunk < 1 ||
         (splits - 1) * tiles_per_chunk >= R || splits * tiles_per_chunk < R ||
         (splits > 1 && scratch == nullptr);
}

template <typename TW>
int xent_fwd(const void* x, const void* w, const void* bias, const void* targets, void* pmax,
             void* psum, void* plab, void* plsum, void* lse, void* nll, int N, int D, int V,
             int transposed, float eps, cudaStream_t s) {
  const int R = (V + tc::kN - 1) / tc::kN;
  // the vocabulary tiles run in gridDim.y, at most 65535 of them
  if (N < 1 || D < 1 || V < 1 || R > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int err = nm::allow_max_smem(reinterpret_cast<const void*>(xent_fwd_kernel<TW>));
  if (err != 0) return err;
  const dim3 grid((N + tc::kM - 1) / tc::kM, R);
  xent_fwd_kernel<TW><<<grid, tc::kThreads, tc::kFwdSmem, s>>>(
      static_cast<const float*>(x), static_cast<const TW*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(targets),
      static_cast<float*>(pmax), static_cast<float*>(psum), static_cast<float*>(plab),
      static_cast<float*>(plsum), N, D, V, transposed);
  const int status = nm::launch_status();
  if (status != 0) return status;
  constexpr int kRowsPerBlock = 8;
  xent_fold_kernel<<<(N + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, 0, s>>>(
      static_cast<const float*>(pmax), static_cast<const float*>(psum),
      static_cast<const float*>(plab), static_cast<const float*>(plsum),
      static_cast<float*>(lse), static_cast<float*>(nll), N, R, V, eps);
  return nm::launch_status();
}

template <typename TW>
int xent_bwd_dx(const void* x, const void* w, const void* bias, const void* targets,
                const void* lse, const void* g, void* dx, void* scratch, int N, int D, int V,
                int transposed, int splits, int tiles_per_chunk, float eps, cudaStream_t s) {
  if (bad_chunks(N, D, V, (V + tc::kN - 1) / tc::kN, splits, tiles_per_chunk, scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = static_cast<int>(cudaFuncSetAttribute(
      xent_bwd_dx_kernel<TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(tc::kSmem)));
  if (err != 0) return err;
  // with one chunk the blocks write dx itself
  float* part = splits > 1 ? static_cast<float*>(scratch) : static_cast<float*>(dx);
  const dim3 grid((N + tc::kM - 1) / tc::kM, splits);
  xent_bwd_dx_kernel<TW><<<grid, tc::kThreads, tc::kSmem, s>>>(
      static_cast<const float*>(x), static_cast<const TW*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(targets),
      static_cast<const float*>(lse), static_cast<const float*>(g), part, N, D, V, transposed,
      tiles_per_chunk, eps);
  const int status = nm::launch_status();
  if (status != 0 || splits == 1) return status;
  return fold(part, static_cast<float*>(dx), static_cast<size_t>(N) * D, splits, s);
}

template <typename TW>
int xent_bwd_dw(const void* x, const void* w, const void* bias, const void* targets,
                const void* lse, const void* g, void* dw, void* db, void* scratch,
                void* db_scratch, int N, int D, int V, int transposed, int splits,
                int tiles_per_chunk, float eps, cudaStream_t s) {
  if (bad_chunks(N, D, V, (N + tc::kM - 1) / tc::kM, splits, tiles_per_chunk, scratch) ||
      (splits > 1 && db_scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = static_cast<int>(cudaFuncSetAttribute(
      xent_bwd_dw_kernel<TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(tc::kSmemW)));
  if (err != 0) return err;
  // with one chunk the blocks write dW and db themselves
  float* part = splits > 1 ? static_cast<float*>(scratch) : static_cast<float*>(dw);
  float* pdb = splits > 1 ? static_cast<float*>(db_scratch) : static_cast<float*>(db);
  const dim3 grid((V + tc::kN - 1) / tc::kN, splits);
  xent_bwd_dw_kernel<TW><<<grid, tc::kThreads, tc::kSmemW, s>>>(
      static_cast<const float*>(x), static_cast<const TW*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(targets),
      static_cast<const float*>(lse), static_cast<const float*>(g), part, pdb, N, D, V,
      transposed, tiles_per_chunk, eps);
  int status = nm::launch_status();
  if (status != 0 || splits == 1) return status;
  status = fold(part, static_cast<float*>(dw), static_cast<size_t>(D) * V, splits, s);
  if (status != 0) return status;
  return fold(pdb, static_cast<float*>(db), static_cast<size_t>(V), splits, s);
}

// ---------------------------------------------------------------------------
// The bf16-W backward on warpgroup products (wgmma_xent.cuh): x's bf16
// parts and W's tiles through a cp.async ring, both operands of every
// product read from shared memory.
namespace wgk {

namespace wg = nm::wg;
using wg::bf16;
constexpr int kThreads = wg::kThreads;     // the product threads
constexpr int kBlock = kThreads + 128;     // and the copying warpgroup
constexpr int kDPass = 512;  // columns (dx) or rows (dW) of D a block owns, 256 a warpgroup
// dx: a block's rows, a vocabulary tile's columns, a logit stage's depth, a
// product stage's vocabulary rows (and the byte rows of their K-major
// tiles), and the ring's stages (bf16 elements each: x's three 64 x 64
// parts and W's 128 x 64 tile, or W's 32 x 512)
constexpr int kDxRows = 64;
constexpr int kDxVTile = 128;
constexpr int kDxKC = 64;
constexpr int kDxVC = 32;
constexpr int kDxKR = 2 * kDxKC, kDxVR = 2 * kDxVC;
constexpr int kDxStages = 4;
constexpr int kDxStage = 3 * kDxRows * kDxKC + kDxVTile * kDxKC;
constexpr int kDxDl = kDxRows * kDxVTile;  // one of dl's parts
// (+ 1024: the ring starts on a 1024-byte boundary, as the swizzle needs;
// + 128: a slot's two barriers)
constexpr size_t kDxSmem = sizeof(bf16) * (kDxStages * kDxStage + 3 * kDxDl) + 1024 + 128;
// dW: a row tile's rows, a block's vocabulary columns, a logit stage's depth
// and the ring's stages (x's three 128 x 32 parts and W's 64 x 32 tile, or
// one of x's parts, 16 x 512)
constexpr int kDwRows = 128;
constexpr int kDwVTile = 64;
constexpr int kDwKC = 32;
constexpr int kDwStages = 6;
constexpr int kDwStage = 3 * kDwRows * kDwKC + kDwVTile * kDwKC;
constexpr int kDwDl = kDwRows * kDwVTile;
constexpr size_t kDwSmem = sizeof(bf16) * (kDwStages * kDwStage + 3 * kDwDl) + 1024 + 128;
// the forward: a block's rows (64 a product warpgroup), a vocabulary tile's
// columns, a stage's depth, and the ring's stages (x's three 128 x 32 parts
// and W's 256 x 32 tile)
constexpr int kFwRows = 128;
constexpr int kFwVTile = 256;
constexpr int kFwKC = 32;
constexpr int kFwStages = 5;
constexpr int kFwStage = 3 * kFwRows * kFwKC + kFwVTile * kFwKC;
constexpr size_t kFwSmem = sizeof(bf16) * kFwStages * kFwStage + 1024 + 128;
static_assert(kDxVC * kDPass <= kDxStage, "a dx product stage fits a stage");
static_assert(16 * kDPass <= kDwStage, "a dW product stage fits a stage");

// x (N, D) float32 as its three bf16 parts, planes of (N, Dp), the columns
// past D zero (Dp: D rounded up to 8, so that every row is 16-byte aligned)
__global__ void split_x_kernel(const float* __restrict__ x, unsigned* __restrict__ parts, int N,
                               int D, int Dp) {
  const size_t pairs = static_cast<size_t>(N) * Dp / 2;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < pairs;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int n = static_cast<int>(2 * i / Dp), d = static_cast<int>(2 * i % Dp);
    const float* row = x + static_cast<size_t>(n) * D;
    unsigned p[3];
    wg::split3(d < D ? row[d] : 0.f, d + 1 < D ? row[d + 1] : 0.f, p);
    parts[i] = p[0];
    parts[pairs + i] = p[1];
    parts[2 * pairs + i] = p[2];
  }
}

// The dynamic shared memory from its first 1024-byte boundary
__device__ __forceinline__ bf16* aligned_ring() {
  extern __shared__ float4 smem4[];
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(smem4));
  return reinterpret_cast<bf16*>(reinterpret_cast<char*>(smem4) + ((1024 - (at & 1023)) & 1023));
}

// dl = g (exp(t + b - lse) - (1 - eps) [v == y] - eps / V) of one logit, 0
// outside N x V
__device__ __forceinline__ float dlogit(float t, bool ok, float b, float l, float gr, bool label,
                                        float eps, int V) {
  if (!ok) return 0.f;
  float d = expf(t + b - l) - (label ? 1.0f - eps : 0.f);
  if (eps != 0.f) d -= eps / V;
  return d * gr;
}

// grid (row tiles of 64, S, passes of 512 columns of D): block (r, s, p)
// walks vocabulary tiles [s T / S, (s + 1) T / S) into plane s of `part`
// (S, N, D), columns 512 p ..
template <bool kWT>
__global__ void __launch_bounds__(kBlock, 1)
xent_bwd_dx_wg_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap_l,
                      const __grid_constant__ CUtensorMap wmap_p, const float* __restrict__ bias,
                      const int* __restrict__ targets, const float* __restrict__ lse,
                      const float* __restrict__ g, float* __restrict__ part, int N, int D, int Dp,
                      int V, int splits, float eps) {
  bf16* ring = aligned_ring();
  bf16* dls = ring + kDxStages * kDxStage;  // dl's three parts, 64 x 128 each
  // a slot's barriers: its stage has landed; the product warps are done with it
  uint64_t* full = reinterpret_cast<uint64_t*>(dls + 3 * kDxDl);
  uint64_t* empty = full + kDxStages;
  const int half = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * kDxRows, d0 = blockIdx.z * kDPass;
  const int tiles = (V + kDxVTile - 1) / kDxVTile;
  const int t0 = static_cast<int>(static_cast<long long>(blockIdx.y) * tiles / splits);
  const int t1 = static_cast<int>(static_cast<long long>(blockIdx.y + 1) * tiles / splits);
  const int kch = (Dp + kDxKC - 1) / kDxKC;           // logit stages of a tile
  const int per_tile = kch + kDxVTile / kDxVC;        // and its product stages
  const int count = (t1 - t0) * per_tile;

  // stage i of vocabulary tile `tile` into ring slot `slot`
  auto load = [&](int slot, int tile, int i) {
    bf16* st = ring + slot * kDxStage;
    uint64_t* bar = &full[slot];
    const int v0 = tile * kDxVTile;
    if (i < kch) {
      // x's three parts [n][d] in one box (128-byte rows) and W's 128 x 64:
      // tied [v][d] (128-byte rows), untied [d][v] (two 64-column blocks)
      const int k0 = i * kDxKC;
      bf16* wt = st + 3 * kDxRows * kDxKC;
      wg::bar_expect(bar, kDxStage * sizeof(bf16));
      wg::tma3d(st, xmap, k0, m0, 0, bar);
      if (kWT) {
        wg::tma2d(wt, wmap_l, k0, v0, bar);
      } else {
        for (int c = 0; c < kDxVTile; c += 64) wg::tma2d(wt + c * kDxKC, wmap_l, v0 + c, k0, bar);
      }
    } else {
      // W's 32 vocabulary rows by the block's 512 columns of D: tied [v][d]
      // in 64-column blocks, untied [d][v] in two boxes of 256 rows
      const int vc = v0 + (i - kch) * kDxVC;
      wg::bar_expect(bar, kDxVC * kDPass * sizeof(bf16));
      if (kWT) {
        for (int c = 0; c < kDPass; c += 64) wg::tma2d(st + c * kDxVC, wmap_p, d0 + c, vc, bar);
      } else {
        for (int r = 0; r < kDPass; r += 256) wg::tma2d(st + r * kDxVC, wmap_p, vc, d0 + r, bar);
      }
    }
  };
  if (threadIdx.x == 0) {
    for (int slot = 0; slot < kDxStages; ++slot) {
      wg::bar_init(&full[slot], 1);
      wg::bar_init(&empty[slot], kThreads / 32);
    }
    wg::bar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= kThreads) {
    // the copying warpgroup: one thread keeps the ring full, refilling a
    // slot once the product warps have released it
    wg::registers_down<40>();
    if (threadIdx.x == kThreads)
      for (int q = 0, tile = t0, i = 0; q < count; ++q) {
        if (q >= kDxStages) wg::bar_wait(&empty[q % kDxStages], (q / kDxStages - 1) & 1);
        load(q % kDxStages, tile, i);
        if (++i == per_tile) i = 0, ++tile;
      }
    return;
  }
  wg::registers_up<232>();

  // this thread's rows (of the logit tile and of dx) and column offset
  const int r_lo = warp * 16 + lane / 4, col = 2 * (lane % 4);
  float row_lse[2], row_g[2];
  int row_y[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = m0 + r_lo + 8 * h;
    row_lse[h] = n < N ? lse[n] : 0.f;
    row_g[h] = n < N ? g[n] : 0.f;
    row_y[h] = n < N ? targets[n] : -1;
  }
  float acc[128];  // dx: columns d0 + 256 half + 8 j + col (+1)
#pragma unroll
  for (int j = 0; j < 128; ++j) acc[j] = 0.f;
  float s[32];     // the logit tile: columns 64 half + 8 j + col (+1)

  for (int q = 0; q < count; ++q) {
    wg::bar_wait(&full[q % kDxStages], q / kDxStages & 1);  // stage q is in
    const bf16* st = ring + (q % kDxStages) * kDxStage;
    const int i = q % per_tile;
    if (i < kch) {
      // t += x W over 64 depths: x's smallest part first; a tile's first
      // product starts the sums
      const bf16* wt = st + 3 * kDxRows * kDxKC;
      wg::fence_operand(s);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < kDxKC; kk += 16) {
        const uint64_t b = kWT ? wg::kslice<kDxKR>(wt, kDxVTile, 64 * half, kk)
                               : wg::mnslice<128>(wt, kDxKC, 64 * half, kk);
#pragma unroll
        for (int p = 2; p >= 0; --p)
          wg::mma64<0, kWT ? 0 : 1>(
              s, wg::kslice<kDxKR>(st + p * kDxRows * kDxKC, kDxRows, 0, kk), b,
              i != 0 || kk != 0 || p != 2);
      }
      wg::fence_operand(s);
    } else {
      // dx += dl W^T over 32 vocabulary rows: dl's smallest part first
      const int k0 = (i - kch) * kDxVC;
      wg::fence_operand(acc);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < kDxVC; kk += 16) {
        const uint64_t b = kWT ? wg::mnslice<128>(st, kDxVC, 256 * half, kk)
                               : wg::kslice<kDxVR>(st, kDPass, 256 * half, kk);
#pragma unroll
        for (int p = 2; p >= 0; --p)
          wg::mma256<0, kWT ? 1 : 0>(acc, wg::kslice<128>(dls + p * kDxDl, kDxRows, 0, k0 + kk),
                                     b, 1);
      }
      wg::fence_operand(acc);
    }
    wg::commit();
    wg::wait<1>();
    // this warp's products of stage q - 1 are done: release its slot
    if (q > 0 && lane == 0) wg::bar_arrive(&empty[(q - 1) % kDxStages]);
    if (i == kch - 1) {
      // the logit tile is complete: dl's parts into shared memory, once
      // both warpgroups have finished reading the previous tile's
      wg::wait<0>();
      wg::fence_operand(s);
      wg::sync_products();
      const int v0 = (t0 + q / per_tile) * kDxVTile;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 64 * half + 8 * j + col, v = v0 + c;
        const float b0 = v < V ? bias[v] : 0.f, b1 = v + 1 < V ? bias[v + 1] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool row_ok = m0 + r_lo + 8 * h < N;
          unsigned parts[3];
          wg::split3(dlogit(s[4 * j + 2 * h], row_ok && v < V, b0, row_lse[h], row_g[h],
                        v == row_y[h], eps, V),
                 dlogit(s[4 * j + 2 * h + 1], row_ok && v + 1 < V, b1, row_lse[h], row_g[h],
                        v + 1 == row_y[h], eps, V),
                 parts);
          const int off = wg::at<128>(r_lo + 8 * h, c, kDxRows);
#pragma unroll
          for (int p = 0; p < 3; ++p) *reinterpret_cast<unsigned*>(dls + p * kDxDl + off) = parts[p];
        }
      }
      wg::fence_shared();
      wg::sync_products();
    }
  }
  wg::wait<0>();
  wg::fence_operand(acc);
  float* out = part + static_cast<size_t>(blockIdx.y) * N * D;
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = m0 + r_lo + 8 * h;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = d0 + 256 * half + 8 * j + col + e;
        if (n < N && d < D) out[static_cast<size_t>(n) * D + d] = acc[4 * j + 2 * h + e];
      }
    }
}

// grid (vocabulary blocks of 64, S, passes of 512 rows of D): block (c, s,
// p) walks row tiles [s T / S, (s + 1) T / S) into plane s of `part` (S,
// dW) and, for p = 0, of `pdb` (S, V)
template <bool kWT>
__global__ void __launch_bounds__(kBlock, 1)
xent_bwd_dw_wg_kernel(const __grid_constant__ CUtensorMap xmap_l,
                      const __grid_constant__ CUtensorMap xmap_p,
                      const __grid_constant__ CUtensorMap wmap, const float* __restrict__ bias,
                      const int* __restrict__ targets, const float* __restrict__ lse,
                      const float* __restrict__ g, float* __restrict__ part,
                      float* __restrict__ pdb, int N, int D, int Dp, int V, int splits,
                      float eps) {
  bf16* ring = aligned_ring();
  bf16* dls = ring + kDwStages * kDwStage;  // dl's three parts, 128 x 64 each
  uint64_t* full = reinterpret_cast<uint64_t*>(dls + 3 * kDwDl);
  uint64_t* empty = full + kDwStages;
  const int half = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int v0 = blockIdx.x * kDwVTile, d0 = blockIdx.z * kDPass;
  const int tiles = (N + kDwRows - 1) / kDwRows;
  const int t0 = static_cast<int>(static_cast<long long>(blockIdx.y) * tiles / splits);
  const int t1 = static_cast<int>(static_cast<long long>(blockIdx.y + 1) * tiles / splits);
  const int kch = (Dp + kDwKC - 1) / kDwKC;               // logit stages of a tile
  const int per_tile = kch + 3 * (kDwRows / 16);          // and its product stages
  const int count = (t1 - t0) * per_tile;

  // stage i of row tile `tile` into ring slot `slot`; product stage j of a
  // tile: rows 16 (j / 3) .. of x's part 2 - j % 3 (the smallest first)
  auto load = [&](int slot, int tile, int i) {
    bf16* st = ring + slot * kDwStage;
    uint64_t* bar = &full[slot];
    const int m0 = tile * kDwRows;
    if (i < kch) {
      // x's three parts [n][d] in one box (64-byte rows) and W's 64 x 32:
      // tied [v][d] (64-byte rows), untied [d][v] (a 64-column block)
      const int k0 = i * kDwKC;
      wg::bar_expect(bar, (3 * kDwRows * kDwKC + kDwVTile * kDwKC) * sizeof(bf16));
      wg::tma3d(st, xmap_l, k0, m0, 0, bar);
      if (kWT) {
        wg::tma2d(st + 3 * kDwRows * kDwKC, wmap, k0, v0, bar);
      } else {
        wg::tma2d(st + 3 * kDwRows * kDwKC, wmap, v0, k0, bar);
      }
    } else {
      // one part of x, 16 rows by the block's 512 columns of D, in
      // 64-column blocks
      const int j = i - kch;
      wg::bar_expect(bar, 16 * kDPass * sizeof(bf16));
      for (int c = 0; c < kDPass; c += 64)
        wg::tma3d(st + c * 16, xmap_p, d0 + c, m0 + 16 * (j / 3), 2 - j % 3, bar);
    }
  };
  if (threadIdx.x == 0) {
    for (int slot = 0; slot < kDwStages; ++slot) {
      wg::bar_init(&full[slot], 1);
      wg::bar_init(&empty[slot], kThreads / 32);
    }
    wg::bar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= kThreads) {
    // the copying warpgroup: one thread keeps the ring full, refilling a
    // slot once the product warps have released it
    wg::registers_down<40>();
    if (threadIdx.x == kThreads)
      for (int q = 0, tile = t0, i = 0; q < count; ++q) {
        if (q >= kDwStages) wg::bar_wait(&empty[q % kDwStages], (q / kDwStages - 1) & 1);
        load(q % kDwStages, tile, i);
        if (++i == per_tile) i = 0, ++tile;
      }
    return;
  }
  wg::registers_up<232>();

  // this thread's rows of the logit tile (64 half + r_lo (+8)), its vocabulary
  // columns v0 + 8 j + col (+1), and dW^T's rows v0 + r_lo (+8)
  const int r_lo = warp * 16 + lane / 4, col = 2 * (lane % 4);
  float bv[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int v = v0 + 8 * j + col + e;
      bv[j][e] = v < V ? bias[v] : 0.f;
    }
  float dbs[8][2] = {};  // db: this thread's columns over its rows
  float acc[128];        // dW^T: columns d0 + 256 half + 8 j + col (+1)
#pragma unroll
  for (int j = 0; j < 128; ++j) acc[j] = 0.f;
  float s[32];

  for (int q = 0; q < count; ++q) {
    wg::bar_wait(&full[q % kDwStages], q / kDwStages & 1);  // stage q is in
    const bf16* st = ring + (q % kDwStages) * kDwStage;
    const int i = q % per_tile;
    if (i < kch) {
      // t += x W over 32 depths, rows 64 half ..: x's smallest part first;
      // a tile's first product starts the sums
      const bf16* wt = st + 3 * kDwRows * kDwKC;
      uint64_t a[2][3], b[2];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        b[kk] = kWT ? wg::kslice<64>(wt, kDwVTile, 0, 16 * kk)
                    : wg::mnslice<128>(wt, kDwKC, 0, 16 * kk);
#pragma unroll
        for (int p = 0; p < 3; ++p)
          a[kk][p] = wg::kslice<64>(st + p * kDwRows * kDwKC, kDwRows, 64 * half, 16 * kk);
      }
      wg::fence_operand(s);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int p = 2; p >= 0; --p)
          wg::mma64<0, kWT ? 0 : 1>(s, a[kk][p], b[kk], i != 0 || kk != 0 || p != 2);
      wg::fence_operand(s);
    } else {
      // dW^T += dl^T x over 16 rows, x's part q against dl's parts p <= 2 - q
      const int j = i - kch, xq = 2 - j % 3;
      const uint64_t b = wg::mnslice<128>(st, 16, 256 * half, 0);
      uint64_t a[3];
#pragma unroll
      for (int p = 0; p < 3; ++p) a[p] = wg::mnslice<128>(dls + p * kDwDl, kDwRows, 0, 16 * (j / 3));
      wg::fence_operand(acc);
      wg::fence();
      if (xq == 0) wg::mma256<1, 1>(acc, a[2], b, 1);
      if (xq <= 1) wg::mma256<1, 1>(acc, a[1], b, 1);
      wg::mma256<1, 1>(acc, a[0], b, 1);
      wg::fence_operand(acc);
    }
    wg::commit();
    wg::wait<1>();
    // this warp's products of stage q - 1 are done: release its slot
    if (q > 0 && lane == 0) wg::bar_arrive(&empty[(q - 1) % kDwStages]);
    if (i == kch - 1) {
      wg::wait<0>();
      wg::fence_operand(s);
      wg::sync_products();
      const int m0 = (t0 + q / per_tile) * kDwRows + 64 * half;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = m0 + r_lo + 8 * h;
        const bool row_ok = n < N;
        const float l = row_ok ? lse[n] : 0.f, gr = row_ok ? g[n] : 0.f;
        const int y = row_ok ? targets[n] : -1;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int v = v0 + 8 * j + col;
          const float a = dlogit(s[4 * j + 2 * h], row_ok && v < V, bv[j][0], l, gr, v == y, eps, V);
          const float b =
              dlogit(s[4 * j + 2 * h + 1], row_ok && v + 1 < V, bv[j][1], l, gr, v + 1 == y, eps, V);
          dbs[j][0] += a;
          dbs[j][1] += b;
          unsigned parts[3];
          wg::split3(a, b, parts);
          const int off = wg::at<128>(64 * half + r_lo + 8 * h, 8 * j + col, kDwRows);
#pragma unroll
          for (int p = 0; p < 3; ++p) *reinterpret_cast<unsigned*>(dls + p * kDwDl + off) = parts[p];
        }
      }
      wg::fence_shared();
      wg::sync_products();
    }
  }
  wg::wait<0>();
  wg::fence_operand(acc);
  float* out = part + static_cast<size_t>(blockIdx.y) * D * V;
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = v0 + r_lo + 8 * h;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = d0 + 256 * half + 8 * j + col + e;
        if (v < V && d < D)
          out[kWT ? static_cast<size_t>(v) * D + d : static_cast<size_t>(d) * V + v] =
              acc[4 * j + 2 * h + e];
      }
    }
  if (blockIdx.z != 0) return;
  // db: each column's sums over the 8 lanes that share it, then over the
  // 8 warps, in one fixed order
  wg::sync_products();  // the ring is free
  float* red = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = dbs[j][e];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) v += __shfl_xor_sync(nm::kFullMask, v, off);
      if (lane < 4) red[(threadIdx.x / 32) * kDwVTile + 8 * j + col + e] = v;
    }
  wg::sync_products();
  if (threadIdx.x < kDwVTile && v0 + threadIdx.x < V) {
    float sum = 0.f;
    for (int wi = 0; wi < kThreads / 32; ++wi) sum += red[wi * kDwVTile + threadIdx.x];
    pdb[static_cast<size_t>(blockIdx.y) * V + v0 + threadIdx.x] = sum;
  }
}

// grid (row tiles of 128, S): block (r, s) walks vocabulary tiles [s T / S,
// (s + 1) T / S) of 256 columns and writes its rows' partials over them
// (the max, the sum of exp(t - max), the label logit and the logit sum of
// the columns below V) to column s of the (N, S) partials, which
// xent_fold_kernel folds. Warpgroup `half` owns rows 64 half .. of the
// block and every column of a tile: 64 x 256 float32 sums, the tile's
// logits over D in 32-deep stages (x's three parts against W), then the
// epilogue folds them into each thread's running partials of its two rows
// over its 64 columns of each tile; the four lanes that share a row meet
// once, at the end.
template <bool kWT>
__global__ void __launch_bounds__(kBlock, 1)
xent_fwd_wg_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap, const float* __restrict__ bias,
                   const int* __restrict__ targets, float* __restrict__ pmax,
                   float* __restrict__ psum, float* __restrict__ plab,
                   float* __restrict__ plsum, int N, int Dp, int V, int splits) {
  bf16* ring = aligned_ring();
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kFwStages * kFwStage);
  uint64_t* empty = full + kFwStages;
  const int half = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * kFwRows;
  const int tiles = (V + kFwVTile - 1) / kFwVTile;
  const int t0 = static_cast<int>(static_cast<long long>(blockIdx.y) * tiles / splits);
  const int t1 = static_cast<int>(static_cast<long long>(blockIdx.y + 1) * tiles / splits);
  const int kch = (Dp + kFwKC - 1) / kFwKC;  // stages of a tile
  const int count = (t1 - t0) * kch;

  // stage q of the walk into ring slot `slot`: x's three parts [n][d] in one
  // box (64-byte rows) and W's 256 x 32: tied [v][d] (64-byte rows), untied
  // [d][v] (four 64-column blocks)
  auto load = [&](int slot, int q) {
    bf16* st = ring + slot * kFwStage;
    uint64_t* bar = &full[slot];
    const int k0 = q % kch * kFwKC, v0 = (t0 + q / kch) * kFwVTile;
    bf16* wt = st + 3 * kFwRows * kFwKC;
    wg::bar_expect(bar, kFwStage * sizeof(bf16));
    wg::tma3d(st, xmap, k0, m0, 0, bar);
    if (kWT) {
      wg::tma2d(wt, wmap, k0, v0, bar);
    } else {
      for (int c = 0; c < kFwVTile; c += 64) wg::tma2d(wt + c * kFwKC, wmap, v0 + c, k0, bar);
    }
  };
  if (threadIdx.x == 0) {
    for (int slot = 0; slot < kFwStages; ++slot) {
      wg::bar_init(&full[slot], 1);
      wg::bar_init(&empty[slot], kThreads / 32);
    }
    wg::bar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= kThreads) {
    // the copying warpgroup: one thread keeps the ring full, refilling a
    // slot once the product warps have released it
    wg::registers_down<40>();
    if (threadIdx.x == kThreads)
      for (int q = 0; q < count; ++q) {
        if (q >= kFwStages) wg::bar_wait(&empty[q % kFwStages], (q / kFwStages - 1) & 1);
        load(q % kFwStages, q);
      }
    return;
  }
  wg::registers_up<232>();

  // this thread's rows 64 half + r_lo (+ 8) and columns 8 j + col (+ 1) of
  // each tile, and its running partials of the two rows over its columns
  const int r_lo = warp * 16 + lane / 4, col = 2 * (lane % 4);
  int row_y[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = m0 + 64 * half + r_lo + 8 * h;
    row_y[h] = n < N ? targets[n] : -1;
  }
  float run_max[2] = {-INFINITY, -INFINITY}, run_sum[2] = {0.f, 0.f};
  float run_lab[2] = {0.f, 0.f}, run_ls[2] = {0.f, 0.f};
  float acc[128];

  for (int q = 0; q < count; ++q) {
    wg::bar_wait(&full[q % kFwStages], q / kFwStages & 1);  // stage q is in
    const bf16* st = ring + (q % kFwStages) * kFwStage;
    const bf16* wt = st + 3 * kFwRows * kFwKC;
    const int i = q % kch;
    // t += x W over 32 depths: x's smallest part first; a tile's first
    // product starts the sums
    wg::fence_operand(acc);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kFwKC; kk += 16) {
      const uint64_t b = kWT ? wg::kslice<64>(wt, kFwVTile, 0, kk)
                             : wg::mnslice<128>(wt, kFwKC, 0, kk);
#pragma unroll
      for (int p = 2; p >= 0; --p)
        wg::mma256<0, kWT ? 0 : 1>(
            acc, wg::kslice<64>(st + p * kFwRows * kFwKC, kFwRows, 64 * half, kk), b,
            i != 0 || kk != 0 || p != 2);
    }
    wg::fence_operand(acc);
    wg::commit();
    wg::wait<1>();
    // this warp's products of stage q - 1 are done: release its slot
    if (q > 0 && lane == 0) wg::bar_arrive(&empty[(q - 1) % kFwStages]);
    if (i == kch - 1) {
      // the logit tile is complete: fold it into the running partials
      wg::wait<0>();
      wg::fence_operand(acc);
      const int v0 = (t0 + q / kch) * kFwVTile;
      float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int v = v0 + 8 * j + col + e;
          const bool ok = v < V;
          const float bv = ok ? __ldg(bias + v) : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float& t = acc[4 * j + 2 * h + e];
            t = ok ? t + bv : -INFINITY;
            tile_max[h] = fmaxf(tile_max[h], t);
            if (ok) {
              run_ls[h] += t;
              if (v == row_y[h]) run_lab[h] = t;
            }
          }
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(run_max[h], tile_max[h]);
        // none of this thread's columns so far lies below V: nothing to add
        if (m_new == -INFINITY) continue;
        float sum = run_sum[h] * expf(run_max[h] - m_new);
#pragma unroll
        for (int j = 0; j < 32; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) sum += expf(acc[4 * j + 2 * h + e] - m_new);
        run_sum[h] = sum;
        run_max[h] = m_new;
      }
    }
  }
  // the four lanes of a row: the row's max, their sums rescaled to it, the
  // label and logit sums, in one fixed order
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = run_max[h];
    mx = fmaxf(mx, __shfl_xor_sync(nm::kFullMask, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(nm::kFullMask, mx, 2));
    float s = run_max[h] == -INFINITY ? 0.f : run_sum[h] * expf(run_max[h] - mx);
    float lab = run_lab[h], ls = run_ls[h];
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      s += __shfl_xor_sync(nm::kFullMask, s, off);
      lab += __shfl_xor_sync(nm::kFullMask, lab, off);
      ls += __shfl_xor_sync(nm::kFullMask, ls, off);
    }
    const int n = m0 + 64 * half + r_lo + 8 * h;
    if (lane % 4 == 0 && n < N) {
      const size_t at = static_cast<size_t>(n) * splits + blockIdx.y;
      pmax[at] = mx;
      psum[at] = s;
      plab[at] = lab;
      plsum[at] = ls;
    }
  }
}

int split_x(const void* x, void* xs, int N, int D, int Dp, cudaStream_t s) {
  constexpr int kSplitThreads = 256;
  const size_t pairs = static_cast<size_t>(N) * Dp / 2;
  const int blocks = static_cast<int>(
      std::min<size_t>((pairs + kSplitThreads - 1) / kSplitThreads, size_t{1} << 14));
  split_x_kernel<<<blocks, kSplitThreads, 0, s>>>(static_cast<const float*>(x),
                                                  static_cast<unsigned*>(xs), N, D, Dp);
  return nm::launch_status();
}

// x's three parts (3, N, Dp) with a box of `cols` x `rows` x `planes`
int parts_map(CUtensorMap* map, const void* xs, int N, int Dp, unsigned cols, unsigned rows,
              unsigned planes) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Dp), static_cast<cuuint64_t>(N), 3};
  const cuuint64_t strides[2] = {2ull * Dp, 2ull * Dp * N};
  const cuuint32_t box[3] = {cols, rows, planes};
  return nm::tma::tensor_map(map, xs, 3, dims, strides, box);
}

// W, (V, D) tied or (D, V), with a box of `cols` x `rows`
int w_map(CUtensorMap* map, const void* w, int D, int V, int transposed, unsigned cols,
          unsigned rows) {
  const int inner = transposed ? D : V, outer = transposed ? V : D;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {2ull * inner};
  const cuuint32_t box[2] = {cols, rows};
  return nm::tma::tensor_map(map, w, 2, dims, strides, box);
}

// what the wgmma kernels take: W's bf16 rows 16-byte aligned (D % 8 == 0
// tied, V % 8 == 0 untied: ops/fused_xent.py `wgmma_takes`), W and the parts
// 16-byte aligned, S chunks of the walked tiles none empty, the grid's y and
// z within 65535
bool bad_wg(const void* w, const void* xs, int N, int D, int V, int transposed, int walked,
            int splits, const void* scratch) {
  const int passes = (D + kDPass - 1) / kDPass;
  return N < 1 || D < 1 || V < 1 || splits < 1 || splits > walked || splits > 65535 ||
         passes > 65535 || (transposed ? D % 8 : V % 8) != 0 || xs == nullptr ||
         ((reinterpret_cast<size_t>(w) | reinterpret_cast<size_t>(xs)) & 15) != 0 ||
         (splits > 1 && scratch == nullptr);
}

int xent_fwd_wg(const void* x, const void* w, const void* bias, const void* targets, void* pmax,
                void* psum, void* plab, void* plsum, void* lse, void* nll, void* xs, int N, int D,
                int V, int transposed, int splits, float eps, cudaStream_t s) {
  if (bad_wg(w, xs, N, D, V, transposed, (V + kFwVTile - 1) / kFwVTile, splits, pmax) ||
      psum == nullptr || plab == nullptr || plsum == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Dp = (D + 7) / 8 * 8;
  int status = split_x(x, xs, N, D, Dp, s);
  if (status != 0) return status;
  // x's parts 128 rows x 32 deep, all three at once; W 256 x 32 (tied
  // [v][d]) or 64 x 32 ([d][v], four boxes a stage)
  CUtensorMap xmap, wmap;
  status = parts_map(&xmap, xs, N, Dp, kFwKC, kFwRows, 3);
  if (status == 0)
    status = transposed ? w_map(&wmap, w, D, V, 1, kFwKC, kFwVTile)
                        : w_map(&wmap, w, D, V, 0, 64, kFwKC);
  if (status != 0) return status;
  auto kernel = transposed ? xent_fwd_wg_kernel<true> : xent_fwd_wg_kernel<false>;
  status = static_cast<int>(cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel), cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kFwSmem)));
  if (status != 0) return status;
  const dim3 grid((N + kFwRows - 1) / kFwRows, splits);
  kernel<<<grid, kBlock, kFwSmem, s>>>(
      xmap, wmap, static_cast<const float*>(bias), static_cast<const int*>(targets),
      static_cast<float*>(pmax), static_cast<float*>(psum), static_cast<float*>(plab),
      static_cast<float*>(plsum), N, Dp, V, splits);
  status = nm::launch_status();
  if (status != 0) return status;
  constexpr int kRowsPerBlock = 8;
  xent_fold_kernel<<<(N + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, 0, s>>>(
      static_cast<const float*>(pmax), static_cast<const float*>(psum),
      static_cast<const float*>(plab), static_cast<const float*>(plsum),
      static_cast<float*>(lse), static_cast<float*>(nll), N, splits, V, eps);
  return nm::launch_status();
}

int xent_bwd_dx_wg(const void* x, const void* w, const void* bias, const void* targets,
                   const void* lse, const void* g, void* dx, void* scratch, void* xs, int N, int D,
                   int V, int transposed, int splits, float eps, cudaStream_t s) {
  if (bad_wg(w, xs, N, D, V, transposed, (V + kDxVTile - 1) / kDxVTile, splits, scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  const int Dp = (D + 7) / 8 * 8;
  int status = split_x(x, xs, N, D, Dp, s);
  if (status != 0) return status;
  // x's parts 64 rows x 64 deep, all three at once; W 128 x 64 (tied [v][d])
  // or 64 x 64 ([d][v]) for the logits, 32 x 64 ([v][d]) or 256 x 32 ([d][v])
  // for dl W^T
  CUtensorMap xmap, wmap_l, wmap_p;
  status = parts_map(&xmap, xs, N, Dp, kDxKC, kDxRows, 3);
  if (status == 0)
    status = transposed ? w_map(&wmap_l, w, D, V, 1, kDxKC, kDxVTile)
                        : w_map(&wmap_l, w, D, V, 0, 64, kDxKC);
  if (status == 0)
    status = transposed ? w_map(&wmap_p, w, D, V, 1, 64, kDxVC)
                        : w_map(&wmap_p, w, D, V, 0, kDxVC, 256);
  if (status != 0) return status;
  auto kernel = transposed ? xent_bwd_dx_wg_kernel<true> : xent_bwd_dx_wg_kernel<false>;
  status = static_cast<int>(cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel), cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kDxSmem)));
  if (status != 0) return status;
  // with one chunk the blocks write dx itself
  float* part = splits > 1 ? static_cast<float*>(scratch) : static_cast<float*>(dx);
  const dim3 grid((N + kDxRows - 1) / kDxRows, splits, (D + kDPass - 1) / kDPass);
  kernel<<<grid, kBlock, kDxSmem, s>>>(
      xmap, wmap_l, wmap_p, static_cast<const float*>(bias), static_cast<const int*>(targets),
      static_cast<const float*>(lse), static_cast<const float*>(g), part, N, D, Dp, V, splits,
      eps);
  status = nm::launch_status();
  if (status != 0 || splits == 1) return status;
  return fold(part, static_cast<float*>(dx), static_cast<size_t>(N) * D, splits, s);
}

int xent_bwd_dw_wg(const void* x, const void* w, const void* bias, const void* targets,
                   const void* lse, const void* g, void* dw, void* db, void* scratch,
                   void* db_scratch, void* xs, int N, int D, int V, int transposed, int splits,
                   float eps, cudaStream_t s) {
  if (bad_wg(w, xs, N, D, V, transposed, (N + kDwRows - 1) / kDwRows, splits, scratch) ||
      (splits > 1 && db_scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int Dp = (D + 7) / 8 * 8;
  int status = split_x(x, xs, N, D, Dp, s);
  if (status != 0) return status;
  // x's parts 128 rows x 32 deep (all three) for the logits, 16 x 64 (one)
  // for dl^T x; W 64 x 32 (tied [v][d]) or 32 x 64 ([d][v])
  CUtensorMap xmap_l, xmap_p, wmap;
  status = parts_map(&xmap_l, xs, N, Dp, kDwKC, kDwRows, 3);
  if (status == 0) status = parts_map(&xmap_p, xs, N, Dp, 64, 16, 1);
  if (status == 0)
    status = transposed ? w_map(&wmap, w, D, V, 1, kDwKC, kDwVTile)
                        : w_map(&wmap, w, D, V, 0, kDwVTile, kDwKC);
  if (status != 0) return status;
  auto kernel = transposed ? xent_bwd_dw_wg_kernel<true> : xent_bwd_dw_wg_kernel<false>;
  status = static_cast<int>(cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel), cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kDwSmem)));
  if (status != 0) return status;
  // with one chunk the blocks write dW and db themselves
  float* part = splits > 1 ? static_cast<float*>(scratch) : static_cast<float*>(dw);
  float* pdb = splits > 1 ? static_cast<float*>(db_scratch) : static_cast<float*>(db);
  const dim3 grid((V + kDwVTile - 1) / kDwVTile, splits, (D + kDPass - 1) / kDPass);
  kernel<<<grid, kBlock, kDwSmem, s>>>(
      xmap_l, xmap_p, wmap, static_cast<const float*>(bias), static_cast<const int*>(targets),
      static_cast<const float*>(lse), static_cast<const float*>(g), part, pdb, N, D, Dp, V, splits,
      eps);
  status = nm::launch_status();
  if (status != 0 || splits == 1) return status;
  status = fold(part, static_cast<float*>(dw), static_cast<size_t>(D) * V, splits, s);
  if (status != 0) return status;
  return fold(pdb, static_cast<float*>(db), static_cast<size_t>(V), splits, s);
}

}  // namespace wgk

}  // namespace

// The C entry points: W float32, and W bf16 (the _bf16w instances: the
// _widened ones with the float32 ones' arguments, the wgmma ones with x's
// parts' scratch, the chunks S and no tiles_per_chunk); dW is float32 in all
// (the wrapper rounds it to bf16).
NM_EXPORT int nm_xent_fwd(const void* x, const void* w, const void* bias, const void* targets,
                          void* pmax, void* psum, void* plab, void* plsum, void* lse, void* nll,
                          int N, int D, int V, int transposed, float eps, void* stream) {
  return xent_fwd<float>(x, w, bias, targets, pmax, psum, plab, plsum, lse, nll, N, D, V,
                         transposed, eps, static_cast<cudaStream_t>(stream));
}

NM_EXPORT int nm_xent_fwd_bf16w(const void* x, const void* w, const void* bias,
                                const void* targets, void* pmax, void* psum, void* plab,
                                void* plsum, void* lse, void* nll, void* xs, int N, int D,
                                int V, int transposed, int splits, float eps, void* stream) {
  return wgk::xent_fwd_wg(x, w, bias, targets, pmax, psum, plab, plsum, lse, nll, xs, N, D, V,
                          transposed, splits, eps, static_cast<cudaStream_t>(stream));
}

NM_EXPORT int nm_xent_fwd_bf16w_widened(const void* x, const void* w, const void* bias,
                                        const void* targets, void* pmax, void* psum,
                                        void* plab, void* plsum, void* lse, void* nll, int N,
                                        int D, int V, int transposed, float eps,
                                        void* stream) {
  return xent_fwd<__nv_bfloat16>(x, w, bias, targets, pmax, psum, plab, plsum, lse, nll, N, D,
                                 V, transposed, eps, static_cast<cudaStream_t>(stream));
}

NM_EXPORT int nm_xent_bwd_dx(const void* x, const void* w, const void* bias, const void* targets,
                             const void* lse, const void* g, void* dx, void* scratch, int N, int D,
                             int V, int transposed, int splits, int tiles_per_chunk, float eps,
                             void* stream) {
  return xent_bwd_dx<float>(x, w, bias, targets, lse, g, dx, scratch, N, D, V, transposed,
                            splits, tiles_per_chunk, eps, static_cast<cudaStream_t>(stream));
}

NM_EXPORT int nm_xent_bwd_dx_bf16w(const void* x, const void* w, const void* bias,
                                   const void* targets, const void* lse, const void* g, void* dx,
                                   void* scratch, void* xs, int N, int D, int V, int transposed,
                                   int splits, float eps, void* stream) {
  return wgk::xent_bwd_dx_wg(x, w, bias, targets, lse, g, dx, scratch, xs, N, D, V, transposed,
                             splits, eps, static_cast<cudaStream_t>(stream));
}

NM_EXPORT int nm_xent_bwd_dx_bf16w_widened(const void* x, const void* w, const void* bias,
                                           const void* targets, const void* lse, const void* g,
                                           void* dx, void* scratch, int N, int D, int V,
                                           int transposed, int splits, int tiles_per_chunk,
                                           float eps, void* stream) {
  return xent_bwd_dx<__nv_bfloat16>(x, w, bias, targets, lse, g, dx, scratch, N, D, V,
                                    transposed, splits, tiles_per_chunk, eps,
                                    static_cast<cudaStream_t>(stream));
}

NM_EXPORT int nm_xent_bwd_dw(const void* x, const void* w, const void* bias, const void* targets,
                             const void* lse, const void* g, void* dw, void* db, void* scratch,
                             void* db_scratch, int N, int D, int V, int transposed, int splits,
                             int tiles_per_chunk, float eps, void* stream) {
  return xent_bwd_dw<float>(x, w, bias, targets, lse, g, dw, db, scratch, db_scratch, N, D, V,
                            transposed, splits, tiles_per_chunk, eps,
                            static_cast<cudaStream_t>(stream));
}

NM_EXPORT int nm_xent_bwd_dw_bf16w(const void* x, const void* w, const void* bias,
                                   const void* targets, const void* lse, const void* g, void* dw,
                                   void* db, void* scratch, void* db_scratch, void* xs, int N,
                                   int D, int V, int transposed, int splits, float eps,
                                   void* stream) {
  return wgk::xent_bwd_dw_wg(x, w, bias, targets, lse, g, dw, db, scratch, db_scratch, xs, N, D,
                             V, transposed, splits, eps, static_cast<cudaStream_t>(stream));
}

NM_EXPORT int nm_xent_bwd_dw_bf16w_widened(const void* x, const void* w, const void* bias,
                                           const void* targets, const void* lse, const void* g,
                                           void* dw, void* db, void* scratch, void* db_scratch,
                                           int N, int D, int V, int transposed, int splits,
                                           int tiles_per_chunk, float eps, void* stream) {
  return xent_bwd_dw<__nv_bfloat16>(x, w, bias, targets, lse, g, dw, db, scratch, db_scratch,
                                    N, D, V, transposed, splits, tiles_per_chunk, eps,
                                    static_cast<cudaStream_t>(stream));
}
