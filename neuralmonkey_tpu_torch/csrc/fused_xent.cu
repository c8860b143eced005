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
// The bf16-W instances (nm_xent_*_bf16w: the bf16 compute policy, where the
// JAX package widens the bf16 use-site table beside float32 states and runs
// its float32 kernels) compute the same function with W read as bf16, half
// its bytes: each W tile is widened as it is staged (tc::load_widen), and
// every product with W takes two TF32 passes, not three, since a bf16 value
// has no low TF32 part. x, dx, dW (rounded to bf16 by the wrapper) and db
// stay float32.
#include <algorithm>

#include "tc_product.cuh"

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

}  // namespace

// The C entry points: W float32, and W bf16 (the _bf16w instances), with the
// same arguments; dW is float32 in both (the wrapper rounds it to bf16).
NM_EXPORT int nm_xent_fwd(const void* x, const void* w, const void* bias, const void* targets,
                          void* pmax, void* psum, void* plab, void* plsum, void* lse, void* nll,
                          int N, int D, int V, int transposed, float eps, void* stream) {
  return xent_fwd<float>(x, w, bias, targets, pmax, psum, plab, plsum, lse, nll, N, D, V,
                         transposed, eps, static_cast<cudaStream_t>(stream));
}

NM_EXPORT int nm_xent_fwd_bf16w(const void* x, const void* w, const void* bias,
                                const void* targets, void* pmax, void* psum, void* plab,
                                void* plsum, void* lse, void* nll, int N, int D, int V,
                                int transposed, float eps, void* stream) {
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
                                   void* scratch, int N, int D, int V, int transposed, int splits,
                                   int tiles_per_chunk, float eps, void* stream) {
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
                                   void* db, void* scratch, void* db_scratch, int N, int D, int V,
                                   int transposed, int splits, int tiles_per_chunk, float eps,
                                   void* stream) {
  return xent_bwd_dw<__nv_bfloat16>(x, w, bias, targets, lse, g, dw, db, scratch, db_scratch,
                                    N, D, V, transposed, splits, tiles_per_chunk, eps,
                                    static_cast<cudaStream_t>(stream));
}
