// K3: logit projection with the beam selector's reductions in its epilogue.
// K4: exact small top-k with lowest-index tie-breaking.
//
// K3 replaces neuralmonkey_tpu/ops/beam_select.py `_fused_kernel` (called by
// `_fused_pallas`): logits = x W + b for x (N, Dm), W (Dm, Vp), b (Vp), with
// Vp a multiple of 128, plus rowmax (N, Vp / 128), the maximum of every
// 128-column group, and lse (N), the log-sum-exp of each whole row.
//
// What bounds K3 on the H100: the f32 product (2 N Dm Vp flops, 20 GFLOP at
// N = 640, Dm = 512, Vp = 30720) on the SIMT units; the logits write (79 MB)
// is second. The design: a tiled SIMT GEMM whose block tile is 128 rows by
// exactly 128 columns, so each block's per-row maximum IS one rowmax entry.
// Each thread accumulates an 8 x 8 tile, so one shared-memory read feeds
// eight FMAs (on an H100 80GB HBM3 at 700 W, 128-row tiles took 0.65 ms at
// the serving shape, 64-row tiles with 4 x 8 per thread 0.95 ms).
// The TPU folded the log-sum-exp across its sequential vocabulary grid; Hopper
// blocks run in no order, so each block writes a per-row partial sum of
// exp(logit - rowmax) into an (N, R) scratch and a second small kernel folds
// the R partials of a row into lse. The logits are written once and never
// re-read. Tensor cores (wgmma, TF32 or bf16) are left for a later change.
//
// K4 replaces `_topk_kernel` (called by `_topk_pallas`): the k largest values
// of each short row (k = beam, rows of K * R or K * 128 entries) in
// descending order, ties to the lowest index like lax.top_k. What bounds it:
// launch latency and the k serial rounds, not bytes. The design: one block per
// row holds the row in shared memory and runs k rounds of a block-wide arg-max
// under the order (value descending, index ascending); a round only considers
// entries that come after the previous winner in that order, so winners need
// no knocking out and an index is never picked twice.
#include "logit_tile.cuh"

namespace {

__global__ void __launch_bounds__(nm::kTileThreads)
fused_logits_kernel(const float* __restrict__ x,     // (N, Dm)
                    const float* __restrict__ w,     // (Dm, Vp)
                    const float* __restrict__ bias,  // (Vp)
                    float* __restrict__ logits,      // (N, Vp)
                    float* __restrict__ rowmax,      // (N, R)
                    float* __restrict__ psum,        // (N, R) scratch
                    int N, int Dm, int Vp) {
  using namespace nm;
  __shared__ __align__(16) TileStage st;
  const int tr = tile_row(), tc = tile_col();
  const int n0 = blockIdx.x * kTileN;
  const int m0 = blockIdx.y * kTileM;
  const int R = Vp / kTileN;

  float acc[kThreadM][kThreadN];
  logit_tile<false>(x, w, N, Dm, Vp, m0, n0, st, acc);

  float bv[kThreadN];
#pragma unroll
  for (int j = 0; j < kThreadN; ++j) bv[j] = bias[n0 + tc + 16 * j];
#pragma unroll
  for (int i = 0; i < kThreadM; ++i) {
    const int gm = m0 + tr * kThreadM + i;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kThreadN; ++j) {
      acc[i][j] += bv[j];
      mx = fmaxf(mx, acc[i][j]);
    }
    mx = row_reduce_max(mx);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kThreadN; ++j) s += expf(acc[i][j] - mx);
    s = row_reduce_sum(s);
    if (gm < N) {
      float* row = logits + static_cast<size_t>(gm) * Vp + n0;
#pragma unroll
      for (int j = 0; j < kThreadN; ++j) row[tc + 16 * j] = acc[i][j];
      if (tc == 0) {
        rowmax[static_cast<size_t>(gm) * R + blockIdx.x] = mx;
        psum[static_cast<size_t>(gm) * R + blockIdx.x] = s;
      }
    }
  }
}

// lse[n] = M + log(sum_r psum[n, r] * exp(rowmax[n, r] - M)), M = max_r rowmax
__global__ void lse_fold_kernel(const float* __restrict__ rowmax,
                                const float* __restrict__ psum,
                                float* __restrict__ lse, int N, int R) {
  const int n = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (n >= N) return;
  const float* rm = rowmax + static_cast<size_t>(n) * R;
  const float* ps = psum + static_cast<size_t>(n) * R;
  float mx = -INFINITY;
  for (int r = lane; r < R; r += 32) mx = fmaxf(mx, rm[r]);
  mx = nm::warp_max(mx);
  float s = 0.f;
  for (int r = lane; r < R; r += 32) s += ps[r] * expf(rm[r] - mx);
  s = nm::warp_sum(s);
  if (lane == 0) lse[n] = mx + logf(s);
}

constexpr int kTopkThreads = 256;

// a ranks before b: larger value first, then lower index
__device__ __forceinline__ bool ranks_before(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

__global__ void __launch_bounds__(kTopkThreads)
small_topk_kernel(const float* __restrict__ x,  // (B, n)
                  float* __restrict__ vals,     // (B, k)
                  int* __restrict__ idx,        // (B, k)
                  int n, int k) {
  extern __shared__ float row[];  // [n]
  __shared__ float warp_v[kTopkThreads / 32];
  __shared__ int warp_i[kTopkThreads / 32];
  __shared__ float win_v;
  __shared__ int win_i;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < n; i += kTopkThreads) row[i] = x[static_cast<size_t>(b) * n + i];
  __syncthreads();

  // every entry comes after the sentinel (+inf, -1)
  float prev_v = INFINITY;
  int prev_i = -1;
  for (int round = 0; round < k; ++round) {
    float best_v = -INFINITY;
    int best_i = INT_MAX;
    for (int i = threadIdx.x; i < n; i += kTopkThreads) {
      const float v = row[i];
      if (ranks_before(prev_v, prev_i, v, i) && ranks_before(v, i, best_v, best_i)) {
        best_v = v;
        best_i = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(nm::kFullMask, best_v, off);
      const int oi = __shfl_xor_sync(nm::kFullMask, best_i, off);
      if (ranks_before(ov, oi, best_v, best_i)) {
        best_v = ov;
        best_i = oi;
      }
    }
    if (lane == 0) {
      warp_v[warp] = best_v;
      warp_i[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      best_v = lane < kTopkThreads / 32 ? warp_v[lane] : -INFINITY;
      best_i = lane < kTopkThreads / 32 ? warp_i[lane] : INT_MAX;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(nm::kFullMask, best_v, off);
        const int oi = __shfl_xor_sync(nm::kFullMask, best_i, off);
        if (ranks_before(ov, oi, best_v, best_i)) {
          best_v = ov;
          best_i = oi;
        }
      }
      if (lane == 0) {
        vals[static_cast<size_t>(b) * k + round] = best_v;
        idx[static_cast<size_t>(b) * k + round] = best_i;
        win_v = best_v;
        win_i = best_i;
      }
    }
    __syncthreads();
    prev_v = win_v;
    prev_i = win_i;
  }
}

}  // namespace

NM_EXPORT int nm_fused_logits(const void* x, const void* w, const void* bias, void* logits,
                              void* rowmax, void* psum, void* lse, int N, int Dm, int Vp,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = Vp / nm::kTileN;
  const dim3 grid(R, (N + nm::kTileM - 1) / nm::kTileM);
  fused_logits_kernel<<<grid, nm::kTileThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(logits),
      static_cast<float*>(rowmax), static_cast<float*>(psum), N, Dm, Vp);
  int status = nm::launch_status();
  if (status != 0) return status;
  constexpr int kRowsPerBlock = 8;
  lse_fold_kernel<<<(N + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, 0, s>>>(
      static_cast<const float*>(rowmax), static_cast<const float*>(psum),
      static_cast<float*>(lse), N, R);
  return nm::launch_status();
}

NM_EXPORT int nm_small_topk(const void* x, void* vals, void* idx, int B, int n, int k,
                            void* stream) {
  small_topk_kernel<<<B, kTopkThreads, static_cast<size_t>(n) * sizeof(float),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(vals), static_cast<int*>(idx), n, k);
  return nm::launch_status();
}

NM_EXPORT const char* nm_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
