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
// What bounds it on the H100: the f32 products on the SIMT units (2 N D V flops
// per logit pass: 94 GFLOP at N = 3072, D = 512, V = 30000), not bytes; the
// inputs are 3 + 61 MB. The TPU ran one sequential grid with the online
// log-sum-exp carried in scratch; Hopper blocks run in no order, so:
//   - xent_fwd: one block per (128-row, 128-column) tile computes the logit tile
//     (logit_tile.cuh, as K3 does) and writes per-row partials (tile max, sum of
//     exp(t - max), label logit, logit sum) into (N, R) scratch; a second small
//     kernel folds the R partials of each row into lse and nll (K3's pattern).
//   - xent_bwd_dx: one block per (128 rows, 128 columns of D) walks all R vocab
//     tiles: it recomputes the logit tile, forms dl in shared memory and
//     accumulates dl W^T for its columns in registers. Each logit tile is
//     recomputed once per 128 columns of D.
//   - xent_bwd_dw: one block per (vocab tile, 128 rows of D) walks all row tiles
//     the same way and accumulates x^T dl, and db for the first D block, in
//     registers: sums run in one fixed order inside a block, with no atomics,
//     so dW and db do not change from run to run.
// Tensor cores (TF32 would change the numerics, bf16 the inputs) and fewer
// recomputations are left for a later change.
#include "logit_tile.cuh"

namespace {

using nm::kThreadM;
using nm::kThreadN;
using nm::kTileK;
using nm::kTileLd;
using nm::kTileM;
using nm::kTileN;
using nm::kTileThreads;
using nm::TileStage;

// per-row partials of one logit tile, reduced over the tile's columns
__global__ void __launch_bounds__(kTileThreads)
xent_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, const int* __restrict__ targets,
                float* __restrict__ pmax, float* __restrict__ psum,
                float* __restrict__ plab, float* __restrict__ plsum,
                int N, int D, int V, int transposed) {
  __shared__ __align__(16) TileStage st;
  const int tr = nm::tile_row(), tc = nm::tile_col();
  const int n0 = blockIdx.x * kTileN;
  const int m0 = blockIdx.y * kTileM;
  const int R = gridDim.x;

  float acc[kThreadM][kThreadN];
  if (transposed)
    nm::logit_tile<true>(x, w, N, D, V, m0, n0, st, acc);
  else
    nm::logit_tile<false>(x, w, N, D, V, m0, n0, st, acc);

#pragma unroll
  for (int i = 0; i < kThreadM; ++i) {
    const int gm = m0 + tr * kThreadM + i;
    const int target = gm < N ? targets[gm] : -1;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kThreadN; ++j) {
      const int gn = n0 + tc + 16 * j;
      if (gn < V) {
        acc[i][j] += bias[gn];
        mx = fmaxf(mx, acc[i][j]);
      }
    }
    mx = nm::row_reduce_max(mx);
    float s = 0.f, lab = 0.f, ls = 0.f;
#pragma unroll
    for (int j = 0; j < kThreadN; ++j) {
      const int gn = n0 + tc + 16 * j;
      if (gn < V) {
        s += expf(acc[i][j] - mx);
        ls += acc[i][j];
        if (gn == target) lab = acc[i][j];
      }
    }
    s = nm::row_reduce_sum(s);
    lab = nm::row_reduce_sum(lab);
    ls = nm::row_reduce_sum(ls);
    if (gm < N && tc == 0) {
      const size_t at = static_cast<size_t>(gm) * R + blockIdx.x;
      pmax[at] = mx;
      psum[at] = s;
      plab[at] = lab;
      plsum[at] = ls;
    }
  }
}

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

// acc <- dl of the logit tile (rows m0.., columns n0..) held in acc, zero
// outside the N x V range
__device__ __forceinline__ void tile_dlogits(float (&acc)[kThreadM][kThreadN],
                                             const float* __restrict__ bias,
                                             const int* __restrict__ targets,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ g, int N, int V,
                                             int m0, int n0, float eps) {
  const int tr = nm::tile_row(), tc = nm::tile_col();
#pragma unroll
  for (int i = 0; i < kThreadM; ++i) {
    const int gm = m0 + tr * kThreadM + i;
    const bool row_ok = gm < N;
    const int target = row_ok ? targets[gm] : -1;
    const float l = row_ok ? lse[gm] : 0.f;
    const float gr = row_ok ? g[gm] : 0.f;
#pragma unroll
    for (int j = 0; j < kThreadN; ++j) {
      const int gn = n0 + tc + 16 * j;
      float d = 0.f;
      if (row_ok && gn < V) {
        d = expf(acc[i][j] + bias[gn] - l) - (gn == target ? 1.0f - eps : 0.f);
        if (eps != 0.f) d -= eps / V;
        d *= gr;
      }
      acc[i][j] = d;
    }
  }
}

// dx (N, D) for columns d0 .. d0 + 128 of D and rows m0 .. m0 + 128
template <bool kWT>
__device__ __forceinline__ void xent_bwd_dx(const float* __restrict__ x,
                                            const float* __restrict__ w,
                                            const float* __restrict__ bias,
                                            const int* __restrict__ targets,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ g, float* __restrict__ dx,
                                            int N, int D, int V, float eps, float* smem) {
  TileStage& st = *reinterpret_cast<TileStage*>(smem);
  float(*dlt)[kTileLd] = reinterpret_cast<float(*)[kTileLd]>(smem + sizeof(TileStage) / 4);
  const int tid = threadIdx.x;
  const int tr = nm::tile_row(), tc = nm::tile_col();
  const int d0 = blockIdx.x * kTileN;
  const int m0 = blockIdx.y * kTileM;

  float out[kThreadM][kThreadN];
  nm::zero(out);
  float acc[kThreadM][kThreadN];
  for (int n0 = 0; n0 < V; n0 += kTileN) {
    nm::logit_tile<kWT>(x, w, N, D, V, m0, n0, st, acc);
    tile_dlogits(acc, bias, targets, lse, g, N, V, m0, n0, eps);
    // dl, transposed: dlt[v][m], the A operand of dl W^T
#pragma unroll
    for (int i = 0; i < kThreadM; ++i)
#pragma unroll
      for (int j = 0; j < kThreadN; ++j) dlt[tc + 16 * j][tr * kThreadM + i] = acc[i][j];
    for (int k0 = 0; k0 < kTileN; k0 += kTileK) {
      // st.b[k][d] = W(d0 + d, n0 + k0 + k), coalesced along W's contiguous axis
#pragma unroll
      for (int q = 0; q < kTileK * kTileN / kTileThreads; ++q) {
        const int e = tid + q * kTileThreads;
        const int k = kWT ? e / kTileN : e % kTileK;
        const int d = kWT ? e % kTileN : e / kTileK;
        const int gv = n0 + k0 + k, gd = d0 + d;
        float v = 0.f;
        if (gv < V && gd < D)
          v = kWT ? w[static_cast<size_t>(gv) * D + gd] : w[static_cast<size_t>(gd) * V + gv];
        st.b[k][d] = v;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kTileK; ++k) {
        float av[kThreadM];
#pragma unroll
        for (int i = 0; i < kThreadM; i += 4) {
          const float4 a = *reinterpret_cast<const float4*>(&dlt[k0 + k][tr * kThreadM + i]);
          av[i] = a.x;
          av[i + 1] = a.y;
          av[i + 2] = a.z;
          av[i + 3] = a.w;
        }
#pragma unroll
        for (int i = 0; i < kThreadM; ++i)
#pragma unroll
          for (int j = 0; j < kThreadN; ++j)
            out[i][j] = fmaf(av[i], st.b[k][tc + 16 * j], out[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < kThreadM; ++i) {
    const int gm = m0 + tr * kThreadM + i;
    if (gm >= N) continue;
#pragma unroll
    for (int j = 0; j < kThreadN; ++j) {
      const int gd = d0 + tc + 16 * j;
      if (gd < D) dx[static_cast<size_t>(gm) * D + gd] = out[i][j];
    }
  }
}

// dW for vocabulary tile n0 .. n0 + 128 and rows d0 .. d0 + 128 of D; db too
// when d0 == 0
template <bool kWT>
__device__ __forceinline__ void xent_bwd_dw(const float* __restrict__ x,
                                            const float* __restrict__ w,
                                            const float* __restrict__ bias,
                                            const int* __restrict__ targets,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ g, float* __restrict__ dw,
                                            float* __restrict__ db, int N, int D, int V,
                                            float eps, float* smem) {
  TileStage& st = *reinterpret_cast<TileStage*>(smem);
  float(*dl)[kTileLd] = reinterpret_cast<float(*)[kTileLd]>(smem + sizeof(TileStage) / 4);
  const int tid = threadIdx.x;
  const int tr = nm::tile_row(), tc = nm::tile_col();
  const int n0 = blockIdx.x * kTileN;
  const int d0 = blockIdx.y * kTileM;

  float out[kThreadM][kThreadN];  // dW(d0 + tr * 8 + i, n0 + tc + 16 j)
  nm::zero(out);
  float bsum = 0.f;  // db[n0 + tid] for tid < 128
  float acc[kThreadM][kThreadN];
  for (int m0 = 0; m0 < N; m0 += kTileM) {
    nm::logit_tile<kWT>(x, w, N, D, V, m0, n0, st, acc);
    tile_dlogits(acc, bias, targets, lse, g, N, V, m0, n0, eps);
    // dl[m][v], the B operand of x^T dl
#pragma unroll
    for (int i = 0; i < kThreadM; ++i)
#pragma unroll
      for (int j = 0; j < kThreadN; ++j) dl[tr * kThreadM + i][tc + 16 * j] = acc[i][j];
    __syncthreads();
    if (d0 == 0 && tid < kTileN)
      for (int m = 0; m < kTileM; ++m) bsum += dl[m][tid];
    for (int k0 = 0; k0 < kTileM; k0 += kTileK) {
      // st.a[k][d] = x[m0 + k0 + k][d0 + d], coalesced along d
#pragma unroll
      for (int q = 0; q < kTileK * kTileM / kTileThreads; ++q) {
        const int e = tid + q * kTileThreads;
        const int k = e / kTileM, d = e % kTileM;
        const int gm = m0 + k0 + k, gd = d0 + d;
        st.a[k][d] = (gm < N && gd < D) ? x[static_cast<size_t>(gm) * D + gd] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kTileK; ++k) {
        float av[kThreadM];
#pragma unroll
        for (int i = 0; i < kThreadM; i += 4) {
          const float4 a = *reinterpret_cast<const float4*>(&st.a[k][tr * kThreadM + i]);
          av[i] = a.x;
          av[i + 1] = a.y;
          av[i + 2] = a.z;
          av[i + 3] = a.w;
        }
#pragma unroll
        for (int i = 0; i < kThreadM; ++i)
#pragma unroll
          for (int j = 0; j < kThreadN; ++j)
            out[i][j] = fmaf(av[i], dl[k0 + k][tc + 16 * j], out[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < kThreadM; ++i) {
    const int gd = d0 + tr * kThreadM + i;
    if (gd >= D) continue;
#pragma unroll
    for (int j = 0; j < kThreadN; ++j) {
      const int gn = n0 + tc + 16 * j;
      if (gn >= V) continue;
      if (kWT)
        dw[static_cast<size_t>(gn) * D + gd] = out[i][j];
      else
        dw[static_cast<size_t>(gd) * V + gn] = out[i][j];
    }
  }
  if (d0 == 0 && tid < kTileN && n0 + tid < V) db[n0 + tid] = bsum;
}

// the backward kernels keep one stage and a 128 x 132 dl tile in dynamic
// shared memory (84 KB)
constexpr size_t kBwdSmem = sizeof(TileStage) + sizeof(float) * kTileN * kTileLd;

__global__ void __launch_bounds__(kTileThreads)
xent_bwd_dx_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, const int* __restrict__ targets,
                   const float* __restrict__ lse, const float* __restrict__ g,
                   float* __restrict__ dx, int N, int D, int V, int transposed, float eps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  if (transposed)
    xent_bwd_dx<true>(x, w, bias, targets, lse, g, dx, N, D, V, eps, smem);
  else
    xent_bwd_dx<false>(x, w, bias, targets, lse, g, dx, N, D, V, eps, smem);
}

__global__ void __launch_bounds__(kTileThreads)
xent_bwd_dw_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, const int* __restrict__ targets,
                   const float* __restrict__ lse, const float* __restrict__ g,
                   float* __restrict__ dw, float* __restrict__ db, int N, int D, int V,
                   int transposed, float eps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  if (transposed)
    xent_bwd_dw<true>(x, w, bias, targets, lse, g, dw, db, N, D, V, eps, smem);
  else
    xent_bwd_dw<false>(x, w, bias, targets, lse, g, dw, db, N, D, V, eps, smem);
}

template <typename Kernel>
int allow_smem(Kernel kernel) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kBwdSmem)));
}

}  // namespace

NM_EXPORT int nm_xent_fwd(const void* x, const void* w, const void* bias, const void* targets,
                          void* pmax, void* psum, void* plab, void* plsum, void* lse, void* nll,
                          int N, int D, int V, int transposed, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = (V + kTileN - 1) / kTileN;
  const dim3 grid(R, (N + kTileM - 1) / kTileM);
  xent_fwd_kernel<<<grid, kTileThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
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

NM_EXPORT int nm_xent_bwd_dx(const void* x, const void* w, const void* bias, const void* targets,
                             const void* lse, const void* g, void* dx, int N, int D, int V,
                             int transposed, float eps, void* stream) {
  const int err = allow_smem(xent_bwd_dx_kernel);
  if (err != 0) return err;
  const dim3 grid((D + kTileN - 1) / kTileN, (N + kTileM - 1) / kTileM);
  xent_bwd_dx_kernel<<<grid, kTileThreads, kBwdSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(targets),
      static_cast<const float*>(lse), static_cast<const float*>(g), static_cast<float*>(dx), N,
      D, V, transposed, eps);
  return nm::launch_status();
}

NM_EXPORT int nm_xent_bwd_dw(const void* x, const void* w, const void* bias, const void* targets,
                             const void* lse, const void* g, void* dw, void* db, int N, int D,
                             int V, int transposed, float eps, void* stream) {
  const int err = allow_smem(xent_bwd_dw_kernel);
  if (err != 0) return err;
  const dim3 grid((V + kTileN - 1) / kTileN, (D + kTileM - 1) / kTileM);
  xent_bwd_dw_kernel<<<grid, kTileThreads, kBwdSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(targets),
      static_cast<const float*>(lse), static_cast<const float*>(g), static_cast<float*>(dw),
      static_cast<float*>(db), N, D, V, transposed, eps);
  return nm::launch_status();
}
