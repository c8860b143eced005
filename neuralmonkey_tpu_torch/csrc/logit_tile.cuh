// One 128 x 128 tile of a product, x W, on the SIMT units.
//
// Used, as logit_tile_rows, by the GRU BPTT's prologue (gru_bptt.cu), which
// computes the gates of every step. The logit projections (K3 and the fused
// cross-entropy, forward and backward) run their products on the tensor
// cores instead (tc_product.cuh). A block of 256 threads owns the tile;
// thread (tr, tc) = (tid / 16, tid % 16) accumulates rows tr * 8 .. + 8 and
// columns tc + 16 j, j < 8, so one shared-memory read feeds eight FMAs.
#pragma once

#include "common.cuh"

namespace nm {

constexpr int kTileM = 128;       // rows per tile
constexpr int kTileN = 128;       // columns per tile
constexpr int kTileK = 16;        // depth per shared-memory stage
constexpr int kThreadM = 8;       // rows per thread
constexpr int kThreadN = 8;       // columns per thread, strided by 16
constexpr int kTileThreads = 256;
constexpr int kTilePad = 4;       // row padding against bank conflicts
constexpr int kTileLd = kTileM + kTilePad;

struct TileStage {
  float a[kTileK][kTileLd];  // x tile, transposed: a[k][m]
  float b[kTileK][kTileLd];  // W tile: b[k][n]
};

__device__ __forceinline__ int tile_row() { return threadIdx.x / 16; }
__device__ __forceinline__ int tile_col() { return threadIdx.x % 16; }

template <int M, int N>
__device__ __forceinline__ void zero(float (&acc)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i][j] = 0.f;
}

// acc[i][j] = sum_{k < K} x[m0 + tr * 8 + i][k] * W(k, n0 + tc + 16 j) for W
// (K, V) row-major and x with rows ldx floats apart, which this launch wrote
// earlier: x is read through L2 (__ldcg), never the read-only path.
// Out-of-range rows, columns and depths contribute zero. Ends with a
// __syncthreads(), so `st` may be reused at once.
__device__ __forceinline__ void logit_tile_rows(const float* x, size_t ldx,
                                                const float* __restrict__ w, int N, int K,
                                                int V, int m0, int n0, TileStage& st,
                                                float (&acc)[kThreadM][kThreadN]) {
  const int tid = threadIdx.x;
  const int tr = tile_row(), tc = tile_col();
  zero(acc);
  for (int k0 = 0; k0 < K; k0 += kTileK) {
#pragma unroll
    for (int q = 0; q < kTileM * kTileK / kTileThreads; ++q) {
      const int e = tid + q * kTileThreads;
      const int m = e / kTileK, k = e % kTileK;
      const int gm = m0 + m, gk = k0 + k;
      st.a[k][m] = (gm < N && gk < K) ? __ldcg(x + gm * ldx + gk) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kTileK * kTileN / kTileThreads; ++q) {
      const int e = tid + q * kTileThreads;
      const int k = e / kTileN, n = e % kTileN;
      const int gk = k0 + k, gn = n0 + n;
      st.b[k][n] = (gk < K && gn < V) ? w[static_cast<size_t>(gk) * V + gn] : 0.f;
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
      float bv[kThreadN];
#pragma unroll
      for (int j = 0; j < kThreadN; ++j) bv[j] = st.b[k][tc + 16 * j];
#pragma unroll
      for (int i = 0; i < kThreadM; ++i)
#pragma unroll
        for (int j = 0; j < kThreadN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace nm
