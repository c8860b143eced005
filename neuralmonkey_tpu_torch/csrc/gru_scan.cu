// K1: forward scan of a masked TF1-convention GRU, all directions in one launch.
//
// Replaces neuralmonkey_tpu/ops/pallas_rnn.py `_gru_scan_kernel` (called by
// `_gru_scan_pallas`). Per step and direction it computes
//   g  = sigmoid(xg_t + h W_gh),  r, u = split(g)
//   c  = tanh(xc_t + (r * h) W_ch)
//   h' = u * h + (1 - u) * c
// writes m_t * h' as the output and carries m_t * h' + (1 - m_t) * h, so padding
// holds the state. A reversed direction walks time from T-1 down to 0. The
// input projections xg, xc are hoisted out of the scan into one matmul by the
// caller (as in the TPU version). When the caller will take gradients it passes
// `carries` (B, T, D * H), and the kernel also writes the carry after every
// step there, as `_gru_scan_kernel` does with `save_carries`: the BPTT kernel
// (gru_bptt.cu) restarts each step from it.
//
// What bounds it on the H100: each step must read both recurrent matrices
// (3 H^2 floats, 3 MB at H = 512), far more than one SM's 227 KB of shared
// memory, and the steps are serial. The TPU kept the weights pinned in VMEM;
// here they stream from L2 (50 MB holds both directions) every step, so the
// scan is bound by L2 bandwidth and latency. The design: one block per
// (direction, batch row) keeps the time loop inside the kernel with h, r*h
// and u in shared memory, and 512 threads keep many weight loads in flight.
// On an H100 80GB HBM3 at 700 W, at B = 64, T = 32, H = 512 this took 1.8 ms
// against 3.4 ms for blocks of 4 rows and 256 threads: the per-block loads
// hide L2 latency better than row reuse saves bytes. Splitting the columns
// across a cluster, so that fewer bytes reach each SM per step, is left for
// a later change.
#include "common.cuh"

namespace {

constexpr int kRows = 1;      // batch rows per block
constexpr int kCols = 2;      // output columns per thread per pass
constexpr int kThreads = 512;

// acc[c][r] = sum_k act[r][k] * w[k][j0 + tid + c * kThreads] over k < H, with
// act in shared memory (row stride Hs, a multiple of 4) and w of width ncols.
__device__ __forceinline__ void tile_matvec(const float* __restrict__ act,
                                            const float* __restrict__ w, int H, int Hs,
                                            int ncols, int j0,
                                            float (&acc)[kCols][kRows]) {
#pragma unroll
  for (int c = 0; c < kCols; ++c)
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[c][r] = 0.f;
  const int H4 = H & ~3;
  for (int k = 0; k < H4; k += 4) {
    float4 a[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      a[r] = *reinterpret_cast<const float4*>(act + r * Hs + k);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int j = j0 + threadIdx.x + c * kThreads;
      if (j < ncols) {
        const float* wk = w + static_cast<size_t>(k) * ncols + j;
        const float w0 = wk[0];
        const float w1 = wk[ncols];
        const float w2 = wk[2 * static_cast<size_t>(ncols)];
        const float w3 = wk[3 * static_cast<size_t>(ncols)];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float s = acc[c][r];
          s = fmaf(a[r].x, w0, s);
          s = fmaf(a[r].y, w1, s);
          s = fmaf(a[r].z, w2, s);
          s = fmaf(a[r].w, w3, s);
          acc[c][r] = s;
        }
      }
    }
  }
  // the last H % 4 rows of w, one at a time
  for (int k = H4; k < H; ++k) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int j = j0 + threadIdx.x + c * kThreads;
      if (j < ncols) {
        const float wk = w[static_cast<size_t>(k) * ncols + j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[c][r] = fmaf(act[r * Hs + k], wk, acc[c][r]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gru_scan_kernel(const float* __restrict__ x,     // (B, T, D * 3H): [xg | xc] per direction
                const float* __restrict__ mask,  // (B, T)
                const float* __restrict__ wgh,   // (D, H, 2H)
                const float* __restrict__ wch,   // (D, H, H)
                float* __restrict__ out,         // (B, T, D * H)
                float* __restrict__ fin,         // (B, D * H)
                float* __restrict__ carries,     // (B, T, D * H) or null
                int B, int T, int H, int D, int reverse_mask) {
  extern __shared__ float smem[];
  const int Hs = (H + 3) & ~3;  // row stride: keeps float4 reads aligned
  float* h = smem;              // [kRows][Hs] carried state
  float* rh = h + kRows * Hs;   // [kRows][Hs] r * h
  float* ug = rh + kRows * Hs;  // [kRows][Hs] update gate u
  const int dir = blockIdx.y;
  const int b0 = blockIdx.x * kRows;
  const bool reverse = (reverse_mask >> dir) & 1;
  const float* w_gates = wgh + static_cast<size_t>(dir) * H * 2 * H;
  const float* w_cand = wch + static_cast<size_t>(dir) * H * H;
  const size_t x_width = static_cast<size_t>(D) * 3 * H;
  const size_t o_width = static_cast<size_t>(D) * H;
  const size_t x_off = static_cast<size_t>(dir) * 3 * H;

  for (int i = threadIdx.x; i < kRows * Hs; i += kThreads) h[i] = 0.f;
  __syncthreads();

  float acc[kCols][kRows];
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    // gates = sigmoid(xg_t + h W_gh): r lands in rh (as r * h), u in ug
    for (int j0 = 0; j0 < 2 * H; j0 += kCols * kThreads) {
      tile_matvec(h, w_gates, H, Hs, 2 * H, j0, acc);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = j0 + threadIdx.x + c * kThreads;
        if (j >= 2 * H) continue;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int b = b0 + r;
          const float xg = b < B ? x[(static_cast<size_t>(b) * T + t) * x_width + x_off + j] : 0.f;
          const float g = nm::sigmoid(xg + acc[c][r]);
          if (j < H) {
            rh[r * Hs + j] = g * h[r * Hs + j];
          } else {
            ug[r * Hs + j - H] = g;
          }
        }
      }
    }
    __syncthreads();
    // candidate = tanh(xc_t + (r * h) W_ch); new state, masked output
    for (int j0 = 0; j0 < H; j0 += kCols * kThreads) {
      tile_matvec(rh, w_cand, H, Hs, H, j0, acc);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = j0 + threadIdx.x + c * kThreads;
        if (j >= H) continue;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int b = b0 + r;
          if (b >= B) continue;
          const size_t bt = static_cast<size_t>(b) * T + t;
          const float m = mask[bt];
          const float cand = tanhf(x[bt * x_width + x_off + 2 * H + j] + acc[c][r]);
          const float prev = h[r * Hs + j];
          const float u = ug[r * Hs + j];
          const float nh = u * prev + (1.0f - u) * cand;
          const float carry = m * nh + (1.0f - m) * prev;
          out[bt * o_width + static_cast<size_t>(dir) * H + j] = m * nh;
          if (carries != nullptr) carries[bt * o_width + static_cast<size_t>(dir) * H + j] = carry;
          h[r * Hs + j] = carry;
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < kRows * H; i += kThreads) {
    const int b = b0 + i / H;
    if (b < B)
      fin[static_cast<size_t>(b) * o_width + static_cast<size_t>(dir) * H + i % H] =
          h[(i / H) * Hs + i % H];
  }
}

}  // namespace

NM_EXPORT int nm_gru_scan(const void* x, const void* mask, const void* wgh, const void* wch,
                          void* out, void* fin, void* carries, int B, int T, int H, int D,
                          int reverse_mask, void* stream) {
  const dim3 grid((B + kRows - 1) / kRows, D);
  const size_t smem = 3 * static_cast<size_t>(kRows) * ((H + 3) & ~3) * sizeof(float);
  if (smem > 48 * 1024) {  // past the default: opt in, up to the SM's 227 KB
    const cudaError_t err = cudaFuncSetAttribute(
        gru_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gru_scan_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(mask),
      static_cast<const float*>(wgh), static_cast<const float*>(wch),
      static_cast<float*>(out), static_cast<float*>(fin), static_cast<float*>(carries), B, T, H,
      D, reverse_mask);
  return nm::launch_status();
}
