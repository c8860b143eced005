// gru_bptt: the reverse-time pass of the masked TF1-GRU scan's backward,
// all directions in one launch.
//
// Replaces neuralmonkey_tpu/ops/pallas_rnn.py `_gru_bwd_kernel` (called by
// `_bwd_pallas`). Starting from dc = gfinal, it visits the forward scan's steps
// in reverse and at each step
//   - recomputes g = sigmoid(xg_t + h_prev W_gh), r, u = split(g), and
//     c = tanh(xc_t + (r * h_prev) W_ch) from the saved pre-step state h_prev
//     (the forward's carries, shifted by the caller);
//   - emits the pre-activation gradients dxg_t = [dr, du] * g * (1 - g) and
//     dxc_t = dh' * (1 - u) * (1 - c^2), with dh' = m_t * (dc + gout_t), into dx,
//     laid out as the hoisted inputs x: [dxg (2H) | dxc (H)] per direction;
//   - carries dc = (1 - m_t) dc + dh' u + (dxc_t W_ch^T) * r + dxg_t W_gh^T, so a
//     padded step passes the carry through.
// The weight and input gradients are large products over B * T of these, done
// outside the kernel (ops/cuda_rnn.py, as XLA does them in `_gru_scan_bwd`).
//
// What bounds it on the H100: like K1 (gru_scan.cu) the steps are serial and
// each reads every recurrent matrix: here W_gh, W_ch and their transposes, 6 H^2
// floats (6 MB at H = 512) per step, streamed from L2, twice K1's bytes. The
// design is K1's: one block per (batch row, direction) keeps the time loop in
// the kernel with the row's vectors in shared memory (8 H floats) and 512
// threads keep many weight loads in flight; the transposes are made once per
// backward by the caller so that every product reads its matrix row-major,
// coalesced across threads. Recompute or store: the gates and the candidate are
// recomputed from h_prev, as the TPU kernel does, so the forward saves only the
// carries; storing r, u and c would drop W_gh and W_ch from the step's reads.
#include "common.cuh"

namespace {

constexpr int kCols = 2;  // output columns per thread per pass
constexpr int kThreads = 512;

// acc[c] = sum_{k < K} act[k] * w[k * ncols + j], j = j0 + threadIdx.x + c * kThreads,
// with act in shared memory (16-byte aligned) and w row-major of width ncols.
__device__ __forceinline__ void matvec(const float* __restrict__ act,
                                       const float* __restrict__ w, int K, int ncols,
                                       int j0, float (&acc)[kCols]) {
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
  const int K4 = K & ~3;
  for (int k = 0; k < K4; k += 4) {
    const float4 a = *reinterpret_cast<const float4*>(act + k);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int j = j0 + threadIdx.x + c * kThreads;
      if (j < ncols) {
        const float* wk = w + static_cast<size_t>(k) * ncols + j;
        float s = acc[c];
        s = fmaf(a.x, wk[0], s);
        s = fmaf(a.y, wk[ncols], s);
        s = fmaf(a.z, wk[2 * static_cast<size_t>(ncols)], s);
        s = fmaf(a.w, wk[3 * static_cast<size_t>(ncols)], s);
        acc[c] = s;
      }
    }
  }
  for (int k = K4; k < K; ++k) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int j = j0 + threadIdx.x + c * kThreads;
      if (j < ncols) acc[c] = fmaf(act[k], w[static_cast<size_t>(k) * ncols + j], acc[c]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gru_bptt_kernel(const float* __restrict__ x,       // (B, T, D * 3H) hoisted inputs
                const float* __restrict__ mask,    // (B, T)
                const float* __restrict__ hprev,   // (B, T, D * H) pre-step states
                const float* __restrict__ gout,    // (B, T, D * H) d outputs
                const float* __restrict__ gfinal,  // (B, D * H) d final states
                const float* __restrict__ wgh,     // (D, H, 2H)
                const float* __restrict__ wch,     // (D, H, H)
                const float* __restrict__ wght,    // (D, 2H, H) transposes
                const float* __restrict__ wcht,    // (D, H, H)
                float* __restrict__ dx,            // (B, T, D * 3H)
                int T, int H, int D, int reverse_mask) {
  extern __shared__ float smem[];
  const int Hs = (H + 3) & ~3;  // vector stride: keeps float4 reads aligned
  float* hp = smem;             // [Hs] h_prev of the step
  float* rh = hp + Hs;          // [Hs] r * h_prev
  float* g = rh + Hs;           // [2 Hs] gates r | u, contiguous over 2H
  float* dac = g + 2 * Hs;      // [Hs] d pre-activation of the candidate
  float* dg = dac + Hs;         // [2 Hs] d pre-activation of the gates
  float* dh = dg + 2 * Hs;      // [Hs] carried d state
  const int b = blockIdx.x;
  const int dir = blockIdx.y;
  const bool reverse = (reverse_mask >> dir) & 1;
  const float* w_g = wgh + static_cast<size_t>(dir) * H * 2 * H;
  const float* w_c = wch + static_cast<size_t>(dir) * H * H;
  const float* w_gt = wght + static_cast<size_t>(dir) * 2 * H * H;
  const float* w_ct = wcht + static_cast<size_t>(dir) * H * H;
  const size_t x_width = static_cast<size_t>(D) * 3 * H;
  const size_t h_width = static_cast<size_t>(D) * H;
  const size_t h_off = static_cast<size_t>(dir) * H;

  for (int i = threadIdx.x; i < H; i += kThreads)
    dh[i] = gfinal[static_cast<size_t>(b) * h_width + h_off + i];

  float acc[kCols];
  for (int s = 0; s < T; ++s) {
    // the forward visited t = 0 .. T-1 (T-1 .. 0 reversed); walk it backwards
    const int t = reverse ? s : T - 1 - s;
    const size_t bt = static_cast<size_t>(b) * T + t;
    const float* xt = x + bt * x_width + static_cast<size_t>(dir) * 3 * H;
    float* dxt = dx + bt * x_width + static_cast<size_t>(dir) * 3 * H;
    const float* go = gout + bt * h_width + h_off;
    const float m = mask[bt];
    for (int i = threadIdx.x; i < H; i += kThreads) hp[i] = hprev[bt * h_width + h_off + i];
    __syncthreads();
    // recompute g = sigmoid(xg + h_prev W_gh)
    for (int j0 = 0; j0 < 2 * H; j0 += kCols * kThreads) {
      matvec(hp, w_g, H, 2 * H, j0, acc);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = j0 + threadIdx.x + c * kThreads;
        if (j >= 2 * H) continue;
        const float gate = nm::sigmoid(xt[j] + acc[c]);
        g[j] = gate;
        if (j < H) rh[j] = gate * hp[j];
      }
    }
    __syncthreads();
    // recompute c = tanh(xc + (r * h_prev) W_ch); dxc, du and the direct carry terms
    for (int j0 = 0; j0 < H; j0 += kCols * kThreads) {
      matvec(rh, w_c, H, H, j0, acc);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = j0 + threadIdx.x + c * kThreads;
        if (j >= H) continue;
        const float cand = tanhf(xt[2 * H + j] + acc[c]);
        const float dc = dh[j];
        const float dnew = m * (dc + go[j]);
        const float u = g[H + j];
        const float du = dnew * (hp[j] - cand);
        const float a = dnew * (1.0f - u) * (1.0f - cand * cand);
        dac[j] = a;
        dxt[2 * H + j] = a;
        const float dgu = du * u * (1.0f - u);
        dg[H + j] = dgu;
        dxt[H + j] = dgu;
        dh[j] = (1.0f - m) * dc + dnew * u;
      }
    }
    __syncthreads();
    // d(r * h_prev) = dxc W_ch^T: dxg's r half and the r * h_prev carry term
    for (int j0 = 0; j0 < H; j0 += kCols * kThreads) {
      matvec(dac, w_ct, H, H, j0, acc);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = j0 + threadIdx.x + c * kThreads;
        if (j >= H) continue;
        const float r = g[j];
        const float dgr = acc[c] * hp[j] * r * (1.0f - r);
        dg[j] = dgr;
        dxt[j] = dgr;
        dh[j] += acc[c] * r;
      }
    }
    __syncthreads();
    // dc += dxg W_gh^T
    for (int j0 = 0; j0 < H; j0 += kCols * kThreads) {
      matvec(dg, w_gt, 2 * H, H, j0, acc);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = j0 + threadIdx.x + c * kThreads;
        if (j < H) dh[j] += acc[c];
      }
    }
    __syncthreads();
  }
}

}  // namespace

NM_EXPORT int nm_gru_bptt(const void* x, const void* mask, const void* hprev, const void* gout,
                          const void* gfinal, const void* wgh, const void* wch, const void* wght,
                          const void* wcht, void* dx, int B, int T, int H, int D,
                          int reverse_mask, void* stream) {
  const dim3 grid(B, D);
  const size_t smem = 8 * static_cast<size_t>((H + 3) & ~3) * sizeof(float);
  if (smem > 48 * 1024) {  // past the default: opt in, up to the SM's 227 KB
    const cudaError_t err = cudaFuncSetAttribute(
        gru_bptt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gru_bptt_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(mask),
      static_cast<const float*>(hprev), static_cast<const float*>(gout),
      static_cast<const float*>(gfinal), static_cast<const float*>(wgh),
      static_cast<const float*>(wch), static_cast<const float*>(wght),
      static_cast<const float*>(wcht), static_cast<float*>(dx), T, H, D, reverse_mask);
  return nm::launch_status();
}
