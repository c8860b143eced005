// lstm_scan: forward scan of a masked TF1-convention LSTM, all directions in
// one launch.
//
// Replaces neuralmonkey_tpu/ops/pallas_rnn.py `_lstm_scan_kernel` (called by
// `_lstm_scan_pallas`). Per step and direction it computes, with the input
// projection xz_t = x_t W_x + b hoisted out of the scan by the caller,
//   z  = xz_t + h W_h                 (gates in i, j, f, o order)
//   c' = c * sigmoid(f + forget_bias) + sigmoid(i) * tanh(j)
//   h' = tanh(c') * sigmoid(o)
// writes m_t * h' as the output and carries m_t * new + (1 - m_t) * old for
// both c and h, so padding holds the state. A reversed direction walks time
// from T-1 down to 0; the outputs keep the original time order. The final
// state is the carried h after the last step. When the caller will take
// gradients it passes `c_car` and `h_car` (B, T, D * H) and the kernel writes
// the carries after every step there, as `_lstm_scan_kernel` does with
// `save_carries`: the BPTT kernel (lstm_bptt.cu) restarts each step from them.
//
// What bounds it on the H100: each step must read the whole recurrent matrix
// W_h (4 H^2 floats, 4 MB at H = 512), far more than one SM's 227 KB of
// shared memory, and the steps are serial. The TPU kept W_h pinned in VMEM;
// here it streams from L2 (50 MB holds both directions' 8 MB) every step, so
// the scan is bound by L2 bandwidth and latency, not by its 2 B T D 4 H^2
// flops. The design is K1's (gru_scan.cu): one block per (batch row,
// direction) keeps the time loop inside the kernel, with h (double-buffered)
// and c in shared memory. Thread j owns hidden unit j and accumulates the four
// gate columns j, H + j, 2H + j, 3H + j of z, so neighbouring threads read
// neighbouring columns of W_h (coalesced) and the cell update needs no
// exchange: one barrier a step. A batch tile of several rows per block, which
// would reuse each W_h read, is left for a later change (for K1, one row per
// block measured faster than four).
#include "common.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
lstm_scan_kernel(const float* __restrict__ xz,    // (B, T, D * 4H) hoisted inputs
                 const float* __restrict__ mask,  // (B, T)
                 const float* __restrict__ wh,    // (D, H, 4H)
                 float* __restrict__ out,         // (B, T, D * H)
                 float* __restrict__ fin,         // (B, D * H)
                 float* __restrict__ c_car,       // (B, T, D * H) or null
                 float* __restrict__ h_car,       // (B, T, D * H) or null
                 int T, int H, int D, int reverse_mask, float forget_bias) {
  extern __shared__ float smem[];
  const int Hs = (H + 3) & ~3;  // vector stride: keeps float4 reads aligned
  float* hbuf[2] = {smem, smem + Hs};  // h before / after the step
  float* c = smem + 2 * Hs;            // carried cell state
  const int b = blockIdx.x;
  const int dir = blockIdx.y;
  const bool reverse = (reverse_mask >> dir) & 1;
  const int G = 4 * H;
  const float* w = wh + static_cast<size_t>(dir) * H * G;
  const size_t z_width = static_cast<size_t>(D) * G;
  const size_t o_width = static_cast<size_t>(D) * H;
  const size_t z_off = static_cast<size_t>(dir) * G;
  const size_t o_off = static_cast<size_t>(dir) * H;

  for (int i = threadIdx.x; i < Hs; i += kThreads) {
    hbuf[0][i] = 0.f;
    hbuf[1][i] = 0.f;
    c[i] = 0.f;
  }
  __syncthreads();

  const int H4 = H & ~3;
  int cur = 0;
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const size_t bt = static_cast<size_t>(b) * T + t;
    const float m = mask[bt];
    const float* zt = xz + bt * z_width + z_off;
    const float* h = hbuf[cur];
    float* hn = hbuf[cur ^ 1];
    for (int j = threadIdx.x; j < H; j += kThreads) {
      float ai = 0.f, aj = 0.f, af = 0.f, ao = 0.f;
      for (int k = 0; k < H4; k += 4) {
        const float4 a = *reinterpret_cast<const float4*>(h + k);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* wk = w + static_cast<size_t>(k + q) * G + j;
          ai = fmaf(av[q], wk[0], ai);
          aj = fmaf(av[q], wk[H], aj);
          af = fmaf(av[q], wk[2 * H], af);
          ao = fmaf(av[q], wk[3 * H], ao);
        }
      }
      for (int k = H4; k < H; ++k) {  // the last H % 4 rows of W_h
        const float* wk = w + static_cast<size_t>(k) * G + j;
        ai = fmaf(h[k], wk[0], ai);
        aj = fmaf(h[k], wk[H], aj);
        af = fmaf(h[k], wk[2 * H], af);
        ao = fmaf(h[k], wk[3 * H], ao);
      }
      const float si = nm::sigmoid(zt[j] + ai);
      const float tj = tanhf(zt[H + j] + aj);
      const float sf = nm::sigmoid(zt[2 * H + j] + af + forget_bias);
      const float so = nm::sigmoid(zt[3 * H + j] + ao);
      const float c_old = c[j];
      const float c_new = c_old * sf + si * tj;
      const float h_new = tanhf(c_new) * so;
      const float cc = m * c_new + (1.0f - m) * c_old;
      const float hc = m * h_new + (1.0f - m) * h[j];
      out[bt * o_width + o_off + j] = m * h_new;
      if (c_car != nullptr) {
        c_car[bt * o_width + o_off + j] = cc;
        h_car[bt * o_width + o_off + j] = hc;
      }
      c[j] = cc;  // only thread j touches c[j]
      hn[j] = hc;
    }
    __syncthreads();  // every read of h done and every h' written
    cur ^= 1;
  }
  for (int j = threadIdx.x; j < H; j += kThreads)
    fin[static_cast<size_t>(b) * o_width + o_off + j] = hbuf[cur][j];
}

}  // namespace

NM_EXPORT int nm_lstm_scan(const void* xz, const void* mask, const void* wh, void* out,
                           void* fin, void* c_car, void* h_car, int B, int T, int H, int D,
                           int reverse_mask, float forget_bias, void* stream) {
  const dim3 grid(B, D);
  const size_t smem = 3 * static_cast<size_t>((H + 3) & ~3) * sizeof(float);
  if (smem > 48 * 1024) {  // past the default: opt in, up to the SM's 227 KB
    const cudaError_t err = cudaFuncSetAttribute(
        lstm_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lstm_scan_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xz), static_cast<const float*>(mask),
      static_cast<const float*>(wh), static_cast<float*>(out), static_cast<float*>(fin),
      static_cast<float*>(c_car), static_cast<float*>(h_car), T, H, D, reverse_mask,
      forget_bias);
  return nm::launch_status();
}
