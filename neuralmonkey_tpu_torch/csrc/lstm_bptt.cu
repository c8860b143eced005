// lstm_bptt: the reverse-time pass of the masked TF1-LSTM scan's backward, all
// directions in one launch.
//
// Replaces neuralmonkey_tpu/ops/pallas_rnn.py `_lstm_bwd_kernel` (called by
// `_lstm_scan_bwd`). Starting from dc = 0 and dh = gfinal, it visits the
// forward scan's steps in reverse and at each step
//   - recomputes z = xz_t + h_prev W_h, the gates si = sigmoid(i), tj = tanh(j),
//     sf = sigmoid(f + forget_bias), so = sigmoid(o) and tc = tanh(c') with
//     c' = c_prev sf + si tj, from the saved pre-step c_prev and h_prev (the
//     forward's carries, shifted by the caller);
//   - with dh' = m_t (dh + gout_t) and dc' = m_t dc + dh' so (1 - tc^2), emits
//     the pre-activation gradients dz_t = [dc' tj si (1 - si), dc' si (1 - tj^2),
//     dc' c_prev sf (1 - sf), dh' tc so (1 - so)] into dxz, laid out as xz;
//   - carries dc = (1 - m_t) dc + dc' sf and dh = (1 - m_t) dh + dz_t W_h^T, so
//     a padded step passes both carries through.
// This is the arithmetic of `_lstm_bwd_kernel`. The weight and input gradients
// are large products over B * T of dz, done outside the kernel
// (ops/cuda_rnn.py, as XLA does them in `_lstm_scan_bwd`).
//
// What bounds it on the H100: the steps are serial and each reads W_h and its
// transpose, 8 H^2 floats (8 MB at H = 512) per step and direction, streamed
// from L2, twice the forward's bytes. The design is gru_bptt.cu's: one block
// per (batch row, direction) keeps the time loop in the kernel with the row's
// vectors in shared memory (7 H floats: h_prev, dz, dc, dh); thread j owns
// hidden unit j for the elementwise part (its four gate columns of z, read
// coalesced across threads), and output column j of dz W_h^T, which reads the
// transpose made once per backward by the caller row-major, coalesced too.
// Two barriers a step.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
lstm_bptt_kernel(const float* __restrict__ xz,      // (B, T, D * 4H) hoisted inputs
                 const float* __restrict__ mask,    // (B, T)
                 const float* __restrict__ cprev,   // (B, T, D * H) pre-step c
                 const float* __restrict__ hprev,   // (B, T, D * H) pre-step h
                 const float* __restrict__ gout,    // (B, T, D * H) d outputs
                 const float* __restrict__ gfinal,  // (B, D * H) d final h
                 const float* __restrict__ wh,      // (D, H, 4H)
                 const float* __restrict__ wht,     // (D, 4H, H) transposes
                 float* __restrict__ dxz,           // (B, T, D * 4H)
                 int T, int H, int D, int reverse_mask, float forget_bias) {
  extern __shared__ float smem[];
  const int Hs = (H + 3) & ~3;  // vector stride: keeps float4 reads aligned
  float* hp = smem;             // [Hs] h_prev of the step
  float* dz = hp + Hs;          // [4 Hs] dz of the step, gates contiguous over 4H
  float* dc = dz + 4 * Hs;      // [Hs] carried d cell state
  float* dh = dc + Hs;          // [Hs] carried d h
  const int b = blockIdx.x;
  const int dir = blockIdx.y;
  const bool reverse = (reverse_mask >> dir) & 1;
  const int G = 4 * H;
  const float* w = wh + static_cast<size_t>(dir) * H * G;
  const float* wt = wht + static_cast<size_t>(dir) * G * H;
  const size_t z_width = static_cast<size_t>(D) * G;
  const size_t h_width = static_cast<size_t>(D) * H;
  const size_t z_off = static_cast<size_t>(dir) * G;
  const size_t h_off = static_cast<size_t>(dir) * H;

  for (int j = threadIdx.x; j < H; j += kThreads) {
    dc[j] = 0.f;
    dh[j] = gfinal[static_cast<size_t>(b) * h_width + h_off + j];
  }

  const int H4 = H & ~3;
  for (int s = 0; s < T; ++s) {
    // the forward visited t = 0 .. T-1 (T-1 .. 0 reversed); walk it backwards
    const int t = reverse ? s : T - 1 - s;
    const size_t bt = static_cast<size_t>(b) * T + t;
    const float m = mask[bt];
    const float* zt = xz + bt * z_width + z_off;
    float* dzt = dxz + bt * z_width + z_off;
    for (int j = threadIdx.x; j < H; j += kThreads) hp[j] = hprev[bt * h_width + h_off + j];
    __syncthreads();  // hp written; the last step's reads of dz done
    // recompute z, the gates and c'; emit dz; carry dc and the direct dh term
    for (int j = threadIdx.x; j < H; j += kThreads) {
      float ai = 0.f, aj = 0.f, af = 0.f, ao = 0.f;
      for (int k = 0; k < H4; k += 4) {
        const float4 a = *reinterpret_cast<const float4*>(hp + k);
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
      for (int k = H4; k < H; ++k) {
        const float* wk = w + static_cast<size_t>(k) * G + j;
        ai = fmaf(hp[k], wk[0], ai);
        aj = fmaf(hp[k], wk[H], aj);
        af = fmaf(hp[k], wk[2 * H], af);
        ao = fmaf(hp[k], wk[3 * H], ao);
      }
      const float si = nm::sigmoid(zt[j] + ai);
      const float tj = tanhf(zt[H + j] + aj);
      const float sf = nm::sigmoid(zt[2 * H + j] + af + forget_bias);
      const float so = nm::sigmoid(zt[3 * H + j] + ao);
      const float c_prev = cprev[bt * h_width + h_off + j];
      const float tc = tanhf(c_prev * sf + si * tj);
      const float dh_new = m * (dh[j] + gout[bt * h_width + h_off + j]);
      const float dc_new = m * dc[j] + dh_new * so * (1.0f - tc * tc);
      const float gi = dc_new * tj * si * (1.0f - si);
      const float gj = dc_new * si * (1.0f - tj * tj);
      const float gf = dc_new * c_prev * sf * (1.0f - sf);
      const float go = dh_new * tc * so * (1.0f - so);
      dz[j] = gi;
      dz[H + j] = gj;
      dz[2 * H + j] = gf;
      dz[3 * H + j] = go;
      dzt[j] = gi;
      dzt[H + j] = gj;
      dzt[2 * H + j] = gf;
      dzt[3 * H + j] = go;
      dc[j] = (1.0f - m) * dc[j] + dc_new * sf;
      dh[j] = (1.0f - m) * dh[j];
    }
    __syncthreads();  // dz complete
    // dh += dz W_h^T, with W_h^T (4H, H) row-major
    for (int j = threadIdx.x; j < H; j += kThreads) {
      float acc = 0.f;
      for (int k = 0; k < G; k += 4) {  // G = 4H: whole float4s of dz
        const float4 a = *reinterpret_cast<const float4*>(dz + k);
        const float* wk = wt + static_cast<size_t>(k) * H + j;
        acc = fmaf(a.x, wk[0], acc);
        acc = fmaf(a.y, wk[H], acc);
        acc = fmaf(a.z, wk[2 * static_cast<size_t>(H)], acc);
        acc = fmaf(a.w, wk[3 * static_cast<size_t>(H)], acc);
      }
      dh[j] += acc;
    }
  }
}

}  // namespace

NM_EXPORT int nm_lstm_bptt(const void* xz, const void* mask, const void* cprev,
                           const void* hprev, const void* gout, const void* gfinal,
                           const void* wh, const void* wht, void* dxz, int B, int T, int H,
                           int D, int reverse_mask, float forget_bias, void* stream) {
  const dim3 grid(B, D);
  const size_t smem = 7 * static_cast<size_t>((H + 3) & ~3) * sizeof(float);
  if (smem > 48 * 1024) {  // past the default: opt in, up to the SM's 227 KB
    const cudaError_t err = cudaFuncSetAttribute(
        lstm_bptt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lstm_bptt_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xz), static_cast<const float*>(mask),
      static_cast<const float*>(cprev), static_cast<const float*>(hprev),
      static_cast<const float*>(gout), static_cast<const float*>(gfinal),
      static_cast<const float*>(wh), static_cast<const float*>(wht), static_cast<float*>(dxz),
      T, H, D, reverse_mask, forget_bias);
  return nm::launch_status();
}
