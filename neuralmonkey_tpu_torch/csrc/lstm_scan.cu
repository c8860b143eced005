// lstm_scan: forward scan of a masked TF1-convention LSTM, all directions in
// one persistent launch.
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
// What bounds it on the H100: the steps are serial and each needs the whole
// recurrent matrix W_h (4 H^2 floats, 4 MB a direction at H = 512), far more
// than one SM's 227 KB. The TPU kept W_h pinned in VMEM. Reading it from L2
// once per batch row per step, as one block per row must, makes L2 bandwidth
// the bound (17 GB over 32 steps at B 64). So W_h is split by hidden unit
// across a persistent grid: block j of a direction owns the units
// u0 .. u0 + U and their four gate columns (u, H+u, 2H+u, 3H+u), keeps that
// slice in shared memory for the whole launch and computes its units' gates
// for every batch row at each step; the cell update needs nothing from other
// blocks. Each weight byte then leaves L2 once per launch, and the bound is
// the 2 B H 4H flops a step spread over the direction's SMs, in float32 on the
// CUDA cores: each thread accumulates a 4-row x 4-column tile from float4
// shared reads (8 reads feed 64 FMAs), optionally split over k.
//
// Between steps h travels through global memory: each block writes its units'
// carried h into a double-buffered (2, D, B, H) scratch, then the direction's
// blocks meet at a barrier (an arrival counter and a generation word per
// direction), and every block stages the whole h of all rows for the next
// step with L2-coherent reads: cp.async.cg copies, all in flight at once
// (or __ldcg where H % 4 != 0), never the read-only path or L1, since h
// changes during the launch. The launch is cooperative, so every block is
// resident or the launch is refused (and the wrapper raises). The cell
// state c lives in the scratch's third plane, touched only by its owning
// block.
//
// The plan (blocks per direction, units per block, rows per h tile, k tile,
// k split, shared bytes) comes from the wrapper (ops/cuda_rnn.py
// `lstm_scan_plan`). Where the W_h slice does not fit beside the h tile (a
// large H), the same kernel streams it from L2 in k tiles, once per row tile
// per step; where the rows do not fit, it walks them in tiles.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
lstm_scan_kernel(const float* __restrict__ xz,    // (B, T, D * 4H) hoisted inputs
                 const float* __restrict__ mask,  // (B, T)
                 const float* __restrict__ wh,    // (D, H, 4H)
                 float* __restrict__ out,         // (B, T, D * H)
                 float* __restrict__ fin,         // (B, D * H)
                 float* __restrict__ c_car,       // (B, T, D * H) or null
                 float* __restrict__ h_car,       // (B, T, D * H) or null
                 float* scratch,                  // (3, D, B, H): h twice, c
                 unsigned* sync,                  // (D, 2) zeros
                 int B, int T, int H, int D, int reverse_mask, int NB, int U, int R,
                 int KT, int KS, float forget_bias) {
  extern __shared__ float4 smem4[];
  const int dir = blockIdx.x / NB;
  const int u0 = (blockIdx.x % NB) * U;
  const int Ue = min(U, H - u0);  // units this block owns (the last may own fewer)
  const bool reverse = (reverse_mask >> dir) & 1;
  const int C = 4 * U;            // slice columns: gate g of unit u0 + uu at g * U + uu
  const int H4 = (H + 3) & ~3;
  const int HS = H4 + 4;          // h row stride: row tiles start in other banks
  const bool resident = KT >= H4;
  float* sw = reinterpret_cast<float*>(smem4);  // [KT][C] W_h slice (or k tile)
  float* sh = sw + KT * C;                        // [R][HS] h of a row tile
  float* sz = sh + R * HS;                        // [KS][R][C] partial gate sums
  float* sm = sz + KS * R * C;                    // [R] mask of the row tile
  const int G = 4 * H;
  const float* w = wh + static_cast<size_t>(dir) * H * G;
  const size_t plane = static_cast<size_t>(D) * B * H;
  float* cbuf = scratch + 2 * plane + static_cast<size_t>(dir) * B * H;
  const size_t z_width = static_cast<size_t>(D) * G, o_width = static_cast<size_t>(D) * H;

  // rows k0 .. k0 + kt of the slice, zero beyond H and beyond the units owned
  auto load_w = [&](int k0, int kt) {
    for (int i = threadIdx.x; i < kt * C; i += kThreads) {
      const int k = k0 + i / C, col = i % C, g = col / U, uu = col % U;
      sw[i] = (k < H && uu < Ue) ? w[static_cast<size_t>(k) * G + g * H + u0 + uu] : 0.f;
    }
  };
  if (resident) load_w(0, H4);

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const float* hin = scratch + (s & 1) * plane + static_cast<size_t>(dir) * B * H;
    float* hout = scratch + ((s + 1) & 1) * plane + static_cast<size_t>(dir) * B * H;
    for (int r0 = 0; r0 < B; r0 += R) {
      const int nr = min(R, B - r0);
      // stage the h rows of this tile (zero before the first step): all
      // copies in flight at once, through L2 only
      if ((H & 3) == 0) {
        for (int i = threadIdx.x; i < nr * (H4 / 4); i += kThreads) {
          const int r = i / (H4 / 4), k = (i % (H4 / 4)) * 4;
          nm::cp_async16(sh + r * HS + k, hin + static_cast<size_t>(r0 + r) * H + k,
                         s == 0 ? 0 : 16);
        }
        nm::cp_async_commit();
      } else {
        for (int i = threadIdx.x; i < nr * H4; i += kThreads) {
          const int r = i / H4, k = i % H4;
          sh[r * HS + k] =
              (s == 0 || k >= H) ? 0.f : __ldcg(hin + static_cast<size_t>(r0 + r) * H + k);
        }
      }
      for (int r = threadIdx.x; r < nr; r += kThreads)
        sm[r] = mask[static_cast<size_t>(r0 + r) * T + t];
      nm::cp_async_wait<0>();

      const int row_groups = (nr + 3) / 4;
      const int tasks = U * row_groups;
      for (int k0 = 0; k0 < H4; k0 += KT) {
        const int kt = min(KT, H4 - k0);
        if (!resident) {
          __syncthreads();  // the previous k tile is consumed
          load_w(k0, kt);
        }
        __syncthreads();
        const int span = ((kt + KS - 1) / KS + 3) & ~3;
        for (int idx = threadIdx.x; idx < tasks * KS; idx += kThreads) {
          const int ks = idx / tasks, task = idx % tasks;
          const int cg = task % U, rg = task / U;
          const int ka = ks * span, kb = min(kt, ka + span);
          const float* hrow[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)  // rows past the tile repeat its last row
            hrow[r] = sh + min(4 * rg + r, nr - 1) * HS + k0;
          float acc[4][4] = {};
          for (int k = ka; k < kb; k += 4) {
            float4 wv[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              wv[q] = *reinterpret_cast<const float4*>(sw + (k + q) * C + 4 * cg);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float4 hv = *reinterpret_cast<const float4*>(hrow[r] + k);
              const float hq[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                acc[r][0] = fmaf(hq[q], wv[q].x, acc[r][0]);
                acc[r][1] = fmaf(hq[q], wv[q].y, acc[r][1]);
                acc[r][2] = fmaf(hq[q], wv[q].z, acc[r][2]);
                acc[r][3] = fmaf(hq[q], wv[q].w, acc[r][3]);
              }
            }
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if (4 * rg + r >= nr) break;
            float4* zp = reinterpret_cast<float4*>(sz + (ks * R + 4 * rg + r) * C + 4 * cg);
            float4 z = k0 == 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : *zp;
            z.x += acc[r][0];
            z.y += acc[r][1];
            z.z += acc[r][2];
            z.w += acc[r][3];
            *zp = z;
          }
        }
      }
      __syncthreads();

      // the cell update of this tile's rows and this block's units
      for (int idx = threadIdx.x; idx < nr * Ue; idx += kThreads) {
        const int r = idx / Ue, uu = idx % Ue, b = r0 + r, u = u0 + uu;
        float z[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float acc = 0.f;
          for (int ks = 0; ks < KS; ++ks) acc += sz[(ks * R + r) * C + g * U + uu];
          z[g] = acc;
        }
        const size_t bt = static_cast<size_t>(b) * T + t;
        const float* zt = xz + bt * z_width + static_cast<size_t>(dir) * G;
        const float m = sm[r];
        const float si = nm::sigmoid(zt[u] + z[0]);
        const float tj = tanhf(zt[H + u] + z[1]);
        const float sf = nm::sigmoid(zt[2 * H + u] + z[2] + forget_bias);
        const float so = nm::sigmoid(zt[3 * H + u] + z[3]);
        const size_t bu = static_cast<size_t>(b) * H + u;
        const float c_old = s == 0 ? 0.f : cbuf[bu];
        const float h_old = sh[r * HS + u];
        const float c_new = c_old * sf + si * tj;
        const float h_new = tanhf(c_new) * so;
        const float cc = m * c_new + (1.0f - m) * c_old;
        const float hc = m * h_new + (1.0f - m) * h_old;
        const size_t o = bt * o_width + static_cast<size_t>(dir) * H + u;
        out[o] = m * h_new;
        if (c_car != nullptr) {
          c_car[o] = cc;
          h_car[o] = hc;
        }
        cbuf[bu] = cc;
        hout[bu] = hc;
        if (s == T - 1) fin[static_cast<size_t>(b) * o_width + static_cast<size_t>(dir) * H + u] = hc;
      }
      __syncthreads();  // the tile's h, mask and sums are consumed
    }
    if (s + 1 < T) nm::direction_barrier(sync + 2 * dir, NB);
  }
}

}  // namespace

NM_EXPORT int nm_lstm_scan(const void* xz, const void* mask, const void* wh, void* out,
                           void* fin, void* c_car, void* h_car, void* scratch, void* sync,
                           int B, int T, int H, int D, int reverse_mask, int blocks_per_dir,
                           int units, int rows, int k_tile, int k_split, int smem,
                           float forget_bias, void* stream) {
  if (B < 1 || T < 1 || H < 1 || D < 1 || blocks_per_dir < 1 || units < 1 ||
      (blocks_per_dir - 1) * units >= H || blocks_per_dir * units < H || rows < 1 ||
      k_tile < 4 || (k_tile & 3) || k_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t cols = 4 * static_cast<size_t>(units);
  const size_t needed = sizeof(float) * (k_tile * cols + rows * (((H + 3) & ~3) + 4) +
                                         k_split * rows * cols + rows);
  if (static_cast<size_t>(smem) < needed) return static_cast<int>(cudaErrorInvalidValue);
  const int status = nm::allow_max_smem(reinterpret_cast<const void*>(lstm_scan_kernel));
  if (status != 0) return status;
  const float* xz_ = static_cast<const float*>(xz);
  const float* mask_ = static_cast<const float*>(mask);
  const float* wh_ = static_cast<const float*>(wh);
  float* out_ = static_cast<float*>(out);
  float* fin_ = static_cast<float*>(fin);
  float* c_car_ = static_cast<float*>(c_car);
  float* h_car_ = static_cast<float*>(h_car);
  float* scratch_ = static_cast<float*>(scratch);
  unsigned* sync_ = static_cast<unsigned*>(sync);
  void* args[] = {&xz_,   &mask_, &wh_, &out_,  &fin_,         &c_car_,        &h_car_,
                  &scratch_, &sync_, &B,  &T,    &H,           &D,             &reverse_mask,
                  &blocks_per_dir, &units, &rows, &k_tile, &k_split, &forget_bias};
  // cooperative: every block resident, or cudaErrorCooperativeLaunchTooLarge
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(lstm_scan_kernel), dim3(blocks_per_dir * D), dim3(kThreads),
      args, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves the error for the next one
    return static_cast<int>(err);
  }
  return nm::launch_status();
}
