// lstm_bptt: the reverse-time pass of the masked TF1-LSTM scan's backward, all
// directions in one persistent launch.
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
// What bounds it on the H100: the steps are serial and each needs all of W_h
// twice (for z and for dz W_h^T), 16 B H^2 flops a step and direction, far more
// weight than one SM's 227 KB holds. Reading W_h from L2 once per batch row per
// step (one block per row) made L2 bandwidth the bound. So the design is
// lstm_scan.cu's: block j of a direction owns the hidden units u0 .. u0 + U and
// their four gate columns (u, H+u, 2H+u, 3H+u) and keeps that column slice of
// W_h in shared memory for the whole launch. Each step, for every batch row,
//   1. the block recomputes z for its columns, h_prev W_h[:, cols], from the
//      saved h_prev: no exchange between blocks is needed for it;
//   2. it runs the elementwise part for its units, writes their dz to dxz, and
//      carries dc and the direct part (1 - m) dh of its units in a scratch that
//      only it touches;
//   3. it multiplies its own dz columns by the same slice, dz[:, cols]
//      W_h[:, cols]^T, a (B, H) partial of dz W_h^T, and writes it to a
//      double-buffered (2, D, NB, B, H) scratch.
// Then the direction's blocks meet at a barrier (common.cuh), and at the next
// step each block sums the NB partials of its units in block order 0 .. NB-1
// (L2-coherent __ldcg reads, never the read-only path), adds the direct part,
// and has dh. One barrier a step; no atomics on values, so dxz is the same
// from run to run. The two products are float32 on the CUDA cores with
// lstm_scan's register tiles: z as 4 rows x 4 gate columns from float4 shared
// reads, optionally split over k; the partial as 4 rows x 4 outputs over the
// block's 4U columns. The slice's row stride is padded so that the partial's
// reads of four rows k apart fall in different banks.
//
// The plan (blocks per direction, units, rows per h tile, k tile, k split,
// shared bytes) comes from the wrapper (ops/cuda_rnn.py `lstm_bptt_plan`).
// Where the slice does not fit beside the h tile (a large H), both products
// stream it from L2 in k tiles, once each per row tile per step; where the
// rows do not fit, the block walks them in tiles. The launch is cooperative,
// so every block is resident or the launch is refused (and the wrapper
// raises).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
lstm_bptt_kernel(const float* __restrict__ xz,      // (B, T, D * 4H) hoisted inputs
                 const float* __restrict__ mask,    // (B, T)
                 const float* __restrict__ cprev,   // (B, T, D * H) pre-step c
                 const float* __restrict__ hprev,   // (B, T, D * H) pre-step h
                 const float* __restrict__ gout,    // (B, T, D * H) d outputs
                 const float* __restrict__ gfinal,  // (B, D * H) d final h
                 const float* __restrict__ wh,      // (D, H, 4H)
                 float* __restrict__ dxz,           // (B, T, D * 4H)
                 float* partial,                    // (2, D, NB, B, H) dz W_h^T parts
                 float* __restrict__ carry,         // (2, D, B, H): dc, (1 - m) dh
                 unsigned* sync,                    // (D, 2) zeros
                 int B, int T, int H, int D, int reverse_mask, int NB, int U, int R,
                 int KT, int KS, float forget_bias) {
  extern __shared__ float4 smem4[];
  const int dir = blockIdx.x / NB;
  const int blk = blockIdx.x % NB;
  const int u0 = blk * U;
  const int Ue = min(U, H - u0);  // units this block owns (the last may own fewer)
  const bool reverse = (reverse_mask >> dir) & 1;
  const int C = 4 * U;             // slice columns: gate g of unit u0 + uu at g * U + uu
  const int CS = 4 * (U + 1 + (U & 1));  // slice row stride: an odd number of float4s
  const int H4 = (H + 3) & ~3;
  const int HS = H4 + 4;           // h row stride: row tiles start in other banks
  const bool resident = KT >= H4;
  float* sw = reinterpret_cast<float*>(smem4);  // [KT][CS] W_h slice (or k tile)
  float* sh = sw + KT * CS;                       // [R][HS] h_prev of a row tile
  float* sz = sh + R * HS;                        // [KS][R][C] partial z; plane 0 then dz
  float* sm = sz + KS * R * C;                    // [R] mask of the row tile
  const int G = 4 * H;
  const float* w = wh + static_cast<size_t>(dir) * H * G;
  const size_t z_width = static_cast<size_t>(D) * G, h_width = static_cast<size_t>(D) * H;
  const size_t bh = static_cast<size_t>(B) * H;
  const size_t buffer = static_cast<size_t>(D) * NB * bh;  // one step's partials
  float* dcar = carry + static_cast<size_t>(dir) * bh;
  float* dhcar = carry + static_cast<size_t>(D + dir) * bh;

  // rows k0 .. k0 + kt of the slice, zero beyond H and beyond the units owned
  auto load_w = [&](int k0, int kt) {
    for (int i = threadIdx.x; i < kt * C; i += kThreads) {
      const int k = k0 + i / C, col = i % C, g = col / U, uu = col % U;
      sw[(i / C) * CS + col] =
          (k < H && uu < Ue) ? w[static_cast<size_t>(k) * G + g * H + u0 + uu] : 0.f;
    }
  };
  if (resident) load_w(0, H4);

  for (int s = 0; s < T; ++s) {
    // the forward visited t = 0 .. T-1 (T-1 .. 0 reversed); walk it backwards
    const int t = reverse ? s : T - 1 - s;
    const bool last = s == T - 1;  // no dh is carried out of the last step
    const float* pin = partial + ((s + 1) & 1) * buffer + static_cast<size_t>(dir) * NB * bh;
    float* pout = partial + (s & 1) * buffer + (static_cast<size_t>(dir) * NB + blk) * bh;
    for (int r0 = 0; r0 < B; r0 += R) {
      const int nr = min(R, B - r0);
      // stage the h_prev rows of this tile at step t
      if ((H & 3) == 0) {
        for (int i = threadIdx.x; i < nr * (H4 / 4); i += kThreads) {
          const int r = i / (H4 / 4), k = (i % (H4 / 4)) * 4;
          const size_t bt = static_cast<size_t>(r0 + r) * T + t;
          nm::cp_async16(sh + r * HS + k, hprev + bt * h_width + static_cast<size_t>(dir) * H + k,
                         16);
        }
        nm::cp_async_commit();
      } else {
        for (int i = threadIdx.x; i < nr * H4; i += kThreads) {
          const int r = i / H4, k = i % H4;
          const size_t bt = static_cast<size_t>(r0 + r) * T + t;
          sh[r * HS + k] = k < H ? hprev[bt * h_width + static_cast<size_t>(dir) * H + k] : 0.f;
        }
      }
      for (int r = threadIdx.x; r < nr; r += kThreads)
        sm[r] = mask[static_cast<size_t>(r0 + r) * T + t];
      nm::cp_async_wait<0>();

      // 1. z for the block's columns: h_prev W_h[:, cols]
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
              wv[q] = *reinterpret_cast<const float4*>(sw + (k + q) * CS + 4 * cg);
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

      // 2. the elementwise part for this tile's rows and this block's units;
      // dz replaces plane 0 of the sums (each slot read and written by one
      // thread), zero in the columns of units the block does not own
      for (int idx = threadIdx.x; idx < nr * U; idx += kThreads) {
        const int r = idx / U, uu = idx % U, b = r0 + r, u = u0 + uu;
        float* dzr = sz + r * C + uu;
        if (uu >= Ue) {
#pragma unroll
          for (int g = 0; g < 4; ++g) dzr[g * U] = 0.f;
          continue;
        }
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
        const size_t o = bt * h_width + static_cast<size_t>(dir) * H + u;
        const float c_prev = cprev[o];
        const float tc = tanhf(c_prev * sf + si * tj);
        const size_t bu = static_cast<size_t>(b) * H + u;
        float dh, dc;
        if (s == 0) {
          dh = gfinal[static_cast<size_t>(b) * h_width + static_cast<size_t>(dir) * H + u];
          dc = 0.f;
        } else {
          // dz W_h^T of the step before: the NB partials in block order
          float sum = 0.f;
          for (int j = 0; j < NB; ++j) sum += __ldcg(pin + j * bh + bu);
          dh = dhcar[bu] + sum;
          dc = dcar[bu];
        }
        const float dh_new = m * (dh + gout[o]);
        const float dc_new = m * dc + dh_new * so * (1.0f - tc * tc);
        const float gi = dc_new * tj * si * (1.0f - si);
        const float gj = dc_new * si * (1.0f - tj * tj);
        const float gf = dc_new * c_prev * sf * (1.0f - sf);
        const float go = dh_new * tc * so * (1.0f - so);
        float* dzt = dxz + bt * z_width + static_cast<size_t>(dir) * G + u;
        dzt[0] = gi;
        dzt[H] = gj;
        dzt[2 * H] = gf;
        dzt[3 * H] = go;
        dzr[0] = gi;
        dzr[U] = gj;
        dzr[2 * U] = gf;
        dzr[3 * U] = go;
        dcar[bu] = (1.0f - m) * dc + dc_new * sf;
        dhcar[bu] = (1.0f - m) * dh;
      }

      // 3. this block's part of dz W_h^T for the tile's rows: thread task
      // (rg, kg) sums rows 4 rg .. + 4 at outputs kg + q kt / 4, q < 4, over
      // the block's 4U columns
      if (!last) {
        for (int k0 = 0; k0 < H4; k0 += KT) {
          const int kt = min(KT, H4 - k0);
          if (!resident) {
            __syncthreads();  // the previous k tile is consumed
            load_w(k0, kt);
          }
          __syncthreads();  // dz (and the k tile) complete
          const int KQ = kt / 4;
          for (int idx = threadIdx.x; idx < row_groups * KQ; idx += kThreads) {
            const int kg = idx % KQ, rg = idx / KQ;
            const float* drow[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) drow[r] = sz + min(4 * rg + r, nr - 1) * C;
            float acc[4][4] = {};
            for (int c = 0; c < C; c += 4) {
              float4 wv[4];
#pragma unroll
              for (int q = 0; q < 4; ++q)
                wv[q] = *reinterpret_cast<const float4*>(sw + (kg + q * KQ) * CS + c);
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const float4 dv = *reinterpret_cast<const float4*>(drow[r] + c);
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  acc[r][q] = fmaf(dv.x, wv[q].x, acc[r][q]);
                  acc[r][q] = fmaf(dv.y, wv[q].y, acc[r][q]);
                  acc[r][q] = fmaf(dv.z, wv[q].z, acc[r][q]);
                  acc[r][q] = fmaf(dv.w, wv[q].w, acc[r][q]);
                }
              }
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              if (4 * rg + r >= nr) break;
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int k = k0 + kg + q * KQ;
                if (k < H) pout[static_cast<size_t>(r0 + 4 * rg + r) * H + k] = acc[r][q];
              }
            }
          }
        }
      }
      __syncthreads();  // the tile's h, mask and dz are consumed
    }
    if (!last) nm::direction_barrier(sync + 2 * dir, NB);
  }
}

}  // namespace

NM_EXPORT int nm_lstm_bptt(const void* xz, const void* mask, const void* cprev,
                           const void* hprev, const void* gout, const void* gfinal,
                           const void* wh, void* dxz, void* partial, void* carry, void* sync,
                           int B, int T, int H, int D, int reverse_mask, int blocks_per_dir,
                           int units, int rows, int k_tile, int k_split, int smem,
                           float forget_bias, void* stream) {
  if (B < 1 || T < 1 || H < 1 || D < 1 || blocks_per_dir < 1 || units < 1 ||
      (blocks_per_dir - 1) * units >= H || blocks_per_dir * units < H || rows < 1 ||
      k_tile < 4 || (k_tile & 3) || k_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t cols = 4 * static_cast<size_t>(units);
  const size_t stride = 4 * static_cast<size_t>(units + 1 + (units & 1));
  const size_t needed = sizeof(float) * (k_tile * stride + rows * (((H + 3) & ~3) + 4) +
                                         k_split * rows * cols + rows);
  if (static_cast<size_t>(smem) < needed) return static_cast<int>(cudaErrorInvalidValue);
  const int status = nm::allow_max_smem(reinterpret_cast<const void*>(lstm_bptt_kernel));
  if (status != 0) return status;
  const float* xz_ = static_cast<const float*>(xz);
  const float* mask_ = static_cast<const float*>(mask);
  const float* cprev_ = static_cast<const float*>(cprev);
  const float* hprev_ = static_cast<const float*>(hprev);
  const float* gout_ = static_cast<const float*>(gout);
  const float* gfinal_ = static_cast<const float*>(gfinal);
  const float* wh_ = static_cast<const float*>(wh);
  float* dxz_ = static_cast<float*>(dxz);
  float* partial_ = static_cast<float*>(partial);
  float* carry_ = static_cast<float*>(carry);
  unsigned* sync_ = static_cast<unsigned*>(sync);
  void* args[] = {&xz_,    &mask_,   &cprev_, &hprev_, &gout_,  &gfinal_,        &wh_,
                  &dxz_,   &partial_, &carry_, &sync_,  &B,      &T,              &H,
                  &D,      &reverse_mask, &blocks_per_dir, &units, &rows, &k_tile, &k_split,
                  &forget_bias};
  // cooperative: every block resident, or cudaErrorCooperativeLaunchTooLarge
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(lstm_bptt_kernel), dim3(blocks_per_dir * D), dim3(kThreads),
      args, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves the error for the next one
    return static_cast<int>(err);
  }
  return nm::launch_status();
}
