// gru_bptt: the reverse-time pass of the masked TF1-GRU scan's backward, all
// directions in one persistent launch.
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
// What bounds it on the H100: the steps are serial and each needs W_gh and
// W_ch twice (for the gates and the candidate, and for the products with
// their transposes), 12 B H^2 flops a step and direction, far more weight than
// one SM's 227 KB holds; read from L2 once per batch row per step (the first
// design) they made L2 bandwidth the bound. Of a step's work only dh is
// serial: the gates and the candidate depend on the saved h_prev alone. So
//   0. a prologue computes them for every (b, t) row as two GEMMs over the
//      direction's B T rows, in 128 x 128 SIMT tiles (logit_tile.cuh's)
//      spread over the direction's blocks: r and u from h_prev (writing r,
//      u and r * h_prev to a scratch), a barrier, then c from the rows of
//      r * h_prev, and a barrier;
// and the serial part is lstm_bptt.cu's design: block j of a direction owns
// the hidden units u0 .. u0 + U (U a multiple of 4) and keeps their three gate
// columns (W_gh's u and H + u, W_ch's u) in shared memory for the rest of the
// launch. Each step, for every batch row,
//   1. the block runs the elementwise part for its units: dxc and du u (1 - u)
//      to dx, and the direct carry (1 - m) dh + dh' u to a scratch only it
//      touches;
//   2. it writes its part of dxc W_ch^T, dxc[:, own] W_ch[:, own]^T, a (B, H)
//      partial, to a scratch;
//   3. barrier 1; it sums the NB partials of its units in block order
//      0 .. NB-1, which gives a = (dxc W_ch^T)[own], writes dr = a h_prev
//      r (1 - r) to dx and adds a r to the direct carry;
//   4. it writes its part of dxg W_gh^T, [dr, du u (1 - u)][:, own]
//      [W_gh[:, own], W_gh[:, H + own]]^T, to a second scratch;
//   5. barrier 2; at the next step each block sums those partials of its
//      units in block order and adds the direct carry: dh.
// Two barriers a step (each scratch is read before the other barrier lets
// any block write it again); values written in the launch are read with
// __ldcg (L2-coherent, never the read-only path); no atomics on values, so dx
// is the same from run to run. The partial products are float32 on the CUDA
// cores in register tiles of 8 rows x 4 outputs over the block's columns of
// one or two gates; the slice is kept transposed ([gate column][k]), so that
// a tile's four outputs are one float4 read of a column and one float4 store
// of a row, neighbouring threads on neighbouring outputs.
//
// The plan (blocks per direction, units, rows per tile, k tile, shared bytes)
// comes from the wrapper (ops/cuda_rnn.py `gru_bptt_plan`). Where the slice
// does not fit (a large H), the partial products stream it from L2 in k
// tiles; where the rows do not fit, the block walks them in tiles. The launch
// is cooperative, so every block is resident or the launch is refused (and
// the wrapper raises).
#include <algorithm>

#include "logit_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kInFlight = 32;  // loads of an exchange sum issued together
constexpr int kRows = 8;       // batch rows of a partial product's thread task

// sum_j p[j * stride], j < n, in the order 0 .. n-1, through L2 (the values
// come from other blocks of the launch), kInFlight loads at a time
__device__ __forceinline__ float ordered_sum(const float* p, size_t stride, int n) {
  float sum = 0.f;
  int j = 0;
  for (; j + kInFlight <= n; j += kInFlight) {
    float v[kInFlight];
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) v[q] = __ldcg(p + (j + q) * stride);
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) sum += v[q];
  }
  for (; j < n; ++j) sum += __ldcg(p + j * stride);
  return sum;
}

// this block's part of d W^T for the tile's nr rows over this k tile:
// pout[row][k0 + k] = sum over the slice rows c0 .. c0 + n (a multiple of 4)
// of sd[row][c] * slice[c][k], the slice stored [c][k] with rows WS floats
// apart; thread task (rg, kq) sums rows kRows rg .. + kRows at the outputs
// 4 kq .. 4 kq + 3: one float4 read of the slice a column, one float4 store a
// row (scalar stores where rows of H floats are not 16-byte aligned)
__device__ __forceinline__ void partial_product(const float* sd, int C, const float* sw, int WS,
                                                int c0, int n, float* pout, int H, int nr,
                                                int k0, int kt) {
  const int KQ = kt / 4, G = (nr + kRows - 1) / kRows;
  for (int idx = threadIdx.x; idx < G * KQ; idx += kThreads) {
    const int kq = idx % KQ, rg = idx / KQ;
    const float* drow[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)  // rows past the tile repeat its last row
      drow[r] = sd + min(kRows * rg + r, nr - 1) * C + c0;
    float acc[kRows][4] = {};
    for (int c = 0; c < n; c += 4) {
      float4 wv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wv[q] = *reinterpret_cast<const float4*>(sw + (c0 + c + q) * WS + 4 * kq);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 dv = *reinterpret_cast<const float4*>(drow[r] + c);
        const float dq[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[r][0] = fmaf(dq[q], wv[q].x, acc[r][0]);
          acc[r][1] = fmaf(dq[q], wv[q].y, acc[r][1]);
          acc[r][2] = fmaf(dq[q], wv[q].z, acc[r][2]);
          acc[r][3] = fmaf(dq[q], wv[q].w, acc[r][3]);
        }
      }
    }
    const int k = k0 + 4 * kq;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (kRows * rg + r >= nr) break;
      float* out = pout + static_cast<size_t>(kRows * rg + r) * H + k;
      if ((H & 3) == 0 && k + 3 < H) {
        *reinterpret_cast<float4*>(out) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (k + q < H) out[q] = acc[r][q];
      }
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
                float* __restrict__ dx,            // (B, T, D * 3H)
                float* gate_scratch,               // (4, B, T, D * H) r, u, c, r * h_prev
                float* partial,                    // (2, D, NB, B, H) dxc W_ch^T, dxg W_gh^T parts
                float* __restrict__ carry,         // (D, B, H) the direct part of dh
                unsigned* sync,                    // (D, 2) zeros
                int B, int T, int H, int D, int reverse_mask, int NB, int U, int R, int KT) {
  extern __shared__ float4 smem4[];
  const int dir = blockIdx.x / NB;
  const int blk = blockIdx.x % NB;
  const int u0 = blk * U;
  const int Ue = min(U, H - u0);  // units this block owns (the last may own fewer)
  const bool reverse = (reverse_mask >> dir) & 1;
  const int C = 3 * U;             // slice rows: gate g (r, u, c) of unit u0 + uu at g U + uu
  const int H4 = (H + 3) & ~3;
  const bool resident = KT >= H4;
  float* sw = reinterpret_cast<float*>(smem4);  // [C][KT] slice (or k tile), transposed
  // the prologue's tile stage, in the slice's place before the slice is loaded
  nm::TileStage& st = *reinterpret_cast<nm::TileStage*>(smem4);
  float* sd = sw + max(C * KT, static_cast<int>(sizeof(nm::TileStage) / 4));  // [R][C]
  float* sm = sd + R * C;  // [R] mask of the row tile
  const float* w_g = wgh + static_cast<size_t>(dir) * H * 2 * H;
  const float* w_c = wch + static_cast<size_t>(dir) * H * H;
  const size_t x_width = static_cast<size_t>(D) * 3 * H, h_width = static_cast<size_t>(D) * H;
  const size_t x_off = static_cast<size_t>(dir) * 3 * H, h_off = static_cast<size_t>(dir) * H;
  const size_t bh = static_cast<size_t>(B) * H;
  const size_t buffer = static_cast<size_t>(D) * NB * bh;  // one kind of partial
  const float* p_c = partial + static_cast<size_t>(dir) * NB * bh;  // dxc W_ch^T parts
  const float* p_g = p_c + buffer;                                  // dxg W_gh^T parts
  float* out_c = partial + (static_cast<size_t>(dir) * NB + blk) * bh;
  float* out_g = out_c + buffer;
  float* dcar = carry + static_cast<size_t>(dir) * bh;
  const int BT = B * T;
  const size_t plane = static_cast<size_t>(BT) * h_width;
  float* g_r = gate_scratch;  // r, u, c and r * h_prev of every step
  float* g_u = g_r + plane;
  float* g_c = g_u + plane;
  float* g_rh = g_c + plane;

  // depths k0 .. k0 + kt of the slice, stored [c][k - k0] (rows of KT),
  // zero beyond H and beyond the units owned; read along the units
  auto load_w = [&](int k0, int kt) {
    for (int i = threadIdx.x; i < kt * C; i += kThreads) {
      const int k = k0 + i / C, col = i % C, g = col / U, uu = col % U;
      float v = 0.f;
      if (k < H && uu < Ue)
        v = g < 2 ? w_g[static_cast<size_t>(k) * 2 * H + g * H + u0 + uu]
                  : w_c[static_cast<size_t>(k) * H + u0 + uu];
      sw[col * KT + i / C] = v;
    }
  };
  // this block's part of (sd's columns of gates g0 .. g0 + ng) W^T into pout
  auto partial_out = [&](int g0, int ng, float* pout, int nr) {
    for (int k0 = 0; k0 < H4; k0 += KT) {
      const int kt = min(KT, H4 - k0);
      if (!resident) {
        __syncthreads();
        load_w(k0, kt);
      }
      __syncthreads();  // sd (and the k tile) complete
      partial_product(sd, C, sw, KT, g0 * U, ng * U, pout, H, nr, k0, kt);
    }
  };
  // one pass of the prologue: the direction's (B T) x n product of the rows of
  // a (h_prev, or r * h_prev) with W (H, n), in 128 x 128 tiles spread over
  // the direction's blocks, each tile's sums handed to emit(row, column, z)
  // for the rows and columns in range
  auto pass = [&](const float* a, const float* w, int n, auto&& emit) {
    const int n_tiles = (n + nm::kTileN - 1) / nm::kTileN;
    const int tiles = (BT + nm::kTileM - 1) / nm::kTileM * n_tiles;
    const int tr = nm::tile_row(), tc = nm::tile_col();
    for (int tile = blk; tile < tiles; tile += NB) {
      const int m0 = tile / n_tiles * nm::kTileM, n0 = tile % n_tiles * nm::kTileN;
      float acc[nm::kThreadM][nm::kThreadN];
      nm::logit_tile_rows(a, h_width, w, BT, H, n, m0, n0, st, acc);
#pragma unroll
      for (int i = 0; i < nm::kThreadM; ++i) {
        const int row = m0 + tr * nm::kThreadM + i;
        if (row >= BT) continue;
#pragma unroll
        for (int j = 0; j < nm::kThreadN; ++j) {
          const int col = n0 + tc + 16 * j;
          if (col < n) emit(row, col, acc[i][j]);
        }
      }
    }
  };

  // 0. the gates of every (b, t) row: pass 1, r and u from h_prev, with
  // r * h_prev; barrier; pass 2, the candidate from r * h_prev; barrier
  pass(hprev + h_off, w_g, 2 * H, [&](int row, int col, float z) {
    const float* xt = x + static_cast<size_t>(row) * x_width + x_off;
    const size_t o = static_cast<size_t>(row) * h_width + h_off;
    const float gate = nm::sigmoid(xt[col] + z);
    if (col < H) {
      g_r[o + col] = gate;
      g_rh[o + col] = gate * hprev[o + col];
    } else {
      g_u[o + col - H] = gate;
    }
  });
  nm::direction_barrier(sync + 2 * dir, NB);
  pass(g_rh + h_off, w_c, H, [&](int row, int col, float z) {
    g_c[static_cast<size_t>(row) * h_width + h_off + col] =
        tanhf(x[static_cast<size_t>(row) * x_width + x_off + 2 * H + col] + z);
  });
  nm::direction_barrier(sync + 2 * dir, NB);
  if (resident) load_w(0, H4);  // over the tile stage, now free

  for (int s = 0; s < T; ++s) {
    // the forward visited t = 0 .. T-1 (T-1 .. 0 reversed); walk it backwards
    const int t = reverse ? s : T - 1 - s;
    const bool last = s == T - 1;  // no dh is carried out of the last step
    for (int r0 = 0; r0 < B; r0 += R) {
      const int nr = min(R, B - r0);
      for (int r = threadIdx.x; r < nr; r += kThreads)
        sm[r] = mask[static_cast<size_t>(r0 + r) * T + t];
      __syncthreads();
      // 1. the elementwise part for the tile's rows and the block's units;
      // dxc goes to sd's candidate columns, zero for units not owned
      for (int idx = threadIdx.x; idx < nr * U; idx += kThreads) {
        const int r = idx / U, uu = idx % U, b = r0 + r, u = u0 + uu;
        if (uu >= Ue) {
          sd[r * C + 2 * U + uu] = 0.f;
          continue;
        }
        const size_t bt = static_cast<size_t>(b) * T + t;
        float* dxt = dx + bt * x_width + x_off;
        const size_t o = bt * h_width + h_off + u;
        const size_t bu = static_cast<size_t>(b) * H + u;
        float dh;
        if (s == 0) {
          dh = gfinal[static_cast<size_t>(b) * h_width + h_off + u];
        } else {
          // dxg W_gh^T of the step before: the NB partials in block order
          dh = dcar[bu] + ordered_sum(p_g + bu, bh, NB);
        }
        const float m = sm[r];
        const float hp = hprev[o];
        const float ug = __ldcg(g_u + o);
        const float cand = __ldcg(g_c + o);
        const float dnew = m * (dh + gout[o]);
        const float du = dnew * (hp - cand);
        const float dxc = dnew * (1.0f - ug) * (1.0f - cand * cand);
        dxt[H + u] = du * ug * (1.0f - ug);
        dxt[2 * H + u] = dxc;
        sd[r * C + 2 * U + uu] = dxc;
        dcar[bu] = (1.0f - m) * dh + dnew * ug;
      }
      // 2. this block's part of dxc W_ch^T
      partial_out(2, 1, out_c + static_cast<size_t>(r0) * H, nr);
      __syncthreads();  // the tile's mask and dxc are consumed
    }
    nm::direction_barrier(sync + 2 * dir, NB);

    for (int r0 = 0; r0 < B; r0 += R) {
      const int nr = min(R, B - r0);
      // 3. a = (dxc W_ch^T)[own]: the NB partials in block order; dr, and
      // dr | du u (1 - u) into sd's gate columns, zero for units not owned
      for (int idx = threadIdx.x; idx < nr * U; idx += kThreads) {
        const int r = idx / U, uu = idx % U, b = r0 + r, u = u0 + uu;
        if (uu >= Ue) {
          sd[r * C + uu] = 0.f;
          sd[r * C + U + uu] = 0.f;
          continue;
        }
        const size_t bt = static_cast<size_t>(b) * T + t;
        const size_t o = bt * h_width + h_off + u;
        const size_t bu = static_cast<size_t>(b) * H + u;
        const float a = ordered_sum(p_c + bu, bh, NB);
        const float rr = __ldcg(g_r + o);
        const float dr = a * hprev[o] * rr * (1.0f - rr);
        float* dxt = dx + bt * x_width + x_off;
        dxt[u] = dr;
        sd[r * C + uu] = dr;
        sd[r * C + U + uu] = dxt[H + u];  // this thread's own write of step 1
        dcar[bu] += a * rr;
      }
      // 4. this block's part of dxg W_gh^T
      if (!last) partial_out(0, 2, out_g + static_cast<size_t>(r0) * H, nr);
      __syncthreads();  // sd is consumed
    }
    if (!last) nm::direction_barrier(sync + 2 * dir, NB);
  }
}

}  // namespace

NM_EXPORT int nm_gru_bptt(const void* x, const void* mask, const void* hprev, const void* gout,
                          const void* gfinal, const void* wgh, const void* wch, void* dx,
                          void* gate_scratch, void* partial, void* carry, void* sync, int B, int T,
                          int H, int D, int reverse_mask, int blocks_per_dir, int units, int rows,
                          int k_tile, int smem, void* stream) {
  if (B < 1 || T < 1 || H < 1 || D < 1 || blocks_per_dir < 1 || units < 4 || (units & 3) ||
      (blocks_per_dir - 1) * units >= H || blocks_per_dir * units < H || rows < 1 ||
      k_tile < 4 || (k_tile & 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t cols = 3 * static_cast<size_t>(units);
  const size_t needed =
      sizeof(float) * std::max(k_tile * cols, sizeof(nm::TileStage) / sizeof(float)) +
      sizeof(float) * rows * (cols + 1);
  if (static_cast<size_t>(smem) < needed) return static_cast<int>(cudaErrorInvalidValue);
  const int status = nm::allow_max_smem(reinterpret_cast<const void*>(gru_bptt_kernel));
  if (status != 0) return status;
  const float* x_ = static_cast<const float*>(x);
  const float* mask_ = static_cast<const float*>(mask);
  const float* hprev_ = static_cast<const float*>(hprev);
  const float* gout_ = static_cast<const float*>(gout);
  const float* gfinal_ = static_cast<const float*>(gfinal);
  const float* wgh_ = static_cast<const float*>(wgh);
  const float* wch_ = static_cast<const float*>(wch);
  float* dx_ = static_cast<float*>(dx);
  float* gates_ = static_cast<float*>(gate_scratch);
  float* partial_ = static_cast<float*>(partial);
  float* carry_ = static_cast<float*>(carry);
  unsigned* sync_ = static_cast<unsigned*>(sync);
  void* args[] = {&x_,      &mask_,  &hprev_, &gout_,         &gfinal_, &wgh_,   &wch_,
                  &dx_,     &gates_, &partial_, &carry_,      &sync_,   &B,      &T,
                  &H,       &D,      &reverse_mask, &blocks_per_dir, &units, &rows, &k_tile};
  // cooperative: every block resident, or cudaErrorCooperativeLaunchTooLarge
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(gru_bptt_kernel), dim3(blocks_per_dir * D), dim3(kThreads),
      args, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves the error for the next one
    return static_cast<int>(err);
  }
  return nm::launch_status();
}
