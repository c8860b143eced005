// K1: forward scan of a masked TF1-convention GRU, all directions in one
// persistent launch.
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
// What bounds it on the H100: the steps are serial and each needs both
// recurrent matrices (3 H^2 floats, 3 MB a direction at H = 512), far more
// than one SM's 227 KB. The TPU kept them pinned in VMEM. The first design
// (one block per batch row and direction) read them from L2 at every step in
// every block, 12.6 GB a launch at B 64, T 32, so L2 bandwidth bound it. So
// the weights are split by hidden unit across a persistent grid, as in
// lstm_scan.cu: block j of a direction owns the units u0 .. u0 + U and their
// three gate columns (W_gh's u and H + u, W_ch's u), keeps that slice in
// shared memory for the whole launch, and computes its units' gates for every
// batch row at each step; each weight byte then leaves L2 once a launch.
//
// Unlike the LSTM's, the GRU's step needs two exchanges: the candidate reads
// r * h over all H, and r of the other blocks' units is known only once their
// gates are. So each step runs in two phases, each ending at a barrier of the
// direction's blocks (one arrival counter a direction, common.cuh
// counting_barrier):
//   1. stage the whole carried h of a tile of batch rows (cp.async.cg, all
//      copies in flight, or __ldcg where H % 4 != 0); compute r and u of the
//      block's units; write r * h and u for them to a scratch;
//   2. stage the whole r * h of the tile the same way; compute c of the
//      block's units and h' = u h + (1 - u) c; write the output, the carry
//      and the carried h of its units.
// h needs one buffer: phase 1 reads all of it and phase 2 writes only the
// block's own units, with a barrier between the two and after phase 2.
// Values written during the launch are read through L2 (cp.async.cg,
// __ldcg), never through the read-only path or L1. Each thread accumulates a
// 4-row x 4-column tile from float4 shared reads, its sum over k optionally
// split between threads; the parts are added in a fixed order and nothing
// uses atomics, so the outputs are the same from run to run. The launch is
// cooperative, so every block is resident or the launch is refused (and the
// wrapper raises with the plan).
//
// On an H100 80GB HBM3 at 700.00 W, at B 64, T 32, H 512 with two
// directions, the scan takes 0.705 ms, 21.7 us a step (the first design 1.78
// ms), and 0.915 ms through the wrapper with its hoisted GEMM
// (scripts/kernel_ab.py, chip_smoke.py). Of the scan's 0.72 ms the barriers
// take 0.16, the staging's reads from L2 0.16 and the products 0.11
// (scripts/kernel_ablation.py): the two exchanges bound it. Sharing h within
// thread-block clusters, in distributed shared memory, is the step after
// this one.
//
// The plan (blocks per direction, units per block, rows per tile, k tile,
// k split, shared bytes) comes from the wrapper (ops/cuda_rnn.py
// `gru_scan_plan`). Where the slice does not fit beside the row tile (a
// large H), the same kernel streams it from L2 in k tiles, once per row tile
// and phase; where the rows do not fit, it walks them in tiles.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPre = 2;  // elementwise items a thread prefetches a row tile
// words between the directions' barrier counters: one 128-byte line each
// (on the H100 counters in neighbouring words made the launch 5% slower)
constexpr int kSyncStride = 32;

__global__ void __launch_bounds__(kThreads)
gru_scan_kernel(const float* __restrict__ x,     // (B, T, D * 3H): [xg | xc] per direction
                const float* __restrict__ mask,  // (B, T)
                const float* __restrict__ wgh,   // (D, H, 2H)
                const float* __restrict__ wch,   // (D, H, H)
                float* __restrict__ out,         // (B, T, D * H)
                float* __restrict__ fin,         // (B, D * H)
                float* __restrict__ carries,     // (B, T, D * H) or null
                float* scratch,                  // (3, D, B, H): h, r * h, u
                unsigned* sync,                  // (D, kSyncStride) zeros
                int B, int T, int H, int D, int reverse_mask, int NB, int U, int R, int KT,
                int KS) {
  extern __shared__ float4 smem4[];
  const int dir = blockIdx.x / NB;
  const int u0 = (blockIdx.x % NB) * U;
  const int Ue = min(U, H - u0);  // units this block owns (the last may own fewer)
  const bool reverse = (reverse_mask >> dir) & 1;
  const int C = 3 * U;            // slice columns: gate g (r, u, c) of unit u0 + uu at g U + uu
  const int H4 = (H + 3) & ~3;
  const int HS = H4 + 4;          // staged row stride: row tiles start in other banks
  const bool resident = KT >= H4;
  float* sw = reinterpret_cast<float*>(smem4);  // [KT][C] slice (or k tile)
  float* sh = sw + KT * C;                        // [R][HS] h, then r * h, of a row tile
  float* sz = sh + R * HS;                        // [KS][R][2U] or [2 KS][R][U] partial sums
  float* sm = sz + KS * R * 2 * U;                // [R] mask of the row tile
  const float* w_g = wgh + static_cast<size_t>(dir) * H * 2 * H;
  const float* w_c = wch + static_cast<size_t>(dir) * H * H;
  const size_t plane = static_cast<size_t>(D) * B * H;
  float* hbuf = scratch + static_cast<size_t>(dir) * B * H;  // carried h
  float* rhbuf = hbuf + plane;                                // r * h
  float* ubuf = rhbuf + plane;                                // u
  const size_t x_width = static_cast<size_t>(D) * 3 * H, o_width = static_cast<size_t>(D) * H;
  const size_t x_off = static_cast<size_t>(dir) * 3 * H;

  // rows k0 .. k0 + kt of the slice's gates g0 .. g0 + ng, zero beyond H and
  // beyond the units owned; read along the units
  auto load_w = [&](int k0, int kt, int g0, int ng) {
    const int cols = ng * U;
    for (int i = threadIdx.x; i < kt * cols; i += kThreads) {
      const int k = k0 + i / cols, col = g0 * U + i % cols, g = col / U, uu = col % U;
      float v = 0.f;
      if (k < H && uu < Ue)
        v = g < 2 ? w_g[static_cast<size_t>(k) * 2 * H + g * H + u0 + uu]
                  : w_c[static_cast<size_t>(k) * H + u0 + uu];
      sw[(i / cols) * C + col] = v;
    }
  };
  // stage rows r0 .. r0 + nr of `src` (B, H), or zeros, into sh: all copies
  // in flight at once, through L2 only
  auto stage = [&](const float* src, int r0, int nr, bool zero) {
    if ((H & 3) == 0) {
      for (int i = threadIdx.x; i < nr * (H4 / 4); i += kThreads) {
        const int r = i / (H4 / 4), k = (i % (H4 / 4)) * 4;
        nm::cp_async16(sh + r * HS + k, src + static_cast<size_t>(r0 + r) * H + k,
                       zero ? 0 : 16);
      }
      nm::cp_async_commit();
      nm::cp_async_wait<0>();
    } else {
      for (int i = threadIdx.x; i < nr * H4; i += kThreads) {
        const int r = i / H4, k = i % H4;
        sh[r * HS + k] =
            (zero || k >= H) ? 0.f : __ldcg(src + static_cast<size_t>(r0 + r) * H + k);
      }
    }
  };
  // sz[ks][r][c] = the part ks of sum_k sh[r][k] sw[k][g0 U + c] for the
  // tile's nr rows and the ng U columns of gates g0 .., over the slice (or
  // its k tiles, loaded here): thread task (ks, rg, cg) sums the rows rg +
  // G q, q < 4, G = ceil(nr / 4), at columns 4 cg .. + 4 over part ks of the
  // depths. Neighbouring tasks take neighbouring rows, so the rows a warp
  // reads at one depth start in different banks (the row stride is 4 mod 32
  // floats at H 512)
  auto product = [&](int g0, int ng, int ks_n, int nr) {
    const int ncols = ng * U, groups = ncols / 4, G = (nr + 3) / 4;
    const int tasks = groups * G;
    for (int k0 = 0; k0 < H4; k0 += KT) {
      const int kt = min(KT, H4 - k0);
      if (!resident) {
        __syncthreads();  // the previous k tile is consumed
        load_w(k0, kt, g0, ng);
      }
      __syncthreads();  // the staged rows (and the k tile) complete
      const int span = ((kt + ks_n - 1) / ks_n + 3) & ~3;
      for (int idx = threadIdx.x; idx < tasks * ks_n; idx += kThreads) {
        const int ks = idx / tasks, task = idx % tasks;
        const int cg = task % groups, rg = task / groups;
        const int ka = ks * span, kb = min(kt, ka + span);
        const float* hrow[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)  // rows past the tile repeat its last row
          hrow[r] = sh + min(rg + G * r, nr - 1) * HS + k0;
        const float* wcol = sw + g0 * U + 4 * cg;
        float acc[4][4] = {};
        for (int k = ka; k < kb; k += 4) {
          float4 wv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            wv[q] = *reinterpret_cast<const float4*>(wcol + (k + q) * C);
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
          if (rg + G * r >= nr) break;
          float4* zp = reinterpret_cast<float4*>(sz + (ks * R + rg + G * r) * ncols + 4 * cg);
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
  };
  // the parts of sum column c of row r, in the order 0 .. ks_n - 1
  auto part_sum = [&](int ks_n, int ncols, int r, int c) {
    float z = 0.f;
    for (int ks = 0; ks < ks_n; ++ks) z += sz[(ks * R + r) * ncols + c];
    return z;
  };
  // the elementwise inputs of a thread's first kPre items of a row tile are
  // loaded before the tile is staged, so their latency hides behind the
  // staging and the product; later items load where they are used
  auto x_at = [&](int b, int t) {
    return x + (static_cast<size_t>(b) * T + t) * x_width + x_off;
  };
  // phase 1's item idx: r and u of one (row, unit), r * h and u to the scratch
  auto gates = [&](int r0, int idx, float xr, float xu) {
    const int r = idx / Ue, uu = idx % Ue, u = u0 + uu;
    const float rg = nm::sigmoid(xr + part_sum(KS, 2 * U, r, uu));
    const float ug = nm::sigmoid(xu + part_sum(KS, 2 * U, r, U + uu));
    const size_t bu = static_cast<size_t>(r0 + r) * H + u;
    rhbuf[bu] = rg * sh[r * HS + u];
    ubuf[bu] = ug;
  };
  // phase 2's item idx: c, the new h, the output and the carries
  auto update = [&](int r0, int idx, int s, int t, float xc, float prev, float ug) {
    const int r = idx / Ue, uu = idx % Ue, b = r0 + r, u = u0 + uu;
    const float cand = tanhf(xc + part_sum(2 * KS, U, r, uu));
    const float m = sm[r];
    const float nh = ug * prev + (1.0f - ug) * cand;
    const float carry = m * nh + (1.0f - m) * prev;
    const size_t col = static_cast<size_t>(dir) * H + u;
    const size_t o = (static_cast<size_t>(b) * T + t) * o_width + col;
    out[o] = m * nh;
    if (carries != nullptr) carries[o] = carry;
    hbuf[static_cast<size_t>(b) * H + u] = carry;
    if (s == T - 1) fin[static_cast<size_t>(b) * o_width + col] = carry;
  };
  if (resident) load_w(0, H4, 0, 3);

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    // 1. r and u of the block's units from the carried h (zero at s = 0)
    for (int r0 = 0; r0 < B; r0 += R) {
      const int nr = min(R, B - r0), items = nr * Ue;
      float pre[kPre][2];
#pragma unroll
      for (int q = 0; q < kPre; ++q) {
        const int idx = threadIdx.x + q * kThreads;
        if (idx < items) {
          const float* xt = x_at(r0 + idx / Ue, t) + u0 + idx % Ue;
          pre[q][0] = xt[0];
          pre[q][1] = xt[H];
        }
      }
      stage(hbuf, r0, nr, s == 0);
      product(0, 2, KS, nr);
#pragma unroll
      for (int q = 0; q < kPre; ++q) {
        const int idx = threadIdx.x + q * kThreads;
        if (idx < items) gates(r0, idx, pre[q][0], pre[q][1]);
      }
      for (int idx = threadIdx.x + kPre * kThreads; idx < items; idx += kThreads) {
        const float* xt = x_at(r0 + idx / Ue, t) + u0 + idx % Ue;
        gates(r0, idx, xt[0], xt[H]);
      }
      __syncthreads();  // the tile's h and sums are consumed
    }
    nm::counting_barrier(sync + kSyncStride * dir, NB);

    // 2. c and the new h of the block's units from the whole r * h
    for (int r0 = 0; r0 < B; r0 += R) {
      const int nr = min(R, B - r0), items = nr * Ue;
      for (int r = threadIdx.x; r < nr; r += kThreads)
        sm[r] = mask[static_cast<size_t>(r0 + r) * T + t];
      float pre[kPre][3];
#pragma unroll
      for (int q = 0; q < kPre; ++q) {
        const int idx = threadIdx.x + q * kThreads;
        if (idx < items) {
          const int b = r0 + idx / Ue, u = u0 + idx % Ue;
          const size_t bu = static_cast<size_t>(b) * H + u;
          pre[q][0] = x_at(b, t)[2 * H + u];
          pre[q][1] = s == 0 ? 0.f : __ldcg(hbuf + bu);
          pre[q][2] = __ldcg(ubuf + bu);
        }
      }
      stage(rhbuf, r0, nr, false);
      product(2, 1, 2 * KS, nr);
#pragma unroll
      for (int q = 0; q < kPre; ++q) {
        const int idx = threadIdx.x + q * kThreads;
        if (idx < items) update(r0, idx, s, t, pre[q][0], pre[q][1], pre[q][2]);
      }
      for (int idx = threadIdx.x + kPre * kThreads; idx < items; idx += kThreads) {
        const int b = r0 + idx / Ue, u = u0 + idx % Ue;
        const size_t bu = static_cast<size_t>(b) * H + u;
        update(r0, idx, s, t, x_at(b, t)[2 * H + u], s == 0 ? 0.f : __ldcg(hbuf + bu),
               __ldcg(ubuf + bu));
      }
      __syncthreads();  // the tile's r * h, mask and sums are consumed
    }
    if (s + 1 < T) nm::counting_barrier(sync + kSyncStride * dir, NB);
  }
}

}  // namespace

NM_EXPORT int nm_gru_scan(const void* x, const void* mask, const void* wgh, const void* wch,
                          void* out, void* fin, void* carries, void* scratch, void* sync, int B,
                          int T, int H, int D, int reverse_mask, int blocks_per_dir, int units,
                          int rows, int k_tile, int k_split, int smem, void* stream) {
  if (B < 1 || T < 1 || H < 1 || D < 1 || blocks_per_dir < 1 || units < 4 || (units & 3) ||
      (blocks_per_dir - 1) * units >= H || blocks_per_dir * units < H || rows < 1 ||
      k_tile < 4 || (k_tile & 3) || k_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t needed =
      sizeof(float) * (static_cast<size_t>(k_tile) * 3 * units +
                       static_cast<size_t>(rows) * (((H + 3) & ~3) + 4) +
                       static_cast<size_t>(k_split) * rows * 2 * units + rows);
  if (static_cast<size_t>(smem) < needed) return static_cast<int>(cudaErrorInvalidValue);
  const int status = nm::allow_max_smem(reinterpret_cast<const void*>(gru_scan_kernel));
  if (status != 0) return status;
  const float* x_ = static_cast<const float*>(x);
  const float* mask_ = static_cast<const float*>(mask);
  const float* wgh_ = static_cast<const float*>(wgh);
  const float* wch_ = static_cast<const float*>(wch);
  float* out_ = static_cast<float*>(out);
  float* fin_ = static_cast<float*>(fin);
  float* carries_ = static_cast<float*>(carries);
  float* scratch_ = static_cast<float*>(scratch);
  unsigned* sync_ = static_cast<unsigned*>(sync);
  void* args[] = {&x_, &mask_, &wgh_, &wch_, &out_, &fin_, &carries_, &scratch_, &sync_,
                  &B,  &T,     &H,    &D,    &reverse_mask, &blocks_per_dir, &units,
                  &rows, &k_tile, &k_split};
  // cooperative: every block resident, or cudaErrorCooperativeLaunchTooLarge
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(gru_scan_kernel), dim3(blocks_per_dir * D), dim3(kThreads),
      args, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves the error for the next one
    return static_cast<int>(err);
  }
  return nm::launch_status();
}
