// K3: logit projection with the beam selector's reductions in its epilogue.
// K4: exact small top-k with lowest-index tie-breaking.
// rowmax_lse: the same reductions over logits that already exist.
//
// K3 replaces neuralmonkey_tpu/ops/beam_select.py `_fused_kernel` (called by
// `_fused_pallas`): logits = x W + b for x (N, Dm), W (Dm, Vp), b (Vp), with
// Vp a multiple of 128, plus rowmax (N, Vp / 128), the maximum of every
// 128-column group, and lse (N), the log-sum-exp of each whole row.
//
// What bounds K3 on the H100: the product (2 N Dm Vp flops, 20.1 GFLOP at
// N = 640, Dm = 512, Vp = 30720); the logits write (79 MB) is second. The
// first design ran it on the SIMT units (a 128 x 128 tile, 8 x 8 sums a
// thread), whose float32 peak (0.301 ms) it could not pass: 0.631 ms. The
// design: the product runs on the tensor cores in 3xTF32 (each float32
// operand split in two TF32 parts and three products kept, which holds
// float32 accuracy), with the routine the fused cross-entropy's backward
// uses (tc_product.cuh: mma.sync m16n8k8, 8 warps as 2 x 4 warp tiles of
// 64 x 32, cp.async double-buffered 32-deep stages, ragged edges
// zero-filled). Its bound is the three TF32 products at the TF32 peak,
// 0.122 ms. A block's tile is 128 rows by exactly 128 columns, so each
// block's per-row maximum IS one rowmax entry: the epilogue adds the bias,
// stores the logits two floats a lane, and takes each row's maximum and
// its sum of exp(logit - max) over the block's columns, the four column
// warps exchanging theirs through 4 KB of shared memory. Row tiles run in
// blockIdx.x, so the few blocks that share a W tile start together and W
// (63 MB, more than the 50 MB L2) leaves device memory about once. Two
// blocks an SM (128 registers a thread) beat one (146 registers): 0.38
// against 0.44 ms. The TPU folded the log-sum-exp across its sequential
// vocabulary grid; Hopper blocks run in no order, so each block writes a
// per-row partial sum into an (N, R) scratch and a second small kernel
// folds the R partials of a row into lse, in one fixed order, with no
// atomics. The logits are written once and never re-read. On an H100 80GB
// HBM3 at 700.00 W this takes 0.382 ms at the serving shape (chip_smoke.py),
// where cuBLAS's float32 product alone (addmm) takes 0.445 (the logits store
// costs under 2%: scripts/kernel_ablation.py). TF32 wgmma, with W laid out
// K-major once per search, is the step after this one.
//
// rowmax_lse replaces `_kernel` (called by `_rowmax_lse_pallas`): for (N, Vp)
// logits, Vp a multiple of 128, the maximum of every 128-column group and each
// row's log-sum-exp, in one read of the logits. The beam search runs it when
// the fused projection is switched off (NM_FUSED_LOGITS=0). What bounds it:
// the bytes of the logits (77 MB at N = 640, Vp = 30080); it does a few
// operations per element. The design reuses K3's reductions and fold: one warp per
// (row, group) reads its 128 columns as one float4 per lane and writes the
// group's maximum and its sum of exp(x - max); K3's fold kernel then turns the
// R partials of a row into lse, rescaling each by exp(max_r - M), in one fixed
// order with no atomics. Any N >= 1 (the TPU's 8-row blocks do not carry
// over).
//
// K4 replaces `_topk_kernel` (called by `_topk_pallas`): the k largest values
// of each row (k = beam, rows of K * R or K * 128 entries) in descending
// order, ties to the lowest index like lax.top_k. What bounds it: latency
// (the launch, a few dependent loads, the serial steps), not bytes (0.6 MB at
// 64 x 2400). The first design held the row in shared memory (so n <= 12000)
// and ran k rounds of a block-wide arg-max, each a pass over the row and two
// block barriers. This design makes one pass over the row
// (ops/beam_select.topk_plan lays it out):
// - a warp reads a chunk of 1024 entries, 32 a lane (512 at k > 32), as
//   float4 where the rows are 16-byte aligned and n a multiple of 4, as
//   floats otherwise; a row of one chunk is one warp's (4 rows a block, no
//   block barrier), a longer row's chunks are shared by 2, 4 or 8 warps, the
//   next chunk's loads issued before the current chunk is scanned;
// - tau, the k-th best (k <= 32) of the 32 lanes' bests over the first
//   chunk (a bitonic sort across the warp): k entries rank at or before it,
//   so nothing after it can be among the k best. The one pass appends the
//   entries at or before tau to the warp's 256 candidates in shared memory
//   (a ballot and a prefix count an entry, no serial step), and each
//   candidate's place in the output is the number of candidates before it
//   (a lane a candidate, the candidates broadcast from shared memory);
// - where k > 32 or more than 256 entries pass (rows of ties, sorted rows),
//   each lane keeps the best KM (16, 32 or 64 >= k) of its entries, sorted,
//   in registers, inserting the entries that pass one at a time from one
//   copy of the insertion code, and k rounds of a warp arg-max over the
//   lists' heads (two redux.sync reductions a round: the best key, then the
//   lowest index among its ties) pick the winners, the winning lane popping
//   its head with selects over its list.
// Where warps share a row, each finds the k best of its chunks so, and one
// warp merges their k-lists (k rounds of the arg-max) after a block barrier.
#include "tc_product.cuh"

namespace {

namespace tc = nm::tc;

// shared memory of a K3 block: the two operand stages of tc::tile_product;
// the epilogue's per-warp row maxima and sums reuse the first of them
constexpr size_t kLogitSmem = sizeof(float) * 2 * tc::kStage;

// One 128-row x 128-column tile of logits = x W + b, with its per-row maximum
// (one rowmax entry) and sum of exp(logit - max) (a partial for lse_fold).
// Grid (row tiles, column tiles): the blocks that share a W tile are
// neighbours in launch order, so they run together and W leaves device
// memory about once.
__global__ void __launch_bounds__(tc::kThreads, 2)
fused_logits_kernel(const float* __restrict__ x,     // (N, Dm)
                    const float* __restrict__ w,     // (Dm, Vp)
                    const float* __restrict__ bias,  // (Vp)
                    float* __restrict__ logits,      // (N, Vp)
                    float* __restrict__ rowmax,      // (N, R)
                    float* __restrict__ psum,        // (N, R) scratch
                    int N, int Dm, int Vp) {
  extern __shared__ float4 smem4[];
  float* stages = reinterpret_cast<float*>(smem4);
  const int m0 = blockIdx.x * tc::kM;
  const int n0 = blockIdx.y * tc::kN;
  const int R = Vp / tc::kN;
  // 16-byte copies need every row of x and W to start 16-byte aligned (Vp is
  // a multiple of 128); otherwise 4-byte ones
  const bool vec = (Dm & 3) == 0 &&
                   ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(w)) & 15) == 0;
  float acc[4][4][4] = {};
  tc::tile_product<false>(x, w, N, Dm, Vp, m0, n0, vec, stages, acc);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4 * 64, wn = warp % 4 * 32;
  float* part = stages;  // [kM][4 column warps][max, sum]: the stages are free
  float bv[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) bv[ni][j] = bias[n0 + wn + ni * 8 + 2 * (lane % 4) + j];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wm + mi * 16 + lane / 4 + 8 * h, gm = m0 + row;
      float mx = -INFINITY;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          acc[mi][ni][2 * h + j] += bv[ni][j];
          mx = fmaxf(mx, acc[mi][ni][2 * h + j]);
        }
      // the 4 lanes that share a row hold its 32 columns of this warp
      mx = fmaxf(mx, __shfl_xor_sync(nm::kFullMask, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(nm::kFullMask, mx, 2));
      float s = 0.f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) s += expf(acc[mi][ni][2 * h + j] - mx);
      s += __shfl_xor_sync(nm::kFullMask, s, 1);
      s += __shfl_xor_sync(nm::kFullMask, s, 2);
      if (gm < N) {
        float* out = logits + static_cast<size_t>(gm) * Vp + n0 + wn + 2 * (lane % 4);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          *reinterpret_cast<float2*>(out + ni * 8) =
              make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
      if (lane % 4 == 0) {
        part[(row * 4 + warp % 4) * 2] = mx;
        part[(row * 4 + warp % 4) * 2 + 1] = s;
      }
    }
  __syncthreads();
  // one thread a row: the block's maximum over its 128 columns, and the four
  // warps' sums rescaled to it, in warp order
  const int row = threadIdx.x;
  if (row < tc::kM && m0 + row < N) {
    const float* p = part + row * 8;
    const float mx = fmaxf(fmaxf(p[0], p[2]), fmaxf(p[4], p[6]));
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) s += p[2 * q + 1] * expf(p[2 * q] - mx);
    const size_t at = static_cast<size_t>(m0 + row) * R + blockIdx.y;
    rowmax[at] = mx;
    psum[at] = s;
  }
}

// lse[n] = M + log(sum_r psum[n, r] * exp(rowmax[n, r] - M)), M = max_r rowmax
__global__ void lse_fold_kernel(const float* __restrict__ rowmax,
                                const float* __restrict__ psum,
                                float* __restrict__ lse, int N, int R) {
  const int n = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (n >= N) return;
  const float* rm = rowmax + static_cast<size_t>(n) * R;
  const float* ps = psum + static_cast<size_t>(n) * R;
  float mx = -INFINITY;
  for (int r = lane; r < R; r += 32) mx = fmaxf(mx, rm[r]);
  mx = nm::warp_max(mx);
  float s = 0.f;
  for (int r = lane; r < R; r += 32) s += ps[r] * expf(rm[r] - mx);
  s = nm::warp_sum(s);
  if (lane == 0) lse[n] = mx + logf(s);
}

constexpr int kGroupWarps = 8;  // 128-column groups per rowmax_lse block

__global__ void __launch_bounds__(32 * kGroupWarps)
rowmax_lse_kernel(const float* __restrict__ x,  // (N, Vp)
                  float* __restrict__ rowmax,   // (N, R)
                  float* __restrict__ psum,     // (N, R) scratch
                  int Vp) {
  const int R = Vp / 128;
  const int g = blockIdx.y * kGroupWarps + threadIdx.x / 32;
  if (g >= R) return;
  const int lane = threadIdx.x & 31;
  const size_t n = blockIdx.x;
  const float4 v = *reinterpret_cast<const float4*>(x + n * Vp + g * 128 + lane * 4);
  const float mx = nm::warp_max(fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
  const float s = nm::warp_sum(expf(v.x - mx) + expf(v.y - mx) + expf(v.z - mx) +
                               expf(v.w - mx));
  if (lane == 0) {
    rowmax[n * R + g] = mx;
    psum[n * R + g] = s;
  }
}

// a ranks before b: larger value first, then lower index
__device__ __forceinline__ bool ranks_before(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Put (v, i), which ranks before the list's last entry, into its place in the
// sorted list (best first): it moves down from the head, each entry it
// passes moving one place on, with selects only (no branch, no dynamic
// index); the last entry drops out.
template <int KM>
__device__ __forceinline__ void list_insert(float (&lv)[KM], int (&li)[KM], float v, int i) {
#pragma unroll
  for (int p = 0; p < KM; ++p) {
    const bool before = ranks_before(v, i, lv[p], li[p]);
    const float ov = lv[p];
    const int oi = li[p];
    lv[p] = before ? v : ov;
    li[p] = before ? i : oi;
    v = before ? ov : v;
    i = before ? oi : i;
  }
}

// An unsigned key in the order of the values (a larger value, a larger key);
// -0.0 keys as +0.0, since the order takes them as equal.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned b = __float_as_uint(v == 0.f ? 0.f : v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// k rounds of a warp arg-max over the heads of the lanes' sorted lists: the
// best head's key by one warp reduction (redux.sync), the lowest index among
// the heads of that key by another; the winning lane (indices are unique)
// writes the round's value and index to out_v/out_i and pops its head, with
// selects over its list (no dynamic index).
template <int KM>
__device__ __forceinline__ void merge_lists(float (&lv)[KM], int (&li)[KM], int k, float* out_v,
                                            int* out_i) {
  for (int r = 0; r < k; ++r) {
    const unsigned key = order_key(lv[0]);
    const unsigned top = __reduce_max_sync(nm::kFullMask, key);
    const int first = __reduce_min_sync(nm::kFullMask, key == top ? li[0] : INT_MAX);
    const bool won = li[0] == first;
    if (won) {
      out_v[r] = lv[0];
      out_i[r] = li[0];
    }
#pragma unroll
    for (int p = 0; p < KM - 1; ++p) {
      lv[p] = won ? lv[p + 1] : lv[p];
      li[p] = won ? li[p + 1] : li[p];
    }
    lv[KM - 1] = won ? -INFINITY : lv[KM - 1];
    li[KM - 1] = won ? INT_MAX : li[KM - 1];
  }
}

constexpr int kTopkWarpChunk = 32;   // entries a lane scans a chunk (16 at KM 64)
constexpr int kTopkListCap = 64;     // a warp's k-list in a long row's merge
constexpr int kTopkCandidates = 256; // a warp's candidates at or before tau
constexpr int kTopkWarpFloats = 2 * (kTopkListCap + kTopkCandidates);

template <int KM>
__host__ __device__ constexpr int topk_chunk() {
  return KM > 32 ? kTopkWarpChunk / 2 : kTopkWarpChunk;
}

template <int KM, bool VEC>
__device__ __forceinline__ void topk_load(float (&buf)[topk_chunk<KM>()], const float* xr, int n,
                                          int base) {
  constexpr int V = topk_chunk<KM>();
  const int lane = threadIdx.x & 31;
  if (VEC) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const int e = base + 128 * q + 4 * lane;  // n is a multiple of 4
      const float4 f = e < n ? __ldg(reinterpret_cast<const float4*>(xr + e))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      buf[4 * q] = f.x;
      buf[4 * q + 1] = f.y;
      buf[4 * q + 2] = f.z;
      buf[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int e = base + 32 * j + lane;
      buf[j] = e < n ? __ldg(xr + e) : 0.f;
    }
  }
}

// the row index of entry j of a lane's chunk that starts at `base`
template <int KM, bool VEC>
__device__ __forceinline__ int topk_entry(int base, int j) {
  const int lane = threadIdx.x & 31;
  return VEC ? base + 128 * (j / 4) + 4 * lane + j % 4 : base + 32 * j + lane;
}

// tau: the k-th best (k <= 32) of the lanes' bests over one chunk (a bitonic
// sort of the 32 bests across the warp, best at lane 0). k entries rank at or
// before it, so no entry after it is among the k best.
template <int KM, bool VEC>
__device__ __forceinline__ void chunk_tau(const float (&buf)[topk_chunk<KM>()], int base, int n,
                                          int k, float& tv, int& ti) {
  const int lane = threadIdx.x & 31;
  float bv = -INFINITY;
  int bi = INT_MAX;
#pragma unroll
  for (int j = 0; j < topk_chunk<KM>(); ++j) {
    const int e = topk_entry<KM, VEC>(base, j);
    if (e < n && ranks_before(buf[j], e, bv, bi)) {
      bv = buf[j];
      bi = e;
    }
  }
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      const float ov = __shfl_xor_sync(nm::kFullMask, bv, stride);
      const int oi = __shfl_xor_sync(nm::kFullMask, bi, stride);
      const bool keep_better = ((lane & size) == 0) == ((lane & stride) == 0);
      if (keep_better == ranks_before(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
  tv = __shfl_sync(nm::kFullMask, bv, k - 1);
  ti = __shfl_sync(nm::kFullMask, bi, k - 1);
}

// Grid: blocks of rows_per_block rows, wpr warps a row. Shared memory, a warp
// each: its k-list (kTopkListCap values, then indices), then its candidates
// (kTopkCandidates values, then indices).
template <int KM, bool VEC>
__global__ void __launch_bounds__(256)
small_topk_kernel(const float* __restrict__ x,  // (B, n)
                  float* __restrict__ vals,     // (B, k)
                  int* __restrict__ idx,        // (B, k)
                  int B, int n, int k, int wpr) {
  constexpr int V = topk_chunk<KM>();
  constexpr int kChunk = 32 * V;  // entries of a warp's chunk
  extern __shared__ float4 topk_smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int row = blockIdx.x * (warps / wpr) + warp / wpr, part = warp % wpr;
  float* klist_v = reinterpret_cast<float*>(topk_smem4) + warp * kTopkWarpFloats;
  int* klist_i = reinterpret_cast<int*>(klist_v + kTopkListCap);
  float* cand_v = klist_v + 2 * kTopkListCap;
  int* cand_i = reinterpret_cast<int*>(cand_v + kTopkCandidates);
  // where this warp's k best go: the row's output, or its k-list when warps
  // share the row (sentinels where its part holds fewer than k entries)
  float* out_v = wpr == 1 ? vals + static_cast<size_t>(row) * k : klist_v;
  int* out_i = wpr == 1 ? idx + static_cast<size_t>(row) * k : klist_i;
  if (wpr > 1) {
    for (int r = lane; r < k; r += 32) {
      klist_v[r] = -INFINITY;
      klist_i[r] = INT_MAX;
    }
    __syncwarp();
  }

  const int n_chunks = (n + kChunk - 1) / kChunk;
  const float* xr = x + static_cast<size_t>(row) * n;
  float tv = -INFINITY;  // tau: keep what ranks at or before it; the
  int ti = INT_MAX;      // sentinel keeps every entry
  bool done = row >= B;
  if (!done && k <= 32) {
    // one pass: the entries at or before tau appended to the warp's
    // candidates (a ballot and a prefix count an entry, no serial step)
    float buf[V], nxt[V];
    int count = 0;
    if (part < n_chunks) {
      topk_load<KM, VEC>(buf, xr, n, part * kChunk);
      chunk_tau<KM, VEC>(buf, part * kChunk, n, k, tv, ti);
    }
    for (int c = part; c < n_chunks; c += wpr) {
      const int base = c * kChunk;
      if (c + wpr < n_chunks) topk_load<KM, VEC>(nxt, xr, n, (c + wpr) * kChunk);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int e = topk_entry<KM, VEC>(base, j);
        const bool keep = e < n && !ranks_before(tv, ti, buf[j], e);
        const unsigned kept = __ballot_sync(nm::kFullMask, keep);
        const int at = count + __popc(kept & ((1u << lane) - 1));
        if (keep && at < kTopkCandidates) {
          cand_v[at] = buf[j];
          cand_i[at] = e;
        }
        count += __popc(kept);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) buf[j] = nxt[j];
    }
    if (count <= kTopkCandidates) {
      // each candidate's place is the number of candidates before it
      __syncwarp();
      for (int i = lane; i < count; i += 32) {
        const float v = cand_v[i];
        const int e = cand_i[i];
        int place = 0;
        for (int j = 0; j < count; ++j) place += ranks_before(cand_v[j], cand_i[j], v, e);
        if (place < k) {
          out_v[place] = v;
          out_i[place] = e;
        }
      }
      done = true;
    }
  }
  if (!done) {
    // k > 32, or more candidates than the buffer holds (rows of ties or
    // sorted rows): each lane keeps the best KM of its entries, sorted, in
    // registers; the entries that pass both thresholds as a chunk starts are
    // marked in a bit mask and inserted one by one from one copy of the
    // insertion (the list's last entry rises as entries go in, so each is
    // checked again); k rounds over the lists' heads follow
    float lv[KM];
    int li[KM];
#pragma unroll
    for (int p = 0; p < KM; ++p) {  // the sentinel ranks after every entry
      lv[p] = -INFINITY;
      li[p] = INT_MAX;
    }
    float buf[V], nxt[V];
    if (part < n_chunks) topk_load<KM, VEC>(buf, xr, n, part * kChunk);
    for (int c = part; c < n_chunks; c += wpr) {
      const int base = c * kChunk;
      if (c + wpr < n_chunks) topk_load<KM, VEC>(nxt, xr, n, (c + wpr) * kChunk);
      unsigned long long pass = 0;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int e = topk_entry<KM, VEC>(base, j);
        if (e < n && ranks_before(buf[j], e, lv[KM - 1], li[KM - 1]) &&
            !ranks_before(tv, ti, buf[j], e))
          pass |= 1ull << j;
      }
      while (pass) {
        const int e = topk_entry<KM, VEC>(base, __ffsll(pass) - 1);
        pass &= pass - 1;
        const float v = __ldg(xr + e);  // in L1: the chunk was just read
        if (ranks_before(v, e, lv[KM - 1], li[KM - 1])) list_insert<KM>(lv, li, v, e);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) buf[j] = nxt[j];
    }
    merge_lists<KM>(lv, li, k, out_v, out_i);
  }
  if (wpr == 1) return;
  __syncthreads();
  if (part != 0 || row >= B) return;
  // the row's k best: lane j < wpr takes warp (warp + j)'s k-list
  const float* src_v = klist_v + lane * kTopkWarpFloats;
  const int* src_i = klist_i + lane * kTopkWarpFloats;
  float lv[KM];
  int li[KM];
#pragma unroll
  for (int p = 0; p < KM; ++p) {
    const bool live = lane < wpr && p < k;
    lv[p] = live ? src_v[p] : -INFINITY;
    li[p] = live ? src_i[p] : INT_MAX;
  }
  merge_lists<KM>(lv, li, k, vals + static_cast<size_t>(row) * k,
                  idx + static_cast<size_t>(row) * k);
}

template <int KM, bool VEC>
int launch_topk(const float* x, float* vals, int* idx, int B, int n, int k, int wpr,
                int rows_per_block, int smem, cudaStream_t stream) {
  const size_t need = sizeof(float) * static_cast<size_t>(wpr) * rows_per_block * kTopkWarpFloats;
  if (static_cast<size_t>(smem) != need) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + rows_per_block - 1) / rows_per_block;
  small_topk_kernel<KM, VEC><<<blocks, 32 * wpr * rows_per_block, smem, stream>>>(x, vals, idx, B,
                                                                                  n, k, wpr);
  return nm::launch_status();
}

}  // namespace

NM_EXPORT int nm_fused_logits(const void* x, const void* w, const void* bias, void* logits,
                              void* rowmax, void* psum, void* lse, int N, int Dm, int Vp,
                              void* stream) {
  if (N < 1 || Dm < 1 || Vp < tc::kN || Vp % tc::kN)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = nm::allow_max_smem(reinterpret_cast<const void*>(fused_logits_kernel));
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = Vp / tc::kN;
  const dim3 grid((N + tc::kM - 1) / tc::kM, R);
  fused_logits_kernel<<<grid, tc::kThreads, kLogitSmem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(logits),
      static_cast<float*>(rowmax), static_cast<float*>(psum), N, Dm, Vp);
  int status = nm::launch_status();
  if (status != 0) return status;
  constexpr int kRowsPerBlock = 8;
  lse_fold_kernel<<<(N + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, 0, s>>>(
      static_cast<const float*>(rowmax), static_cast<const float*>(psum),
      static_cast<float*>(lse), N, R);
  return nm::launch_status();
}

NM_EXPORT int nm_rowmax_lse(const void* x, void* rowmax, void* psum, void* lse, int N, int Vp,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = Vp / 128;
  const dim3 grid(N, (R + kGroupWarps - 1) / kGroupWarps);
  rowmax_lse_kernel<<<grid, 32 * kGroupWarps, 0, s>>>(
      static_cast<const float*>(x), static_cast<float*>(rowmax), static_cast<float*>(psum), Vp);
  int status = nm::launch_status();
  if (status != 0) return status;
  constexpr int kRowsPerBlock = 8;
  lse_fold_kernel<<<(N + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, 0, s>>>(
      static_cast<const float*>(rowmax), static_cast<const float*>(psum),
      static_cast<float*>(lse), N, R);
  return nm::launch_status();
}

// The launch follows ops/beam_select.topk_plan: lists of `k_max` (16, 32 or
// 64 >= k) entries, `wpr` warps a row (1, 2, 4 or 8), `rows_per_block` rows a
// block, 16-byte loads when `vec`, `smem` shared bytes a block (checked).
NM_EXPORT int nm_small_topk(const void* x, void* vals, void* idx, int B, int n, int k, int k_max,
                            int wpr, int rows_per_block, int vec, int smem, void* stream) {
  if (B < 1 || n < 1 || k < 1 || k > n || k > k_max || wpr < 1 || wpr > 8 ||
      rows_per_block < 1 || 32 * wpr * rows_per_block > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  auto* vf = static_cast<float*>(vals);
  auto* ii = static_cast<int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NM_TOPK(KM)                                                                    \
  return vec ? launch_topk<KM, true>(xf, vf, ii, B, n, k, wpr, rows_per_block, smem, s) \
             : launch_topk<KM, false>(xf, vf, ii, B, n, k, wpr, rows_per_block, smem, s)
  switch (k_max) {
    case 16: NM_TOPK(16);
    case 32: NM_TOPK(32);
    case 64: NM_TOPK(64);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NM_TOPK
}

NM_EXPORT const char* nm_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
