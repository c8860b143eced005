// Lineage decode attention (lineage_attention), float32.
//
// Replaces neuralmonkey_tpu/ops/lineage_attention.py `_kernel` (called by
// `lineage_attention`). For each (batch b, head h, beam slot k):
//   s[l]   = (q[b,h,k] * scale) . k_cache[b,h,:,l] + bias[b,k,l],  l < W
//   ctx    = sum_l softmax(s)[l] * v_cache[b,h,l,:]
// over the flat lanes l = t * K + j of the unpermuted caches, the softmax's
// sum floored at 1e-20. The bias (0 on the slot that wrote position t of
// hypothesis k, -1e9 elsewhere) resolves the beam ancestry.
//
// Layouts: q, out (B, H, K, D); k_cache (B, H, D, L); v_cache (B, H, L, D);
// bias (B, K, W) for the first W <= L lanes.
//
// What bounds it on the H100: the bytes of the caches. Every step and layer
// reads K and V of the window once, B * H * W * D * 8 bytes (126 MB at B 64,
// H 8, W 480 = beam 10 x 48 steps, D 64), against 4 flops per byte pair of
// the K slots. The first design loaded each tile with scalar loads and then
// computed, with no copy in flight meanwhile: 1.2 TB/s. A pipelined version of
// it on the CUDA cores (a cp.async ring, three block barriers a tile) reached
// only 1.3 TB/s: its score and context sums, broadcast from shared memory,
// and its block-wide softmax held it, not the copies (with 2 stages and 4
// blocks an SM it beat 3 and 4 stages). This design:
//
// - A block owns one (b, h), a group of 8 * NB slot rows (the beam rounded up
//   to the products' 8-wide tiles; a beam past 32 takes several groups) and a
//   chunk of the lanes (the lane split). It streams tiles of T lanes (32, or
//   16 at head dims past 256, where two stages of 32 would not fit) of K (D
//   rows at stride L), V (T rows of D floats, contiguous) and the bias (the
//   group's rows at stride W) through a
//   ring of 2-4 stages filled by cp.async: 16-byte copies (.cg, through L2
//   only) where L and D are multiples of 4 floats and the caches 16-byte
//   aligned, 4-byte copies otherwise; the bias always takes 4-byte copies (W
//   need not be a multiple of 4). One block barrier a tile, for the ring. The
//   plan (ops/lineage_attention.lineage_plan) picks the stages for the most
//   blocks an SM, by shared memory, threads and the registers the launch
//   bounds allow: a block's warps work in step between its barriers, so more
//   blocks, not more stages, hide the latency (at B 64, H 8, D 64 with
//   64-lane tiles, 2 stages and 2 blocks an SM took 0.075 ms, 4 stages and
//   one block 0.112; 64-lane tiles measured slower than 32, see
//   scripts/kernel_ablation.py).
// - Warp (m, n) owns lanes 16m .. 16m + 15 of every tile and slots 8n ..
//   8n + 7 of the group, and is a flash-decoding worker of its own: its
//   scores are a 16 x 8 tile of K^T q^T, its context a D x 8 tile of V^T P^T,
//   both on the tensor cores in 3xTF32 (mma.sync m16n8k8, each float32
//   operand split into two TF32 parts and three products kept, which holds
//   float32 accuracy, as K3 and the fused cross-entropy do); its online max
//   and sum of each slot are warp shuffles, and its weights reach the context
//   product through 512 bytes of its own shared memory. The warps of a slot
//   group meet once, at the end, and fold their (max, sum, context) in one
//   fixed order.
// - The lane split: with S > 1 chunks each block writes its unnormalised
//   context, max and sum; a second small kernel folds the S partials of a row
//   in one fixed order (rescaling each by exp(m_s - M)), with no atomics. The
//   plan splits when the (b, h, group) blocks would not fill the card twice
//   (a server decoding a few sentences), not at B 64, H 8.
// - The bias of b is read by the H blocks of its heads, which are neighbours
//   in launch order: it stays on the L2 path (1.2 MB against the caches'
//   126 MB at the smoke shape).
// - Head dims up to 512 in this design, padded to 32, 64, 128, 256 or 512;
//   past 512 the chunked instance below (lineage_wide_kernel) takes any head
//   dim, as the JAX decoder's gate admits any multiple of 128.
// - A lane whose scores are all -1e9 (an early step) gets the plain version's
//   uniform weights; a warp whose lanes of a tile lie past the chunk keeps
//   max -inf and adds nothing, never exp(-inf - -inf).
//
// The bf16 instance (nm_lineage_attention_bf16, at the end of this file)
// takes bf16 caches, as the JAX kernel does under the bf16 compute policy, and
// rounds where it rounds (`_kernel`, lineage_attention.py:71-86): q to bf16,
// then q times the scale (itself rounded to bf16) to bf16 again; the scores
// and the softmax in float32; the NORMALISED weights to bf16 before the
// context product; a float32 context. Both products run on mma.sync
// m16n8k16 in bf16 with float32 sums, one pass each (a product of two bf16
// values is exact in float32). Normalising before rounding needs each row's
// max and sum before any weight, so no online softmax. What bounds it: the
// bf16 caches' bytes (63 MB at B 64, H 8, 480 lanes, D 64), read once.
//   - lineage_bf16_pass_kernel: a block owns one (b, h) and 16 slot rows
//     (the beam; a beam past 16 takes several groups) and, at the lane split,
//     a chunk of the window as one rank of a thread-block cluster (when B * H
//     blocks do not fill the card, or one block's shared memory cannot hold
//     the window's scores). Thread 0 streams the chunk's K tiles, then its V
//     tiles, by TMA into a ring of 2-4 stages (64 lanes a tile, copied as
//     they lie with the 128-byte swizzle: K as its D rows of 64 lanes, V as
//     64 rows in column blocks of 64; lanes past the window and rows past D
//     zero-filled), each stage's "full" mbarrier telling the warps it has
//     landed and its "empty" one telling thread 0 the warps are done with it.
//     The scores (16 slots x the chunk, float32) stay in shared memory: q K
//     with q as A and the K tile read transposed by ldmatrix.trans as B;
//     then each row's max and sum over the whole window (the cluster's
//     blocks exchange their rows' partial maxima, then sums, through
//     distributed shared memory, each adding them in rank order), the
//     normalised weights rounded to bf16 over the scores; then the context w
//     V, the V tile read transposed as B. At the lane split each block's
//     partial context goes to its ring and each block sums a share of the
//     entries over the cluster's partials in rank order: no scratch, no
//     second kernel, no atomics. The shape gate (ops/lineage_attention.
//     lineage_bf16_pass_plan): L and D multiples of 8 and 16-byte aligned
//     caches (TMA's row strides), D up to 256, the chunk's scores within a
//     block's shared memory at clusters of up to 8.
//   - the shapes past it take the scratch design (nm_lineage_attention_
//     bf16_scratch, counted as lineage_attention_bf16_scratch), any head dim:
//     lineage_bf16_scores_kernel writes the biased scores of every (row,
//     lane) to a float32 scratch; lineage_bf16_context_kernel reads a row's
//     scores twice for its max and sum, then streams V's lane tiles, rounds
//     each weight exp(s - max) / sum to bf16 and adds V^T w^T on the tensor
//     cores, 256 columns a block; a fold adds the lane split's partials.
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <algorithm>

#include "tc_product.cuh"
#include "tma.cuh"

namespace {

namespace cg = cooperative_groups;
namespace tc = nm::tc;

struct Args {
  const float* q;
  const float* kc;
  const float* vc;
  const float* bias;
  float* out;
  float* part_o;   // (S, B*H*K, D): a split's unnormalised context
  float* part_ml;  // (S, B*H*K, 2): its max and sum
  int H, K, D, L, W, chunk, stages, vec;
  float scale;
};

// Lanes a stage at a padded head dim: 32, or 16 past 256
template <int DMAX>
constexpr int lane_tile() {
  return DMAX > 256 ? 16 : 32;
}

// The tile shapes of one instance: DMAX the head dim padded to 32, 64, 128,
// 256 or 512; NB slot tiles of 8 a group; T lanes a stage.
template <int DMAX, int NB, int T>
struct Shape {
  static constexpr int kT = T;         // lanes a stage
  static constexpr int kMB = kT / 16;  // lane tiles of 16
  static constexpr int kWarps = kMB * NB;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kSlots = 8 * NB;
  static constexpr int kLdK = kT + 8;    // K tile [d][lane]: conflict-free A reads
  static constexpr int kLdV = DMAX + 8;  // V tile [lane][d]: conflict-free A reads
  static constexpr int kLdQ = DMAX + 4;  // q [slot][d]: conflict-free B reads
  static constexpr int kStage = DMAX * kLdK + kT * kLdV + kSlots * kT;
  // q, then each warp's 16 x 8 weights
  static constexpr int kFixed = kSlots * kLdQ + kWarps * 128;
  // registers a thread (the launch bounds): 128, so that the blocks the plan
  // counts on an SM are not cut further; 256 from DMAX 256 (one block an SM
  // by shared memory), whose context takes 64 or 128
  static constexpr int kRegs = DMAX >= 256 ? 256 : 128;
};

template <int DMAX, int NB, int T>
size_t smem_bytes(int stages) {
  using S = Shape<DMAX, NB, T>;
  return sizeof(float) * (static_cast<size_t>(stages) * S::kStage + S::kFixed);
}

// Issue the copies of one tile (lanes l0 .., those at or past `end`
// zero-filled; K rows from D to D rounded up to 8 zero-filled) into `st`.
template <int DMAX, int NB, int T>
__device__ __forceinline__ void load_tile(float* st, const Args& a, const float* kb,
                                          const float* vb, const float* bb, int k0, int l0,
                                          int end) {
  using S = Shape<DMAX, NB, T>;
  float* sk = st;                        // [DMAX][kLdK]
  float* sv = sk + DMAX * S::kLdK;       // [kT][kLdV]
  float* sbias = sv + S::kT * S::kLdV;   // [kSlots][kT]
  const int D = a.D, D8 = (a.D + 7) & ~7;
  if (a.vec) {  // L and D multiples of 4, the caches 16-byte aligned
    constexpr int kRow = S::kT / 4;
    for (int c = threadIdx.x; c < D8 * kRow; c += S::kThreads) {
      const int d = c / kRow, j = (c % kRow) * 4;
      const int valid = d < D ? min(max(end - (l0 + j), 0), 4) : 0;
      nm::cp_async16(sk + d * S::kLdK + j,
                     valid ? kb + static_cast<size_t>(d) * a.L + l0 + j : kb, 4 * valid);
    }
    constexpr int kCols = DMAX / 4;
    for (int c = threadIdx.x; c < S::kT * kCols; c += S::kThreads) {
      const int r = c / kCols, j = (c % kCols) * 4;
      if (j >= D) continue;
      const bool ok = l0 + r < end;
      nm::cp_async16(sv + r * S::kLdV + j, ok ? vb + static_cast<size_t>(l0 + r) * D + j : vb,
                     ok ? 16 : 0);
    }
  } else {  // rows of K or V not 16-byte aligned: 4-byte copies
    for (int c = threadIdx.x; c < D8 * S::kT; c += S::kThreads) {
      const int d = c / S::kT, j = c % S::kT;
      const bool ok = d < D && l0 + j < end;
      nm::cp_async4(sk + d * S::kLdK + j, ok ? kb + static_cast<size_t>(d) * a.L + l0 + j : kb,
                    ok ? 4 : 0);
    }
    for (int c = threadIdx.x; c < S::kT * DMAX; c += S::kThreads) {
      const int r = c / DMAX, j = c % DMAX;
      if (j >= D) continue;
      const bool ok = l0 + r < end;
      nm::cp_async4(sv + r * S::kLdV + j, ok ? vb + static_cast<size_t>(l0 + r) * D + j : vb,
                    ok ? 4 : 0);
    }
  }
  for (int c = threadIdx.x; c < S::kSlots * S::kT; c += S::kThreads) {
    const int r = c / S::kT, j = c % S::kT;
    const bool ok = k0 + r < a.K && l0 + j < end;
    nm::cp_async4(sbias + c, ok ? bb + static_cast<size_t>(r) * a.W + l0 + j : bb, ok ? 4 : 0);
  }
}

// wait until at most `stages - 2` groups of copies are in flight
__device__ __forceinline__ void wait_for_tile(int stages) {
  if (stages >= 4)
    nm::cp_async_wait<2>();
  else if (stages == 3)
    nm::cp_async_wait<1>();
  else
    nm::cp_async_wait<0>();
}

// acc += A B in 3xTF32 for one m16n8k8 step: the small terms first
__device__ __forceinline__ void mma3(float (&acc)[4], const float (&av)[4], float b0, float b1) {
  unsigned ah[4], al[4], bh0, bl0, bh1, bl1;
#pragma unroll
  for (int i = 0; i < 4; ++i) tc::split(av[i], ah[i], al[i]);
  tc::split(b0, bh0, bl0);
  tc::split(b1, bh1, bl1);
  tc::mma(acc, al, bh0, bh1);
  tc::mma(acc, ah, bl0, bl1);
  tc::mma(acc, ah, bh0, bh1);
}

template <int DMAX, int NB, int T>
__global__ void __launch_bounds__(Shape<DMAX, NB, T>::kThreads,
                                  65536 / (Shape<DMAX, NB, T>::kRegs *
                                           Shape<DMAX, NB, T>::kThreads))
    lineage_kernel(const Args a) {
  using S = Shape<DMAX, NB, T>;
  constexpr int kMBlocks = DMAX / 16;  // the context's 16-row tiles of d
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* sq = ring + a.stages * S::kStage;  // [kSlots][kLdQ], pre-scaled
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int mw = warp % S::kMB, nw = warp / S::kMB;  // lane tile, slot tile
  float* sp = sq + S::kSlots * S::kLdQ + warp * 128;  // this warp's [16][8] weights

  const int bh = blockIdx.x, b = bh / a.H;
  const int k0 = blockIdx.y * S::kSlots;
  const int begin = blockIdx.z * a.chunk, end = min(a.W, begin + a.chunk);
  const int n_tiles = end > begin ? (end - begin + S::kT - 1) / S::kT : 0;
  const float* kb = a.kc + static_cast<size_t>(bh) * a.D * a.L;
  const float* vb = a.vc + static_cast<size_t>(bh) * a.L * a.D;
  const float* bb = a.bias + (static_cast<size_t>(b) * a.K + k0) * a.W;

  for (int s = 0; s < a.stages - 1; ++s) {
    if (s < n_tiles)
      load_tile<DMAX, NB, T>(ring + s * S::kStage, a, kb, vb, bb, k0, begin + s * S::kT, end);
    nm::cp_async_commit();
  }
  for (int i = threadIdx.x; i < S::kSlots * S::kLdQ; i += S::kThreads) {
    const int r = i / S::kLdQ, d = i % S::kLdQ;
    sq[i] = (k0 + r < a.K && d < a.D)
                ? a.q[(static_cast<size_t>(bh) * a.K + k0 + r) * a.D + d] * a.scale
                : 0.f;
  }

  const int k_steps = (a.D + 7) / 8, m_blocks = (a.D + 15) / 16;
  const float* qb = sq + (nw * 8 + g) * S::kLdQ + t;  // B reads of the scores
  float o[kMBlocks][4];  // context^T: rows d, columns this warp's 8 slots
#pragma unroll
  for (int i = 0; i < kMBlocks; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  // the online max and sum of slots 8 nw + 2t and 8 nw + 2t + 1
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int tile = 0; tile < n_tiles; ++tile) {
    wait_for_tile(a.stages);
    __syncthreads();  // this tile has landed; every warp is done with the last
    const int next = tile + a.stages - 1;
    if (next < n_tiles)
      load_tile<DMAX, NB, T>(ring + (next % a.stages) * S::kStage, a, kb, vb, bb, k0,
                          begin + next * S::kT, end);
    nm::cp_async_commit();
    const float* sk = ring + (tile % a.stages) * S::kStage;
    const float* sv = sk + DMAX * S::kLdK;
    const float* sbias = sv + S::kT * S::kLdV;
    const int m0 = mw * 16;  // this warp's lanes in the tile

    // scores^T (16 lanes x 8 slots) = K^T q^T over d, the even and odd
    // depth steps in separate sums so that the products do not wait on one
    // another
    float acc[4] = {}, odd[4] = {};
    for (int ks = 0; ks < k_steps; ks += 2) {
      const float* ka = sk + (ks * 8 + t) * S::kLdK + m0 + g;
      const float av[4] = {ka[0], ka[8], ka[4 * S::kLdK], ka[4 * S::kLdK + 8]};
      mma3(acc, av, qb[ks * 8], qb[ks * 8 + 4]);
      if (ks + 1 < k_steps) {
        const float* kn = ka + 8 * S::kLdK;
        const float an[4] = {kn[0], kn[8], kn[4 * S::kLdK], kn[4 * S::kLdK + 8]};
        mma3(odd, an, qb[ks * 8 + 8], qb[ks * 8 + 12]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += odd[e];
    // acc[2h + j]: lane m0 + g + 8h, slot 8 nw + 2t + j
    const int l_lo = begin + tile * S::kT + m0 + g;
    float p[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float sc[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        sc[h] = l_lo + 8 * h < end
                    ? acc[2 * h + j] + sbias[(nw * 8 + 2 * t + j) * S::kT + m0 + g + 8 * h]
                    : -INFINITY;
      float mx = fmaxf(sc[0], sc[1]);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(nm::kFullMask, mx, off));
      const float m_new = fmaxf(m_run[j], mx);
      // all of this warp's lanes so far past the chunk: nothing to add
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m_run[j] - m_use);
      p[0][j] = expf(sc[0] - m_use);
      p[1][j] = expf(sc[1] - m_use);
      float sum = p[0][j] + p[1][j];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) sum += __shfl_xor_sync(nm::kFullMask, sum, off);
      l_run[j] = l_run[j] * corr + sum;
      m_run[j] = m_new;
#pragma unroll
      for (int i = 0; i < kMBlocks; ++i) {
        o[i][j] *= corr;
        o[i][2 + j] *= corr;
      }
    }
    // the weights, [lane][slot], for the context's B reads
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j) sp[(g + 8 * h) * 8 + 2 * t + j] = p[h][j];
    __syncwarp();
    // context^T (d x 8 slots) += V^T P^T over this warp's 16 lanes
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const float b0 = sp[(kk * 8 + t) * 8 + g], b1 = sp[(kk * 8 + t + 4) * 8 + g];
      const float* va = sv + (m0 + kk * 8 + t) * S::kLdV + g;
#pragma unroll
      for (int i = 0; i < kMBlocks; ++i) {
        if (i < m_blocks) {
          const float av[4] = {va[16 * i], va[16 * i + 8], va[4 * S::kLdV + 16 * i],
                               va[4 * S::kLdV + 16 * i + 8]};
          mma3(o[i], av, b0, b1);
        }
      }
    }
    __syncwarp();  // the weights are read before the next tile writes them
  }

  nm::cp_async_wait<0>();
  __syncthreads();  // the ring is free: it takes the warps' partials
  // warp w: its (max, sum) of 8 slots, then its context^T [d][8 slots]
  float* wpart = ring + warp * (16 + DMAX * 8);
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wpart[2 * (2 * t + j)] = m_run[j];
      wpart[2 * (2 * t + j) + 1] = l_run[j];
    }
  }
#pragma unroll
  for (int i = 0; i < kMBlocks; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      wpart[16 + (16 * i + g + 8 * (e / 2)) * 8 + 2 * t + e % 2] = o[i][e];
  __syncthreads();
  // fold the kMB lane tiles of each slot, in order
  const size_t rows = static_cast<size_t>(gridDim.x) * a.K;
  for (int i = threadIdx.x; i < S::kSlots * DMAX; i += S::kThreads) {
    const int slot = i / DMAX, d = i % DMAX;
    if (k0 + slot >= a.K || d >= a.D) continue;
    const int n = slot / 8, c = slot % 8;
    float M = -INFINITY;
#pragma unroll
    for (int m = 0; m < S::kMB; ++m)
      M = fmaxf(M, ring[(n * S::kMB + m) * (16 + DMAX * 8) + 2 * c]);
    float l = 0.f, ctx = 0.f;
#pragma unroll
    for (int m = 0; m < S::kMB; ++m) {
      const float* wp = ring + (n * S::kMB + m) * (16 + DMAX * 8);
      if (wp[2 * c] == -INFINITY) continue;
      const float f = expf(wp[2 * c] - M);
      l += wp[2 * c + 1] * f;
      ctx += wp[16 + d * 8 + c] * f;
    }
    const size_t row = static_cast<size_t>(bh) * a.K + k0 + slot;
    if (gridDim.z == 1) {
      a.out[row * a.D + d] = ctx / fmaxf(l, 1e-20f);
    } else {
      const size_t at = blockIdx.z * rows + row;
      a.part_o[at * a.D + d] = ctx;
      if (d == 0) {
        a.part_ml[2 * at] = M;
        a.part_ml[2 * at + 1] = l;
      }
    }
  }
}

// out[row] = sum_s O_s exp(m_s - M) / max(sum_s l_s exp(m_s - M), 1e-20), in
// split order; a split with no lanes (m = -inf) adds nothing
__global__ void lineage_combine_kernel(const float* __restrict__ part_o,
                                       const float* __restrict__ part_ml, float* __restrict__ out,
                                       int rows, int D, int S) {
  const size_t row = blockIdx.x;
  float M = -INFINITY;
  for (int s = 0; s < S; ++s) M = fmaxf(M, part_ml[2 * (s * static_cast<size_t>(rows) + row)]);
  float l = 0.f;
  for (int s = 0; s < S; ++s) {
    const float* ml = part_ml + 2 * (s * static_cast<size_t>(rows) + row);
    if (ml[0] != -INFINITY) l += ml[1] * expf(ml[0] - M);
  }
  const float inv = 1.f / fmaxf(l, 1e-20f);
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s) {
      const size_t at = s * static_cast<size_t>(rows) + row;
      const float m = part_ml[2 * at];
      if (m != -INFINITY) acc += part_o[at * D + c] * expf(m - M);
    }
    out[row * D + c] = acc * inv;
  }
}

// ------------------------------------------------------------------------ //
// head dims past 512: the chunked instance
// ------------------------------------------------------------------------ //
// A block owns one beam slot (blockIdx.x: the slots of a (b, h) are
// neighbours in launch order, so the caches they all read stay in L2), one
// (b, h), one lane chunk and one column block of kWideCols columns of the
// context (blockIdx.z = split * column blocks + column block). It walks its
// chunk kWideLanes lanes at a time: each tile's scores are summed over the
// whole head dim, warp w taking d = w, w + 4, ...
// (K's rows at stride L, so a warp reads 32 consecutive lanes of a row), and
// folded across the four warps through shared memory; warp 0 keeps the
// online max and sum of the slot and hands the tile's weights to every thread
// through shared memory; each thread adds them into its kWideCols / 128
// context columns (V's rows contiguous, so a warp reads 32 consecutive
// columns). The lane split's partials and their fold are the single-pass
// kernel's (lineage_combine_kernel). Every column block recomputes the
// scores, and every slot reads the caches again (through L2): a simple
// kernel that is right first (PERF.md has its time against its bound).
constexpr int kWideThreads = 128;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideLanes = 32;
constexpr int kWideCols = 512;

// shared floats of the chunked instance: q (rounded up to 4), each warp's
// partial scores of a tile, the tile's weights, and the rescale, max and sum
inline size_t wide_smem_bytes(int D) {
  return sizeof(float) * (((D + 3) & ~3) + kWideWarps * kWideLanes + kWideLanes + 4);
}

__global__ void __launch_bounds__(kWideThreads, 4) lineage_wide_kernel(const Args a, int col_blocks) {
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                                   // [D] this slot's q, pre-scaled
  float* part = sq + ((a.D + 3) & ~3);                // [warps][lanes] partial scores
  float* sp = part + kWideWarps * kWideLanes;         // [lanes] the tile's weights
  float* sstat = sp + kWideLanes;                     // rescale, max, sum
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = blockIdx.x, bh = blockIdx.y, b = bh / a.H;
  const int split = blockIdx.z / col_blocks, cb = blockIdx.z % col_blocks;
  const int begin = split * a.chunk, end = min(a.W, begin + a.chunk);
  const float* kb = a.kc + static_cast<size_t>(bh) * a.D * a.L;
  const float* vb = a.vc + static_cast<size_t>(bh) * a.L * a.D;
  const float* brow = a.bias + (static_cast<size_t>(b) * a.K + slot) * a.W;
  const size_t row = static_cast<size_t>(bh) * a.K + slot;
  for (int d = threadIdx.x; d < a.D; d += kWideThreads) sq[d] = a.q[row * a.D + d] * a.scale;

  constexpr int kCols = kWideCols / kWideThreads;  // context columns a thread
  const int c_first = cb * kWideCols + threadIdx.x;
  float o[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) o[j] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;  // warp 0's
  __syncthreads();  // q is in place

  for (int l0 = begin; l0 < end; l0 += kWideLanes) {
    const int l = l0 + lane;
    float acc = 0.f;
    if (l < end) {
      // unrolled so that the K rows' loads are in flight together
#pragma unroll 8
      for (int d = warp; d < a.D; d += kWideWarps)
        acc = fmaf(sq[d], kb[static_cast<size_t>(d) * a.L + l], acc);
    }
    part[warp * kWideLanes + lane] = acc;
    __syncthreads();  // the partial scores are in place
    if (warp == 0) {
      float sc = -INFINITY;
      if (l < end) {
        sc = brow[l];
#pragma unroll
        for (int w = 0; w < kWideWarps; ++w) sc += part[w * kWideLanes + lane];
      }
      // every lane of [begin, end) has a finite score (its bias is 0 or
      // -1e9), so m_new is finite from the first tile on
      const float m_new = fmaxf(m_run, nm::warp_max(sc));
      const float p = expf(sc - m_new);
      const float corr = expf(m_run - m_new);
      l_run = l_run * corr + nm::warp_sum(p);
      m_run = m_new;
      sp[lane] = p;
      if (lane == 0) sstat[0] = corr;
    }
    __syncthreads();  // the weights and the rescale are in place
    const float corr = sstat[0];
    const int n = min(kWideLanes, end - l0);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = c_first + j * kWideThreads;
      float acc_c = o[j] * corr;
      if (c < a.D) {
#pragma unroll 8
        for (int x = 0; x < n; ++x)
          acc_c = fmaf(sp[x], vb[static_cast<size_t>(l0 + x) * a.D + c], acc_c);
      }
      o[j] = acc_c;
    }
    __syncthreads();  // the weights are read before the next tile writes them
  }

  if (threadIdx.x == 0) {
    sstat[1] = m_run;
    sstat[2] = l_run;
  }
  __syncthreads();
  const float M = sstat[1], l = sstat[2];
  const size_t rows = static_cast<size_t>(gridDim.y) * a.K;
  const int splits = gridDim.z / col_blocks;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int c = c_first + j * kWideThreads;
    if (c >= a.D) continue;
    if (splits == 1)
      a.out[row * a.D + c] = o[j] / fmaxf(l, 1e-20f);
    else
      a.part_o[(split * rows + row) * a.D + c] = o[j];
  }
  if (splits > 1 && cb == 0 && threadIdx.x == 0) {
    a.part_ml[2 * (split * rows + row)] = M;
    a.part_ml[2 * (split * rows + row) + 1] = l;
  }
}

int launch_wide(const Args& a, int BH, int splits, int smem, cudaStream_t stream) {
  if (static_cast<size_t>(smem) != wide_smem_bytes(a.D) || a.stages != 1 || a.chunk % kWideLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = nm::allow_max_smem(reinterpret_cast<const void*>(lineage_wide_kernel));
  if (err != 0) return err;
  const int col_blocks = (a.D + kWideCols - 1) / kWideCols;
  lineage_wide_kernel<<<dim3(a.K, BH, splits * col_blocks), kWideThreads, smem, stream>>>(
      a, col_blocks);
  int status = nm::launch_status();
  if (status != 0 || splits == 1) return status;
  lineage_combine_kernel<<<BH * a.K, 64, 0, stream>>>(a.part_o, a.part_ml, a.out, BH * a.K, a.D,
                                                      splits);
  return nm::launch_status();
}

template <int DMAX, int NB, int T>
int launch(const Args& a, int BH, int groups, int splits, int smem, cudaStream_t stream) {
  using S = Shape<DMAX, NB, T>;
  if (static_cast<size_t>(smem) != smem_bytes<DMAX, NB, T>(a.stages) || a.stages < 2 ||
      a.stages > 4 || a.chunk % S::kT)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err =
      nm::allow_max_smem(reinterpret_cast<const void*>(lineage_kernel<DMAX, NB, T>));
  if (err != 0) return err;
  lineage_kernel<DMAX, NB, T><<<dim3(BH, groups, splits), S::kThreads, smem, stream>>>(a);
  int status = nm::launch_status();
  if (status != 0 || splits == 1) return status;
  lineage_combine_kernel<<<BH * a.K, 64, 0, stream>>>(a.part_o, a.part_ml, a.out, BH * a.K, a.D,
                                                      splits);
  return nm::launch_status();
}

template <int DMAX>
int launch_slots(const Args& a, int BH, int tile, int slots, int groups, int splits, int smem,
                 cudaStream_t stream) {
  constexpr int T = lane_tile<DMAX>();
  if (tile != T) return static_cast<int>(cudaErrorInvalidValue);
  switch (slots) {
    case 8: return launch<DMAX, 1, T>(a, BH, groups, splits, smem, stream);
    case 16: return launch<DMAX, 2, T>(a, BH, groups, splits, smem, stream);
    case 24: return launch<DMAX, 3, T>(a, BH, groups, splits, smem, stream);
    case 32: return launch<DMAX, 4, T>(a, BH, groups, splits, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ------------------------------------------------------------------------ //
// the bf16 instance
// ------------------------------------------------------------------------ //
constexpr int kB16Threads = 128;  // 4 warps in both kernels
constexpr int kB16ScoreLanes = 64;  // lanes a scores block: 16 a warp
constexpr int kB16DChunk = 256;     // head-dim columns a shared stage of the scores
constexpr int kB16ScoreSlots = 64;  // slot rows a scores block, in tiles of 8
constexpr int kB16CtxLanes = 64;    // lanes a context step: four m16n8k16 depths
constexpr int kB16CtxCols = 256;    // context columns a block: 4 16-row tiles a warp
constexpr int kB16LdV = kB16CtxLanes + 8;  // V^T [d][lane] rows, bf16

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two consecutive bf16 of shared memory as one mma operand register
__device__ __forceinline__ unsigned pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

struct B16Args {
  const float* q;
  const __nv_bfloat16* kc;
  const __nv_bfloat16* vc;
  const float* bias;
  float* out;
  float* scores;  // (B*H*K, W) biased scores
  float* part_o;  // (S, B*H*K, D) normalised partial contexts of the lane split
  int H, K, D, L, W, chunk, col_blocks;
  int vec;   // V's rows 16-byte aligned (D a multiple of 8): 16-byte loads
  int kvec;  // K's rows 16-byte aligned (L a multiple of 8): 16-byte loads
  int ld;    // the scores kernel's shared rows: the head-dim chunk (to 16) + 8
  float scale;
};

// scores[row, l] = (bf16(bf16(q) * bf16(scale)) . K[:, l]) + bias: block
// (b, h), 64 lanes, 64 slot rows; warp w owns lanes 16 w .. 16 w + 15 and all
// slot tiles, its sums scores^T = K^T qs^T (16 lanes x 8 slots a tile) on
// mma.sync m16n8k16. The K tile is staged [lane][d] (16-byte loads along the
// lanes where K's rows allow) and q [slot][d], so every operand register is
// two neighbouring bf16 of one shared row; the rows are as long as the head
// dim's chunk needs (a.ld), so that small head dims keep many blocks an SM.
__global__ void __launch_bounds__(kB16Threads) lineage_bf16_scores_kernel(const B16Args a) {
  extern __shared__ __align__(16) unsigned char smem_b16[];
  const int ld = a.ld;
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem_b16);  // [64][ld]
  __nv_bfloat16* sq = sk + kB16ScoreLanes * ld;                    // [64][ld]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x, b = bh / a.H;
  const int l0 = blockIdx.y * kB16ScoreLanes;
  const int k0 = blockIdx.z * kB16ScoreSlots;
  const int slots = min(kB16ScoreSlots, a.K - k0);
  const int n_tiles = (slots + 7) / 8;
  const __nv_bfloat16* kb = a.kc + static_cast<size_t>(bh) * a.D * a.L;
  const __nv_bfloat16 scale = __float2bfloat16_rn(a.scale);
  float acc[kB16ScoreSlots / 8][4];
#pragma unroll
  for (int n = 0; n < kB16ScoreSlots / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int d0 = 0; d0 < a.D; d0 += kB16DChunk) {
    const int dw = min(kB16DChunk, (a.D - d0 + 15) / 16 * 16);  // columns, to 16
    __syncthreads();  // the last chunk's operands are read
    // K (D, L): neighbouring threads read neighbouring lanes of a row, 8 a
    // thread where the row allows 16-byte loads and the 8 lanes lie below W
    for (int i = threadIdx.x; i < dw * (kB16ScoreLanes / 8); i += kB16Threads) {
      const int d = i / (kB16ScoreLanes / 8), j = (i % (kB16ScoreLanes / 8)) * 8;
      const int gd = d0 + d, gl = l0 + j;
      if (a.kvec && gd < a.D && gl + 8 <= a.W) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kb + static_cast<size_t>(gd) * a.L + gl);
        const __nv_bfloat16* k8 = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int e = 0; e < 8; ++e) sk[(j + e) * ld + d] = k8[e];
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          sk[(j + e) * ld + d] = (gd < a.D && gl + e < a.W)
                                     ? kb[static_cast<size_t>(gd) * a.L + gl + e]
                                     : __float2bfloat16_rn(0.f);
      }
    }
    for (int i = threadIdx.x; i < n_tiles * 8 * dw; i += kB16Threads) {
      const int r = i / dw, d = i % dw, gd = d0 + d;
      __nv_bfloat16 v = __float2bfloat16_rn(0.f);
      if (r < slots && gd < a.D) {
        const float qv = a.q[(static_cast<size_t>(bh) * a.K + k0 + r) * a.D + gd];
        v = __float2bfloat16_rn(__bfloat162float(__float2bfloat16_rn(qv)) *
                                __bfloat162float(scale));
      }
      sq[r * ld + d] = v;
    }
    __syncthreads();
    const __nv_bfloat16* ka = sk + (warp * 16 + g) * ld + 2 * t;
    for (int ks = 0; ks < dw; ks += 16) {
      const unsigned av[4] = {pair(ka + ks), pair(ka + 8 * ld + ks), pair(ka + ks + 8),
                              pair(ka + 8 * ld + ks + 8)};
#pragma unroll
      for (int n = 0; n < kB16ScoreSlots / 8; ++n) {
        if (n < n_tiles) {
          const __nv_bfloat16* qb = sq + (n * 8 + g) * ld + ks + 2 * t;
          mma_bf16(acc[n], av, pair(qb), pair(qb + 8));
        }
      }
    }
  }
  // acc[n][2h + j]: lane l0 + 16 warp + g + 8 h, slot k0 + 8 n + 2 t + j
#pragma unroll
  for (int n = 0; n < kB16ScoreSlots / 8; ++n) {
    if (n >= n_tiles) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int l = l0 + warp * 16 + g + 8 * (e / 2), k = k0 + n * 8 + 2 * t + e % 2;
      if (l < a.W && k < a.K)
        a.scores[(static_cast<size_t>(bh) * a.K + k) * a.W + l] =
            acc[n][e] + a.bias[(static_cast<size_t>(b) * a.K + k) * a.W + l];
    }
  }
}

// context[row] = sum_l bf16(exp(s_l - max) / max(sum, 1e-20)) V[l]: block (b, h),
// 8 slot rows, one lane chunk and one block of 256 context columns
// (blockIdx.z = split * col_blocks + column block). Each warp folds two rows'
// max and sum over all W scores (the normalisation is the whole row's, whatever
// the chunk), then the block walks its chunk 64 lanes at a time: the weights
// [slot][lane] and the V tile transposed to [d][lane] (16-byte loads along d
// where V's rows allow) in shared memory, and warp w adds V^T w^T for the
// 16-row tiles of d w, w + 4, ... on mma.sync m16n8k16, four depth steps a
// tile. With S > 1 chunks the block writes its normalised partial to part_o
// and lineage_bf16_fold_kernel adds the S partials in order.
__global__ void __launch_bounds__(kB16Threads) lineage_bf16_context_kernel(const B16Args a) {
  __shared__ __align__(16) __nv_bfloat16 sw[8 * kB16LdV];
  // [columns][kB16LdV]: as many columns as the head dim needs, up to 256, so
  // that small head dims keep many blocks an SM
  extern __shared__ __align__(16) __nv_bfloat16 sv[];
  __shared__ float s_max[8], s_sum[8];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x, k0 = blockIdx.y * 8;
  const int split = blockIdx.z / a.col_blocks, c0 = (blockIdx.z % a.col_blocks) * kB16CtxCols;
  const int cw = min(kB16CtxCols, (a.D - c0 + 15) / 16 * 16);  // columns, to 16
  const int begin = split * a.chunk, end = min(a.W, begin + a.chunk);
  const __nv_bfloat16* vb = a.vc + static_cast<size_t>(bh) * a.L * a.D;
  const float* srow = a.scores + (static_cast<size_t>(bh) * a.K + k0) * a.W;

  for (int r = 2 * warp; r < 2 * warp + 2; ++r) {
    float mx = -INFINITY, sum = 0.f;
    if (k0 + r < a.K) {
      // unrolled so that a lane's loads of the row are in flight together
#pragma unroll 4
      for (int l = lane; l < a.W; l += 32) mx = fmaxf(mx, srow[r * a.W + l]);
      mx = nm::warp_max(mx);
#pragma unroll 4
      for (int l = lane; l < a.W; l += 32) sum += expf(srow[r * a.W + l] - mx);
      sum = nm::warp_sum(sum);
    }
    if (lane == 0) {
      s_max[r] = mx;
      s_sum[r] = fmaxf(sum, 1e-20f);
    }
  }
  float acc[kB16CtxCols / 64][4];
#pragma unroll
  for (int i = 0; i < kB16CtxCols / 64; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int l0 = begin; l0 < end; l0 += kB16CtxLanes) {
    __syncthreads();  // the row statistics are in place; the last tile is read
    for (int i = threadIdx.x; i < 8 * kB16CtxLanes; i += kB16Threads) {
      const int r = i / kB16CtxLanes, j = i % kB16CtxLanes;
      const int l = l0 + j;
      float w = 0.f;
      if (k0 + r < a.K && l < end) w = expf(srow[r * a.W + l] - s_max[r]) / s_sum[r];
      sw[r * kB16LdV + j] = __float2bfloat16_rn(w);
    }
    // V (L, D): neighbouring threads read neighbouring columns of a row
    if (a.vec) {
      const int octs = cw / 8;
      for (int i = threadIdx.x; i < kB16CtxLanes * octs; i += kB16Threads) {
        const int j = i / octs, d = (i % octs) * 8;
        const int l = l0 + j;
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (l < end && c0 + d < a.D)
          raw = *reinterpret_cast<const uint4*>(vb + static_cast<size_t>(l) * a.D + c0 + d);
        const __nv_bfloat16* v8 = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int e = 0; e < 8; ++e) sv[(d + e) * kB16LdV + j] = v8[e];
      }
    } else {
      for (int i = threadIdx.x; i < kB16CtxLanes * cw; i += kB16Threads) {
        const int j = i / cw, d = i % cw;
        const int l = l0 + j, gd = c0 + d;
        sv[d * kB16LdV + j] = (l < end && gd < a.D) ? vb[static_cast<size_t>(l) * a.D + gd]
                                                    : __float2bfloat16_rn(0.f);
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kB16CtxLanes; ks += 16) {
      const unsigned b0 = pair(sw + g * kB16LdV + ks + 2 * t);
      const unsigned b1 = pair(sw + g * kB16LdV + ks + 2 * t + 8);
#pragma unroll
      for (int i = 0; i < kB16CtxCols / 64; ++i) {
        const int m0 = (warp + 4 * i) * 16;
        if (m0 < cw) {
          const __nv_bfloat16* va = sv + (m0 + g) * kB16LdV + ks + 2 * t;
          const unsigned av[4] = {pair(va), pair(va + 8 * kB16LdV), pair(va + 8),
                                  pair(va + 8 * kB16LdV + 8)};
          mma_bf16(acc[i], av, b0, b1);
        }
      }
    }
  }
  // acc[i][2h + j]: column c0 + (warp + 4 i) 16 + g + 8 h, slot k0 + 2 t + j
  const size_t rows = static_cast<size_t>(gridDim.x) * a.K;
#pragma unroll
  for (int i = 0; i < kB16CtxCols / 64; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = c0 + (warp + 4 * i) * 16 + g + 8 * (e / 2), k = k0 + 2 * t + e % 2;
      if (d >= c0 + cw || d >= a.D || k >= a.K) continue;
      const size_t row = static_cast<size_t>(bh) * a.K + k;
      if (gridDim.z == static_cast<unsigned>(a.col_blocks))
        a.out[row * a.D + d] = acc[i][e];
      else
        a.part_o[(split * rows + row) * a.D + d] = acc[i][e];
    }
  }
}

// out = the sum of the S normalised partials, in the order 0 .. S-1
__global__ void lineage_bf16_fold_kernel(const float* __restrict__ part_o,
                                         float* __restrict__ out, size_t count, int S) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < count;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float sum = part_o[i];
    for (int s = 1; s < S; ++s) sum += part_o[s * count + i];
    out[i] = sum;
  }
}

// the scores kernel's shared row length for head dim D: its widest chunk,
// rounded up to 16, plus 8 (conflict-free operand reads), and its bytes
inline int b16_scores_ld(int D) { return std::min(kB16DChunk, (D + 15) / 16 * 16) + 8; }
// the context kernel's shared V tile for head dim D: its widest column block,
// rounded up to 16, by kB16LdV
inline size_t b16_context_smem(int D) {
  return sizeof(__nv_bfloat16) * std::min(kB16CtxCols, (D + 15) / 16 * 16) * kB16LdV;
}
inline size_t b16_scores_smem(int D) {
  return sizeof(__nv_bfloat16) * 2 * kB16ScoreLanes * b16_scores_ld(D);
}

// ------------------------------------------------------------------------ //
// the bf16 instance in one pass over the caches
// ------------------------------------------------------------------------ //
constexpr int kPassThreads = 256;  // 8 warps
constexpr int kPassSlots = 16;     // slot rows a block: one m16 tile
constexpr int kPassLanes = 64;     // lanes a tile: 128-byte rows of K
constexpr int kPassMaxStages = 4;
constexpr int kPassMaxCluster = 8;

// A block's shared bytes (ops/lineage_attention.bf16_pass_smem_bytes): 1024
// to put the ring on a 1024-byte boundary (TMA's 128-byte swizzle), the
// ring of `stages` tiles of 64 x DMAX bf16 (K's DMAX rows of 64 lanes, or
// V's 64 lanes in column blocks of 64), q [16][DMAX + 8] bf16, the scores
// [rows][chunk + 4] float of the block's slot rows (rows = min(16, K): first
// the bias, then the biased scores, then exp(s - max), then each row's bf16
// weights in its first half), the 8 warps' row maxima, each row's partial
// max and sum, and a full and an empty mbarrier a stage
inline size_t pass_smem_bytes(int dmax, int chunk, int stages, int rows) {
  return 1024 + sizeof(__nv_bfloat16) * (static_cast<size_t>(stages) * kPassLanes * dmax +
                                         kPassSlots * (dmax + 8)) +
         sizeof(float) * (static_cast<size_t>(rows) * (chunk + 4) + 10 * kPassSlots) +
         2 * sizeof(uint64_t) * stages;
}

struct PassArgs {
  const float* q;
  const float* bias;
  float* out;
  int H, K, D, W, chunk, stages;
  float scale;
};

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(nm::tma::smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x2_trans(unsigned& r0, unsigned& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(nm::tma::smem_addr(p))
               : "memory");
}

// Byte offset of 16-byte chunk c of row r of a tile of 128-byte rows, as
// TMA's 128-byte swizzle lays it out
__device__ __forceinline__ int swz128(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// grid (B * H * C, slot groups) in clusters of C: cluster (b, h) of group
// blockIdx.y, rank r owning lanes r * chunk .. of the window; 8 warps, so
// that each warp's share of a block's phases (two slot rows of the softmax)
// is short
template <int DMAX>
__global__ void __launch_bounds__(kPassThreads)
    lineage_bf16_pass_kernel(const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap, const PassArgs a) {
  constexpr int kStage = kPassLanes * DMAX;  // bf16 values a tile
  constexpr int kLdQ = DMAX + 8;
  constexpr int kWarps = kPassThreads / 32;
  constexpr int kWarpCols = DMAX / kWarps;  // context columns a warp
  constexpr int kWarpLanes = kPassLanes / kWarps;  // score lanes a warp a tile
  extern __shared__ __align__(16) unsigned char smem_pass[];
  unsigned char* base =
      smem_pass + ((1024 - (nm::tma::smem_addr(smem_pass) & 1023)) & 1023);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* sq = ring + a.stages * kStage;
  const int ld = a.chunk + 4;
  float* ss = reinterpret_cast<float*>(sq + kPassSlots * kLdQ);
  float* wmax = ss + min(kPassSlots, a.K) * ld;  // [warp][row]
  float* pmax = wmax + kWarps * kPassSlots;
  float* psum = pmax + kPassSlots;
  uint64_t* full = reinterpret_cast<uint64_t*>(psum + kPassSlots);
  uint64_t* empty = full + a.stages;

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / C, b = bh / a.H;
  const int k0 = blockIdx.y * kPassSlots, slots = min(kPassSlots, a.K - k0);
  const int begin = rank * a.chunk, lanes = min(a.W, begin + a.chunk) - begin;
  const int tiles = (lanes + kPassLanes - 1) / kPassLanes;
  const int count = 2 * tiles;  // K's tiles, then V's
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  // tile i of the walk into ring slot `slot`, as it lies: K's DMAX rows of
  // 64 lanes (rows past D, lanes past W zero-filled), or V's 64 lanes in
  // column blocks of 64
  auto load = [&](int slot, int i) {
    __nv_bfloat16* st = ring + slot * kStage;
    uint64_t* bar = &full[slot];
    nm::tma::bar_expect(bar, kStage * sizeof(__nv_bfloat16));
    if (i < tiles) {
      nm::tma::tma3d(st, kmap, begin + i * kPassLanes, 0, bh, bar);
    } else {
      const int l0 = begin + (i - tiles) * kPassLanes;
      for (int c = 0; c < DMAX; c += 64) nm::tma::tma3d(st + c * kPassLanes, vmap, c, l0, bh, bar);
    }
  };
  // a slot refilled once its tile's products are done: each warp arrives on
  // its "empty" barrier and thread 0 waits there, then issues the copy
  auto release = [&](int i) {
    __syncwarp();
    const int slot = i % a.stages;
    if (lane == 0) nm::tma::bar_arrive(&empty[slot]);
    if (threadIdx.x == 0 && i + a.stages < count) {
      nm::tma::bar_wait(&empty[slot], (i / a.stages) & 1);
      load(slot, i + a.stages);
    }
    __syncwarp();
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      nm::tma::bar_init(&full[s], 1);
      nm::tma::bar_init(&empty[s], kWarps);
    }
    nm::tma::bar_init_fence();
  }
  // the bias rows of the block's slots over the chunk, into the scores'
  // rows (the epilogue below adds the products to them), by coalesced
  // asynchronous copies issued ahead of the first tiles' (every block's
  // first tiles reach device memory at once; the bias does not queue behind
  // them) and awaited at the first tile's epilogue
  const float* bb = a.bias + (static_cast<size_t>(b) * a.K + k0) * a.W + begin;
  for (int r = 0; r < slots; ++r)
    for (int l = threadIdx.x; l < lanes; l += kPassThreads)
      nm::cp_async4(ss + r * ld + l, bb + static_cast<size_t>(r) * a.W + l, 4);
  nm::cp_async_commit();
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < min(a.stages, count); ++i) load(i, i);
  // q rounded to bf16, then times the scale rounded to bf16, in bf16
  const __nv_bfloat16 scale = __float2bfloat16_rn(a.scale);
  for (int i = threadIdx.x; i < kPassSlots * DMAX; i += kPassThreads) {
    const int r = i / DMAX, d = i % DMAX;
    __nv_bfloat16 v = __float2bfloat16_rn(0.f);
    if (r < slots && d < a.D) {
      const float qv = a.q[(static_cast<size_t>(bh) * a.K + k0 + r) * a.D + d];
      v = __float2bfloat16_rn(__bfloat162float(__float2bfloat16_rn(qv)) *
                              __bfloat162float(scale));
    }
    sq[r * kLdQ + d] = v;
  }
  __syncthreads();

  // 1. the biased scores over the chunk: warp w the lanes kWarpLanes w ..
  // of each tile, m16n8k16 with q's rows as A and K's tile, read transposed
  // from its rows, as B; each thread's running max of its two slot rows
  constexpr int kTileN = kWarpLanes / 8;
  const int ksteps = (a.D + 15) / 16;
  float run_max[2] = {-INFINITY, -INFINITY};
  for (int i = 0; i < tiles; ++i) {
    const int slot = i % a.stages;
    nm::tma::bar_wait(&full[slot], (i / a.stages) & 1);
    const unsigned char* kt = reinterpret_cast<const unsigned char*>(ring + slot * kStage);
    float acc[kTileN][4] = {};
    for (int ks = 0; ks < ksteps; ++ks) {
      unsigned af[4];
      ldsm_x4(af, sq + (lane % 8 + 8 * (lane / 8 % 2)) * kLdQ + 16 * ks + 8 * (lane / 16));
#pragma unroll
      for (int nt = 0; nt < kTileN; ++nt) {
        unsigned b0, b1;
        ldsm_x2_trans(b0, b1, kt + swz128(16 * ks + lane % 16, kTileN * warp + nt));
        mma_bf16(acc[nt], af, b0, b1);
      }
    }
    release(i);
    if (i == 0) {
      nm::cp_async_wait<0>();
      __syncthreads();  // the bias is in place
    }
    // acc[nt][2 h + e]: slot g + 8 h, lane l + e; lanes past the window
    // score -inf
#pragma unroll
    for (int nt = 0; nt < kTileN; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = g + 8 * h;
        const int l = kPassLanes * i + kWarpLanes * warp + 8 * nt + 2 * t;
        if (r < slots) {
          float2* at = reinterpret_cast<float2*>(ss + r * ld + l);
          const float2 bias = *at;
          const float s0 = l < lanes ? acc[nt][2 * h] + bias.x : -INFINITY;
          const float s1 = l + 1 < lanes ? acc[nt][2 * h + 1] + bias.y : -INFINITY;
          run_max[h] = fmaxf(run_max[h], fmaxf(s0, s1));
          *at = make_float2(s0, s1);
        }
      }
  }
  // each row's max: over the four lanes that share it, then over the warps
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = run_max[h];
    mx = fmaxf(mx, __shfl_xor_sync(nm::kFullMask, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(nm::kFullMask, mx, 2));
    if (t == 0) wmax[warp * kPassSlots + g + 8 * h] = mx;
  }
  __syncthreads();  // every warp's scores and maxima are in place
  if (threadIdx.x < kPassSlots) {
    float mx = wmax[threadIdx.x];
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, wmax[w * kPassSlots + threadIdx.x]);
    pmax[threadIdx.x] = mx;
  }
  // 2. the softmax of each slot row over the whole window, warp w rows w,
  // w + 8: at the lane split the cluster's blocks read each other's row
  // maxima, then sums, through distributed shared memory, each adding them
  // in rank order
  if (C > 1)
    cluster.sync();  // every block's maxima
  else
    __syncthreads();
  float row_sum[kPassSlots / kWarps];
#pragma unroll
  for (int j = 0; j < kPassSlots / kWarps; ++j) {
    const int r = warp + kWarps * j;
    float sum = 0.f;
    if (r < slots) {
      float mx = pmax[r];
      for (int c = 0; c < C; ++c)
        if (c != rank) mx = fmaxf(mx, cluster.map_shared_rank(pmax, c)[r]);
      // exp(s - max) over the scores: the weights' numerators
      float* srow = ss + r * ld;
#pragma unroll 4
      for (int l = lane; l < lanes; l += 32) {
        const float p = expf(srow[l] - mx);
        srow[l] = p;
        sum += p;
      }
      sum = nm::warp_sum(sum);
    }
    row_sum[j] = sum;
    if (lane == 0) psum[r] = sum;
  }
  if (C > 1) cluster.sync();  // every block's sums
  // the normalised weights, rounded to bf16, over each row's first half
  // (lanes past the window 0; a numerator 0, a lane the bias masks, skips
  // its division): a warp reads 128 numerators before it writes their
  // weights, which lie over numerators it has read
#pragma unroll
  for (int j = 0; j < kPassSlots / kWarps; ++j) {
    const int r = warp + kWarps * j;
    if (r >= slots) continue;
    float total = row_sum[j];
    if (C > 1) {
      total = 0.f;
      for (int c = 0; c < C; ++c) total += cluster.map_shared_rank(psum, c)[r];
    }
    const float denom = fmaxf(total, 1e-20f);
    float* srow = ss + r * ld;
    __nv_bfloat16* wrow = reinterpret_cast<__nv_bfloat16*>(srow);
    for (int l0 = 0; l0 < kPassLanes * tiles; l0 += 128) {
      float sv[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int l = l0 + 32 * m + lane;
        sv[m] = l < lanes ? srow[l] : 0.f;
      }
      __syncwarp();
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int l = l0 + 32 * m + lane;
        if (l < kPassLanes * tiles)
          wrow[l] = __float2bfloat16_rn(sv[m] != 0.f ? sv[m] / denom : 0.f);
      }
      __syncwarp();
    }
  }
  __syncthreads();  // every row's weights are in place

  // 3. the context w V over the chunk: warp w the columns kWarpCols w .. ,
  // m16n8k16 with the weights as A (rows past the beam read the last
  // slot's: their sums are never written) and V's tile, read transposed
  // from its rows, as B
  const unsigned char* sw = reinterpret_cast<const unsigned char*>(
      ss + min(lane % 8 + 8 * (lane / 8 % 2), slots - 1) * ld);
  const int c_base = kWarpCols * warp;
  float o[kWarpCols / 8][4] = {};
  for (int j = 0; j < tiles; ++j) {
    const int i = tiles + j, slot = i % a.stages;
    nm::tma::bar_wait(&full[slot], (i / a.stages) & 1);
    const unsigned char* vt = reinterpret_cast<const unsigned char*>(ring + slot * kStage);
#pragma unroll
    for (int ks = 0; ks < kPassLanes / 16; ++ks) {
      unsigned af[4];
      ldsm_x4(af, sw + 2 * (kPassLanes * j + 16 * ks + 8 * (lane / 16)));
#pragma unroll
      for (int nt = 0; nt < kWarpCols / 8; ++nt) {
        const int d = c_base + 8 * nt;
        if (d < a.D) {
          unsigned b0, b1;
          ldsm_x2_trans(b0, b1, vt + d / 64 * (kPassLanes * 128) +
                                    swz128(16 * ks + lane % 16, d % 64 / 8));
          mma_bf16(o[nt], af, b0, b1);
        }
      }
    }
    release(i);
  }

  // o[nt][2 h + e]: slot g + 8 h, column c_base + 8 nt + 2 t + e
  const size_t row0 = static_cast<size_t>(bh) * a.K + k0;
  if (C == 1) {
#pragma unroll
    for (int nt = 0; nt < kWarpCols / 8; ++nt) {
      const int d = c_base + 8 * nt + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (d < a.D && g + 8 * h < slots)
          *reinterpret_cast<float2*>(a.out + (row0 + g + 8 * h) * a.D + d) =
              make_float2(o[nt][2 * h], o[nt][2 * h + 1]);
    }
    return;
  }
  // the lane split: each block's partial context into its ring (every warp
  // is done with it), then each block sums its share of the entries over
  // the cluster's partials in rank order
  __syncthreads();
  float* part = reinterpret_cast<float*>(ring);  // [16][DMAX]
#pragma unroll
  for (int nt = 0; nt < kWarpCols / 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(part + (g + 8 * h) * DMAX + c_base + 8 * nt + 2 * t) =
          make_float2(o[nt][2 * h], o[nt][2 * h + 1]);
  cluster.sync();  // every block's partial context
  for (int e = rank * kPassThreads + threadIdx.x; e < slots * a.D; e += C * kPassThreads) {
    const int r = e / a.D, d = e % a.D;
    float sum = 0.f;
    for (int c = 0; c < C; ++c) sum += cluster.map_shared_rank(part, c)[r * DMAX + d];
    a.out[(row0 + r) * a.D + d] = sum;
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <int DMAX>
int launch_pass(const PassArgs& a, const CUtensorMap& kmap, const CUtensorMap& vmap, int BH,
                int groups, int cluster, int smem, cudaStream_t stream) {
  const int err =
      nm::allow_max_smem(reinterpret_cast<const void*>(lineage_bf16_pass_kernel<DMAX>));
  if (err != 0) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(BH * cluster, groups);
  config.blockDim = dim3(kPassThreads);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = cluster;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  const cudaError_t status =
      cudaLaunchKernelEx(&config, lineage_bf16_pass_kernel<DMAX>, kmap, vmap, a);
  const int last = nm::launch_status();  // also clears a refusal
  return status != cudaSuccess ? static_cast<int>(status) : last;
}

}  // namespace

// The launch follows ops/lineage_attention.lineage_plan: `dmax` the head dim
// padded to 32, 64, 128, 256 or 512 (512, the column block, past 512: then
// `slots` is 1, `groups` the beam, `tile` 32 and `stages` 1); `tile` lanes a stage (checked against
// the instance's); `slots` rows a block (8, 16, 24 or 32) in `groups` groups;
// `splits` lane chunks of `chunk` lanes (a multiple of the tile); `stages`
// ring stages; `vec` the 16-byte copies; `smem` the block's shared bytes
// (checked against the layout). part_o and part_ml are scratch for
// splits > 1.
NM_EXPORT int nm_lineage_attention(const void* q, const void* k_cache, const void* v_cache,
                                   const void* bias, void* out, void* part_o, void* part_ml,
                                   int B, int H, int K, int D, int L, int W, int dmax,
                                   int tile, int slots, int groups, int splits, int chunk,
                                   int stages, int vec, int smem, float scale, void* stream) {
  if (B < 1 || H < 1 || K < 1 || D < 1 || W < 1 || W > L || groups * slots < K || splits < 1 ||
      (splits > 1 && (part_o == nullptr || part_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(q),     static_cast<const float*>(k_cache),
               static_cast<const float*>(v_cache), static_cast<const float*>(bias),
               static_cast<float*>(out),         static_cast<float*>(part_o),
               static_cast<float*>(part_ml),     H, K, D, L, W, chunk, stages, vec, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > 512) {  // the chunked instance: a block a slot, 32-lane tiles
    if (dmax != 512 || tile != kWideLanes || slots != 1 || groups != K)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_wide(a, B * H, splits, smem, s);
  }
  if (D > dmax) return static_cast<int>(cudaErrorInvalidValue);
  switch (dmax) {
    case 32: return launch_slots<32>(a, B * H, tile, slots, groups, splits, smem, s);
    case 64: return launch_slots<64>(a, B * H, tile, slots, groups, splits, smem, s);
    case 128: return launch_slots<128>(a, B * H, tile, slots, groups, splits, smem, s);
    case 256: return launch_slots<256>(a, B * H, tile, slots, groups, splits, smem, s);
    case 512: return launch_slots<512>(a, B * H, tile, slots, groups, splits, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 instance in one pass: caches k_cache (B, H, D, L) and v_cache
// (B, H, L, D) in bf16, q, bias and out float32
// (ops/lineage_attention.lineage_bf16_pass_plan): `dmax` the head dim padded
// to 64, 128 or 256, clusters of `cluster` blocks a (b, h) and slot group,
// rank r owning lanes r * chunk .. (a multiple of 64, every rank some lanes
// of the window), a ring of `stages` tiles, `smem` the block's shared bytes
// (checked against the layout). The shape gate: L and D multiples of 8 and
// the caches 16-byte aligned, as TMA's row strides need.
NM_EXPORT int nm_lineage_attention_bf16(const void* q, const void* k_cache, const void* v_cache,
                                        const void* bias, void* out, int B, int H, int K, int D,
                                        int L, int W, int dmax, int cluster, int chunk,
                                        int stages, int smem, float scale, void* stream) {
  const long long groups = (K + kPassSlots - 1) / kPassSlots;
  if (B < 1 || H < 1 || K < 1 || D < 1 || W < 1 || W > L || L % 8 != 0 || D % 8 != 0 ||
      D > dmax || cluster < 1 || cluster > kPassMaxCluster || chunk < kPassLanes ||
      chunk % kPassLanes != 0 || static_cast<long long>(cluster - 1) * chunk >= W ||
      static_cast<long long>(cluster) * chunk < W || stages < 1 || stages > kPassMaxStages ||
      groups > 65535 || static_cast<long long>(B) * H * cluster > INT_MAX ||
      ((reinterpret_cast<size_t>(k_cache) | reinterpret_cast<size_t>(v_cache)) & 15) != 0 ||
      smem < 0 ||
      static_cast<size_t>(smem) != pass_smem_bytes(dmax, chunk, stages, std::min(K, kPassSlots)))
    return static_cast<int>(cudaErrorInvalidValue);
  // K as (B*H, D, L) read over its first W lanes in boxes of 64 lanes by
  // dmax rows; V as (B*H, L, D) over its first W rows in boxes of 64 rows by
  // 64 columns
  const cuuint64_t BH = static_cast<cuuint64_t>(B) * H;
  const cuuint64_t kdims[3] = {static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(D), BH};
  const cuuint64_t kstrides[2] = {2ull * L, 2ull * L * D};
  const cuuint32_t kbox[3] = {kPassLanes, static_cast<cuuint32_t>(dmax), 1};
  const cuuint64_t vdims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(W), BH};
  const cuuint64_t vstrides[2] = {2ull * D, 2ull * L * D};
  const cuuint32_t vbox[3] = {64, kPassLanes, 1};
  CUtensorMap kmap, vmap;
  int status = nm::tma::tensor_map(&kmap, k_cache, 3, kdims, kstrides, kbox);
  if (status == 0) status = nm::tma::tensor_map(&vmap, v_cache, 3, vdims, vstrides, vbox);
  if (status != 0) return status;
  const PassArgs a{static_cast<const float*>(q), static_cast<const float*>(bias),
                   static_cast<float*>(out), H, K, D, W, chunk, stages, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = static_cast<int>(groups);
  switch (dmax) {
    case 64: return launch_pass<64>(a, kmap, vmap, B * H, g, cluster, smem, s);
    case 128: return launch_pass<128>(a, kmap, vmap, B * H, g, cluster, smem, s);
    case 256: return launch_pass<256>(a, kmap, vmap, B * H, g, cluster, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 instance's scratch design, kept for the shapes the one-pass kernel
// does not take: caches k_cache (B, H, D, L) and v_cache (B, H, L, D) in
// bf16, q, bias and out float32. `scores` is scratch of (B*H*K, W) floats;
// `splits` lane chunks of `chunk` lanes (a multiple of 16), `part_o` scratch of
// (splits, B*H*K, D) floats when splits > 1
// (ops/lineage_attention.lineage_bf16_plan).
NM_EXPORT int nm_lineage_attention_bf16_scratch(const void* q, const void* k_cache,
                                                const void* v_cache, const void* bias, void* out,
                                                void* scores, void* part_o, int B, int H, int K,
                                                int D, int L, int W, int splits, int chunk,
                                                float scale, void* stream) {
  if (B < 1 || H < 1 || K < 1 || D < 1 || W < 1 || W > L || splits < 1 || chunk < 1 ||
      chunk % kB16CtxLanes || (splits - 1) * chunk >= W || splits * chunk < W ||
      scores == nullptr || (splits > 1 && part_o == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int col_blocks = (D + kB16CtxCols - 1) / kB16CtxCols;
  const B16Args a{static_cast<const float*>(q),
                  static_cast<const __nv_bfloat16*>(k_cache),
                  static_cast<const __nv_bfloat16*>(v_cache),
                  static_cast<const float*>(bias),
                  static_cast<float*>(out),
                  static_cast<float*>(scores),
                  static_cast<float*>(part_o),
                  H, K, D, L, W, chunk, col_blocks,
                  D % 8 == 0 && reinterpret_cast<size_t>(v_cache) % 16 == 0,
                  L % 8 == 0 && reinterpret_cast<size_t>(k_cache) % 16 == 0,
                  b16_scores_ld(D), scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = nm::allow_max_smem(reinterpret_cast<const void*>(lineage_bf16_scores_kernel));
  if (err != 0) return err;
  const dim3 score_grid(B * H, (W + kB16ScoreLanes - 1) / kB16ScoreLanes,
                        (K + kB16ScoreSlots - 1) / kB16ScoreSlots);
  lineage_bf16_scores_kernel<<<score_grid, kB16Threads, b16_scores_smem(D), s>>>(a);
  int status = nm::launch_status();
  if (status != 0) return status;
  lineage_bf16_context_kernel<<<dim3(B * H, (K + 7) / 8, splits * col_blocks), kB16Threads,
                                b16_context_smem(D), s>>>(a);
  status = nm::launch_status();
  if (status != 0 || splits == 1) return status;
  const size_t count = static_cast<size_t>(B) * H * K * D;
  const int blocks = static_cast<int>(std::min<size_t>((count + 255) / 256, size_t{1} << 16));
  lineage_bf16_fold_kernel<<<blocks, 256, 0, s>>>(a.part_o, a.out, count, splits);
  return nm::launch_status();
}
