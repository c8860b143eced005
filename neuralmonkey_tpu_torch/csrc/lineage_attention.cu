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
// - Head dims up to 512, padded to 32, 64, 128, 256 or 512: every multiple
//   of 128 to 512 that the JAX decoder's gate admits, and any other; past 512
//   the wrapper raises on the card.
// - A lane whose scores are all -1e9 (an early step) gets the plain version's
//   uniform weights; a warp whose lanes of a tile lie past the chunk keeps
//   max -inf and adds nothing, never exp(-inf - -inf).
#include "tc_product.cuh"

namespace {

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

}  // namespace

// The launch follows ops/lineage_attention.lineage_plan: `dmax` the head dim
// padded to 32, 64, 128, 256 or 512; `tile` lanes a stage (checked against
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
  if (B < 1 || H < 1 || K < 1 || D < 1 || D > dmax || W < 1 || W > L || groups * slots < K ||
      splits < 1 || (splits > 1 && (part_o == nullptr || part_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(q),     static_cast<const float*>(k_cache),
               static_cast<const float*>(v_cache), static_cast<const float*>(bias),
               static_cast<float*>(out),         static_cast<float*>(part_o),
               static_cast<float*>(part_ml),     H, K, D, L, W, chunk, stages, vec, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dmax) {
    case 32: return launch_slots<32>(a, B * H, tile, slots, groups, splits, smem, s);
    case 64: return launch_slots<64>(a, B * H, tile, slots, groups, splits, smem, s);
    case 128: return launch_slots<128>(a, B * H, tile, slots, groups, splits, smem, s);
    case 256: return launch_slots<256>(a, B * H, tile, slots, groups, splits, smem, s);
    case 512: return launch_slots<512>(a, B * H, tile, slots, groups, splits, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
