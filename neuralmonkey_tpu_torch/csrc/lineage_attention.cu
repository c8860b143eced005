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
// the K slots. The TPU kernel held all heads of a batch row in VMEM; one
// (b, h) alone needs 246 KB at the full window, above an SM's 227 KB. So a
// block owns up to 16 slots of one (b, h) and streams 64-lane tiles of K and
// V through shared memory with the online max and sum; only the W lanes of
// the window are read. Each product is register-tiled so that shared memory
// does not bound it: a thread computes the scores of 4 slots at one lane
// (float4 loads of the slots' q along d) and the context of DMAX/16 slots at
// one column (float4 loads of their weights along the lanes).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 16;                         // slots per block
constexpr int kTile = 64;                          // lanes per tile
constexpr int kScoreSlots = kSlots * kTile / kThreads;  // 4 per thread
constexpr int kSlotThreads = kThreads / kSlots;    // 16 share a slot's softmax
constexpr int kLPT = kTile / kSlotThreads;         // 4 lanes each

__device__ __forceinline__ float slot_reduce_max(float v) {
#pragma unroll
  for (int off = 1; off < kSlotThreads; off <<= 1)
    v = fmaxf(v, __shfl_xor_sync(nm::kFullMask, v, off));
  return v;
}

__device__ __forceinline__ float slot_reduce_sum(float v) {
#pragma unroll
  for (int off = 1; off < kSlotThreads; off <<= 1) v += __shfl_xor_sync(nm::kFullMask, v, off);
  return v;
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
lineage_kernel(const float* __restrict__ q, const float* __restrict__ kc,
               const float* __restrict__ vc, const float* __restrict__ bias,
               float* __restrict__ out, int H, int K, int D, int L, int W, float scale) {
  constexpr int kOutSlots = kSlots * DMAX / kThreads;  // context slots per thread
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                  // [kSlots][DMAX], pre-scaled
  float* sk = sq + kSlots * DMAX;    // [DMAX][kTile]
  float* sv = sk + DMAX * kTile;     // [kTile][DMAX]
  float* sp = sv + kTile * DMAX;     // [kSlots][kTile] scores, then weights
  float* scorr = sp + kSlots * kTile;  // [kSlots] this tile's rescale
  float* ssum = scorr + kSlots;      // [kSlots] final softmax sums
  const int bh = blockIdx.x, b = bh / H;
  const int k0 = blockIdx.y * kSlots;
  const float* kb = kc + static_cast<size_t>(bh) * D * L;
  const float* vb = vc + static_cast<size_t>(bh) * L * D;

  for (int i = threadIdx.x; i < kSlots * DMAX; i += kThreads) {
    const int r = i / DMAX, d = i % DMAX;
    sq[i] = (k0 + r < K && d < D) ? q[(static_cast<size_t>(bh) * K + k0 + r) * D + d] * scale
                                  : 0.f;
  }
  // scores: lane `lane` of slots s_lo .. s_lo + 3
  const int lane = threadIdx.x % kTile, s_lo = threadIdx.x / kTile * kScoreSlots;
  // softmax: slot `srow`, lanes sub * kLPT ..
  const int srow = threadIdx.x / kSlotThreads, sub = threadIdx.x % kSlotThreads;
  // context: column `col` of slots o_lo .. o_lo + kOutSlots - 1
  const int col = threadIdx.x % DMAX, o_lo = threadIdx.x / DMAX * kOutSlots;
  float o[kOutSlots];
#pragma unroll
  for (int i = 0; i < kOutSlots; ++i) o[i] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int l0 = 0; l0 < W; l0 += kTile) {
    __syncthreads();  // the previous tile's weights and values are consumed
    for (int i = threadIdx.x; i < DMAX * kTile; i += kThreads) {
      const int d = i / kTile, c = i % kTile;
      sk[i] = (d < D && l0 + c < W) ? kb[static_cast<size_t>(d) * L + l0 + c] : 0.f;
    }
    for (int i = threadIdx.x; i < kTile * DMAX; i += kThreads) {
      const int c = i / DMAX, d = i % DMAX;
      sv[i] = (d < D && l0 + c < W) ? vb[static_cast<size_t>(l0 + c) * D + d] : 0.f;
    }
    __syncthreads();

    float acc[kScoreSlots];
#pragma unroll
    for (int i = 0; i < kScoreSlots; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DMAX; d += 4) {
      const float x0 = sk[(d + 0) * kTile + lane], x1 = sk[(d + 1) * kTile + lane];
      const float x2 = sk[(d + 2) * kTile + lane], x3 = sk[(d + 3) * kTile + lane];
#pragma unroll
      for (int i = 0; i < kScoreSlots; ++i) {
        const float4 w = *reinterpret_cast<const float4*>(sq + (s_lo + i) * DMAX + d);
        acc[i] = fmaf(w.x, x0, fmaf(w.y, x1, fmaf(w.z, x2, fmaf(w.w, x3, acc[i]))));
      }
    }
#pragma unroll
    for (int i = 0; i < kScoreSlots; ++i) {
      const int kk = k0 + s_lo + i;
      float s = -INFINITY;  // lanes past the window
      if (l0 + lane < W)    // slots past K only need a finite score
        s = kk < K ? acc[i] + bias[(static_cast<size_t>(b) * K + kk) * W + l0 + lane] : 0.f;
      sp[(s_lo + i) * kTile + lane] = s;
    }
    __syncthreads();

    // online softmax of slot `srow` over this tile
    float4 s4 = *reinterpret_cast<const float4*>(sp + srow * kTile + sub * kLPT);
    const float m_new =
        fmaxf(m, slot_reduce_max(fmaxf(fmaxf(s4.x, s4.y), fmaxf(s4.z, s4.w))));
    const float corr = expf(m - m_new);
    s4.x = expf(s4.x - m_new);
    s4.y = expf(s4.y - m_new);
    s4.z = expf(s4.z - m_new);
    s4.w = expf(s4.w - m_new);
    *reinterpret_cast<float4*>(sp + srow * kTile + sub * kLPT) = s4;
    l = l * corr + slot_reduce_sum((s4.x + s4.y) + (s4.z + s4.w));
    m = m_new;
    if (sub == 0) scorr[srow] = corr;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kOutSlots; ++i) o[i] *= scorr[o_lo + i];
#pragma unroll 4
    for (int c = 0; c < kTile; c += 4) {
      const float v0 = sv[(c + 0) * DMAX + col], v1 = sv[(c + 1) * DMAX + col];
      const float v2 = sv[(c + 2) * DMAX + col], v3 = sv[(c + 3) * DMAX + col];
#pragma unroll
      for (int i = 0; i < kOutSlots; ++i) {
        const float4 p = *reinterpret_cast<const float4*>(sp + (o_lo + i) * kTile + c);
        o[i] = fmaf(p.x, v0, fmaf(p.y, v1, fmaf(p.z, v2, fmaf(p.w, v3, o[i]))));
      }
    }
  }

  if (sub == 0) ssum[srow] = fmaxf(l, 1e-20f);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kOutSlots; ++i) {
    const int kk = k0 + o_lo + i;
    if (kk < K && col < D)
      out[(static_cast<size_t>(bh) * K + kk) * D + col] = o[i] / ssum[o_lo + i];
  }
}

template <int DMAX>
int launch(const float* q, const float* kc, const float* vc, const float* bias, float* out, int B,
           int H, int K, int D, int L, int W, float scale, cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(float) * (kSlots * DMAX + 2 * DMAX * kTile + kSlots * kTile + 2 * kSlots);
  const cudaError_t attr = cudaFuncSetAttribute(
      lineage_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(B * H, (K + kSlots - 1) / kSlots);
  lineage_kernel<DMAX><<<grid, kThreads, smem, stream>>>(q, kc, vc, bias, out, H, K, D, L, W,
                                                         scale);
  return nm::launch_status();
}

}  // namespace

NM_EXPORT int nm_lineage_attention(const void* q, const void* k_cache, const void* v_cache,
                                   const void* bias, void* out, int B, int H, int K, int D,
                                   int L, int W, float scale, void* stream) {
  const auto args = [&](auto fn) {
    return fn(static_cast<const float*>(q), static_cast<const float*>(k_cache),
              static_cast<const float*>(v_cache), static_cast<const float*>(bias),
              static_cast<float*>(out), B, H, K, D, L, W, scale,
              static_cast<cudaStream_t>(stream));
  };
  if (D <= 16) return args(launch<16>);
  if (D <= 32) return args(launch<32>);
  if (D <= 64) return args(launch<64>);
  if (D <= 128) return args(launch<128>);
  return static_cast<int>(cudaErrorInvalidValue);
}
