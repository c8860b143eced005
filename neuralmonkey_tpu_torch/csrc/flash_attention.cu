// Flash attention: forward (flash_attention_fwd) and the two backward kernels
// (flash_attention_bwd_dq, flash_attention_bwd_dkv), float32.
//
// Replace neuralmonkey_tpu/ops/pallas_attention.py `_flash_kernel` (called by
// `_flash_attention_pallas`), `_flash_bwd_dq_kernel` and
// `_flash_bwd_dkv_kernel` (called by `_flash_backward_pallas`).
//
// Layouts: q, out, dout, dq (B*H, Tq, D); k, v, dk, dv (B*H, Tk, D); mask
// (B, Tk) float key validity; lse and dcap = rowsum(dout * out) (B*H, Tq).
//
// Semantics (as the TPU kernels): masked scores are -1e9, so a query row
// with no valid key gets uniform weights; keys at or beyond Tk do not exist
// (no padding enters a sum); the row sum is floored at 1e-20 and
// lse = row_max + log(row_sum). Dropout falls after the softmax: the row sum
// takes the undropped p, the context p * keep / kp; the backward masks and
// scales dP, dV takes the dropped P and dS the undropped P. The keep bit of
// score (bh, q, k) is murmur3's fmix32 of the key words, bh and q * Tk + k in
// uint32 arithmetic (wrapping multiplies, logical shifts), kept when its low
// 23 bits are below round(kp * 2^23): the JAX package's `_keep_hash`, bit for
// bit.
//
// What bounds them on the H100: at the Transformer's shapes (T 32-48, head
// dim 64) the bytes. Each (batch, head) reads q, k, v (and in the backward
// dO) once: about 17 MB over B 64, H 8 at T 32, against 2 * T * D flops per
// byte pair. At a 512-token source the flops bound them instead. All three
// are FlashAttention-2 on the CUDA cores, every sum in one fixed order (no
// atomics, deterministic); causal attention skips the key tiles above the
// diagonal (forward, dq) and the query tiles before it (dkv). Tensor cores
// are left out on purpose: the port is float32, TF32 products (10-bit
// mantissas) would break the gradients' 1e-4 tolerance, and at the
// Transformer's shapes the bytes, not the flops, set the bound. Where the
// flops bind (a 512-token source), the shared-memory reads that feed the
// FMAs (a float4 per 4 to 8 FMAs) hold these kernels near a third of the
// CUDA cores' peak; a product split into three TF32 parts would keep
// float32 accuracy on the tensor cores there (ROADMAP).
//
// One layout for all three: a block of 128 threads owns 32 rows of one
// (batch, head) -- queries in the forward and dq, keys in dkv -- and walks
// the other axis in tiles of 32, loaded with 16-byte cp.async copies,
// double-buffered when there is more than one tile. A design whose FMAs
// read both operands from shared memory as scalars is bounded by that
// traffic, not by its flops, so each thread keeps register tiles: 2 of the
// block's rows x 4 entries of the tile for the scores, and the same 2 rows x
// D/8 columns of the output. Every shared read is a float4
// that feeds 4 to 8 FMAs: the 8 threads of a row sit in one quarter warp,
// where reads of the block's rows broadcast and reads of the tile's rows
// (row stride W + 4) hit distinct bank groups. The 8 threads reduce a row
// and hand each other the probabilities with shuffles, so P and dS never
// enter shared memory. The last tile's loops stop at the entries that exist
// (groups of 8 in the scores, one entry in the products).
//
// - Forward: S = q kᵀ, online softmax, O += P v. At D 64 a block takes 26 KB
//   (one tile) or 43 KB.
// - dq: S = q kᵀ and dP = dO vᵀ in one pass over D, P = exp(S - lse)
//   recomputed, dS = P (dP·keep/kp - dcap), dq += dS k. At D 64: 34 KB or
//   51 KB; the encoder's 32 keys are one tile, with no padding key in any
//   product.
// - dkv: the same transposed. Sᵀ = k qᵀ and dPᵀ = v dOᵀ with keys as rows,
//   dV += Pᵀ dO (dropped P) and dK += dSᵀ q (undropped P), the sums over
//   queries as dq's over keys. Each query tile brings its lse and dcap rows
//   with it. At D 64: 34 KB or 52 KB.
// Head dims up to 256, padded to 32, 64, 128 or 256 (the JAX kernels pad any
// head dim to the 128-lane; past 256 the wrappers raise). At 256 a block
// takes 166 KB (forward) to 200 KB (dkv), one block an SM.
// In dq, a warp whose 8 queries all lie past Tq (the second block of a
// 48-query axis holds 16) only loads and synchronises; the same skip in dkv
// measured slower.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;                      // every kernel
constexpr int kRowThreads = 8;                     // threads sharing a row
constexpr int kRows = 32;                          // rows a block owns
constexpr int kTile = 32;                          // tile of the other axis
constexpr int kTPT = kTile / kRowThreads;          // 4 tile entries per thread
constexpr int kRPT = kRows * kRowThreads / kThreads;  // 2 rows per thread
constexpr int kWarpRows = kRows / (kThreads / 32);    // 8 rows per warp
constexpr float kMasked = -1e9f;

struct Dropout {
  int enabled;
  uint32_t k0, k1, thresh;
  float inv_keep;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ bool keep_bit(const Dropout& d, uint32_t bh, uint32_t pos) {
  const uint32_t h = fmix32(pos ^ d.k0);
  return (fmix32(h ^ (bh * 0x9E3779B9u) ^ d.k1) & ((1u << 23) - 1u)) < d.thresh;
}

// reduce over the 8 consecutive lanes that share a row
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 1; off < kRowThreads; off <<= 1)
    v = fmaxf(v, __shfl_xor_sync(nm::kFullMask, v, off));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 1; off < kRowThreads; off <<= 1) v += __shfl_xor_sync(nm::kFullMask, v, off);
  return v;
}

// the value lane `src` of this thread's quarter warp holds
__device__ __forceinline__ float from_lane(float v, int src) {
  return __shfl_sync(nm::kFullMask, v, ((threadIdx.x & 31) & ~(kRowThreads - 1)) | src);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
}

// acc[0..3] += w * x
__device__ __forceinline__ void axpy4(float* acc, float w, float4 x) {
  acc[0] = fmaf(w, x.x, acc[0]);
  acc[1] = fmaf(w, x.y, acc[1]);
  acc[2] = fmaf(w, x.z, acc[2]);
  acc[3] = fmaf(w, x.w, acc[3]);
}

// rows x W tile (row stride ld) of a (T, D) matrix, zero beyond T and D:
// 16-byte cp.async copies (zero-filled past the end) when D % 4 == 0, plain
// loads otherwise; the caller commits and waits
template <int W>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, int row0, int rows,
                                          int T, int D) {
  if ((D & 3) == 0) {
    for (int i = threadIdx.x; i < rows * (W / 4); i += kThreads) {
      const int r = i / (W / 4), d = (i % (W / 4)) * 4;
      const bool in = row0 + r < T && d < D;
      nm::cp_async16(dst + r * ld + d, in ? src + static_cast<size_t>(row0 + r) * D + d : src,
                     in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * W; i += kThreads) {
      const int r = i / W, d = i % W;
      dst[r * ld + d] = (row0 + r < T && d < D) ? src[static_cast<size_t>(row0 + r) * D + d] : 0.f;
    }
  }
}

// n floats of a vector from `first`, zero at or beyond `end`, by 4-byte
// cp.async copies; the caller commits and waits
__device__ __forceinline__ void load_vector(float* dst, const float* src, int first, int n,
                                            int end) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const bool in = first + i < end;
    nm::cp_async4(dst + i, in ? src + first + i : src, in ? 4 : 0);
  }
}

// scale * acc into this thread's columns (n * 8 + kg) * 4 .. + 4 of a row
template <int NV>
__device__ __forceinline__ void store_cols(float* out, const float* acc, float scale, int D,
                                           int kg) {
#pragma unroll
  for (int n = 0; n < NV; ++n) {
    const int d = (n * kRowThreads + kg) * 4;
    if ((D & 3) == 0) {
      if (d < D)
        *reinterpret_cast<float4*>(out + d) =
            make_float4(acc[4 * n] * scale, acc[4 * n + 1] * scale, acc[4 * n + 2] * scale,
                        acc[4 * n + 3] * scale);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (d + c < D) out[d + c] = acc[4 * n + c] * scale;
    }
  }
}

// ------------------------------------------------------------------------ //
// forward
// ------------------------------------------------------------------------ //
// floats of one key stage (k, v, mask) and of the whole block
template <int W>
__host__ __device__ constexpr int fwd_stage_floats() {
  return kTile * (W + 4) + kTile * W + kTile;
}
template <int W>
constexpr size_t fwd_smem(int stages) {
  return sizeof(float) * (kRows * (W + 4) + stages * fwd_stage_floats<W>());
}

template <int W>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ mask,
                 float* __restrict__ out, float* __restrict__ lse, int H, int Tq, int Tk, int D,
                 int causal, Dropout drop, float scale) {
  constexpr int LD = W + 4;              // q and k row stride: 8 keys' float4s hit 8 bank groups
  constexpr int NV = W / (4 * kRowThreads);  // float4 column chunks of O per thread
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // [kRows][LD]
  float* stages = sq + kRows * LD;              // per stage: k [kTile][LD], v [kTile][W], mask
  const int bh = blockIdx.x, b = bh / H;
  const int q0 = blockIdx.y * kRows;
  const int lane = threadIdx.x & 31, kg = lane & (kRowThreads - 1);
  const int row0 = ((threadIdx.x >> 5) * 4 + (lane >> 3)) * kRPT;  // this thread's rows
  const size_t kv_off = static_cast<size_t>(bh) * Tk * D;
  const bool two = Tk > kTile;  // double-buffered key tiles
  int n_tiles = (Tk + kTile - 1) / kTile;
  if (causal) n_tiles = min(n_tiles, (q0 + kRows + kTile - 1) / kTile);

  auto stage = [&](int t) { return stages + (two ? (t & 1) : 0) * fwd_stage_floats<W>(); };
  auto load_tile = [&](int t) {
    float* st = stage(t);
    const int k0 = t * kTile;
    load_rows<W>(st, LD, k + kv_off, k0, kTile, Tk, D);
    load_rows<W>(st + kTile * LD, W, v + kv_off, k0, kTile, Tk, D);
    float* sm = st + kTile * (LD + W);
    for (int c = threadIdx.x; c < kTile; c += kThreads)
      sm[c] = k0 + c < Tk ? mask[static_cast<size_t>(b) * Tk + k0 + c] : 0.f;
    nm::cp_async_commit();
  };

  load_rows<W>(sq, LD, q + static_cast<size_t>(bh) * Tq * D, q0, kRows, Tq, D);
  load_tile(0);
  float o[kRPT][4 * NV];
  float m[kRPT], l[kRPT];
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NV; ++c) o[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    if (two && t + 1 < n_tiles) {
      load_tile(t + 1);
      nm::cp_async_wait<1>();
    } else {
      nm::cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and q) visible to every thread
    const float* sk = stage(t);
    const float* sv = sk + kTile * LD;
    const float* sm = sv + kTile * W;
    const int k0 = t * kTile;
    const int kn = min(kTile, Tk - k0);          // keys that exist in this tile
    const int groups = (kn + kRowThreads - 1) / kRowThreads;  // warp-uniform

    // S = q k^T for 2 rows x 4 keys (key kg + 8 j)
    float s[kRPT][kTPT];
#pragma unroll
    for (int i = 0; i < kRPT; ++i)
#pragma unroll
      for (int j = 0; j < kTPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < W; d += 4) {
      float4 qv[kRPT];
#pragma unroll
      for (int i = 0; i < kRPT; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sq + (row0 + i) * LD + d);
#pragma unroll
      for (int j = 0; j < kTPT; ++j) {
        if (j < groups) {
          const float4 kv = *reinterpret_cast<const float4*>(sk + (kg + j * kRowThreads) * LD + d);
#pragma unroll
          for (int i = 0; i < kRPT; ++i) s[i][j] = dot4(qv[i], kv, s[i][j]);
        }
      }
    }

    // online softmax; s becomes the (dropped) weights of this tile
#pragma unroll
    for (int i = 0; i < kRPT; ++i) {
      const int qi = q0 + row0 + i;
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kTPT; ++j) {
        const int c = kg + j * kRowThreads, key = k0 + c;
        float x = s[i][j] * scale;
        if (c >= kn)
          x = -INFINITY;
        else if (!(sm[c] > 0.f) || (causal && qi < key))
          x = kMasked;
        s[i][j] = x;
        tile_max = fmaxf(tile_max, x);
      }
      const float m_new = fmaxf(m[i], row_max(tile_max));
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kTPT; ++j) {
        const int c = kg + j * kRowThreads, key = k0 + c;
        const float p = expf(s[i][j] - m_new);
        psum += p;
        float pv = p;
        if (drop.enabled && c < kn)
          pv = keep_bit(drop, bh, static_cast<uint32_t>(qi) * Tk + key) ? p * drop.inv_keep : 0.f;
        s[i][j] = pv;
      }
      l[i] = l[i] * corr + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NV; ++c) o[i][c] *= corr;
    }

    // O += P v: key c's weights come from lane c % 8 of the row's quarter
    // warp; thread kg holds columns (8 n + kg) * 4 .. + 4
#pragma unroll
    for (int j = 0; j < kTPT; ++j) {
      if (j >= groups) break;
#pragma unroll
      for (int src = 0; src < kRowThreads; ++src) {
        const int c = j * kRowThreads + src;
        if (c >= kn) break;
        float p[kRPT];
#pragma unroll
        for (int i = 0; i < kRPT; ++i) p[i] = from_lane(s[i][j], src);
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          const float4 vv =
              *reinterpret_cast<const float4*>(sv + c * W + (n * kRowThreads + kg) * 4);
#pragma unroll
          for (int i = 0; i < kRPT; ++i) axpy4(o[i] + 4 * n, p[i], vv);
        }
      }
    }
    __syncthreads();  // the stage is consumed before the next load refills it
  }

#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int qi = q0 + row0 + i;
    if (qi >= Tq) continue;
    const float denom = fmaxf(l[i], 1e-20f);
    float* ob = out + (static_cast<size_t>(bh) * Tq + qi) * D;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int d = (n * kRowThreads + kg) * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (d + c < D) ob[d + c] = o[i][4 * n + c] / denom;
    }
    if (kg == 0) lse[static_cast<size_t>(bh) * Tq + qi] = m[i] + logf(denom);
  }
}

// ------------------------------------------------------------------------ //
// backward: dq, one block per (batch·head, 32 query rows)
// ------------------------------------------------------------------------ //
// floats of one key stage (k, v, mask) and of the whole block (q, dO, stages)
template <int W>
__host__ __device__ constexpr int dq_stage_floats() {
  return 2 * kTile * (W + 4) + kTile;
}
template <int W>
constexpr size_t dq_smem(int stages) {
  return sizeof(float) * (2 * kRows * (W + 4) + stages * dq_stage_floats<W>());
}

template <int W>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ mask,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ dcap, float* __restrict__ dq, int H, int Tq, int Tk,
                    int D, int causal, Dropout drop, float scale) {
  constexpr int LD = W + 4;
  constexpr int NV = W / (4 * kRowThreads);
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // [kRows][LD]
  float* sdo = sq + kRows * LD;                 // [kRows][LD]
  float* stages = sdo + kRows * LD;             // per stage: k, v [kTile][LD], mask [kTile]
  const int bh = blockIdx.x, b = bh / H;
  const int q0 = blockIdx.y * kRows;
  const int lane = threadIdx.x & 31, kg = lane & (kRowThreads - 1);
  const int row0 = ((threadIdx.x >> 5) * 4 + (lane >> 3)) * kRPT;  // this thread's queries
  // a warp whose queries all lie beyond Tq only loads and synchronises
  const bool live = q0 + static_cast<int>(threadIdx.x >> 5) * kWarpRows < Tq;
  const size_t q_off = static_cast<size_t>(bh) * Tq * D, kv_off = static_cast<size_t>(bh) * Tk * D;
  const bool two = Tk > kTile;  // double-buffered key tiles
  int n_tiles = (Tk + kTile - 1) / kTile;
  if (causal) n_tiles = min(n_tiles, (q0 + kRows + kTile - 1) / kTile);

  auto stage = [&](int t) { return stages + (two ? (t & 1) : 0) * dq_stage_floats<W>(); };
  auto load_tile = [&](int t) {
    float* st = stage(t);
    const int k0 = t * kTile;
    load_rows<W>(st, LD, k + kv_off, k0, kTile, Tk, D);
    load_rows<W>(st + kTile * LD, LD, v + kv_off, k0, kTile, Tk, D);
    load_vector(st + 2 * kTile * LD, mask + static_cast<size_t>(b) * Tk, k0, kTile, Tk);
    nm::cp_async_commit();
  };

  load_rows<W>(sq, LD, q + q_off, q0, kRows, Tq, D);
  load_rows<W>(sdo, LD, dout + q_off, q0, kRows, Tq, D);
  load_tile(0);
  float row_lse[kRPT], row_dcap[kRPT], acc[kRPT][4 * NV];
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int qi = q0 + row0 + i;
    row_lse[i] = qi < Tq ? lse[static_cast<size_t>(bh) * Tq + qi] : 0.f;
    row_dcap[i] = qi < Tq ? dcap[static_cast<size_t>(bh) * Tq + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NV; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    if (two && t + 1 < n_tiles) {
      load_tile(t + 1);
      nm::cp_async_wait<1>();
    } else {
      nm::cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and q, dO) visible to every thread
    if (!live) {
      __syncthreads();
      continue;
    }
    const float* sk = stage(t);
    const float* sv = sk + kTile * LD;
    const float* sm = sv + kTile * LD;
    const int k0 = t * kTile;
    const int kn = min(kTile, Tk - k0);          // keys that exist in this tile
    const int groups = (kn + kRowThreads - 1) / kRowThreads;  // warp-uniform

    // S = q k^T and dP = dO v^T for 2 rows x 4 keys (key kg + 8 j)
    float s[kRPT][kTPT], dp[kRPT][kTPT];
#pragma unroll
    for (int i = 0; i < kRPT; ++i)
#pragma unroll
      for (int j = 0; j < kTPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < W; d += 4) {
      float4 qv[kRPT], gv[kRPT];
#pragma unroll
      for (int i = 0; i < kRPT; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(sq + (row0 + i) * LD + d);
        gv[i] = *reinterpret_cast<const float4*>(sdo + (row0 + i) * LD + d);
      }
#pragma unroll
      for (int j = 0; j < kTPT; ++j) {
        if (j < groups) {
          const int c = kg + j * kRowThreads;
          const float4 kv = *reinterpret_cast<const float4*>(sk + c * LD + d);
          const float4 vv = *reinterpret_cast<const float4*>(sv + c * LD + d);
#pragma unroll
          for (int i = 0; i < kRPT; ++i) {
            s[i][j] = dot4(qv[i], kv, s[i][j]);
            dp[i][j] = dot4(gv[i], vv, dp[i][j]);
          }
        }
      }
    }

    // dS = P (dP - dcap) with P = exp(s - lse) and dP through the keep
    // bits; s becomes dS
#pragma unroll
    for (int i = 0; i < kRPT; ++i) {
      const int qi = q0 + row0 + i;
#pragma unroll
      for (int j = 0; j < kTPT; ++j) {
        const int c = kg + j * kRowThreads, key = k0 + c;
        float ds = 0.f;
        if (c < kn && qi < Tq) {
          float x = s[i][j] * scale;
          if (!(sm[c] > 0.f) || (causal && qi < key)) x = kMasked;
          const float p = expf(x - row_lse[i]);
          float g = dp[i][j];
          if (drop.enabled)
            g = keep_bit(drop, bh, static_cast<uint32_t>(qi) * Tk + key) ? g * drop.inv_keep : 0.f;
          ds = p * (g - row_dcap[i]);
        }
        s[i][j] = ds;
      }
    }

    // dq += dS k: key c's dS comes from lane c % 8 of the row's quarter warp
#pragma unroll
    for (int j = 0; j < kTPT; ++j) {
      if (j >= groups) break;
#pragma unroll
      for (int src = 0; src < kRowThreads; ++src) {
        const int c = j * kRowThreads + src;
        if (c >= kn) break;
        float w[kRPT];
#pragma unroll
        for (int i = 0; i < kRPT; ++i) w[i] = from_lane(s[i][j], src);
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          const float4 kv =
              *reinterpret_cast<const float4*>(sk + c * LD + (n * kRowThreads + kg) * 4);
#pragma unroll
          for (int i = 0; i < kRPT; ++i) axpy4(acc[i] + 4 * n, w[i], kv);
        }
      }
    }
    __syncthreads();  // the stage is consumed before the next load refills it
  }

#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int qi = q0 + row0 + i;
    if (qi < Tq) store_cols<NV>(dq + q_off + static_cast<size_t>(qi) * D, acc[i], scale, D, kg);
  }
}

// ------------------------------------------------------------------------ //
// backward: dk and dv, one block per (batch·head, 32 key rows)
// ------------------------------------------------------------------------ //
// floats of one query stage (q, dO, lse, dcap) and of the whole block (k, v,
// stages)
template <int W>
__host__ __device__ constexpr int dkv_stage_floats() {
  return 2 * kTile * (W + 4) + 2 * kTile;
}
template <int W>
constexpr size_t dkv_smem(int stages) {
  return sizeof(float) * (2 * kRows * (W + 4) + stages * dkv_stage_floats<W>());
}

template <int W>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ mask,
                     const float* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ dcap, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int Tq, int Tk, int D, int causal,
                     Dropout drop, float scale) {
  constexpr int LD = W + 4;
  constexpr int NV = W / (4 * kRowThreads);
  extern __shared__ float4 smem4[];
  float* sk = reinterpret_cast<float*>(smem4);  // [kRows][LD] this block's keys
  float* sv = sk + kRows * LD;                  // [kRows][LD]
  float* stages = sv + kRows * LD;  // per stage: q, dO [kTile][LD], lse, dcap [kTile]
  const int bh = blockIdx.x, b = bh / H;
  const int kv0 = blockIdx.y * kRows;
  const int lane = threadIdx.x & 31, qg = lane & (kRowThreads - 1);
  const int row0 = ((threadIdx.x >> 5) * 4 + (lane >> 3)) * kRPT;  // this thread's keys
  const size_t q_off = static_cast<size_t>(bh) * Tq * D, kv_off = static_cast<size_t>(bh) * Tk * D;
  const bool two = Tq > kTile;  // double-buffered query tiles
  const int n_tiles = (Tq + kTile - 1) / kTile;
  // causal: the queries before the block's first key see none of its keys
  const int first = causal ? kv0 / kTile : 0;

  auto stage = [&](int t) { return stages + (two ? (t & 1) : 0) * dkv_stage_floats<W>(); };
  auto load_tile = [&](int t) {
    float* st = stage(t);
    const int q0 = t * kTile;
    load_rows<W>(st, LD, q + q_off, q0, kTile, Tq, D);
    load_rows<W>(st + kTile * LD, LD, dout + q_off, q0, kTile, Tq, D);
    float* sl = st + 2 * kTile * LD;
    load_vector(sl, lse + static_cast<size_t>(bh) * Tq, q0, kTile, Tq);
    load_vector(sl + kTile, dcap + static_cast<size_t>(bh) * Tq, q0, kTile, Tq);
    nm::cp_async_commit();
  };

  load_rows<W>(sk, LD, k + kv_off, kv0, kRows, Tk, D);
  load_rows<W>(sv, LD, v + kv_off, kv0, kRows, Tk, D);
  load_tile(first);
  bool key_ok[kRPT], key_valid[kRPT];
  float ak[kRPT][4 * NV], av[kRPT][4 * NV];
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int key = kv0 + row0 + i;
    key_ok[i] = key < Tk;
    key_valid[i] = key_ok[i] && mask[static_cast<size_t>(b) * Tk + key] > 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NV; ++c) ak[i][c] = av[i][c] = 0.f;
  }

  for (int t = first; t < n_tiles; ++t) {
    if (two && t + 1 < n_tiles) {
      load_tile(t + 1);
      nm::cp_async_wait<1>();
    } else {
      nm::cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and k, v) visible to every thread
    const float* sq = stage(t);
    const float* sdo = sq + kTile * LD;
    const float* slse = sdo + kTile * LD;
    const float* sdcap = slse + kTile;
    const int q0 = t * kTile;
    const int qn = min(kTile, Tq - q0);          // queries that exist in this tile
    const int groups = (qn + kRowThreads - 1) / kRowThreads;  // warp-uniform

    // S^T = k q^T and dP^T = v dO^T for 2 keys x 4 queries (query qg + 8 j)
    float s[kRPT][kTPT], dp[kRPT][kTPT];
#pragma unroll
    for (int i = 0; i < kRPT; ++i)
#pragma unroll
      for (int j = 0; j < kTPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < W; d += 4) {
      float4 kv[kRPT], vv[kRPT];
#pragma unroll
      for (int i = 0; i < kRPT; ++i) {
        kv[i] = *reinterpret_cast<const float4*>(sk + (row0 + i) * LD + d);
        vv[i] = *reinterpret_cast<const float4*>(sv + (row0 + i) * LD + d);
      }
#pragma unroll
      for (int j = 0; j < kTPT; ++j) {
        if (j < groups) {
          const int r = qg + j * kRowThreads;
          const float4 qv = *reinterpret_cast<const float4*>(sq + r * LD + d);
          const float4 gv = *reinterpret_cast<const float4*>(sdo + r * LD + d);
#pragma unroll
          for (int i = 0; i < kRPT; ++i) {
            s[i][j] = dot4(kv[i], qv, s[i][j]);
            dp[i][j] = dot4(vv[i], gv, dp[i][j]);
          }
        }
      }
    }

    // s becomes the dropped P (for dV), dp becomes dS from the undropped P
    // (for dK)
#pragma unroll
    for (int i = 0; i < kRPT; ++i) {
      const int key = kv0 + row0 + i;
#pragma unroll
      for (int j = 0; j < kTPT; ++j) {
        const int r = qg + j * kRowThreads, qi = q0 + r;
        float pd = 0.f, ds = 0.f;
        if (r < qn && key_ok[i]) {
          float x = s[i][j] * scale;
          if (!key_valid[i] || (causal && qi < key)) x = kMasked;
          const float p = expf(x - slse[r]);
          float g = dp[i][j];
          pd = p;
          if (drop.enabled) {
            const bool keep = keep_bit(drop, bh, static_cast<uint32_t>(qi) * Tk + key);
            pd = keep ? p * drop.inv_keep : 0.f;
            g = keep ? g * drop.inv_keep : 0.f;
          }
          ds = p * (g - sdcap[r]);
        }
        s[i][j] = pd;
        dp[i][j] = ds;
      }
    }

    // dV += P^T dO and dK += dS^T q: query r's values come from lane r % 8
    // of the key's quarter warp
#pragma unroll
    for (int j = 0; j < kTPT; ++j) {
      if (j >= groups) break;
#pragma unroll
      for (int src = 0; src < kRowThreads; ++src) {
        const int r = j * kRowThreads + src;
        if (r >= qn) break;
        float wp[kRPT], ws[kRPT];
#pragma unroll
        for (int i = 0; i < kRPT; ++i) {
          wp[i] = from_lane(s[i][j], src);
          ws[i] = from_lane(dp[i][j], src);
        }
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          const int d = (n * kRowThreads + qg) * 4;
          const float4 gv = *reinterpret_cast<const float4*>(sdo + r * LD + d);
          const float4 qv = *reinterpret_cast<const float4*>(sq + r * LD + d);
#pragma unroll
          for (int i = 0; i < kRPT; ++i) {
            axpy4(av[i] + 4 * n, wp[i], gv);
            axpy4(ak[i] + 4 * n, ws[i], qv);
          }
        }
      }
    }
    __syncthreads();  // the stage is consumed before the next load refills it
  }
  nm::cp_async_wait<0>();  // no copy in flight where the causal walk is empty

#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int key = kv0 + row0 + i;
    if (!key_ok[i]) continue;
    const size_t off = kv_off + static_cast<size_t>(key) * D;
    store_cols<NV>(dk + off, ak[i], scale, D, qg);
    store_cols<NV>(dv + off, av[i], 1.f, D, qg);
  }
}

// the shared-memory cap is raised once per kernel and device, not per launch
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int threads, size_t smem, dim3 grid, cudaStream_t stream,
           Args... args) {
  const int status = nm::allow_max_smem(reinterpret_cast<const void*>(kernel));
  if (status != 0) return status;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return nm::launch_status();
}

Dropout make_dropout(int enabled, int k0, int k1, int thresh, float inv_keep) {
  return Dropout{enabled, static_cast<uint32_t>(k0), static_cast<uint32_t>(k1),
                 static_cast<uint32_t>(thresh), inv_keep};
}

// the head dimension rounded up to a width the kernels are built for: float4
// columns of 8 threads need at least 32
int head_width(int D) {
  return D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : D <= 256 ? 256 : 0;
}

}  // namespace

#define NM_FLASH_DISPATCH(D, CALL)                            \
  switch (head_width(D)) {                                    \
    case 32: return CALL(32);                                 \
    case 64: return CALL(64);                                 \
    case 128: return CALL(128);                               \
    case 256: return CALL(256);                               \
    default: return static_cast<int>(cudaErrorInvalidValue);  \
  }

NM_EXPORT int nm_flash_fwd(const void* q, const void* k, const void* v, const void* mask,
                           void* out, void* lse, int B, int H, int Tq, int Tk, int D,
                           int causal, int dropout, int k0, int k1, int thresh, float scale,
                           float inv_keep, void* stream) {
  const dim3 grid(B * H, (Tq + kRows - 1) / kRows);
  const int stages = Tk > kTile ? 2 : 1;
  const Dropout drop = make_dropout(dropout, k0, k1, thresh, inv_keep);
  const auto s = static_cast<cudaStream_t>(stream);
#define NM_CALL(W)                                                                            \
  launch(flash_fwd_kernel<W>, kThreads, fwd_smem<W>(stages), grid, s,                         \
         static_cast<const float*>(q), static_cast<const float*>(k),                          \
         static_cast<const float*>(v), static_cast<const float*>(mask),                       \
         static_cast<float*>(out), static_cast<float*>(lse), H, Tq, Tk, D, causal, drop, scale)
  NM_FLASH_DISPATCH(D, NM_CALL)
#undef NM_CALL
}

NM_EXPORT int nm_flash_bwd_dq(const void* q, const void* k, const void* v, const void* mask,
                              const void* dout, const void* lse, const void* dcap, void* dq,
                              int B, int H, int Tq, int Tk, int D, int causal, int dropout,
                              int k0, int k1, int thresh, float scale, float inv_keep,
                              void* stream) {
  const dim3 grid(B * H, (Tq + kRows - 1) / kRows);
  const int stages = Tk > kTile ? 2 : 1;
  const Dropout drop = make_dropout(dropout, k0, k1, thresh, inv_keep);
  const auto s = static_cast<cudaStream_t>(stream);
#define NM_CALL(W)                                                                            \
  launch(flash_bwd_dq_kernel<W>, kThreads, dq_smem<W>(stages), grid, s,                       \
         static_cast<const float*>(q), static_cast<const float*>(k),                          \
         static_cast<const float*>(v), static_cast<const float*>(mask),                       \
         static_cast<const float*>(dout), static_cast<const float*>(lse),                     \
         static_cast<const float*>(dcap), static_cast<float*>(dq), H, Tq, Tk, D, causal, drop, \
         scale)
  NM_FLASH_DISPATCH(D, NM_CALL)
#undef NM_CALL
}

NM_EXPORT int nm_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* mask,
                               const void* dout, const void* lse, const void* dcap, void* dk,
                               void* dv, int B, int H, int Tq, int Tk, int D, int causal,
                               int dropout, int k0, int k1, int thresh, float scale,
                               float inv_keep, void* stream) {
  const dim3 grid(B * H, (Tk + kRows - 1) / kRows);
  const int stages = Tq > kTile ? 2 : 1;
  const Dropout drop = make_dropout(dropout, k0, k1, thresh, inv_keep);
  const auto s = static_cast<cudaStream_t>(stream);
#define NM_CALL(W)                                                                             \
  launch(flash_bwd_dkv_kernel<W>, kThreads, dkv_smem<W>(stages), grid, s,                      \
         static_cast<const float*>(q), static_cast<const float*>(k),                           \
         static_cast<const float*>(v), static_cast<const float*>(mask),                        \
         static_cast<const float*>(dout), static_cast<const float*>(lse),                      \
         static_cast<const float*>(dcap), static_cast<float*>(dk), static_cast<float*>(dv), H, \
         Tq, Tk, D, causal, drop, scale)
  NM_FLASH_DISPATCH(D, NM_CALL)
#undef NM_CALL
}
