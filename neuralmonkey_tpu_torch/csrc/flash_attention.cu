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
// dim 64) the bytes. Each (batch, head) reads q, k, v once (about 17 MB over
// B 64, H 8 at T 32) against about 2 * T * D flops per byte pair; the score
// tiles live in shared memory or registers only. All three are
// FlashAttention-2 on the CUDA cores, every sum in one fixed order (no
// atomics, deterministic); causal attention skips the key tiles above the
// diagonal (forward, dq) and the query tiles before it (dkv).
//
// The forward: a block of 128 threads owns 32 query rows of one
// (batch, head) and walks the keys in tiles of 32, loaded with 16-byte
// cp.async copies, double-buffered when there is more than one tile. Its
// shared-memory traffic, not its flops, bounded the first design (each FMA
// read both operands from shared memory), so each thread keeps a register
// tile: 2 query rows x 4 keys of S, and the same 2 rows x D/8 columns of O.
// Every q, k and v read is a float4 that feeds 4 to 8 FMAs; the 8 threads of
// a row sit in one quarter warp, where the q reads broadcast and the k and v
// reads hit distinct banks, and they reduce the row's max and sum with
// shuffles and hand each other P with shuffles, so P never enters shared
// memory. The last tile's loops stop at the keys that exist (groups of 8 in
// QK, one key in PV). At D 64 a block takes 26 KB (one tile) or 43 KB.
//
// The backward kernels: a block owns 32 query rows (dq) or 32 key rows (dkv);
// 8 threads share a row, each holding D/8 output columns in registers; the
// block walks the other axis in 64-wide tiles through shared memory with the
// recomputed P = exp(s - lse).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;                      // backward
constexpr int kRowThreads = 8;                     // threads sharing a row
constexpr int kRows = kThreads / kRowThreads;      // 32 rows per block
constexpr int kTileKV = 64;                        // key tile (dq)
constexpr int kKPT = kTileKV / kRowThreads;        // keys per thread (dq)
constexpr int kQPT = kRows / kRowThreads;          // queries per thread (dkv)
constexpr float kMasked = -1e9f;

constexpr int kFwdThreads = 128;                   // forward
constexpr int kFwdRows = 32;                       // query rows per block
constexpr int kFwdKeys = 32;                       // key tile
constexpr int kFwdKPT = kFwdKeys / kRowThreads;    // 4 keys per thread
constexpr int kFwdQPT = kFwdRows * kRowThreads / kFwdThreads;  // 2 rows per thread

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

// rows x DMAX tile from a (T, D) matrix, zero beyond T and D, row stride ld
template <int DMAX>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, int row0,
                                          int rows, int T, int D, float scale) {
  for (int i = threadIdx.x; i < rows * DMAX; i += kThreads) {
    const int r = i / DMAX, d = i % DMAX;
    dst[r * ld + d] = (row0 + r < T && d < D) ? src[static_cast<size_t>(row0 + r) * D + d] * scale
                                              : 0.f;
  }
}

template <int DMAX>
__device__ __forceinline__ float dot_row(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll 16
  for (int d = 0; d < DMAX; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

// ------------------------------------------------------------------------ //
// forward
// ------------------------------------------------------------------------ //
// rows x W tile (row stride ld) of a (T, D) matrix, zero beyond T and D:
// 16-byte cp.async copies (zero-filled past the end) when D % 4 == 0, plain
// loads otherwise; the caller commits and waits
template <int W>
__device__ __forceinline__ void fwd_load_rows(float* dst, int ld, const float* src, int row0,
                                              int rows, int T, int D) {
  if ((D & 3) == 0) {
    for (int i = threadIdx.x; i < rows * (W / 4); i += kFwdThreads) {
      const int r = i / (W / 4), d = (i % (W / 4)) * 4;
      const bool in = row0 + r < T && d < D;
      nm::cp_async16(dst + r * ld + d, in ? src + static_cast<size_t>(row0 + r) * D + d : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * W; i += kFwdThreads) {
      const int r = i / W, d = i % W;
      dst[r * ld + d] = (row0 + r < T && d < D) ? src[static_cast<size_t>(row0 + r) * D + d] : 0.f;
    }
  }
}

// floats of one key stage (k, v, mask) and of the whole block
template <int W>
__host__ __device__ constexpr int fwd_stage_floats() {
  return kFwdKeys * (W + 4) + kFwdKeys * W + kFwdKeys;
}
template <int W>
constexpr size_t fwd_smem(int stages) {
  return sizeof(float) * (kFwdRows * (W + 4) + stages * fwd_stage_floats<W>());
}

template <int W>
__global__ void __launch_bounds__(kFwdThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ mask,
                 float* __restrict__ out, float* __restrict__ lse, int H, int Tq, int Tk, int D,
                 int causal, Dropout drop, float scale) {
  constexpr int LD = W + 4;              // q and k row stride: 8 keys' float4s hit 8 bank groups
  constexpr int NV = W / (4 * kRowThreads);  // float4 column chunks of O per thread
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // [kFwdRows][LD]
  float* stages = sq + kFwdRows * LD;           // per stage: k [kFwdKeys][LD], v [kFwdKeys][W], mask
  const int bh = blockIdx.x, b = bh / H;
  const int q0 = blockIdx.y * kFwdRows;
  const int lane = threadIdx.x & 31, kg = lane & (kRowThreads - 1);
  const int row0 = ((threadIdx.x >> 5) * 4 + (lane >> 3)) * kFwdQPT;  // this thread's rows
  const size_t kv_off = static_cast<size_t>(bh) * Tk * D;
  const bool two = Tk > kFwdKeys;  // double-buffered key tiles
  int n_tiles = (Tk + kFwdKeys - 1) / kFwdKeys;
  if (causal) n_tiles = min(n_tiles, (q0 + kFwdRows + kFwdKeys - 1) / kFwdKeys);

  auto stage = [&](int t) { return stages + (two ? (t & 1) : 0) * fwd_stage_floats<W>(); };
  auto load_tile = [&](int t) {
    float* st = stage(t);
    const int k0 = t * kFwdKeys;
    fwd_load_rows<W>(st, LD, k + kv_off, k0, kFwdKeys, Tk, D);
    fwd_load_rows<W>(st + kFwdKeys * LD, W, v + kv_off, k0, kFwdKeys, Tk, D);
    float* sm = st + kFwdKeys * (LD + W);
    for (int c = threadIdx.x; c < kFwdKeys; c += kFwdThreads)
      sm[c] = k0 + c < Tk ? mask[static_cast<size_t>(b) * Tk + k0 + c] : 0.f;
    nm::cp_async_commit();
  };

  fwd_load_rows<W>(sq, LD, q + static_cast<size_t>(bh) * Tq * D, q0, kFwdRows, Tq, D);
  load_tile(0);
  float o[kFwdQPT][4 * NV];
  float m[kFwdQPT], l[kFwdQPT];
#pragma unroll
  for (int i = 0; i < kFwdQPT; ++i) {
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
    const float* sv = sk + kFwdKeys * LD;
    const float* sm = sv + kFwdKeys * W;
    const int k0 = t * kFwdKeys;
    const int kn = min(kFwdKeys, Tk - k0);          // keys that exist in this tile
    const int groups = (kn + kRowThreads - 1) / kRowThreads;  // warp-uniform

    // S = q k^T for 2 rows x 4 keys (key kg + 8 j)
    float s[kFwdQPT][kFwdKPT];
#pragma unroll
    for (int i = 0; i < kFwdQPT; ++i)
#pragma unroll
      for (int j = 0; j < kFwdKPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < W; d += 4) {
      float4 qv[kFwdQPT];
#pragma unroll
      for (int i = 0; i < kFwdQPT; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sq + (row0 + i) * LD + d);
#pragma unroll
      for (int j = 0; j < kFwdKPT; ++j) {
        if (j < groups) {
          const float4 kv = *reinterpret_cast<const float4*>(sk + (kg + j * kRowThreads) * LD + d);
#pragma unroll
          for (int i = 0; i < kFwdQPT; ++i)
            s[i][j] = fmaf(qv[i].x, kv.x,
                           fmaf(qv[i].y, kv.y, fmaf(qv[i].z, kv.z, fmaf(qv[i].w, kv.w, s[i][j]))));
        }
      }
    }

    // online softmax; s becomes the (dropped) weights of this tile
#pragma unroll
    for (int i = 0; i < kFwdQPT; ++i) {
      const int qi = q0 + row0 + i;
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kFwdKPT; ++j) {
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
      for (int j = 0; j < kFwdKPT; ++j) {
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
    for (int j = 0; j < kFwdKPT; ++j) {
      if (j >= groups) break;
#pragma unroll
      for (int src = 0; src < kRowThreads; ++src) {
        const int c = j * kRowThreads + src;
        if (c >= kn) break;
        float p[kFwdQPT];
#pragma unroll
        for (int i = 0; i < kFwdQPT; ++i)
          p[i] = __shfl_sync(nm::kFullMask, s[i][j], (lane & ~(kRowThreads - 1)) | src);
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          const float4 vv =
              *reinterpret_cast<const float4*>(sv + c * W + (n * kRowThreads + kg) * 4);
#pragma unroll
          for (int i = 0; i < kFwdQPT; ++i) {
            o[i][4 * n] = fmaf(p[i], vv.x, o[i][4 * n]);
            o[i][4 * n + 1] = fmaf(p[i], vv.y, o[i][4 * n + 1]);
            o[i][4 * n + 2] = fmaf(p[i], vv.z, o[i][4 * n + 2]);
            o[i][4 * n + 3] = fmaf(p[i], vv.w, o[i][4 * n + 3]);
          }
        }
      }
    }
    __syncthreads();  // the stage is consumed before the next load refills it
  }

#pragma unroll
  for (int i = 0; i < kFwdQPT; ++i) {
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
template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ mask,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ dcap, float* __restrict__ dq, int H, int Tq, int Tk,
                    int D, int causal, Dropout drop, float scale) {
  constexpr int LD = DMAX + 1, LP = kTileKV + 1, DPT = DMAX / kRowThreads;
  extern __shared__ float smem[];
  float* sq = smem;                  // [kRows][LD]
  float* sdo = sq + kRows * LD;      // [kRows][LD]
  float* sk = sdo + kRows * LD;      // [kTileKV][LD]
  float* sv = sk + kTileKV * LD;     // [kTileKV][LD]
  float* sds = sv + kTileKV * LD;    // [kRows][LP]
  float* sm = sds + kRows * LP;      // [kTileKV]
  const int bh = blockIdx.x, b = bh / H;
  const int q0 = blockIdx.y * kRows;
  const int row = threadIdx.x / kRowThreads, sub = threadIdx.x % kRowThreads;
  const int qi = q0 + row;
  const bool row_ok = qi < Tq;
  const size_t q_off = static_cast<size_t>(bh) * Tq * D, kv_off = static_cast<size_t>(bh) * Tk * D;
  const float row_lse = row_ok ? lse[static_cast<size_t>(bh) * Tq + qi] : 0.f;
  const float row_dcap = row_ok ? dcap[static_cast<size_t>(bh) * Tq + qi] : 0.f;

  load_rows<DMAX>(sq, LD, q + q_off, q0, kRows, Tq, D, 1.f);
  load_rows<DMAX>(sdo, LD, dout + q_off, q0, kRows, Tq, D, 1.f);
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  int n_tiles = (Tk + kTileKV - 1) / kTileKV;
  if (causal) n_tiles = min(n_tiles, (q0 + kRows + kTileKV - 1) / kTileKV);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTileKV;
    __syncthreads();
    load_rows<DMAX>(sk, LD, k + kv_off, k0, kTileKV, Tk, D, 1.f);
    load_rows<DMAX>(sv, LD, v + kv_off, k0, kTileKV, Tk, D, 1.f);
    for (int c = threadIdx.x; c < kTileKV; c += kThreads)
      sm[c] = k0 + c < Tk ? mask[static_cast<size_t>(b) * Tk + k0 + c] : 0.f;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kKPT; ++j) {
      const int c = sub + j * kRowThreads, key = k0 + c;
      float ds = 0.f;
      if (row_ok && key < Tk) {
        float s = dot_row<DMAX>(sq + row * LD, sk + c * LD) * scale;
        if (!(sm[c] > 0.f) || (causal && qi < key)) s = kMasked;
        const float p = expf(s - row_lse);
        float dp = dot_row<DMAX>(sdo + row * LD, sv + c * LD);
        if (drop.enabled)
          dp = keep_bit(drop, bh, static_cast<uint32_t>(qi) * Tk + key) ? dp * drop.inv_keep : 0.f;
        ds = p * (dp - row_dcap);
      }
      sds[row * LP + c] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = sub + i * kRowThreads;
      float a = 0.f;
#pragma unroll 8
      for (int c = 0; c < kTileKV; ++c) a = fmaf(sds[row * LP + c], sk[c * LD + d], a);
      acc[i] += a;
    }
  }

  if (row_ok) {
    float* out = dq + q_off + static_cast<size_t>(qi) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = sub + i * kRowThreads;
      if (d < D) out[d] = acc[i] * scale;
    }
  }
}

// ------------------------------------------------------------------------ //
// backward: dk and dv, one block per (batch·head, 32 key rows)
// ------------------------------------------------------------------------ //
template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ mask,
                     const float* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ dcap, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int Tq, int Tk, int D, int causal,
                     Dropout drop, float scale) {
  constexpr int LD = DMAX + 1, LQ = kRows + 1, DPT = DMAX / kRowThreads;
  extern __shared__ float smem[];
  float* sk = smem;                  // [kRows][LD]   this block's keys
  float* sv = sk + kRows * LD;       // [kRows][LD]
  float* sq = sv + kRows * LD;       // [kRows][LD]   a tile of queries
  float* sdo = sq + kRows * LD;      // [kRows][LD]
  float* spd = sdo + kRows * LD;     // [kRows][LQ]   dropped P, key-major
  float* sds = spd + kRows * LQ;     // [kRows][LQ]   dS, key-major
  float* slse = sds + kRows * LQ;    // [kRows]
  float* sdcap = slse + kRows;       // [kRows]
  const int bh = blockIdx.x, b = bh / H;
  const int kv0 = blockIdx.y * kRows;
  const int row = threadIdx.x / kRowThreads, sub = threadIdx.x % kRowThreads;
  const int key = kv0 + row;
  const bool key_ok = key < Tk;
  const bool key_valid = key_ok && mask[static_cast<size_t>(b) * Tk + key] > 0.f;
  const size_t q_off = static_cast<size_t>(bh) * Tq * D, kv_off = static_cast<size_t>(bh) * Tk * D;

  load_rows<DMAX>(sk, LD, k + kv_off, kv0, kRows, Tk, D, 1.f);
  load_rows<DMAX>(sv, LD, v + kv_off, kv0, kRows, Tk, D, 1.f);
  float ak[DPT], av[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) ak[i] = av[i] = 0.f;
  const int n_tiles = (Tq + kRows - 1) / kRows;
  const int first = causal ? kv0 / kRows : 0;

  for (int t = first; t < n_tiles; ++t) {
    const int q0 = t * kRows;
    __syncthreads();
    load_rows<DMAX>(sq, LD, q + q_off, q0, kRows, Tq, D, 1.f);
    load_rows<DMAX>(sdo, LD, dout + q_off, q0, kRows, Tq, D, 1.f);
    for (int r = threadIdx.x; r < kRows; r += kThreads) {
      const bool in = q0 + r < Tq;
      slse[r] = in ? lse[static_cast<size_t>(bh) * Tq + q0 + r] : 0.f;
      sdcap[r] = in ? dcap[static_cast<size_t>(bh) * Tq + q0 + r] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kQPT; ++j) {
      const int r = sub + j * kRowThreads, qi = q0 + r;
      float pd = 0.f, ds = 0.f;
      if (key_ok && qi < Tq) {
        float s = dot_row<DMAX>(sq + r * LD, sk + row * LD) * scale;
        if (!key_valid || (causal && qi < key)) s = kMasked;
        const float p = expf(s - slse[r]);
        float dp = dot_row<DMAX>(sdo + r * LD, sv + row * LD);
        pd = p;
        if (drop.enabled) {
          const bool keep = keep_bit(drop, bh, static_cast<uint32_t>(qi) * Tk + key);
          pd = keep ? p * drop.inv_keep : 0.f;
          dp = keep ? dp * drop.inv_keep : 0.f;
        }
        ds = p * (dp - sdcap[r]);
      }
      spd[row * LQ + r] = pd;
      sds[row * LQ + r] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = sub + i * kRowThreads;
      float a = 0.f, c = 0.f;
#pragma unroll 8
      for (int r = 0; r < kRows; ++r) {
        a = fmaf(spd[row * LQ + r], sdo[r * LD + d], a);
        c = fmaf(sds[row * LQ + r], sq[r * LD + d], c);
      }
      av[i] += a;
      ak[i] += c;
    }
  }

  if (key_ok) {
    const size_t off = kv_off + static_cast<size_t>(key) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = sub + i * kRowThreads;
      if (d < D) {
        dk[off + d] = ak[i] * scale;
        dv[off + d] = av[i];
      }
    }
  }
}

// shared memory of the backward kernels
template <int DMAX>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * kRows * (DMAX + 1) + 2 * kTileKV * (DMAX + 1) +
                          kRows * (kTileKV + 1) + kTileKV);
}
template <int DMAX>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * kRows * (DMAX + 1) + 2 * kRows * (kRows + 1) + 2 * kRows);
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

// the head dimension rounded up to the widths the kernels are built for
int head_width(int D) { return D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 0; }
// the forward's widths: float4 columns of 8 threads need at least 32
int fwd_width(int D) { return D <= 32 ? 32 : head_width(D); }

}  // namespace

#define NM_FLASH_DISPATCH(D, CALL) \
  switch (head_width(D)) {         \
    case 16: return CALL(16);      \
    case 32: return CALL(32);      \
    case 64: return CALL(64);      \
    case 128: return CALL(128);    \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

NM_EXPORT int nm_flash_fwd(const void* q, const void* k, const void* v, const void* mask,
                           void* out, void* lse, int B, int H, int Tq, int Tk, int D,
                           int causal, int dropout, int k0, int k1, int thresh, float scale,
                           float inv_keep, void* stream) {
  const dim3 grid(B * H, (Tq + kFwdRows - 1) / kFwdRows);
  const int stages = Tk > kFwdKeys ? 2 : 1;
  const Dropout drop = make_dropout(dropout, k0, k1, thresh, inv_keep);
  const auto s = static_cast<cudaStream_t>(stream);
#define NM_CALL(W)                                                                            \
  launch(flash_fwd_kernel<W>, kFwdThreads, fwd_smem<W>(stages), grid, s,                      \
         static_cast<const float*>(q), static_cast<const float*>(k),                          \
         static_cast<const float*>(v), static_cast<const float*>(mask),                       \
         static_cast<float*>(out), static_cast<float*>(lse), H, Tq, Tk, D, causal, drop, scale)
  switch (fwd_width(D)) {
    case 32: return NM_CALL(32);
    case 64: return NM_CALL(64);
    case 128: return NM_CALL(128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NM_CALL
}

NM_EXPORT int nm_flash_bwd_dq(const void* q, const void* k, const void* v, const void* mask,
                              const void* dout, const void* lse, const void* dcap, void* dq,
                              int B, int H, int Tq, int Tk, int D, int causal, int dropout,
                              int k0, int k1, int thresh, float scale, float inv_keep,
                              void* stream) {
  const dim3 grid(B * H, (Tq + kRows - 1) / kRows);
  const Dropout drop = make_dropout(dropout, k0, k1, thresh, inv_keep);
  const auto s = static_cast<cudaStream_t>(stream);
#define NM_CALL(W)                                                                            \
  launch(flash_bwd_dq_kernel<W>, kThreads, dq_smem<W>(), grid, s,                           \
         static_cast<const float*>(q), static_cast<const float*>(k),                          \
         static_cast<const float*>(v),                                                        \
         static_cast<const float*>(mask), static_cast<const float*>(dout),                    \
         static_cast<const float*>(lse), static_cast<const float*>(dcap),                     \
         static_cast<float*>(dq), H, Tq, Tk, D, causal, drop, scale)
  NM_FLASH_DISPATCH(D, NM_CALL)
#undef NM_CALL
}

NM_EXPORT int nm_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* mask,
                               const void* dout, const void* lse, const void* dcap, void* dk,
                               void* dv, int B, int H, int Tq, int Tk, int D, int causal,
                               int dropout, int k0, int k1, int thresh, float scale,
                               float inv_keep, void* stream) {
  const dim3 grid(B * H, (Tk + kRows - 1) / kRows);
  const Dropout drop = make_dropout(dropout, k0, k1, thresh, inv_keep);
  const auto s = static_cast<cudaStream_t>(stream);
#define NM_CALL(W)                                                                             \
  launch(flash_bwd_dkv_kernel<W>, kThreads, dkv_smem<W>(), grid, s,                          \
         static_cast<const float*>(q), static_cast<const float*>(k),                           \
         static_cast<const float*>(v),                                                         \
         static_cast<const float*>(mask), static_cast<const float*>(dout),                     \
         static_cast<const float*>(lse), static_cast<const float*>(dcap),                      \
         static_cast<float*>(dk), static_cast<float*>(dv), H, Tq, Tk, D, causal, drop, scale)
  NM_FLASH_DISPATCH(D, NM_CALL)
#undef NM_CALL
}
