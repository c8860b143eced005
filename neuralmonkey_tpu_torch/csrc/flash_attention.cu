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
// tiles live in shared memory only. The design: FlashAttention-2 on the CUDA
// cores. A block owns 32 query rows (forward, dq) or 32 key rows (dkv) of one
// (batch, head); 8 threads share a row, each holding D/8 output columns in
// registers; the block walks the other axis in tiles through shared memory
// with the online max and sum (forward) or recomputed P = exp(s - lse)
// (backward). Every sum runs in one fixed order: no atomics, deterministic.
// Causal attention skips the key tiles above the diagonal (forward, dq) and
// the query tiles before it (dkv).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowThreads = 8;                     // threads sharing a row
constexpr int kRows = kThreads / kRowThreads;      // 32 rows per block
constexpr int kTileKV = 64;                        // key tile (forward, dq)
constexpr int kKPT = kTileKV / kRowThreads;        // keys per thread
constexpr int kQPT = kRows / kRowThreads;          // queries per thread (dkv)
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
template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ mask,
                 float* __restrict__ out, float* __restrict__ lse, int H, int Tq, int Tk, int D,
                 int causal, Dropout drop, float scale) {
  constexpr int LD = DMAX + 1, LP = kTileKV + 1, DPT = DMAX / kRowThreads;
  extern __shared__ float smem[];
  float* sq = smem;                    // [kRows][LD], pre-scaled
  float* sk = sq + kRows * LD;         // [kTileKV][LD]
  float* sv = sk + kTileKV * LD;       // [kTileKV][DMAX]
  float* sp = sv + kTileKV * DMAX;     // [kRows][LP]
  float* sm = sp + kRows * LP;         // [kTileKV]
  const int bh = blockIdx.x, b = bh / H;
  const int q0 = blockIdx.y * kRows;
  const int row = threadIdx.x / kRowThreads, sub = threadIdx.x % kRowThreads;
  const int qi = q0 + row;
  const size_t kv_off = static_cast<size_t>(bh) * Tk * D;

  load_rows<DMAX>(sq, LD, q + static_cast<size_t>(bh) * Tq * D, q0, kRows, Tq, D, scale);
  float o[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) o[i] = 0.f;
  float m = -INFINITY, l = 0.f;
  int n_tiles = (Tk + kTileKV - 1) / kTileKV;
  if (causal) n_tiles = min(n_tiles, (q0 + kRows + kTileKV - 1) / kTileKV);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTileKV;
    __syncthreads();  // the previous tile is consumed
    load_rows<DMAX>(sk, LD, k + kv_off, k0, kTileKV, Tk, D, 1.f);
    load_rows<DMAX>(sv, DMAX, v + kv_off, k0, kTileKV, Tk, D, 1.f);
    for (int c = threadIdx.x; c < kTileKV; c += kThreads)
      sm[c] = k0 + c < Tk ? mask[static_cast<size_t>(b) * Tk + k0 + c] : 0.f;
    __syncthreads();

    float s[kKPT];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKPT; ++j) {
      const int c = sub + j * kRowThreads, key = k0 + c;
      float x = dot_row<DMAX>(sq + row * LD, sk + c * LD);
      if (key >= Tk)
        x = -INFINITY;
      else if (!(sm[c] > 0.f) || (causal && qi < key))
        x = kMasked;
      s[j] = x;
      tile_max = fmaxf(tile_max, x);
    }
    const float m_new = fmaxf(m, row_max(tile_max));
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kKPT; ++j) {
      const int c = sub + j * kRowThreads, key = k0 + c;
      const float p = expf(s[j] - m_new);
      psum += p;
      float pv = p;
      if (drop.enabled && key < Tk)
        pv = keep_bit(drop, bh, static_cast<uint32_t>(qi) * Tk + key) ? p * drop.inv_keep : 0.f;
      sp[row * LP + c] = pv;
    }
    l = l * corr + row_sum(psum);
    m = m_new;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = sub + i * kRowThreads;
      float acc = 0.f;
#pragma unroll 8
      for (int c = 0; c < kTileKV; ++c) acc = fmaf(sp[row * LP + c], sv[c * DMAX + d], acc);
      o[i] = o[i] * corr + acc;
    }
  }

  if (qi < Tq) {
    const float denom = fmaxf(l, 1e-20f);
    float* ob = out + (static_cast<size_t>(bh) * Tq + qi) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = sub + i * kRowThreads;
      if (d < D) ob[d] = o[i] / denom;
    }
    if (sub == 0) lse[static_cast<size_t>(bh) * Tq + qi] = m + logf(denom);
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

// shared memory of each kernel, in floats
template <int DMAX>
constexpr size_t fwd_smem() {
  return sizeof(float) * (kRows * (DMAX + 1) + kTileKV * (DMAX + 1) + kTileKV * DMAX +
                          kRows * (kTileKV + 1) + kTileKV);
}
template <int DMAX>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * kRows * (DMAX + 1) + 2 * kTileKV * (DMAX + 1) +
                          kRows * (kTileKV + 1) + kTileKV);
}
template <int DMAX>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * kRows * (DMAX + 1) + 2 * kRows * (kRows + 1) + 2 * kRows);
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, dim3 grid, cudaStream_t stream, Args... args) {
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return nm::launch_status();
}

Dropout make_dropout(int enabled, int k0, int k1, int thresh, float inv_keep) {
  return Dropout{enabled, static_cast<uint32_t>(k0), static_cast<uint32_t>(k1),
                 static_cast<uint32_t>(thresh), inv_keep};
}

// the head dimension rounded up to the widths the kernels are built for
int head_width(int D) { return D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 0; }

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
  const dim3 grid(B * H, (Tq + kRows - 1) / kRows);
  const Dropout drop = make_dropout(dropout, k0, k1, thresh, inv_keep);
  const auto s = static_cast<cudaStream_t>(stream);
#define NM_CALL(W)                                                                          \
  launch(flash_fwd_kernel<W>, fwd_smem<W>(), grid, s, static_cast<const float*>(q),        \
         static_cast<const float*>(k), static_cast<const float*>(v),                        \
         static_cast<const float*>(mask), static_cast<float*>(out), static_cast<float*>(lse), \
         H, Tq, Tk, D, causal, drop, scale)
  NM_FLASH_DISPATCH(D, NM_CALL)
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
  launch(flash_bwd_dq_kernel<W>, dq_smem<W>(), grid, s, static_cast<const float*>(q),        \
         static_cast<const float*>(k), static_cast<const float*>(v),                          \
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
  launch(flash_bwd_dkv_kernel<W>, dkv_smem<W>(), grid, s, static_cast<const float*>(q),       \
         static_cast<const float*>(k), static_cast<const float*>(v),                           \
         static_cast<const float*>(mask), static_cast<const float*>(dout),                     \
         static_cast<const float*>(lse), static_cast<const float*>(dcap),                      \
         static_cast<float*>(dk), static_cast<float*>(dv), H, Tq, Tk, D, causal, drop, scale)
  NM_FLASH_DISPATCH(D, NM_CALL)
#undef NM_CALL
}
