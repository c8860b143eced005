// Float32 products on the tensor cores (3xTF32), shared by the fused
// cross-entropy's backward (fused_xent.cu: dx and dW) and K3, the beam step's
// logit projection (beam_select.cu).
//
// Every float32 product a * b is taken as three TF32 products,
// a_lo b_hi + a_hi b_lo + a_hi b_hi, with a_hi = tf32(a) and a_lo = tf32(a - a_hi)
// (3xTF32: the dropped a_lo b_lo is below float32's rounding), by mma.sync
// m16n8k8, so the sums keep float32 accuracy. A block of 256 threads owns a
// 128 x 128 output tile; its 8 warps are laid out 2 x 4, each a 64 x 32 warp
// tile of 4 x 4 m16n8 fragments. Operands arrive by cp.async in
// double-buffered 32-deep stages, so the next stage's loads overlap this
// stage's products.
#pragma once

#include "common.cuh"

namespace nm {
namespace tc {

constexpr int kM = 128;          // rows of a block's tile
constexpr int kN = 128;          // columns of a block's tile
constexpr int kKC = 32;          // depth of a shared-memory stage
constexpr int kLdK = kKC + 4;    // an [n][k] operand: rows of 32 along k
constexpr int kLdN = kN + 8;     // a [k][n] operand: rows of 128 along n
constexpr int kOperand = kN * kLdK > kKC * kLdN ? kN * kLdK : kKC * kLdN;
constexpr int kStage = kM * kLdK + kOperand;  // an [m][k] A tile and a B tile
constexpr int kThreads = 256;    // 8 warps as 2 x 4, each a 64 x 32 warp tile

// v = hi + lo: hi is v rounded to TF32's 10 mantissa bits (integer operations:
// cvt.rna.tf32 runs on a slow pipe); lo is the exact rest, of which the
// tensor core reads the top 19 bits
__device__ __forceinline__ void split(float v, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy rows x cols (cols a multiple of 4) of `src` (row stride lds) into
// `dst` (row stride ld) with cp.async, zero past rows_ok rows and cols_ok
// columns; 16-byte copies when `vec` (every row 16-byte aligned, cols_ok a
// multiple of 4), else 4-byte ones. Commits one group.
__device__ __forceinline__ void load(float* dst, int ld, const float* __restrict__ src, size_t lds,
                                     int rows, int cols, int rows_ok, int cols_ok, bool vec) {
  if (vec) {
    const int quads = cols / 4;
    for (int i = threadIdx.x; i < rows * quads; i += kThreads) {
      const int r = i / quads, c = (i % quads) * 4;
      const bool ok = r < rows_ok && c < cols_ok;
      nm::cp_async16(dst + r * ld + c, ok ? src + r * lds + c : src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int r = i / cols, c = i % cols;
      const bool ok = r < rows_ok && c < cols_ok;
      nm::cp_async4(dst + r * ld + c, ok ? src + r * lds + c : src, ok ? 4 : 0);
    }
  }
  nm::cp_async_commit();
}

// acc += A B over one stage of `kc` (a multiple of 8) depths for this warp's
// 64 x 32 tile: A row-major (a[m][k], row stride lda), or stored [k][m] (row
// stride lda) when kAKMajor; B stored [n][k] (row stride kLdK) when kBNMajor,
// else [k][n] (row stride kLdB).
template <bool kBNMajor, bool kAKMajor = false, int kLdB = kLdN>
__device__ __forceinline__ void warp_product(const float* a, int lda, const float* b, int kc,
                                             float (&acc)[4][4][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4 * 64, wn = warp % 4 * 32;
  for (int k = 0; k < kc; k += 8) {
    unsigned ah[4][4], al[4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      if (kAKMajor) {
        const float* ac = a + (k + t) * lda + wm + mi * 16 + g;
        split(ac[0], ah[mi][0], al[mi][0]);
        split(ac[8], ah[mi][1], al[mi][1]);
        split(ac[4 * lda], ah[mi][2], al[mi][2]);
        split(ac[4 * lda + 8], ah[mi][3], al[mi][3]);
      } else {
        const float* ar = a + (wm + mi * 16 + g) * lda + k + t;
        split(ar[0], ah[mi][0], al[mi][0]);
        split(ar[8 * lda], ah[mi][1], al[mi][1]);
        split(ar[4], ah[mi][2], al[mi][2]);
        split(ar[8 * lda + 4], ah[mi][3], al[mi][3]);
      }
    }
    unsigned bh[4][2], bl[4][2];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = wn + ni * 8 + g;
      split(kBNMajor ? b[n * kLdK + k + t] : b[(k + t) * kLdB + n], bh[ni][0], bl[ni][0]);
      split(kBNMajor ? b[n * kLdK + k + t + 4] : b[(k + t + 4) * kLdB + n], bh[ni][1],
            bl[ni][1]);
    }
    // the small terms first; each pass walks all 16 sums, so that
    // consecutive products never wait on one another
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], al[mi], bh[ni][0], bh[ni][1]);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], ah[mi], bl[ni][0], bl[ni][1]);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], ah[mi], bh[ni][0], bh[ni][1]);
  }
}

// acc += the 128 x 128 tile of x W at rows m0.., columns n0.., over all D
// depths, for x (N, D) and W (D, V) row-major, or W given as its transpose
// (V, D) when kWT (a tied embedding table). Rows, columns and depths out of
// range contribute zero. Stage s of `stages` (2 kStage floats) holds x[m0..,
// k0..] as [m][k], then W(k0.., n0..) as [k][n] or, tied, [n][k]; stage c + 1
// is in flight while stage c is multiplied. Ends with a __syncthreads(), so
// `stages` is free on return. Warp w's sums are rows w / 4 * 64 + mi * 16 +
// lane / 4 + 8 (e / 2), columns w % 4 * 32 + ni * 8 + 2 (lane % 4) + e % 2 of
// acc[mi][ni][e].
template <bool kWT>
__device__ __forceinline__ void tile_product(const float* __restrict__ x,
                                             const float* __restrict__ w, int N, int D, int V,
                                             int m0, int n0, bool vec, float* stages,
                                             float (&acc)[4][4][4]) {
  auto stage_in = [&](int s, int k0) {
    float* st = stages + s * kStage;
    load(st, kLdK, x + static_cast<size_t>(m0) * D + k0, D, kM, kKC, N - m0, D - k0, vec);
    if (kWT)
      load(st + kM * kLdK, kLdK, w + static_cast<size_t>(n0) * D + k0, D, kN, kKC, V - n0,
           D - k0, vec);
    else
      load(st + kM * kLdK, kLdN, w + static_cast<size_t>(k0) * V + n0, V, kKC, kN, D - k0,
           V - n0, vec);
  };
  const int chunks = (D + kKC - 1) / kKC;
  stage_in(0, 0);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      stage_in((c + 1) & 1, (c + 1) * kKC);
      nm::cp_async_wait<2>();  // this stage's two groups are in
    } else {
      nm::cp_async_wait<0>();
    }
    __syncthreads();
    const float* st = stages + (c & 1) * kStage;
    warp_product<kWT>(st, kLdK, st + kM * kLdK, kKC, acc);
    __syncthreads();  // the stage is consumed before it is loaded again
  }
}

}  // namespace tc
}  // namespace nm
