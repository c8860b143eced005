// Warpgroup products (wgmma) on bf16 tiles in shared memory, for the bf16-W
// instances of the fused cross-entropy's backward (fused_xent.cu:
// xent_bwd_dx_wg_kernel, xent_bwd_dw_wg_kernel).
//
// Layout. Every operand of a product lies in shared memory as bf16 in
// wgmma's swizzled canonical layout: a tile of `rows` rows (the source's
// row axis) by `cols` columns (its contiguous axis) is cut into column
// blocks of R / 2 values (R = 32, 64 or 128 bytes), each stored as `rows`
// rows of R bytes, the blocks one after another; within each 8-row group
// the 16-byte chunks of row r trade places by XOR with bits 7.. of the
// row's offset (the hardware's 32-, 64- or 128-byte swizzle), so that the
// eight rows of a chunk column lie in distinct banks, and tile bases sit
// on 1024-byte boundaries. Such a tile serves as a product's operand
// summed along its columns (K-major: stride byte offset 8 R between 8-row
// groups) or along its rows (MN-major, which bf16 wgmma takes for A and B
// alike: leading byte offset rows R between column blocks, stride 8 R
// between 8-row groups). So the tied (V, D) table, an untied (D, V) W, x's
// bf16 parts and the kernel's own dl parts are all copied as they lie, and
// nothing is transposed. (An unswizzled first layout, 8 x 8 blocks of 128
// contiguous bytes, was right but up to 10% slower.)
//
// Copies. A tile arrives by the Tensor Memory Accelerator: one thread of
// a warpgroup of its own (which gives its registers to the product
// warpgroups) issues a bulk tensor copy for each column block (a box
// of R / 2 values by `rows` rows, or by rows x 3 for x's three parts at
// once), described by a tensor map with the same swizzle, and the hardware
// signals the stage's "full" mbarrier when all its bytes have landed; the
// eight product warps release a slot on its "empty" mbarrier once their
// products of it are done, so the copying thread runs ahead by the whole
// ring. Elements past the source's rows and columns are zero-filled, so a
// ragged edge adds zeros to every sum. (16-byte cp.async copies issued by
// the 256 product threads, and TMA copies issued by a product thread
// between two block barriers a stage, each left the products waiting on
// the copies.)
//
// Products. A float32 operand a is split into three bf16 parts, a = a0 +
// a1 + a2: exact for float32 values in bf16's exponent range (each part
// takes the next 8 significant bits; the last rest has at most 8). A
// product with a bf16 W is then three bf16 products, a2 W + a1 W + a0 W,
// each exact in the float32 sums, where the TF32 design took two passes at
// half the rate. A product of two split float32 operands (dW's x^T dl)
// keeps the six terms a_p b_q with p + q <= 2: the three dropped ones lie
// below 2^-23 of the product, the accuracy of 3xTF32, in the same tensor
// time as three TF32 passes.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"
#include "tma.cuh"

namespace nm {
namespace wg {

using bf16 = __nv_bfloat16;
// the mbarriers and bulk tensor copies (tma.cuh): wg::bar_wait, wg::tma2d, ...
using namespace nm::tma;

constexpr int kThreads = 256;  // two warpgroups of four warps: the products

// a barrier of the kThreads product threads alone (the copying warpgroup
// beside them takes no part)
__device__ __forceinline__ void sync_products() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// Byte offset of 16-byte chunk c of row r in a column block of R-byte rows
// (the swizzle that TMA applies and wgmma reads)
template <int R>
__device__ __forceinline__ int swz(int r, int c) {
  const int o = r * R + c * 16;
  return o ^ (((o >> 7) & (R / 16 - 1)) << 4);
}

// Offset (in elements) of element (r, c) of a swizzled tile of `rows` rows
// of R-byte column blocks
template <int R>
__device__ __forceinline__ int at(int r, int c, int rows) {
  constexpr int kCols = R / 2;
  return (c / kCols * rows * R + swz<R>(r, c % kCols / 8)) / 2 + c % 8;
}

__device__ __forceinline__ uint64_t descriptor(const void* p, unsigned lead, unsigned stride,
                                               uint64_t swizzle) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3ffffu) >> 4) | static_cast<uint64_t>(lead >> 4) << 16 |
         static_cast<uint64_t>(stride >> 4) << 32 | swizzle << 62;
}
template <int R>
constexpr uint64_t kSwizzle = R == 128 ? 1 : R == 64 ? 2 : 3;

// The descriptor of the 16-deep slice at depth k0 (a multiple of 16) and
// MN offset mn0 of a swizzled tile of `rows` rows of R-byte column blocks,
// summed along its columns (K-major; mn0 a multiple of 8)
template <int R>
__device__ __forceinline__ uint64_t kslice(const bf16* tile, int rows, int mn0, int k0) {
  const char* p = reinterpret_cast<const char*>(tile) + k0 / (R / 2) * rows * R + mn0 / 8 * 8 * R +
                  k0 % (R / 2) * 2;
  return descriptor(p, 16, 8 * R, kSwizzle<R>);
}
// ... or along its rows (MN-major, the transpose flag 1; mn0 a multiple of
// R / 2)
template <int R>
__device__ __forceinline__ uint64_t mnslice(const bf16* tile, int rows, int mn0, int k0) {
  const char* p =
      reinterpret_cast<const char*>(tile) + mn0 / (R / 2) * rows * R + k0 / 8 * 8 * R;
  return descriptor(p, rows * R, 8 * R, kSwizzle<R>);
}

// the register budget of this warpgroup's threads: the copying warpgroup
// gives back what the product warpgroups take (40 + 2 x 232 per thread of
// the three = 504 <= 3 x 168, the launch's budget)
template <int N>
__device__ __forceinline__ void registers_down() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void registers_up() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// shared-memory writes of this thread (st.shared) made visible to the wgmma
// reads that follow the next barrier
__device__ __forceinline__ void fence_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keep the compiler from moving accesses of accumulators across wgmma
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, float32) = A (64 x 16) B (16 x 64) (+ d where `accumulate`),
// both bf16 in shared memory; kTA, kTB: the transpose flags (1 for an
// MN-major operand). Starting a sum with accumulate = 0, and not by zeroing
// d, keeps other instructions off the accumulators while products run.
// Thread
// t of the warpgroup holds rows 16 (t / 32) + t % 32 / 4 (+ 8 for d[4j + 2],
// d[4j + 3]) and columns 8 j + 2 (t % 4) (+ 1 for odd indices).
template <int kTA, int kTB>
__device__ __forceinline__ void mma64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate), "n"(kTA), "n"(kTB));
}

// d (64 x 256, float32) = A (64 x 16) B (16 x 256) (+ d); as mma64, with columns
// 8 j + 2 (t % 4), j < 32
template <int kTA, int kTB>
__device__ __forceinline__ void mma256(float (&d)[128], uint64_t a, uint64_t b,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(accumulate), "n"(kTA), "n"(kTB));
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 h) {
  return *reinterpret_cast<const unsigned*>(&h);
}

// The three bf16 parts of the float32 pair (a, b), packed as bf16x2 with a
// in the low half: a = part 0 + part 1 + part 2, b likewise
__device__ __forceinline__ void split3(float a, float b, unsigned (&parts)[3]) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 f = __bfloat1622float2(h);
    parts[p] = bits(h);
    a -= f.x;
    b -= f.y;
  }
  parts[2] = bits(__floats2bfloat162_rn(a, b));
}

}  // namespace wg
}  // namespace nm
