// Shared helpers for the hand-written Hopper kernels of neuralmonkey_tpu_torch.
//
// Every kernel entry point is a plain C function: pointers and the CUDA
// stream arrive as void*, sizes as int, and the function returns the
// cudaError_t of its launch (0 on success) so the Python wrapper can
// raise. Nothing here allocates or synchronises.
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <mutex>
#include <utility>
#include <vector>

#define NM_EXPORT extern "C" __attribute__((visibility("default")))

namespace nm {

// Raise `kernel`'s dynamic shared-memory cap to the device's opt-in maximum,
// once per (kernel, device): the cap only allows, so later launches of any
// size up to the maximum need no further host call.
inline int allow_max_smem(const void* kernel) {
  static std::mutex lock;
  static std::vector<std::pair<const void*, int>> done;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const std::lock_guard<std::mutex> guard(lock);
  for (const auto& entry : done)
    if (entry.first == kernel && entry.second == device) return 0;
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  done.emplace_back(kernel, device);
  return 0;
}

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// 16-byte asynchronous copy from global to shared memory through L2 only
// (.cg: never from a stale L1 line); bytes past `src_bytes` are zero-filled
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}
// 4-byte asynchronous copy (through L1: .cg takes 16 bytes only); zero-fills
// when `src_bytes` is 0
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace nm
