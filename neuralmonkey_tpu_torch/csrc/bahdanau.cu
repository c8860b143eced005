// K2: one fused Bahdanau attention step (energies, masked softmax, context).
//
// Replaces neuralmonkey_tpu/ops/pallas_attention.py `_bahdanau_kernel` (called
// by `_fused_bahdanau_pallas`). For each batch row:
//   e_t     = v . tanh(keys_t + pq)
//   w       = masked softmax of e over T: masked energies are -1e9, the
//             weights are multiplied by (mask > 0) and divided by
//             max(sum, 1e-9)
//   context = sum_t w_t * states_t
//
// What bounds it on the H100: memory. Every step reads the keys and the states
// once, B * T * (A + D) * 4 bytes (12.6 MB at B = 64, T = 32, A = 512,
// D = 1024), against a few flops per byte: 3.8 us at 3.35 TB/s. One block a
// batch row (the first design) put 64 blocks on 132 SMs and read the states
// only after the softmax. The design: a thread-block cluster of C blocks
// (C <= 8, the portable size) for each batch row, so that B * C blocks fill
// the card (the plan: ops/cuda_attention.py `bahdanau_plan`; C = 4 at B = 64).
// Each block
//   1. issues cp.async copies of the energies' operands (pq, v, the mask row
//      and the keys of its T/C source positions) into shared memory, then
//      loads its T x D/C slice of the row's states (32 KB at the bench shape)
//      into registers, at most kHeld float4 a thread: the states do not
//      depend on the energies, so their read overlaps them;
//   2. computes the energies of its positions, one warp a position, and
//      writes each into every block of the cluster through distributed shared
//      memory; the cluster syncs once;
//   3. computes the masked softmax over all T itself (it costs nothing at
//      T = 32 and saves a second exchange); block rank 0 writes the weights;
//   4. writes the context of its D/C columns, in 16-byte stores.
// Where the operands do not fit in shared memory they are read in place;
// where the slice does not fit in registers (long sources), step 4 reads it
// from device memory. A first version copied the slice into shared memory
// by cp.async instead; on the H100 that was slower than reading it from
// device memory after the softmax, and registers beat both (PERF.md).
// No atomics: the results do not change from run to run.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeld = 8;     // float4 of the states a thread may hold
constexpr int kRed = 32;     // floats of the block reductions' scratch
constexpr int kPart = 1024;  // floats of the context's partial sums
constexpr float kMaskedEnergy = -1e9f;

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// shared floats of a block: energies (then weights), reductions, context
// partials; pq, v, the mask row and the block's keys when staged
__host__ __device__ constexpr size_t smem_floats(int T, int A, int positions, bool staged) {
  return static_cast<size_t>(round4(T)) + kRed + kPart +
         (staged ? (2 + static_cast<size_t>(positions)) * round4(A) + round4(T) : 0);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

// one arrival at the cluster barrier, ordering nothing: the wait that follows
// only tells that every block of the cluster has started
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// the block's maximum or sum of one value a thread, the same in every thread:
// the warps' results in `red` (8 floats), combined in warp order
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  v = kMax ? nm::warp_max(v) : nm::warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// The context pass's split of the block's `nc` columns: units of kW columns,
// each unit's sum over t = g, g + groups, ... taken by thread i = g * units + u
// when there are fewer units than threads (the groups' partials then added in
// order), or by threads u, u + kThreads, ... over all T.
struct Split {
  int units, groups;
  __device__ Split(int nc, int w) : units((nc + w - 1) / w) {
    groups = units >= kThreads ? 1 : kThreads / units;
  }
};

// context[c0 + ...] = sum_t w[t] states[t][c0 + ...] for the block's columns:
// from `held` (the kHeld float4 this thread loaded, `use_held`) or from `src`
// (row stride ld), in 16-byte loads and stores when kW is 4
template <int kW>
__device__ __forceinline__ void context_pass(const float* w, const float* src, size_t ld, int T,
                                             int nc, float* out, bool store4, float* part,
                                             const float4 (&held)[kHeld], bool use_held) {
  const Split split(nc, kW);
  const int units = split.units, groups = split.groups;
  auto store = [&](int u, const float (&c)[kW]) {
    const int col = u * kW;
    if constexpr (kW == 4) {
      if (store4 && col + 4 <= nc) {
        *reinterpret_cast<float4*>(out + col) = make_float4(c[0], c[1], c[2], c[3]);
        return;
      }
    }
#pragma unroll
    for (int j = 0; j < kW; ++j)
      if (col + j < nc) out[col + j] = c[j];
  };
  for (int i = threadIdx.x; i < units * groups; i += kThreads) {
    const int u = i % units, g = i / units;
    float c[kW] = {};
    if constexpr (kW == 4) {
      if (use_held) {  // one unit a thread, at most kHeld positions
#pragma unroll
        for (int k = 0; k < kHeld; ++k) {
          const int t = g + k * groups;
          if (t < T) {
            const float wt = w[t];
            c[0] = fmaf(wt, held[k].x, c[0]);
            c[1] = fmaf(wt, held[k].y, c[1]);
            c[2] = fmaf(wt, held[k].z, c[2]);
            c[3] = fmaf(wt, held[k].w, c[3]);
          }
        }
      } else {
#pragma unroll 8
        for (int t = g; t < T; t += groups) {
          const float wt = w[t];
          const float4 s = __ldg(reinterpret_cast<const float4*>(src + t * ld + u * 4));
          c[0] = fmaf(wt, s.x, c[0]);
          c[1] = fmaf(wt, s.y, c[1]);
          c[2] = fmaf(wt, s.z, c[2]);
          c[3] = fmaf(wt, s.w, c[3]);
        }
      }
    } else {
#pragma unroll 8
      for (int t = g; t < T; t += groups) c[0] = fmaf(w[t], __ldg(src + t * ld + u), c[0]);
    }
    if (groups == 1) {
      store(u, c);
    } else {
#pragma unroll
      for (int j = 0; j < kW; ++j) part[(g * units + u) * kW + j] = c[j];
    }
  }
  if (groups > 1) {
    __syncthreads();
    for (int u = threadIdx.x; u < units; u += kThreads) {
      float c[kW] = {};
      for (int g = 0; g < groups; ++g)
#pragma unroll
        for (int j = 0; j < kW; ++j) c[j] += part[(g * units + u) * kW + j];
      store(u, c);
    }
  }
}

// grid B * C blocks in clusters of C: cluster b is batch row b; block rank r
// owns source positions r * positions .. and columns r * columns ..
__global__ void __launch_bounds__(kThreads)
bahdanau_kernel(const float* __restrict__ keys,    // (B, T, A)
                const float* __restrict__ states,  // (B, T, D)
                const float* __restrict__ mask,    // (B, T)
                const float* __restrict__ pq,      // (B, A)
                const float* __restrict__ v,       // (A)
                float* __restrict__ ctx,           // (B, D)
                float* __restrict__ weights,       // (B, T)
                int T, int A, int D, int positions, int columns, int staged, int resident) {
  const int A4 = round4(A);
  extern __shared__ float4 smem4[];
  float* se = reinterpret_cast<float*>(smem4);  // [T] energies, then weights
  float* red = se + round4(T);                  // [kRed]
  float* part = red + kRed;                     // [kPart]
  // when `staged`: [A] pq, [A] v, [T] mask, [positions][A] keys
  float* sq = part + kPart;
  float* sv = sq + A4;
  float* sm = sv + A4;
  float* sk = sm + round4(T);

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t0 = rank * positions, t1 = min(T, t0 + positions);
  const int c0 = rank * columns, nc = max(0, min(columns, D - c0));
  const float* kb = keys + static_cast<size_t>(b) * T * A;
  const float* sb = states + static_cast<size_t>(b) * T * D + c0;
  const float* q = pq + static_cast<size_t>(b) * A;
  const float* vv = v;
  const float* mk = mask + static_cast<size_t>(b) * T;
  const bool vec_a = (A & 3) == 0 && aligned16(keys) && aligned16(pq) && aligned16(v);
  const bool vec_d = (D & 3) == 0 && aligned16(states) && aligned16(ctx);

  // 1. the energies' operands by cp.async, then the states slice into
  // registers, all in flight at once
  if (staged) {
    const int nk = max(0, t1 - t0);
    if (vec_a) {
      for (int a = 4 * threadIdx.x; a < A; a += 4 * kThreads) {
        nm::cp_async16(sq + a, q + a, 16);
        nm::cp_async16(sv + a, vv + a, 16);
      }
      const int quads = A / 4;
      for (int i = threadIdx.x; i < nk * quads; i += kThreads) {
        const int t = i / quads, a = (i % quads) * 4;
        nm::cp_async16(sk + t * A4 + a, kb + static_cast<size_t>(t0 + t) * A + a, 16);
      }
    } else {
      for (int a = threadIdx.x; a < A; a += kThreads) {
        nm::cp_async4(sq + a, q + a, 4);
        nm::cp_async4(sv + a, vv + a, 4);
      }
      for (int i = threadIdx.x; i < nk * A; i += kThreads) {
        const int t = i / A, a = i % A;
        nm::cp_async4(sk + t * A4 + a, kb + static_cast<size_t>(t0 + t) * A + a, 4);
      }
    }
    for (int t = threadIdx.x; t < T; t += kThreads) nm::cp_async4(sm + t, mk + t, 4);
    nm::cp_async_commit();
    q = sq;
    vv = sv;
    mk = sm;
  }
  // the slice in registers: thread i = g * units + u holds rows g, g +
  // groups, ... of 4-column unit u (the context pass's split)
  const Split split(nc, 4);
  const bool held = resident && vec_d && nc > 0 && split.units <= kThreads &&
                    T <= kHeld * split.groups;
  float4 hs[kHeld];
  if (held && threadIdx.x < split.units * split.groups) {
    const int u = threadIdx.x % split.units, g = threadIdx.x / split.units;
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      const int t = g + k * split.groups;
      if (t < T)
        hs[k] = __ldg(reinterpret_cast<const float4*>(sb + static_cast<size_t>(t) * D + 4 * u));
    }
  }
  cluster_arrive_relaxed();
  nm::cp_async_wait<0>();  // the energies' operands are in
  __syncthreads();
  cluster_wait();  // every block of the cluster has started: its shared
                   // memory may be written

  // 2. the energies of positions t0 .. t1, one warp a position, each written
  // into every block of the cluster
  for (int t = t0 + warp; t < t1; t += kWarps) {
    const float* kt = staged ? sk + (t - t0) * A4 : kb + static_cast<size_t>(t) * A;
    float e = 0.f;
    if (vec_a) {
#pragma unroll 4
      for (int a = 4 * lane; a < A; a += 128) {
        const float4 k = *reinterpret_cast<const float4*>(kt + a);
        const float4 p = *reinterpret_cast<const float4*>(q + a);
        const float4 s = *reinterpret_cast<const float4*>(vv + a);
        e += tanhf(k.x + p.x) * s.x;
        e += tanhf(k.y + p.y) * s.y;
        e += tanhf(k.z + p.z) * s.z;
        e += tanhf(k.w + p.w) * s.w;
      }
    } else {
      for (int a = lane; a < A; a += 32) e += tanhf(kt[a] + q[a]) * vv[a];
    }
    e = nm::warp_sum(e);
    if (lane < C) {
      float* peer = cluster.map_shared_rank(se, lane);
      peer[t] = mk[t] > 0.f ? e : kMaskedEnergy;
    }
  }
  cluster.sync();  // every energy is in every block

  // 3. the masked softmax over all T, in every block
  float mx = -INFINITY;
  for (int t = threadIdx.x; t < T; t += kThreads) mx = fmaxf(mx, se[t]);
  mx = block_reduce<true>(mx, red);
  float total = 0.f;
  for (int t = threadIdx.x; t < T; t += kThreads) {
    const float w = mk[t] > 0.f ? expf(se[t] - mx) : 0.f;
    se[t] = w;
    total += w;
  }
  const float denom = fmaxf(block_reduce<false>(total, red + kWarps), 1e-9f);
  for (int t = threadIdx.x; t < T; t += kThreads) {
    const float w = se[t] / denom;
    se[t] = w;
    if (rank == 0) weights[static_cast<size_t>(b) * T + t] = w;
  }
  __syncthreads();

  // 4. the context of the block's columns
  if (nc > 0) {
    float* out = ctx + static_cast<size_t>(b) * D + c0;
    if (vec_d)
      context_pass<4>(se, sb, D, T, nc, out, true, part, hs, held);
    else
      context_pass<1>(se, sb, D, T, nc, out, false, part, hs, false);
  }
}

}  // namespace

// The launch plan (ops/cuda_attention.py `bahdanau_plan`): clusters of
// `cluster` blocks, each owning `positions` source positions and `columns`
// context columns (a multiple of 4), the energies' operands staged when
// `staged`, the states slice held in registers when `resident`, `smem_bytes`
// of shared memory, which must be the layout's. A refused cluster launch
// returns its error.
NM_EXPORT int nm_bahdanau_step(const void* keys, const void* states, const void* mask,
                               const void* pq, const void* v, void* ctx, void* weights,
                               int B, int T, int A, int D, int cluster, int positions,
                               int columns, int staged, int resident, int smem_bytes,
                               void* stream) {
  if (B < 1 || T < 1 || A < 1 || D < 1 || cluster < 1 || cluster > 8 || positions < 1 ||
      static_cast<long long>(positions) * cluster < T || columns < 4 || columns % 4 != 0 ||
      static_cast<long long>(columns) * cluster < D ||
      static_cast<long long>(B) * cluster > INT_MAX ||
      static_cast<size_t>(smem_bytes) != sizeof(float) * smem_floats(T, A, positions, staged != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes > 48 * 1024) {
    const int err = nm::allow_max_smem(reinterpret_cast<const void*>(bahdanau_kernel));
    if (err != 0) return err;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(B * cluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = cluster;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, bahdanau_kernel, static_cast<const float*>(keys),
      static_cast<const float*>(states), static_cast<const float*>(mask),
      static_cast<const float*>(pq), static_cast<const float*>(v), static_cast<float*>(ctx),
      static_cast<float*>(weights), T, A, D, positions, columns, staged, resident);
  const int status = nm::launch_status();  // also clears a refusal
  return err != cudaSuccess ? static_cast<int>(err) : status;
}
