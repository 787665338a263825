// Shared device helpers for the port's persistent recurrence kernels.
//
// The recurrence kernels (lstm_stack.cu, lstm_train.cu, gru_train.cu,
// wavernn_sample.cu) are persistent
// cooperative grids: one block per SM at most, every block alive for the
// whole recurrence, dependent stages separated by a grid-wide barrier.
// Their matvecs give each output unit (one or a few weight columns) to
// kSplit warps of one block, each over its part of K: the weights are
// stored TRANSPOSED (N, K), so a column's K values are contiguous and a
// warp reads them as 16-byte vectors; the (<= kRB rows of) inputs sit in
// shared memory, staged once per stage and block; the warps' partial sums
// meet in shared memory.  Accumulation is always f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace avc {

constexpr int kWarps = 8;               // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kRB = 8;                  // rows per register tile
constexpr int kSplit = 2;               // warps sharing one unit's K range
constexpr int kUnits = kWarps / kSplit; // output units per block and pass

// Grid-wide barrier.  bar[0] counts arrivals, bar[1] is the generation.
// Needs a cooperative launch (all blocks co-resident) and bar[0] == 0 at
// launch.  Writes made by any thread of the grid before the barrier are
// visible to every thread after it (read them with __ldcg: the per-SM L1
// is not coherent).
__device__ __forceinline__ void grid_sync(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* vgen = bar + 1;
    const unsigned int gen = *vgen;
    __threadfence();
    const unsigned int arrived = atomicAdd(bar, 1u);
    if (arrived == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      // a barrier that never opens is a bug (a block that is not
      // resident, or one that skipped the barrier): abort the launch with
      // an error after ~2^26 polls (seconds) rather than hang the card
      unsigned int polls = 0;
      while (*vgen == gen) {
        __nanosleep(20);
        if (++polls == (1u << 26)) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 8 consecutive values -> f32 registers.  p must be 16-byte aligned.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
// Read-only (weights): through the non-coherent texture path.
__device__ __forceinline__ void ldg8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void ldg8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Per-lane partial dot products of NC weight columns with nrows staged
// input rows over k in [k0, k1): acc[c][r] += sum over this lane's k of
// in[r][k] * wcol[c][k].  The NC columns' loads of a k-chunk are issued
// together (and the chunk loop is unrolled by two), so a warp waits on few
// L2 round trips; each staged input vector is reused across the NC
// columns.  k0, k1 and K are multiples of 8; lanes stride in 8-value
// vectors.
template <int NC, typename T>
__device__ __forceinline__ void warp_dot(const T* const* wcols,
                                         const T* in_s, int K, int k0, int k1,
                                         int nrows, float (&acc)[NC][kRB]) {
  const int lane = threadIdx.x & 31;
#pragma unroll 2
  for (int k = k0 + lane * 8; k < k1; k += 256) {
    float w[NC][8];
#pragma unroll
    for (int c = 0; c < NC; ++c) ldg8(wcols[c] + k, w[c]);
#pragma unroll
    for (int r = 0; r < kRB; ++r) {
      if (r < nrows) {
        float v[8];
        load8(in_s + r * K + k, v);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[c][r] = fmaf(v[i], w[c][i], acc[c][r]);
        }
      }
    }
  }
}

// Transpose reduction over the warp: N per-lane partials -> their warp
// sums, spread over the lanes.  While N is even, each step hands half of
// the values to the partner lane (N/2 shuffles, not N); odd N butterflies.
// `base` tracks which value indices this lane ends up holding.
template <int N, int OFF>
__device__ __forceinline__ void reduce_step(float* v, int lane, int& base) {
  if constexpr (OFF > 0) {
    if constexpr (N % 2 == 0) {
      const bool up = (lane & OFF) != 0;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = up ? v[i] : v[i + N / 2];
        const float keep = up ? v[i + N / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      if (up) base += N / 2;
      reduce_step<N / 2, OFF / 2>(v, lane, base);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], OFF);
      reduce_step<N, OFF / 2>(v, lane, base);
    }
  }
}

template <int N>
__host__ __device__ constexpr int reduced_count() {
  int n = N;
  for (int off = 16; off > 0 && n % 2 == 0; off >>= 1) n /= 2;
  return n;
}

// Warp-sum N per-lane partials and write the N sums to red[0..N).
template <int N>
__device__ __forceinline__ void warp_sum_to_smem(float (&v)[N], float* red) {
  const int lane = threadIdx.x & 31;
  int base = 0;
  reduce_step<N, 16>(v, lane, base);
#pragma unroll
  for (int i = 0; i < reduced_count<N>(); ++i) red[base + i] = v[i];
  __syncwarp();
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned int*>(&lo);
  u.y = *reinterpret_cast<unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Stage rows [r0, r0+nrows) of a row-major (rows, K) f32 global array into
// shared memory as T (the matmul operand type: the bf16 rounding of the
// operand happens here).  16-byte loads, kStageUnroll of them in flight
// per thread: a staging pass costs about one L2 round trip, not one per
// element.  K must be a multiple of 4 and src 16-byte aligned.
constexpr int kStageUnroll = 4;
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const float* src, int r0,
                                           int nrows, int K) {
  const int n4 = nrows * K / 4;
  const float4* s4 = reinterpret_cast<const float4*>(src + (size_t)r0 * K);
  for (int i0 = threadIdx.x; i0 < n4; i0 += kStageUnroll * blockDim.x) {
    float4 v[kStageUnroll];
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n4) v[u] = __ldcg(s4 + i);
    }
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n4) store4(dst + 4 * i, v[u]);
    }
  }
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Streaming stores of the saved training state (evict-first: they must not
// push the resident weights out of L2), in the store's dtype.
__device__ __forceinline__ void store_cs(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void store_cs(__nv_bfloat16* p, float v) {
  __stcs(reinterpret_cast<unsigned short*>(p),
         __bfloat16_as_ushort(__float2bfloat16_rn(v)));
}
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// d += A (16 x 16, row-major) * B (16 x 8, col-major) on the tensor cores:
// bf16 operands, f32 accumulation.  Fragment layout of the PTX ISA: lane =
// 4 * gid + tq; a = {(gid, 2tq..), (gid+8, 2tq..), (gid, 2tq+8..),
// (gid+8, 2tq+8..)}, b = {(k 2tq.., n gid), (k 2tq+8.., n gid)},
// d = {(gid, 2tq), (gid, 2tq+1), (gid+8, 2tq), (gid+8, 2tq+1)}.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Grid-wide barrier on a monotonic arrival count: the k-th barrier of a
// launch waits for k x gridDim.x arrivals (count == 0 at launch).  One
// release reduction arrives and acquire loads wait: one L2 round trip
// fewer on the critical path than grid_sync's count-reset-generation
// scheme.  A barrier that never opens aborts the launch (~2^26 polls).
// kScFence = false drops the sequentially consistent fence before the
// arrival, which waits for the block's outstanding memory operations.
// The PTX ISA's memory consistency model orders the block's writes without
// it: a bar.sync synchronizes with the other threads' bar.sync on the same
// barrier, and a release reduction with the acquire load that observes it
// (section "Synchronizes-with"); base causality order is transitive over
// program order and synchronizes-with (section "Base causality order").
// So every write a thread made before the opening __syncthreads precedes,
// in causality order, every read after another block's closing
// __syncthreads.  Kernel 2 runs without the fence; kernels 3-6 keep it
// until they are measured without it.
template <bool kScFence = true>
__device__ __forceinline__ void grid_sync_count(unsigned int* count,
                                                unsigned int& k) {
  __syncthreads();
  ++k;
  if (threadIdx.x == 0) {
    const unsigned int target = k * gridDim.x;
    if constexpr (kScFence) __threadfence();
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;"
                 :: "l"(count) : "memory");
    unsigned int v, polls = 0;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(v) : "l"(count) : "memory");
      if (++polls == (1u << 26)) __trap();
    } while (v < target);
  }
  __syncthreads();
}

// Streaming loads (each value is read once: evict-first, so they do not
// push the ring or the weights out of L2).
__device__ __forceinline__ float ld_stream(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float ld_stream(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcs(reinterpret_cast<const unsigned short*>(p))));
}

// A 16-byte weight fragment: from shared memory (resident) or, read-only,
// from L2.
__device__ __forceinline__ uint4 ld_w16(const __nv_bfloat16* p,
                                        bool resident) {
  return resident ? *reinterpret_cast<const uint4*>(p)
                  : __ldg(reinterpret_cast<const uint4*>(p));
}

// Launch a persistent cooperative kernel: at most one block per SM and no
// more blocks than `want`.  Returns a cudaError_t value.
template <typename Kern, typename Args>
inline int launch_cooperative(Kern kernel, Args& args, int want,
                              size_t smem, cudaStream_t stream) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  int grid = want < sms ? want : sms;
  if (grid < 1) grid = 1;
  void* kargs[] = {&args};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                  dim3(grid), dim3(kThreads), kargs, smem,
                                  stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace avc
