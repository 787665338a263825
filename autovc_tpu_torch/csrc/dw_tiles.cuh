// Weight and bias gradients of the training backwards, as hand-written tile
// products over K = T * B (step, row) pairs: kernel 7's dW_hh, dW_ih, db
// (lstm_train.cu) and kernel 5's dW_hh1, dW_hh2, dW_ih2x, db (gru_train.cu),
// as the TPU kernels form them in their own bodies.
//
// One problem is C (M, N) = sum over k < K of A[k - shift]^T Bm[k], rows of
// A before `shift` read as zero (h_{t-1} at t = 0), and optionally db (N,)
// = the column sums of Bm.  Columns n >= n_gate of Bm are multiplied by
// gate[k * gate_ld + n - n_gate] as they are staged (the GRU's dhp is its
// dxp with the n lane times the saved reset gate r); n_gate >= N disables
// that.  A block owns a 64 x 64 tile of one problem and walks all of K:
// shared-memory stages of 32 k, FMA in f32, mma.sync bf16 tensor-core tiles
// in bf16 (operands rounded to bf16 as they leave shared memory, f32
// accumulation, as the TPU kernels' bf16 dot_generals); db sums the
// unrounded f32 values.
#pragma once

#include <vector>

#include "common.cuh"

namespace avc {

struct DwProblem {
  const float* A;     // (K, M) rows
  const float* Bm;    // (K, N) rows
  float* C;           // (M, N) out
  float* db;          // (N,) out, or null
  const void* gate;   // f32 or bf16 (gate_bf16), or null
  int M, N, K, shift, n_gate, gate_ld, gate_bf16;
};

constexpr int kMaxDwProblems = 8;   // problems per launch (grid z)
struct DwBatch {
  DwProblem p[kMaxDwProblems];
};

constexpr int kTile = 64;             // M and N of a block tile
constexpr int kTileK = 32;            // K of a shared-memory stage
constexpr int kTilePad = kTile + 4;   // row pitch: conflict-free fragments

__device__ __forceinline__ float4 load_gate4(const DwProblem& p, size_t i) {
  if (p.gate_bf16) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(p.gate) + i));
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  return __ldg(reinterpret_cast<const float4*>(
      static_cast<const float*>(p.gate) + i));
}

// Stage rows [k0, k0 + kTileK) of the A and B tiles as f32 (coalesced
// 16-byte loads, zero outside); accumulate B's column sums for db.
template <int NT>
__device__ __forceinline__ void dw_stage(const DwProblem& p, int k0, int m0,
                                         int n0, float (*As)[kTilePad],
                                         float (*Bs)[kTilePad],
                                         float (&colsum)[4]) {
  constexpr int kVec = kTile / 4;                    // float4 per tile row
  for (int i = threadIdx.x; i < kTileK * kVec; i += NT) {
    const int kk = i / kVec, c = (i % kVec) * 4;
    const int k = k0 + kk, n = n0 + c;
    float4 va = make_float4(0.f, 0.f, 0.f, 0.f), vb = va;
    if (k < p.K) {
      if (k >= p.shift && m0 + c < p.M)
        va = __ldg(reinterpret_cast<const float4*>(
            p.A + (size_t)(k - p.shift) * p.M + m0 + c));
      if (n < p.N) {
        vb = __ldg(reinterpret_cast<const float4*>(p.Bm + (size_t)k * p.N + n));
        if (n >= p.n_gate) {
          const float4 g = load_gate4(p, (size_t)k * p.gate_ld + n - p.n_gate);
          vb.x *= g.x; vb.y *= g.y; vb.z *= g.z; vb.w *= g.w;
        }
      }
    }
    As[kk][c] = va.x; As[kk][c + 1] = va.y;
    As[kk][c + 2] = va.z; As[kk][c + 3] = va.w;
    Bs[kk][c] = vb.x; Bs[kk][c + 1] = vb.y;
    Bs[kk][c + 2] = vb.z; Bs[kk][c + 3] = vb.w;
    colsum[0] += vb.x; colsum[1] += vb.y; colsum[2] += vb.z; colsum[3] += vb.w;
  }
}

// db for the block's 64 columns: the threads that staged the same columns
// sum their partials through shared memory (a fixed order: deterministic).
template <int NT>
__device__ __forceinline__ void dw_colsum(const DwProblem& p, int n0,
                                          const float (&colsum)[4],
                                          float* red) {
  constexpr int kVec = kTile / 4, kGroups = NT / kVec;
  const int g = threadIdx.x / kVec, c = (threadIdx.x % kVec) * 4;
  __syncthreads();
  for (int q = 0; q < 4; ++q) red[g * kTile + c + q] = colsum[q];
  __syncthreads();
  if (threadIdx.x < kTile && n0 + threadIdx.x < p.N) {
    float s = 0.0f;
    for (int gg = 0; gg < kGroups; ++gg) s += red[gg * kTile + threadIdx.x];
    p.db[n0 + threadIdx.x] = s;
  }
}

// f32: 256 threads as 16 x 16, each a 4 x 4 register tile (FMA).
constexpr int kDwF32Threads = 256;
__global__ void __launch_bounds__(kDwF32Threads) dw_f32_kernel(DwBatch b) {
  __shared__ __align__(16) float As[kTileK][kTilePad];
  __shared__ __align__(16) float Bs[kTileK][kTilePad];
  __shared__ float red[kDwF32Threads / (kTile / 4) * kTile];
  const DwProblem p = b.p[blockIdx.z];
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  if (m0 >= p.M || n0 >= p.N) return;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {}, colsum[4] = {};
  for (int k0 = 0; k0 < p.K; k0 += kTileK) {
    dw_stage<kDwF32Threads>(p, k0, m0, n0, As, Bs, colsum);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 va = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 vb = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {va.x, va.y, va.z, va.w};
      const float bv[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i, n = n0 + tx * 4;
    if (m < p.M && n < p.N)
      *reinterpret_cast<float4*>(p.C + (size_t)m * p.N + n) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  if (p.db != nullptr && blockIdx.y == 0)
    dw_colsum<kDwF32Threads>(p, n0, colsum, red);
}

// bf16: 4 warps as 2 x 2, each a 32 x 32 tile of m16n8k16 mma.sync
// fragments.
constexpr int kDwBf16Threads = 128;
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__global__ void __launch_bounds__(kDwBf16Threads) dw_bf16_kernel(DwBatch b) {
  __shared__ __align__(16) float As[kTileK][kTilePad];
  __shared__ __align__(16) float Bs[kTileK][kTilePad];
  __shared__ float red[kDwBf16Threads / (kTile / 4) * kTile];
  const DwProblem p = b.p[blockIdx.z];
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  if (m0 >= p.M || n0 >= p.N) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tq = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  float acc[2][4][4] = {}, colsum[4] = {};
  for (int k0 = 0; k0 < p.K; k0 += kTileK) {
    dw_stage<kDwBf16Threads>(p, k0, m0, n0, As, Bs, colsum);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kTileK; ks += 16) {
      const int kl = ks + 2 * tq, kh = kl + 8;
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int m = wm + mt * 16 + gid;
        af[mt][0] = pack_bf16(As[kl][m], As[kl + 1][m]);
        af[mt][1] = pack_bf16(As[kl][m + 8], As[kl + 1][m + 8]);
        af[mt][2] = pack_bf16(As[kh][m], As[kh + 1][m]);
        af[mt][3] = pack_bf16(As[kh][m + 8], As[kh + 1][m + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = wn + nt * 8 + gid;
        const uint32_t b0 = pack_bf16(Bs[kl][n], Bs[kl + 1][n]);
        const uint32_t b1 = pack_bf16(Bs[kh][n], Bs[kh + 1][n]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][nt], af[mt], b0, b1);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int m = m0 + wm + mt * 16 + gid;
      const int n = n0 + wn + nt * 8 + 2 * tq;
      if (n >= p.N) continue;
      if (m < p.M)
        *reinterpret_cast<float2*>(p.C + (size_t)m * p.N + n) =
            make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      if (m + 8 < p.M)
        *reinterpret_cast<float2*>(p.C + (size_t)(m + 8) * p.N + n) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
  if (p.db != nullptr && blockIdx.y == 0)
    dw_colsum<kDwBf16Threads>(p, n0, colsum, red);
}

// Launch every problem, kMaxDwProblems per launch.  M, N multiples of 4
// (16-byte rows); a gated problem's n_gate and gate_ld multiples of 4.
// Returns a cudaError_t value.
inline int launch_dw(const std::vector<DwProblem>& probs, bool bf16,
                     cudaStream_t stream) {
  for (size_t i0 = 0; i0 < probs.size(); i0 += kMaxDwProblems) {
    DwBatch b{};
    int M = 0, N = 0, count = 0;
    for (size_t i = i0; i < probs.size() && count < kMaxDwProblems; ++i) {
      b.p[count++] = probs[i];
      M = probs[i].M > M ? probs[i].M : M;
      N = probs[i].N > N ? probs[i].N : N;
    }
    const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, count);
    if (bf16)
      dw_bf16_kernel<<<grid, kDwBf16Threads, 0, stream>>>(b);
    else
      dw_f32_kernel<<<grid, kDwF32Threads, 0, stream>>>(b);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace avc
