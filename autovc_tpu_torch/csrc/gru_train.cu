// GRU-pair TRAINING kernels for Hopper (sm_90a): kernel 4 (forward) and
// kernel 5 (backward) of the port.
//
// Replace the two Pallas TPU kernels of autovc_tpu/ops/gru_train_pallas.py:
//   * gru_train_fwd_launch <- _fwd_call / _fwd_kernel: the WaveRNN's
//     chained, teacher-forced GRU pair from zero states,
//       h1_t = GRU(h1_{t-1}; xp1_t)
//       h2_t = GRU(h2_{t-1}; base2_t + h1_t W_ih2x)
//     (PyTorch gate semantics: b_hh inside the reset product), saving every
//     step's h1, h2 (f32) and r, z, n, hn of both layers (compute dtype);
//   * gru_train_bwd_launch <- _gru_pair_bwd / _bwd_kernel: (a) the
//     reverse-time chain dhp2 W_hh2^T, dxp2 W_ih2x^T, dhp1 W_hh1^T that
//     turns the saved state and the cotangents of h1, h2 into dxp1 and
//     dbase2 (= dxp2), and (b) dW_hh1, dW_hh2, dW_ih2x and db_hh1, db_hh2
//     as hand-written products over K = T * B (dw_tiles.cuh, shared with
//     kernel 7), as the TPU kernel forms them in its own body.
//
// What bounds them on an H100: the recurrences are a dependent chain of
// 2 T stages, each a matvec of B rows (8 on the training path) against up
// to two 512 x 1536 weight blocks (1.5 MB each in bf16), so a stage is
// latency-bound (staging, FMA issue, a grid barrier), never compute- or
// HBM-bound; the saved state (~243 MB per call at 8 x 2475) and the
// streams of the backward must leave and come back through HBM.  The dW
// products are the only dense work (3 x 31 GFLOP at 8 x 2475).  What the
// design does about it: the structure of kernels 6/7 (one persistent
// cooperative grid, a warp pair per hidden unit's r, z, n columns over
// halves of K, the cell update as the epilogue), with the three weight
// blocks (4.7 MB in bf16) resident in the 50 MB L2 across all rounds and
// the saved state written with streaming stores so it does not evict them;
// rows and steps are not padded (the TPU's 8-row / 32-step blocks were for
// VMEM).  dhp, which the recurrence and the dW products both need, is the
// dxp stream with its n lane times the saved r: the recurrence keeps one
// step of it in a (B, 3H) scratch, the dW products form it as they stage.
#include "dw_tiles.cuh"

namespace avc {

// ---------------------------------------------------------------------------
// kernel 4: forward.  A step is two dependent stages, each followed by a
// grid barrier: (A) h1_{t-1} W_hh1 and h2_{t-1} W_hh2, then layer 1's cell;
// (B) h1_t W_ih2x, then layer 2's cell.
// ---------------------------------------------------------------------------

template <typename WT>
struct GruFwdArgs {
  const float* xp1;    // (T, B, 3H) f32: layer 1's input projection + b_ih
  const float* base2;  // (T, B, 3H) f32: layer 2's hoisted projection + b_ih
  const WT* whh1;      // (3H, H): W_hh1 transposed (column c contiguous)
  const WT* wih2x;     // (3H, H): W_ih2x transposed
  const WT* whh2;      // (3H, H): W_hh2 transposed
  const float* bhh1;   // (3H,)
  const float* bhh2;   // (3H,)
  float* hs;           // (2, T, B, H) out: h1, h2
  WT* acts;            // (2, T, B, 4H) out: r, z, n, hn of each layer
  float* hp2;          // scratch (B, 3H): h2_{t-1} W_hh2 + b_hh2
  unsigned int* bar;   // (2,): grid barrier, bar[0] == 0 at launch
  int T, B, H;
};

// Stage A: layer 1's cell at step t (the pre-activations: xp1_t, and
// h1_{t-1} W_hh1 + b_hh1); keeps h2_{t-1} W_hh2 + b_hh2 for stage B.
template <typename WT>
__device__ void fwd_stage_a(const GruFwdArgs<WT>& a, int t, WT* smem) {
  const int H = a.H, B = a.B;
  if (blockIdx.x * kUnits >= H) return;  // no unit of this block here
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int V = 6 * kRB;
  const int slot = warp % kUnits, part = warp / kUnits;
  const int kpart = H / kSplit, k0 = part * kpart;
  const size_t BH = (size_t)B * H;
  WT* h1s = smem;
  WT* h2s = smem + kRB * H;
  float* red = reinterpret_cast<float*>(smem + 2 * kRB * H);  // (kWarps, V)
  float* h1_out = a.hs + (size_t)t * BH;
  const float* h1_in = h1_out - BH;                  // h1_{t-1}, t > 0
  const float* h2_in = h1_in + (size_t)a.T * BH;     // h2_{t-1}, t > 0
  WT* act1 = a.acts + (size_t)t * BH * 4;
  for (int r0 = 0; r0 < B; r0 += kRB) {
    const int nr = min(kRB, B - r0);
    if (t > 0) {
      stage_rows(h1s, h1_in, r0, nr, H);
      stage_rows(h2s, h2_in, r0, nr, H);
    }
    __syncthreads();
    for (int j0 = blockIdx.x * kUnits; j0 < H; j0 += gridDim.x * kUnits) {
      const int j = j0 + slot;
      const bool epi = part == 0 && j < H && lane < nr;
      if (j < H) {
        float acc1[3][kRB] = {}, acc2[3][kRB] = {};
        if (t > 0) {
          const WT* const w1[3] = {a.whh1 + (size_t)j * H,
                                   a.whh1 + (size_t)(H + j) * H,
                                   a.whh1 + (size_t)(2 * H + j) * H};
          warp_dot(w1, h1s, H, k0, k0 + kpart, nr, acc1);
          const WT* const w2[3] = {a.whh2 + (size_t)j * H,
                                   a.whh2 + (size_t)(H + j) * H,
                                   a.whh2 + (size_t)(2 * H + j) * H};
          warp_dot(w2, h2s, H, k0, k0 + kpart, nr, acc2);
        }
        float v[V];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
#pragma unroll
          for (int r = 0; r < kRB; ++r) {
            v[g * kRB + r] = acc1[g][r];
            v[(3 + g) * kRB + r] = acc2[g][r];
          }
        }
        warp_sum_to_smem(v, red + warp * V);
      }
      __syncthreads();
      if (epi) {
        const int row = r0 + lane;
        float xp[3], hp1[3];
        const float* x = a.xp1 + ((size_t)t * B + row) * 3 * H + j;
        float* q = a.hp2 + (size_t)row * 3 * H + j;
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
          for (int p = 0; p < kSplit; ++p) {
            s1 += red[(p * kUnits + slot) * V + g * kRB + lane];
            s2 += red[(p * kUnits + slot) * V + (3 + g) * kRB + lane];
          }
          hp1[g] = s1 + __ldg(a.bhh1 + g * H + j);
          q[g * H] = s2 + __ldg(a.bhh2 + g * H + j);
          xp[g] = __ldg(x + g * H);
        }
        const size_t idx = (size_t)row * H + j;
        const float h_prev = t > 0 ? __ldcg(h1_in + idx) : 0.0f;
        const float r = sigmoidf_(xp[0] + hp1[0]);
        const float z = sigmoidf_(xp[1] + hp1[1]);
        const float n = tanhf(xp[2] + r * hp1[2]);
        store_cs(h1_out + idx, (1.0f - z) * n + z * h_prev);
        WT* act = act1 + (size_t)row * 4 * H + j;
        store_cs(act, r);
        store_cs(act + H, z);
        store_cs(act + 2 * H, n);
        store_cs(act + 3 * H, hp1[2]);
      }
      __syncthreads();
    }
  }
}

// Stage B: layer 2's cell at step t (xp2 = base2_t + h1_t W_ih2x).
template <typename WT>
__device__ void fwd_stage_b(const GruFwdArgs<WT>& a, int t, WT* smem) {
  const int H = a.H, B = a.B;
  if (blockIdx.x * kUnits >= H) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int V = 3 * kRB;
  const int slot = warp % kUnits, part = warp / kUnits;
  const int kpart = H / kSplit, k0 = part * kpart;
  const size_t BH = (size_t)B * H, TBH = (size_t)a.T * BH;
  WT* h1s = smem;
  float* red = reinterpret_cast<float*>(smem + 2 * kRB * H);
  const float* h1_in = a.hs + (size_t)t * BH;        // h1_t
  float* h2_out = a.hs + TBH + (size_t)t * BH;
  const float* h2_in = h2_out - BH;                  // h2_{t-1}, t > 0
  WT* act2 = a.acts + (TBH + (size_t)t * BH) * 4;
  for (int r0 = 0; r0 < B; r0 += kRB) {
    const int nr = min(kRB, B - r0);
    stage_rows(h1s, h1_in, r0, nr, H);
    __syncthreads();
    for (int j0 = blockIdx.x * kUnits; j0 < H; j0 += gridDim.x * kUnits) {
      const int j = j0 + slot;
      const bool epi = part == 0 && j < H && lane < nr;
      if (j < H) {
        float acc[3][kRB] = {};
        const WT* const w[3] = {a.wih2x + (size_t)j * H,
                                a.wih2x + (size_t)(H + j) * H,
                                a.wih2x + (size_t)(2 * H + j) * H};
        warp_dot(w, h1s, H, k0, k0 + kpart, nr, acc);
        float v[V];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
#pragma unroll
          for (int r = 0; r < kRB; ++r) v[g * kRB + r] = acc[g][r];
        }
        warp_sum_to_smem(v, red + warp * V);
      }
      __syncthreads();
      if (epi) {
        const int row = r0 + lane;
        float xp[3], hp[3];
        const float* x = a.base2 + ((size_t)t * B + row) * 3 * H + j;
        const float* q = a.hp2 + (size_t)row * 3 * H + j;
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          float s = 0.0f;
#pragma unroll
          for (int p = 0; p < kSplit; ++p)
            s += red[(p * kUnits + slot) * V + g * kRB + lane];
          xp[g] = __ldg(x + g * H) + s;
          hp[g] = __ldcg(q + g * H);
        }
        const size_t idx = (size_t)row * H + j;
        const float h_prev = t > 0 ? __ldcg(h2_in + idx) : 0.0f;
        const float r = sigmoidf_(xp[0] + hp[0]);
        const float z = sigmoidf_(xp[1] + hp[1]);
        const float n = tanhf(xp[2] + r * hp[2]);
        store_cs(h2_out + idx, (1.0f - z) * n + z * h_prev);
        WT* act = act2 + (size_t)row * 4 * H + j;
        store_cs(act, r);
        store_cs(act + H, z);
        store_cs(act + 2 * H, n);
        store_cs(act + 3 * H, hp[2]);
      }
      __syncthreads();
    }
  }
}

template <typename WT>
__global__ void __launch_bounds__(kThreads)
    gru_train_fwd_kernel(GruFwdArgs<WT> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WT* smem = reinterpret_cast<WT*>(smem_raw);
  for (int t = 0; t < a.T; ++t) {
    fwd_stage_a(a, t, smem);
    grid_sync(a.bar);
    fwd_stage_b(a, t, smem);
    grid_sync(a.bar);
  }
}

// ---------------------------------------------------------------------------
// kernel 5 (a): the reverse-time chain.  Per step t, two rounds, each
// followed by a grid barrier:
//   R2(t): dhp2_t W_hh2^T (layer 2's dh for t-1) and dxp2_t W_ih2x^T (layer
//          1's dh at t); epilogue: layer 1's gate derivatives at t;
//   R1(t): dhp1_t W_hh1^T (layer 1's dh for t-1); epilogue: layer 2's gate
//          derivatives at t-1.
// The carried dh of each layer (dh z, then plus the matvec) lives in a
// (B, H) scratch; dhp of the current step in a (B, 3H) scratch.
// ---------------------------------------------------------------------------

template <typename WT>
struct GruBwdArgs {
  const WT* acts;      // (2, T, B, 4H): saved r, z, n, hn
  const float* hs;     // (2, T, B, H): saved h1, h2
  const float* dh1s;   // (T, B, H): cotangent of h1
  const float* dh2s;   // (T, B, H): cotangent of h2
  const WT* whh1;      // (H, 3H): W_hh1 in the param layout (row j = unit
                       //   j's 3H weights, contiguous)
  const WT* wih2x;     // (H, 3H)
  const WT* whh2;      // (H, 3H)
  float* dxp1;         // (T, B, 3H) out
  float* dxp2;         // (T, B, 3H) out: dbase2
  float* dhp1;         // scratch (B, 3H): layer 1's dhp of the current step
  float* dhp2;         // scratch (B, 3H)
  float* dh1c;         // scratch (B, H): layer 1's carried dh
  float* dh2c;         // scratch (B, H)
  unsigned int* bar;   // (2,): grid barrier, bar[0] == 0 at launch
  int T, B, H;
};

// Gate derivatives of layer l (0 or 1), unit j, row `row`, step t, given
// its total dh (arithmetic and order of gru_train_pallas._bwd_kernel):
// writes dxp (out) and dhp (scratch); returns dh z, the part of the next
// (earlier) step's dh that does not go through W_hh.
template <typename WT>
__device__ __forceinline__ float gate_grads(const GruBwdArgs<WT>& a, int l,
                                            int t, int row, int j,
                                            float dh) {
  const int H = a.H;
  const size_t BH = (size_t)a.B * H, TBH = (size_t)a.T * BH;
  const size_t at = l * TBH + (size_t)t * BH + (size_t)row * H;  // (l,t,row)
  const WT* ac = a.acts + at * 4;
  const float r = to_float(ac[j]), z = to_float(ac[H + j]);
  const float n = to_float(ac[2 * H + j]), hn = to_float(ac[3 * H + j]);
  const float h_prev = t > 0 ? __ldg(a.hs + at - BH + j) : 0.0f;
  const float da_n = dh * (1.0f - z) * (1.0f - n * n);
  const float da_z = dh * (h_prev - n) * z * (1.0f - z);
  const float da_r = da_n * hn * r * (1.0f - r);
  float* dx = (l == 0 ? a.dxp1 : a.dxp2) + ((size_t)t * a.B + row) * 3 * H + j;
  dx[0] = da_r;
  dx[H] = da_z;
  dx[2 * H] = da_n;
  float* dp = (l == 0 ? a.dhp1 : a.dhp2) + (size_t)row * 3 * H + j;
  dp[0] = da_r;
  dp[H] = da_z;
  dp[2 * H] = da_n * r;
  return dh * z;
}

template <typename WT>
__device__ void bwd_round2(const GruBwdArgs<WT>& a, int t, WT* smem) {
  const int H = a.H, B = a.B, K = 3 * H;
  if (blockIdx.x * kUnits >= H) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int V = 2 * kRB;
  const int slot = warp % kUnits, part = warp / kUnits;
  const int kpart = K / kSplit, k0 = part * kpart;
  const size_t BH = (size_t)B * H;
  WT* hsm = smem;                  // dhp2_t rows
  WT* xsm = smem + kRB * K;        // dxp2_t rows
  float* red = reinterpret_cast<float*>(smem + 2 * kRB * K);
  const float* dxp2_t = a.dxp2 + (size_t)t * B * K;
  for (int r0 = 0; r0 < B; r0 += kRB) {
    const int nr = min(kRB, B - r0);
    if (t > 0) stage_rows(hsm, a.dhp2, r0, nr, K);
    stage_rows(xsm, dxp2_t, r0, nr, K);
    __syncthreads();
    for (int j0 = blockIdx.x * kUnits; j0 < H; j0 += gridDim.x * kUnits) {
      const int j = j0 + slot;
      const bool epi = part == 0 && j < H && lane < nr;
      if (j < H) {
        float acc_h[1][kRB] = {}, acc_x[1][kRB] = {};
        if (t > 0) {
          const WT* const wh[1] = {a.whh2 + (size_t)j * K};
          warp_dot(wh, hsm, K, k0, k0 + kpart, nr, acc_h);
        }
        const WT* const wx[1] = {a.wih2x + (size_t)j * K};
        warp_dot(wx, xsm, K, k0, k0 + kpart, nr, acc_x);
        float v[V];
#pragma unroll
        for (int r = 0; r < kRB; ++r) {
          v[r] = acc_h[0][r];
          v[kRB + r] = acc_x[0][r];
        }
        warp_sum_to_smem(v, red + warp * V);
      }
      __syncthreads();
      if (epi) {
        const int row = r0 + lane;
        float dh_rec = 0.0f, dh_x = 0.0f;
#pragma unroll
        for (int p = 0; p < kSplit; ++p) {
          dh_rec += red[(p * kUnits + slot) * V + lane];
          dh_x += red[(p * kUnits + slot) * V + kRB + lane];
        }
        const size_t idx = (size_t)row * H + j;
        // layer 1 at step t: its dh takes dxp2_t W_ih2x^T of the SAME step
        const float dh1 = __ldg(a.dh1s + (size_t)t * BH + idx) +
                          __ldcg(a.dh1c + idx) + dh_x;
        a.dh1c[idx] = gate_grads(a, 0, t, row, j, dh1);
        // layer 2's dh for step t-1: dh2 z2 (carried) + dhp2_t W_hh2^T
        if (t > 0) a.dh2c[idx] = __ldcg(a.dh2c + idx) + dh_rec;
      }
      __syncthreads();
    }
  }
}

template <typename WT>
__device__ void bwd_round1(const GruBwdArgs<WT>& a, int t, WT* smem) {
  const int H = a.H, B = a.B, K = 3 * H;
  if (blockIdx.x * kUnits >= H) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int V = kRB;
  const int slot = warp % kUnits, part = warp / kUnits;
  const int kpart = K / kSplit, k0 = part * kpart;
  const size_t BH = (size_t)B * H;
  WT* hsm = smem;                  // dhp1_t rows
  float* red = reinterpret_cast<float*>(smem + 2 * kRB * K);
  for (int r0 = 0; r0 < B; r0 += kRB) {
    const int nr = min(kRB, B - r0);
    stage_rows(hsm, a.dhp1, r0, nr, K);
    __syncthreads();
    for (int j0 = blockIdx.x * kUnits; j0 < H; j0 += gridDim.x * kUnits) {
      const int j = j0 + slot;
      const bool epi = part == 0 && j < H && lane < nr;
      if (j < H) {
        float acc[1][kRB] = {};
        const WT* const wh[1] = {a.whh1 + (size_t)j * K};
        warp_dot(wh, hsm, K, k0, k0 + kpart, nr, acc);
        float v[V];
#pragma unroll
        for (int r = 0; r < kRB; ++r) v[r] = acc[0][r];
        warp_sum_to_smem(v, red + warp * V);
      }
      __syncthreads();
      if (epi) {
        const int row = r0 + lane;
        float dh_rec = 0.0f;
#pragma unroll
        for (int p = 0; p < kSplit; ++p)
          dh_rec += red[(p * kUnits + slot) * V + lane];
        const size_t idx = (size_t)row * H + j;
        // layer 1's dh for step t-1: dh1 z1 (carried) + dhp1_t W_hh1^T
        a.dh1c[idx] = __ldcg(a.dh1c + idx) + dh_rec;
        // layer 2 at step t-1
        const float dh2 = __ldg(a.dh2s + (size_t)(t - 1) * BH + idx) +
                          __ldcg(a.dh2c + idx);
        a.dh2c[idx] = gate_grads(a, 1, t - 1, row, j, dh2);
      }
      __syncthreads();
    }
  }
}

template <typename WT>
__global__ void __launch_bounds__(kThreads)
    gru_train_bwd_kernel(GruBwdArgs<WT> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WT* smem = reinterpret_cast<WT*>(smem_raw);
  const size_t BH = (size_t)a.B * a.H;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t nthreads = (size_t)gridDim.x * blockDim.x;
  // layer 1 enters the last step with no carried dh; layer 2's gate
  // derivatives at the last step need only its cotangent
  for (size_t i = tid; i < BH; i += nthreads) {
    a.dh1c[i] = 0.0f;
    a.dh2c[i] = gate_grads(a, 1, a.T - 1, (int)(i / a.H), (int)(i % a.H),
                           a.dh2s[(size_t)(a.T - 1) * BH + i]);
  }
  grid_sync(a.bar);
  for (int t = a.T - 1; t >= 0; --t) {
    bwd_round2(a, t, smem);
    grid_sync(a.bar);
    if (t > 0) {
      bwd_round1(a, t, smem);
      grid_sync(a.bar);
    }
  }
}

// ---------------------------------------------------------------------------
// kernel 5 (b): dW_hh1 = sum_k h1[k - B]^T dhp1[k], dW_hh2 likewise,
// dW_ih2x = sum_k h1[k]^T dxp2[k], db_hh = sum_k dhp (dw_tiles.cuh; dhp
// formed from dxp and the saved r as the tiles are staged).
// ---------------------------------------------------------------------------

template <typename WT>
static std::vector<DwProblem> gru_dw_problems(const WT* acts, const float* hs,
                                              const float* dxp1,
                                              const float* dxp2, float* dwhh1,
                                              float* dwih2x, float* dwhh2,
                                              float* dbhh1, float* dbhh2,
                                              int T, int B, int H) {
  const size_t TBH = (size_t)T * B * H;
  const int M = H, N = 3 * H, K = T * B, bf16 = sizeof(WT) == 2;
  return {
      {hs, dxp1, dwhh1, dbhh1, acts, M, N, K, B, 2 * H, 4 * H, bf16},
      {hs + TBH, dxp2, dwhh2, dbhh2, acts + TBH * 4, M, N, K, B, 2 * H, 4 * H,
       bf16},
      {hs, dxp2, dwih2x, nullptr, nullptr, M, N, K, 0, N, 0, 0}};
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename WT>
static int fwd_launch(const void* xp1, const void* base2, const void* whh1,
                      const void* wih2x, const void* whh2, const void* bhh1,
                      const void* bhh2, void* hs, void* acts, void* hp2,
                      void* bar, int T, int B, int H, cudaStream_t stream) {
  GruFwdArgs<WT> a{static_cast<const float*>(xp1),
                   static_cast<const float*>(base2),
                   static_cast<const WT*>(whh1), static_cast<const WT*>(wih2x),
                   static_cast<const WT*>(whh2),
                   static_cast<const float*>(bhh1),
                   static_cast<const float*>(bhh2), static_cast<float*>(hs),
                   static_cast<WT*>(acts), static_cast<float*>(hp2),
                   static_cast<unsigned int*>(bar), T, B, H};
  const size_t smem = (size_t)2 * kRB * H * sizeof(WT) +
                      (size_t)kWarps * 6 * kRB * sizeof(float);
  return launch_cooperative(gru_train_fwd_kernel<WT>, a,
                            (H + kUnits - 1) / kUnits, smem, stream);
}

template <typename WT>
static int bwd_launch(const void* acts, const void* hs, const void* dh1s,
                      const void* dh2s, const void* whh1, const void* wih2x,
                      const void* whh2, void* dxp1, void* dxp2, void* dwhh1,
                      void* dwih2x, void* dwhh2, void* dbhh1, void* dbhh2,
                      void* dhp1, void* dhp2, void* dh1c, void* dh2c,
                      void* bar, int T, int B, int H, cudaStream_t stream) {
  GruBwdArgs<WT> a{static_cast<const WT*>(acts),
                   static_cast<const float*>(hs),
                   static_cast<const float*>(dh1s),
                   static_cast<const float*>(dh2s),
                   static_cast<const WT*>(whh1), static_cast<const WT*>(wih2x),
                   static_cast<const WT*>(whh2), static_cast<float*>(dxp1),
                   static_cast<float*>(dxp2), static_cast<float*>(dhp1),
                   static_cast<float*>(dhp2), static_cast<float*>(dh1c),
                   static_cast<float*>(dh2c),
                   static_cast<unsigned int*>(bar), T, B, H};
  const size_t smem = (size_t)2 * kRB * 3 * H * sizeof(WT) +
                      (size_t)kWarps * 2 * kRB * sizeof(float);
  const int e = launch_cooperative(gru_train_bwd_kernel<WT>, a,
                                   (H + kUnits - 1) / kUnits, smem, stream);
  if (e != 0) return e;
  return launch_dw(
      gru_dw_problems(static_cast<const WT*>(acts),
                      static_cast<const float*>(hs),
                      static_cast<const float*>(dxp1),
                      static_cast<const float*>(dxp2),
                      static_cast<float*>(dwhh1), static_cast<float*>(dwih2x),
                      static_cast<float*>(dwhh2), static_cast<float*>(dbhh1),
                      static_cast<float*>(dbhh2), T, B, H),
      sizeof(WT) == 2, stream);
}

}  // namespace avc

// C interface (ctypes).  bf16 != 0 selects bf16 weights, operands and saved
// activations.  Returns a cudaError_t value (0 on success).
extern "C" int gru_train_fwd_launch(const void* xp1, const void* base2,
                                    const void* whh1, const void* wih2x,
                                    const void* whh2, const void* bhh1,
                                    const void* bhh2, void* hs, void* acts,
                                    void* hp2, void* bar, int T, int B, int H,
                                    int bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? avc::fwd_launch<__nv_bfloat16>(xp1, base2, whh1, wih2x, whh2,
                                               bhh1, bhh2, hs, acts, hp2, bar,
                                               T, B, H, st)
              : avc::fwd_launch<float>(xp1, base2, whh1, wih2x, whh2, bhh1,
                                       bhh2, hs, acts, hp2, bar, T, B, H, st);
}

extern "C" int gru_train_bwd_launch(const void* acts, const void* hs,
                                    const void* dh1s, const void* dh2s,
                                    const void* whh1, const void* wih2x,
                                    const void* whh2, void* dxp1, void* dxp2,
                                    void* dwhh1, void* dwih2x, void* dwhh2,
                                    void* dbhh1, void* dbhh2, void* dhp1,
                                    void* dhp2, void* dh1c, void* dh2c,
                                    void* bar, int T, int B, int H, int bf16,
                                    void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? avc::bwd_launch<__nv_bfloat16>(
                    acts, hs, dh1s, dh2s, whh1, wih2x, whh2, dxp1, dxp2,
                    dwhh1, dwih2x, dwhh2, dbhh1, dbhh2, dhp1, dhp2, dh1c,
                    dh2c, bar, T, B, H, st)
              : avc::bwd_launch<float>(acts, hs, dh1s, dh2s, whh1, wih2x,
                                       whh2, dxp1, dxp2, dwhh1, dwih2x, dwhh2,
                                       dbhh1, dbhh2, dhp1, dhp2, dh1c, dh2c,
                                       bar, T, B, H, st);
}
