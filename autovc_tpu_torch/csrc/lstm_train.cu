// LSTM-stack TRAINING kernels for Hopper (sm_90a): kernel 6 (forward) and
// kernel 7 (backward) of the port.
//
// Replace the two Pallas TPU kernels of autovc_tpu/ops/lstm_train_pallas.py:
//   * lstm_train_fwd_launch <- _fwd_call / _fwd_kernel: the L-layer stack
//     over T steps from the hoisted layer-0 pre-activations, saving every
//     step's h and c (f32) and the i, f, g, o activations (compute dtype)
//     for the backward;
//   * lstm_train_bwd_launch <- _stack_train_bwd / _bwd_kernel: (a) the
//     reverse-time recurrence that turns the saved activations and the
//     cotangents into the gate derivatives da of every (layer, step), and
//     (b) the weight and bias gradients dW_hh, dW_ih, db as products over
//     K = T * B, written by hand in dw_tiles.cuh (shared-memory tiles;
//     mma.sync bf16 tensor-core tiles in bf16, FMA in f32), as the TPU
//     kernel forms them in its own body.
//
// What bounds them on an H100: the recurrences are a dependent chain of
// T * L rounds, each re-reading a layer's weights (8 MB per layer in bf16
// for the 2 x 1024 decoder stack) for B <= 64 rows of work, so a round is
// latency- and weight-streaming-bound, never compute-bound; the saved
// state (~210 MB per call at lstm2, B = 16, T = 400) must leave and come
// back through HBM.  The dW products are the only dense work (3 x 54
// GFLOP at lstm2) and are compute-bound.  What the design does about it:
// kernel 3's structure (one persistent cooperative grid, all layers at one
// timestep a round, a grid barrier after each layer, a warp pair per hidden
// unit, the cell update as the epilogue) keeps the weights in the 50 MB L2
// across rounds; the saved state is written with streaming stores so it
// does not evict them; the backward's owner of unit j computes the next
// layer's (or the next step's) gate derivatives for unit j in the epilogue
// of its own matvec, so each (step, layer) costs ONE grid barrier; the dW
// products run after the recurrence as one launch of independent tiles.
#include "dw_tiles.cuh"

namespace avc {

// ---------------------------------------------------------------------------
// kernel 6: forward
// ---------------------------------------------------------------------------

template <typename WT>
struct TrainFwdArgs {
  const float* xp0;   // (T, B, 4H) f32: layer-0 gate pre-activations
  const WT* whh;      // (L, 4H, H): W_hh transposed, per layer
  const WT* wih;      // (L-1, 4H, H): W_ih transposed, layers >= 1
  const float* bias;  // (L-1, 4H): b_ih + b_hh, layers >= 1
  float* ys;          // (T, B, H): last layer's h
  float* hs;          // (L, T, B, H): saved h
  float* cs;          // (L, T, B, H): saved c
  WT* acts;           // (L, T, B, 4H): saved i, f, g, o
  unsigned int* bar;  // (2,): grid barrier, bar[0] == 0 at launch
  int T, B, H, L;
};

// Layer l at step t for all rows: reads h_{l,t-1}, c_{l,t-1} (zero at
// t = 0) and y_{l-1,t}; writes h_{l,t}, c_{l,t}, the activations, and ys.
template <typename WT>
__device__ void fwd_phase(const TrainFwdArgs<WT>& a, int l, int t, WT* smem) {
  const int H = a.H, B = a.B;
  if (blockIdx.x * kUnits >= H) return;  // no unit of this block here
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int V = 4 * kRB;
  const int slot = warp % kUnits, part = warp / kUnits;
  const int kpart = H / kSplit, k0 = part * kpart;
  const size_t BH = (size_t)B * H, TBH = (size_t)a.T * BH;
  WT* hsm = smem;
  WT* ysm = smem + kRB * H;
  float* red = reinterpret_cast<float*>(smem + 2 * kRB * H);  // (kWarps, V)
  float* h_out = a.hs + l * TBH + (size_t)t * BH;
  float* c_out = a.cs + l * TBH + (size_t)t * BH;
  const float* h_in = t > 0 ? h_out - BH : nullptr;   // h_{l,t-1}
  const float* c_in = t > 0 ? c_out - BH : nullptr;   // c_{l,t-1}
  const float* y_in = l > 0 ? h_out - TBH : nullptr;  // h_{l-1,t}
  WT* act_out = a.acts + (l * TBH + (size_t)t * BH) * 4;
  const WT* whh = a.whh + (size_t)l * 4 * H * H;
  const WT* wih = l > 0 ? a.wih + (size_t)(l - 1) * 4 * H * H : nullptr;
  for (int r0 = 0; r0 < B; r0 += kRB) {
    const int nr = min(kRB, B - r0);
    if (t > 0) stage_rows(hsm, h_in, r0, nr, H);
    if (l > 0) stage_rows(ysm, y_in, r0, nr, H);
    __syncthreads();
    for (int j0 = blockIdx.x * kUnits; j0 < H; j0 += gridDim.x * kUnits) {
      const int j = j0 + slot;
      const bool epi = part == 0 && j < H && lane < nr;
      float in[4], c_old = 0.0f;
      if (epi) {
        const int row = r0 + lane;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          in[g] = l == 0
              ? __ldg(a.xp0 + ((size_t)t * B + row) * 4 * H + g * H + j)
              : __ldg(a.bias + (size_t)(l - 1) * 4 * H + g * H + j);
        if (t > 0) c_old = __ldcg(c_in + (size_t)row * H + j);
      }
      if (j < H) {
        float acc[4][kRB] = {};
        if (t > 0) {
          const WT* const wh[4] = {whh + (size_t)j * H,
                                   whh + (size_t)(H + j) * H,
                                   whh + (size_t)(2 * H + j) * H,
                                   whh + (size_t)(3 * H + j) * H};
          warp_dot(wh, hsm, H, k0, k0 + kpart, nr, acc);
        }
        if (l > 0) {
          const WT* const wi[4] = {wih + (size_t)j * H,
                                   wih + (size_t)(H + j) * H,
                                   wih + (size_t)(2 * H + j) * H,
                                   wih + (size_t)(3 * H + j) * H};
          warp_dot(wi, ysm, H, k0, k0 + kpart, nr, acc);
        }
        float v[V];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
#pragma unroll
          for (int r = 0; r < kRB; ++r) v[g * kRB + r] = acc[g][r];
        }
        warp_sum_to_smem(v, red + warp * V);
      }
      __syncthreads();
      if (epi) {
        float pre[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float sum = 0.0f;
#pragma unroll
          for (int p = 0; p < kSplit; ++p)
            sum += red[(p * kUnits + slot) * V + g * kRB + lane];
          pre[g] = in[g] + sum;
        }
        const float ig = sigmoidf_(pre[0]);
        const float fg = sigmoidf_(pre[1]);
        const float gg = tanhf(pre[2]);
        const float og = sigmoidf_(pre[3]);
        const int row = r0 + lane;
        const size_t idx = (size_t)row * H + j;
        const float c_new = fg * c_old + ig * gg;
        const float h_new = og * tanhf(c_new);
        store_cs(c_out + idx, c_new);
        store_cs(h_out + idx, h_new);
        WT* act = act_out + (size_t)row * 4 * H + j;
        store_cs(act, ig);
        store_cs(act + H, fg);
        store_cs(act + 2 * H, gg);
        store_cs(act + 3 * H, og);
        if (l == a.L - 1) store_cs(a.ys + (size_t)t * BH + idx, h_new);
      }
      __syncthreads();
    }
  }
}

template <typename WT>
__global__ void __launch_bounds__(kThreads)
    lstm_train_fwd_kernel(TrainFwdArgs<WT> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WT* smem = reinterpret_cast<WT*>(smem_raw);
  for (int t = 0; t < a.T; ++t) {
    for (int l = 0; l < a.L; ++l) {
      fwd_phase(a, l, t, smem);
      grid_sync(a.bar);
    }
  }
}

// ---------------------------------------------------------------------------
// kernel 7 (a): the reverse-time recurrence
// ---------------------------------------------------------------------------

template <typename WT>
struct TrainBwdArgs {
  const WT* acts;       // (L, T, B, 4H): saved i, f, g, o
  const float* cs;      // (L, T, B, H): saved c
  const float* dys;     // (T, B, H): cotangent of ys
  const float* dh_fin;  // (B, H): cotangent of the last layer's final h
  const float* dc_fin;  // (B, H): ... and of its final c
  const WT* whh;        // (L, H, 4H): W_hh in the param layout (row j =
                        //   unit j's 4H weights, contiguous)
  const WT* wih;        // (L-1, H, 4H): W_ih of layers >= 1, same layout
  float* da;            // (L, T, B, 4H) out: gate derivatives
  float* dhr;           // scratch (L, B, H): dh from the step above, per layer
  float* dcs;           // scratch (L, B, H): the carried dc, per layer
  unsigned int* bar;    // (2,): grid barrier, bar[0] == 0 at launch
  int T, B, H, L;
};

// Gate derivatives of unit j, row `row` of layer l at step t, given its
// total dh; updates the carried dc.  Arithmetic and order of
// lstm_train_pallas._bwd_kernel (ops/rnn._lstm_core_bwd).
template <typename WT>
__device__ __forceinline__ void gate_grads(const TrainBwdArgs<WT>& a, int l,
                                           int t, int row, int j, float dh) {
  const int H = a.H;
  const size_t BH = (size_t)a.B * H, TBH = (size_t)a.T * BH;
  const size_t at = l * TBH + (size_t)t * BH + (size_t)row * H;  // (l,t,row)
  const WT* ac = a.acts + at * 4;
  const float i_ = to_float(ac[j]), f_ = to_float(ac[H + j]);
  const float g_ = to_float(ac[2 * H + j]), o_ = to_float(ac[3 * H + j]);
  const float c_t = __ldg(a.cs + at + j);
  const float c_p = t > 0 ? __ldg(a.cs + at - BH + j) : 0.0f;
  float* dcp = a.dcs + ((size_t)l * a.B + row) * H + j;
  const float tc = tanhf(c_t);
  const float da_o = dh * tc * o_ * (1.0f - o_);
  const float dc = __ldcg(dcp) + dh * o_ * (1.0f - tc * tc);
  const float da_i = dc * g_ * i_ * (1.0f - i_);
  const float da_g = dc * i_ * (1.0f - g_ * g_);
  const float da_f = dc * c_p * f_ * (1.0f - f_);
  float* d = a.da + at * 4 + j;
  d[0] = da_i;
  d[H] = da_f;
  d[2 * H] = da_g;
  d[3 * H] = da_o;
  *dcp = dc * f_;
}

// Round (t, l): dh_rec = da_{l,t} W_hh[l]^T (for step t-1) and, for l >= 1,
// dh_below = da_{l,t} W_ih[l]^T (for layer l-1 at step t).  Epilogue, by
// the owner of (row, j): the top layer's gate derivatives at t-1, and layer
// l-1's at t.  The owner of (row, j) is the same thread in every round, so
// dhr and dcs need no barrier between writer and reader.
template <typename WT>
__device__ void bwd_phase(const TrainBwdArgs<WT>& a, int l, int t, WT* smem) {
  const int H = a.H, B = a.B, K = 4 * H;
  if (blockIdx.x * kUnits >= H) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int V = 2 * kRB;
  const int slot = warp % kUnits, part = warp / kUnits;
  const int kpart = K / kSplit, k0 = part * kpart;
  const size_t BH = (size_t)B * H;
  WT* dsm = smem;
  float* red = reinterpret_cast<float*>(smem + kRB * K);      // (kWarps, V)
  const float* da_in = a.da + ((size_t)l * a.T + t) * BH * 4;
  const WT* whh = a.whh + (size_t)l * H * K;
  const WT* wih = l > 0 ? a.wih + (size_t)(l - 1) * H * K : nullptr;
  const bool top = l == a.L - 1;
  for (int r0 = 0; r0 < B; r0 += kRB) {
    const int nr = min(kRB, B - r0);
    stage_rows(dsm, da_in, r0, nr, K);
    __syncthreads();
    for (int j0 = blockIdx.x * kUnits; j0 < H; j0 += gridDim.x * kUnits) {
      const int j = j0 + slot;
      const bool epi = part == 0 && j < H && lane < nr;
      if (j < H) {
        float acc_h[1][kRB] = {}, acc_b[1][kRB] = {};
        if (t > 0) {
          const WT* const wh[1] = {whh + (size_t)j * K};
          warp_dot(wh, dsm, K, k0, k0 + kpart, nr, acc_h);
        }
        if (l > 0) {
          const WT* const wi[1] = {wih + (size_t)j * K};
          warp_dot(wi, dsm, K, k0, k0 + kpart, nr, acc_b);
        }
        float v[V];
#pragma unroll
        for (int r = 0; r < kRB; ++r) {
          v[r] = acc_h[0][r];
          v[kRB + r] = acc_b[0][r];
        }
        warp_sum_to_smem(v, red + warp * V);
      }
      __syncthreads();
      if (epi) {
        const int row = r0 + lane;
        float dh_rec = 0.0f, dh_below = 0.0f;
#pragma unroll
        for (int p = 0; p < kSplit; ++p) {
          dh_rec += red[(p * kUnits + slot) * V + lane];
          dh_below += red[(p * kUnits + slot) * V + kRB + lane];
        }
        const size_t idx = (size_t)row * H + j;
        if (t > 0) {
          if (top)
            gate_grads(a, l, t - 1, row, j,
                       dh_rec + __ldg(a.dys + (size_t)(t - 1) * BH + idx));
          else
            a.dhr[(size_t)l * BH + idx] = dh_rec;
        }
        if (l > 0)
          gate_grads(a, l - 1, t, row, j,
                     __ldcg(a.dhr + (size_t)(l - 1) * BH + idx) + dh_below);
      }
      __syncthreads();
    }
  }
}

template <typename WT>
__global__ void __launch_bounds__(kThreads)
    lstm_train_bwd_kernel(TrainBwdArgs<WT> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WT* smem = reinterpret_cast<WT*>(smem_raw);
  const size_t BH = (size_t)a.B * a.H;
  const size_t top = (size_t)(a.L - 1) * BH;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t nthreads = (size_t)gridDim.x * blockDim.x;
  // carried state: dh from above is zero at the last step except the top
  // layer's, which enters with dys below; dc starts at dc_fin on top
  for (size_t i = tid; i < (size_t)a.L * BH; i += nthreads) {
    a.dhr[i] = 0.0f;
    a.dcs[i] = i >= top ? a.dc_fin[i - top] : 0.0f;
  }
  grid_sync(a.bar);
  // the top layer at the last step: dh = dh_fin + dys[T-1]
  for (size_t i = tid; i < BH; i += nthreads)
    gate_grads(a, a.L - 1, a.T - 1, (int)(i / a.H), (int)(i % a.H),
               a.dh_fin[i] + a.dys[(size_t)(a.T - 1) * BH + i]);
  grid_sync(a.bar);
  for (int t = a.T - 1; t >= 0; --t) {
    for (int l = a.L - 1; l >= 0; --l) {
      bwd_phase(a, l, t, smem);
      grid_sync(a.bar);
    }
  }
}

// ---------------------------------------------------------------------------
// kernel 7 (b): weight and bias gradients (dw_tiles.cuh)
// ---------------------------------------------------------------------------
//
// Problem z < L:     dW_hh[z] = sum_k h_z[k - B]^T da_z[k]  (h_{t-1}; zero
//                    for the rows of t = 0), db[z] = sum_k da_z[k];
// problem z >= L:    dW_ih[l-1] = sum_k h_{l-1}[k]^T da_l[k], l = z - L + 1.
// k runs over the T * B (step, row) pairs; M = H, N = 4H.

static std::vector<DwProblem> lstm_dw_problems(const float* hs, const float* da,
                                               float* dwhh, float* dwih,
                                               float* db, int T, int B, int H,
                                               int L) {
  const size_t TBH = (size_t)T * B * H, HN = (size_t)H * 4 * H;
  const int M = H, N = 4 * H, K = T * B;
  std::vector<DwProblem> probs;
  for (int z = 0; z < L; ++z)
    probs.push_back({hs + z * TBH, da + z * TBH * 4, dwhh + z * HN,
                     db + (size_t)z * N, nullptr, M, N, K, B, N, 0, 0});
  for (int l = 1; l < L; ++l)
    probs.push_back({hs + (l - 1) * TBH, da + l * TBH * 4, dwih + (l - 1) * HN,
                     nullptr, nullptr, M, N, K, 0, N, 0, 0});
  return probs;
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename WT>
static int fwd_launch(const void* xp0, const void* whh, const void* wih,
                      const void* bias, void* ys, void* hs, void* cs,
                      void* acts, void* bar, int T, int B, int H, int L,
                      cudaStream_t stream) {
  TrainFwdArgs<WT> a{static_cast<const float*>(xp0),
                     static_cast<const WT*>(whh), static_cast<const WT*>(wih),
                     static_cast<const float*>(bias), static_cast<float*>(ys),
                     static_cast<float*>(hs), static_cast<float*>(cs),
                     static_cast<WT*>(acts),
                     static_cast<unsigned int*>(bar), T, B, H, L};
  const size_t smem = (size_t)2 * kRB * H * sizeof(WT) +
                      (size_t)kWarps * 4 * kRB * sizeof(float);
  return launch_cooperative(lstm_train_fwd_kernel<WT>, a,
                            (H + kUnits - 1) / kUnits, smem, stream);
}

template <typename WT>
static int bwd_launch(const void* acts, const void* hs, const void* cs,
                      const void* dys, const void* dh_fin, const void* dc_fin,
                      const void* whh, const void* wih, void* da, void* dwhh,
                      void* dwih, void* db, void* dhr, void* dcs, void* bar,
                      int T, int B, int H, int L, cudaStream_t stream) {
  TrainBwdArgs<WT> a{static_cast<const WT*>(acts),
                     static_cast<const float*>(cs),
                     static_cast<const float*>(dys),
                     static_cast<const float*>(dh_fin),
                     static_cast<const float*>(dc_fin),
                     static_cast<const WT*>(whh), static_cast<const WT*>(wih),
                     static_cast<float*>(da), static_cast<float*>(dhr),
                     static_cast<float*>(dcs),
                     static_cast<unsigned int*>(bar), T, B, H, L};
  const size_t smem = (size_t)kRB * 4 * H * sizeof(WT) +
                      (size_t)kWarps * 2 * kRB * sizeof(float);
  const int e = launch_cooperative(lstm_train_bwd_kernel<WT>, a,
                                   (H + kUnits - 1) / kUnits, smem, stream);
  if (e != 0) return e;
  return launch_dw(
      lstm_dw_problems(static_cast<const float*>(hs),
                       static_cast<const float*>(da), static_cast<float*>(dwhh),
                       static_cast<float*>(dwih), static_cast<float*>(db), T, B,
                       H, L),
      sizeof(WT) == 2, stream);
}

}  // namespace avc

// C interface (ctypes).  bf16 != 0 selects bf16 weights, operands and saved
// activations.  Returns a cudaError_t value (0 on success).
extern "C" int lstm_train_fwd_launch(const void* xp0, const void* whh,
                                     const void* wih, const void* bias,
                                     void* ys, void* hs, void* cs, void* acts,
                                     void* bar, int T, int B, int H, int L,
                                     int bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? avc::fwd_launch<__nv_bfloat16>(xp0, whh, wih, bias, ys, hs,
                                               cs, acts, bar, T, B, H, L, st)
              : avc::fwd_launch<float>(xp0, whh, wih, bias, ys, hs, cs, acts,
                                       bar, T, B, H, L, st);
}

extern "C" int lstm_train_bwd_launch(const void* acts, const void* hs,
                                     const void* cs, const void* dys,
                                     const void* dh_fin, const void* dc_fin,
                                     const void* whh, const void* wih,
                                     void* da, void* dwhh, void* dwih,
                                     void* db, void* dhr, void* dcs,
                                     void* bar, int T, int B, int H, int L,
                                     int bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? avc::bwd_launch<__nv_bfloat16>(
                    acts, hs, cs, dys, dh_fin, dc_fin, whh, wih, da, dwhh,
                    dwih, db, dhr, dcs, bar, T, B, H, L, st)
              : avc::bwd_launch<float>(acts, hs, cs, dys, dh_fin, dc_fin, whh,
                                       wih, da, dwhh, dwih, db, dhr, dcs, bar,
                                       T, B, H, L, st);
}
