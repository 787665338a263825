// Decoder LSTM-stack inference kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of autovc_tpu/ops/lstm_pallas.py:
//   * lstm_stack_skewed_launch  <- lstm_stack_pallas / _stack_core / _kernel
//     (<= 8 rows; round s advances layer l at timestep t = s - l, so the
//     L-layer stack runs in T + L - 1 rounds, ONE grid barrier a round);
//     the kernel below;
//   * lstm_stack_stream_launch  <- lstm_stack_stream / _stream_kernel
//     (> 8 rows): the layer-skewed tensor-core routine of lstm_fwd.cuh,
//     shared with kernel 6, saving nothing but the top layer's h.
// The layer-0 input projection over all T (plus both biases) is hoisted
// by the caller (one large matmul); the kernel's own work is h @ W_hh for
// every layer, y_{l-1} @ W_ih (+ b_ih + b_hh) for layers >= 1, and the
// cell update.
//
// Kernel 2.  What bounds it on an H100: every round re-reads the
// recurrent weights — 25 MB in bf16 for the 2 x 1024 decoder stack (two
// W_hh and one W_ih), 50 MB in f32 — against only B <= 64 rows of
// arithmetic, so a round is weight-streaming bound (about 7.5 us at the
// 3.35 TB/s HBM rate), and a dependent chain of T + L - 1 rounds has no
// parallelism across rounds.
// What the design does about it: the stack fits the 50 MB L2, so after
// the first round the weights stream from L2, not HBM; one persistent
// cooperative grid (one block per SM) keeps every round inside one
// launch, a round costing one grid barrier instead of a kernel launch;
// a pair of warps owns hidden unit j, each over half of K, and computes
// the four gate columns j, j+H, j+2H, j+3H for all rows; the two halves
// meet in shared memory and the cell update is the block's epilogue, c
// staying with the thread that owns (row, j).  h is double-buffered in
// global memory between rounds.
#include "lstm_fwd.cuh"

namespace avc {

template <typename WT>
struct LstmArgs {
  const float* xp0;   // (T, B, 4H) f32: layer-0 gate pre-activations
  const WT* whh;       // (L, 4H, H): W_hh transposed, per layer
  const WT* wih;       // (L-1, 4H, H): W_ih transposed, layers >= 1
  const float* bias;  // (L-1, 4H): b_ih + b_hh, layers >= 1
  float* out;         // (T, B, H): last layer's h
  float* h;           // scratch (2, L, B, H): ping-pong
  float* c;           // scratch (L, B, H)
  unsigned int* bar;  // (2,): grid barrier, bar[0] == 0 at launch
  int T, B, H, L;
};

template <typename WT>
__device__ void zero_state(const LstmArgs<WT>& a) {
  const size_t n_h = (size_t)2 * a.L * a.B * a.H;
  const size_t n_c = (size_t)a.L * a.B * a.H;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_h;
       i += (size_t)gridDim.x * blockDim.x) {
    a.h[i] = 0.0f;
    if (i < n_c) a.c[i] = 0.0f;
  }
}

// One layer at one timestep for all rows: h_out = cell(h_in, y_in).
// A non-live layer (outside its valid time range) carries its h over.
template <typename WT>
__device__ void layer_phase(const LstmArgs<WT>& a, int l, int t, bool live,
                            const float* h_in, const float* y_in,
                            float* h_out, WT* smem) {
  const int H = a.H, B = a.B;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = gridDim.x * kWarps;
  const int gw = blockIdx.x * kWarps + warp;
  if (!live) {
    for (int j = gw; j < H; j += nw)
      for (int r = lane; r < B; r += 32)
        h_out[(size_t)r * H + j] = __ldcg(h_in + (size_t)r * H + j);
    return;
  }
  if (blockIdx.x * kUnits >= H) return;  // no unit of this block here
  constexpr int V = 4 * kRB;
  const int slot = warp % kUnits, part = warp / kUnits;
  const int kpart = H / kSplit, k0 = part * kpart;
  WT* hs = smem;
  WT* ys = smem + kRB * H;
  float* red = reinterpret_cast<float*>(smem + 2 * kRB * H);  // (kWarps, V)
  float* c = a.c + (size_t)l * B * H;
  const WT* whh = a.whh + (size_t)l * 4 * H * H;
  const WT* wih = l > 0 ? a.wih + (size_t)(l - 1) * 4 * H * H : nullptr;
  for (int r0 = 0; r0 < B; r0 += kRB) {
    const int nr = min(kRB, B - r0);
    stage_rows(hs, h_in, r0, nr, H);
    if (l > 0) stage_rows(ys, y_in, r0, nr, H);
    __syncthreads();
    for (int j0 = blockIdx.x * kUnits; j0 < H; j0 += gridDim.x * kUnits) {
      const int j = j0 + slot;
      const bool epi = part == 0 && j < H && lane < nr;
      // the epilogue's operands, loaded before the dots
      float in[4], c_old = 0.0f;
      if (epi) {
        const int row = r0 + lane;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          in[g] = l == 0
              ? __ldg(a.xp0 + ((size_t)t * B + row) * 4 * H + g * H + j)
              : __ldg(a.bias + (size_t)(l - 1) * 4 * H + g * H + j);
        c_old = __ldcg(c + (size_t)row * H + j);
      }
      if (j < H) {
        float acc[4][kRB] = {};
        const WT* const wh[4] = {whh + (size_t)j * H,
                                 whh + (size_t)(H + j) * H,
                                 whh + (size_t)(2 * H + j) * H,
                                 whh + (size_t)(3 * H + j) * H};
        warp_dot(wh, hs, H, k0, k0 + kpart, nr, acc);
        if (l > 0) {
          const WT* const wi[4] = {wih + (size_t)j * H,
                                   wih + (size_t)(H + j) * H,
                                   wih + (size_t)(2 * H + j) * H,
                                   wih + (size_t)(3 * H + j) * H};
          warp_dot(wi, ys, H, k0, k0 + kpart, nr, acc);
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
        c[idx] = c_new;
        h_out[idx] = h_new;
        if (l == a.L - 1) a.out[((size_t)t * B + row) * H + j] = h_new;
      }
      __syncthreads();
    }
  }
}

template <typename WT>
__global__ void __launch_bounds__(kThreads) lstm_skewed_kernel(LstmArgs<WT> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WT* smem = reinterpret_cast<WT*>(smem_raw);
  zero_state(a);
  grid_sync(a.bar);
  const size_t BH = (size_t)a.B * a.H, LBH = (size_t)a.L * BH;
  for (int s = 0; s < a.T + a.L - 1; ++s) {
    const float* hc = a.h + (s & 1) * LBH;
    float* hn = a.h + ((s + 1) & 1) * LBH;
    for (int l = 0; l < a.L; ++l) {
      // layer l-1's h after round s-1 is its output at t = s - l
      const int t = s - l;
      layer_phase(a, l, t, t >= 0 && t < a.T, hc + l * BH,
                  l > 0 ? hc + (l - 1) * BH : nullptr, hn + l * BH, smem);
    }
    grid_sync(a.bar);
  }
}

template <typename WT>
static int launch_skewed(const void* xp0, const void* whh,
                  const void* wih, const void* bias, void* out, void* h,
                  void* c, void* bar, int T, int B, int H, int L,
                  cudaStream_t stream) {
  LstmArgs<WT> a{static_cast<const float*>(xp0), static_cast<const WT*>(whh),
                static_cast<const WT*>(wih), static_cast<const float*>(bias),
                static_cast<float*>(out), static_cast<float*>(h),
                static_cast<float*>(c), static_cast<unsigned int*>(bar),
                T, B, H, L};
  const size_t smem = (size_t)2 * kRB * H * sizeof(WT) +
                      (size_t)kWarps * 4 * kRB * sizeof(float);
  const int want = (H + kUnits - 1) / kUnits;
  return launch_cooperative(lstm_skewed_kernel<WT>, a, want, smem, stream);
}

}  // namespace avc

// C interface (ctypes).  bf16 != 0 selects bf16 weights and operands.
// Returns a cudaError_t value (0 on success).
extern "C" int lstm_stack_skewed_launch(const void* xp0, const void* whh,
                                        const void* wih, const void* bias,
                                        void* out, void* h, void* c, void* bar,
                                        int T, int B, int H, int L, int bf16,
                                        void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? avc::launch_skewed<__nv_bfloat16>(xp0, whh, wih, bias, out,
                                                   h, c, bar, T, B, H, L, st)
              : avc::launch_skewed<float>(xp0, whh, wih, bias, out, h, c, bar,
                                          T, B, H, L, st);
}

// Kernel 3: the layer-skewed routine of lstm_fwd.cuh with nothing saved
// but the top layer's h, on the plan of ops/lstm_kernels.py:fwd_plan.
extern "C" int lstm_stack_stream_launch(const void* xp0, const void* whh,
                                        const void* wih, const void* bias,
                                        void* out, void* ring, void* bar,
                                        int T, int B, int H, int L, int units,
                                        int rows, int resident, int smem_bytes,
                                        int bf16, void* stream) {
  return avc::lstm_fwd_entry<false>(xp0, whh, wih, bias, out, nullptr,
                                    nullptr, nullptr, ring, bar, T, B, H, L,
                                    units, rows, resident, smem_bytes, bf16,
                                    stream);
}
