// WaveRNN autoregressive sampling loop for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel autovc_tpu/ops/wavernn_pallas.py:
// generate_rows_pallas / _kernel.  B fold rows advance together through
// fpf * S sequential steps; each step, for every row:
//   pre_I = base[q] + sum_w mf[q + w] * ktab[w, p]   (banded upsample)
//   xI    = x * w_x + pre_I
//   h1    = GRU1(xI, h1);              x1 = xI + h1
//   h2    = GRU2(x1 @ W_ih2x + pre_r2[q], h2);   x2 = x1 + h2
//   x3    = relu(x2 @ W_fc1 + pre_f1[q]); x4 = relu(x3 @ W_fc2 + pre_f2[q])
//   logits = x4 @ W_fc3 + b_fc3
//   MOL: Gumbel-max mixture pick, logistic inverse CDF, clip to [-1, 1]
//   RAW: Gumbel-max class pick -> 2 pick / (n_classes - 1) - 1
// and the sample feeds back as x.  The frame-rate projections (mf, base,
// pre_r2, pre_f1, pre_f2) and the noise are computed by the caller.
//
// What bounds it on an H100: each step reads every recurrent weight once
// (about 7.3 MB in bf16 at rnn_dims = fc_dims = 512, 14.7 MB in f32) for
// only B <= 64 rows of work, through a chain of five dependent matvec
// stages, 12100 steps per 11000-sample fold: per-step latency, not FLOPs.
// What the design does about it: the weights fit the 50 MB L2 and stay
// there across steps; one persistent cooperative grid runs the whole loop,
// a stage costing one grid barrier instead of a kernel launch; in each
// stage a pair of warps owns an output unit (a GRU hidden unit with its
// r, z, n columns of both matrices, or one fc column), each warp over half
// of K, and their sums meet in shared memory, so the GRU cell and the ReLU
// are the block's epilogue; in bf16 the two GRU stages (most of a step)
// run on the tensor cores instead, a block per group of 8 hidden units;
// the fc3 + sampling stage runs one row per block and also computes the
// next step's xI, so a step is five barriers.
#include <type_traits>

#include "common.cuh"

namespace avc {

constexpr float kLogScaleMin = -32.23619130191664f;  // log(1e-14)

template <typename T>
struct WrArgs {
  const float* mf;      // (B, fpf + 2J, rd) projected mel frames
  const float* base;    // (B, fpf, rd)   I-layer aux projection + bias
  const float* pre_r2;  // (B, fpf, 3rd)  GRU2 aux projection + b_ih
  const float* pre_f1;  // (B, fpf, fc)
  const float* pre_f2;  // (B, fpf, fc)
  const float* ktab;    // (W, S) per-(tap, phase) upsample weights
  const float* w_x;     // (rd,) I-layer weight of the previous sample
  const T* w_ih1;       // (3rd, rd)  transposed
  const T* w_hh1;       // (3rd, rd)
  const T* w_ih2;       // (3rd, rd)  rows [0, rd) of GRU2's W_ih, transposed
  const T* w_hh2;       // (3rd, rd)
  const T* w_fc1;       // (fc, rd)
  const T* w_fc2;       // (fc, fc)
  const T* w_fc3;       // (n_classes, fc)
  const float* b_ih1;   // (3rd,)
  const float* b_hh1;   // (3rd,)
  const float* b_hh2;   // (3rd,)
  const float* b_fc3;   // (n_classes,)
  const float* gumbel;    // (steps, B, pick_dim)
  const float* logistic;  // (steps, B)
  float* out;             // (B, steps)
  float* state;           // scratch, see the offsets in wr_kernel
  unsigned int* bar;      // (2,): grid barrier, bar[0] == 0 at launch
  int B, fpf, S, W, rd, fc, n_classes, nr_mix, pick_dim, raw_mode;
};

// xI[b] = x * w_x + pre_I for step t (frame q = t / S, phase p = t % S).
// The tap loop is unrolled to kMaxTaps with a guard so that all of an
// element's loads are in flight together.
constexpr int kMaxTaps = 9;
template <typename T>
__device__ void compute_xI(const WrArgs<T>& a, int b, int t, float x,
                           float* xI) {
  const int q = t / a.S, p = t % a.S, rd = a.rd;
  const int Fq = a.fpf + a.W - 1;
  const float* base = a.base + ((size_t)b * a.fpf + q) * rd;
  const float* mf = a.mf + ((size_t)b * Fq + q) * rd;
  for (int k = threadIdx.x; k < rd; k += blockDim.x) {
    float pre = __ldg(base + k);
#pragma unroll
    for (int w = 0; w < kMaxTaps; ++w)
      if (w < a.W)
        pre = pre + __ldg(mf + (size_t)w * rd + k) * __ldg(a.ktab + w * a.S + p);
    xI[(size_t)b * rd + k] = x * __ldg(a.w_x + k) + pre;
  }
}

// GRU stage: h_out = GRU(x_in @ w_ih + xb, h_in @ w_hh + b_hh),
// res_out = x_in + h_out.  xb(row, col) = xb[row * xb_stride + col].
// A block takes kUnits hidden units a pass; kSplit warps share a unit,
// each over its part of K, and their sums meet in shared memory (red).
template <typename T>
__device__ void gru_stage(const WrArgs<T>& a, const T* w_ih, const T* w_hh,
                          const float* x_in, const float* h_in,
                          const float* xb, size_t xb_stride,
                          const float* b_hh, float* h_out, float* res_out,
                          T* smem, float* red) {
  constexpr int V = 6 * kRB;
  const int H = a.rd, B = a.B;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp % kUnits, part = warp / kUnits;
  const int kpart = H / kSplit, k0 = part * kpart;
  if (blockIdx.x * kUnits >= H) return;
  T* xs = smem;
  T* hs = smem + kRB * H;
  for (int r0 = 0; r0 < B; r0 += kRB) {
    const int nr = min(kRB, B - r0);
    stage_rows(xs, x_in, r0, nr, H);
    stage_rows(hs, h_in, r0, nr, H);
    __syncthreads();
    for (int j0 = blockIdx.x * kUnits; j0 < H; j0 += gridDim.x * kUnits) {
      const int j = j0 + slot;
      const bool epi = part == 0 && j < H && lane < nr;
      // the epilogue's operands, loaded before the dots
      float xbv[3], bhv[3], h_old = 0.0f, x_old = 0.0f;
      if (epi) {
        const float* xbr = xb + (size_t)(r0 + lane) * xb_stride;
        const size_t idx = (size_t)(r0 + lane) * H + j;
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          xbv[g] = __ldg(xbr + g * H + j);
          bhv[g] = __ldg(b_hh + g * H + j);
        }
        h_old = __ldcg(h_in + idx);
        x_old = __ldcg(x_in + idx);
      }
      if (j < H) {
        float ai[3][kRB] = {}, ah[3][kRB] = {};
        const T* const wi[3] = {w_ih + (size_t)j * H,
                                w_ih + (size_t)(H + j) * H,
                                w_ih + (size_t)(2 * H + j) * H};
        const T* const wh[3] = {w_hh + (size_t)j * H,
                                w_hh + (size_t)(H + j) * H,
                                w_hh + (size_t)(2 * H + j) * H};
        warp_dot(wi, xs, H, k0, k0 + kpart, nr, ai);
        warp_dot(wh, hs, H, k0, k0 + kpart, nr, ah);
        float v[V];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
#pragma unroll
          for (int r = 0; r < kRB; ++r) {
            v[g * kRB + r] = ai[g][r];
            v[(3 + g) * kRB + r] = ah[g][r];
          }
        }
        warp_sum_to_smem(v, red + warp * V);
      }
      __syncthreads();
      if (epi) {
        float sum[6];
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          sum[c] = 0.0f;
#pragma unroll
          for (int p = 0; p < kSplit; ++p)
            sum[c] += red[(p * kUnits + slot) * V + c * kRB + lane];
        }
        const float rg = sigmoidf_(sum[0] + xbv[0] + (sum[3] + bhv[0]));
        const float zg = sigmoidf_(sum[1] + xbv[1] + (sum[4] + bhv[1]));
        const float ng = tanhf(sum[2] + xbv[2] + rg * (sum[5] + bhv[2]));
        const size_t idx = (size_t)(r0 + lane) * H + j;
        const float h_new = (1.0f - zg) * ng + zg * h_old;
        h_out[idx] = h_new;
        res_out[idx] = x_old + h_new;
      }
      __syncthreads();
    }
  }
}

// bf16 GRU stage on the tensor cores (mma.sync m16n8k16, f32 accumulate):
// the same function as gru_stage.  A block takes a group of 8 hidden units
// a pass; its 8 warps split K, each running the group's 6 tiles of 8
// columns (r, z, n of W_ih and of W_hh) over its K slice for up to 16 rows,
// so one weight read serves 16 rows instead of 8 and no shuffles reduce.
// The warps' partial tiles meet in shared memory; 128 threads, one per
// (row, unit), run the GRU cell.
constexpr int kRowsMma = 16;
constexpr int kRedFloats = kWarps * 6 * 4 * 32;

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t ldg32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ void gru_stage_mma(const WrArgs<__nv_bfloat16>& a,
                              const __nv_bfloat16* w_ih,
                              const __nv_bfloat16* w_hh, const float* x_in,
                              const float* h_in, const float* xb,
                              size_t xb_stride, const float* b_hh,
                              float* h_out, float* res_out,
                              __nv_bfloat16* smem, float* red) {
  const int H = a.rd, B = a.B;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tq = lane & 3;
  const int kw = H / kWarps, k0 = warp * kw;   // this warp's K slice
  const int ngroups = H / 8;
  if (blockIdx.x >= ngroups) return;
  __nv_bfloat16* xs = smem;
  __nv_bfloat16* hs = smem + kRowsMma * H;
  // the epilogue thread's (row, unit) within a 16 x 8 tile
  const int rl = threadIdx.x >> 3, ul = threadIdx.x & 7;
  const int src = (rl & 7) * 4 + (ul >> 1), e = (rl >> 3) * 2 + (ul & 1);
  for (int r0 = 0; r0 < B; r0 += kRowsMma) {
    const int nr = min(kRowsMma, B - r0);
    stage_rows(xs, x_in, r0, nr, H);
    stage_rows(hs, h_in, r0, nr, H);
    __syncthreads();
    for (int grp = blockIdx.x; grp < ngroups; grp += gridDim.x) {
      const int j = grp * 8 + ul;
      const bool epi = threadIdx.x < 128 && rl < nr;
      float xbv[3], bhv[3], h_old = 0.0f, x_old = 0.0f;
      if (epi) {
        const float* xbr = xb + (size_t)(r0 + rl) * xb_stride;
        const size_t idx = (size_t)(r0 + rl) * H + j;
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          xbv[g] = __ldg(xbr + g * H + j);
          bhv[g] = __ldg(b_hh + g * H + j);
        }
        h_old = __ldcg(h_in + idx);
        x_old = __ldcg(x_in + idx);
      }
      float acc[6][4] = {};
      const size_t col = (size_t)grp * 8 + gid;    // this lane's B column
#pragma unroll 2
      for (int k = k0; k < k0 + kw; k += 16) {
        const int kk = k + tq * 2;
        uint32_t b[6][2];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          const __nv_bfloat16* wi = w_ih + (g * H + col) * H + kk;
          const __nv_bfloat16* wh = w_hh + (g * H + col) * H + kk;
          b[g][0] = ldg32(wi);
          b[g][1] = ldg32(wi + 8);
          b[3 + g][0] = ldg32(wh);
          b[3 + g][1] = ldg32(wh + 8);
        }
        const uint32_t ax[4] = {lds32(xs + gid * H + kk),
                                lds32(xs + (gid + 8) * H + kk),
                                lds32(xs + gid * H + kk + 8),
                                lds32(xs + (gid + 8) * H + kk + 8)};
        const uint32_t ah[4] = {lds32(hs + gid * H + kk),
                                lds32(hs + (gid + 8) * H + kk),
                                lds32(hs + gid * H + kk + 8),
                                lds32(hs + (gid + 8) * H + kk + 8)};
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          mma_bf16(acc[g], ax, b[g][0], b[g][1]);
          mma_bf16(acc[3 + g], ah, b[3 + g][0], b[3 + g][1]);
        }
      }
#pragma unroll
      for (int t = 0; t < 6; ++t) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          red[((warp * 6 + t) * 4 + c) * 32 + lane] = acc[t][c];
      }
      __syncthreads();
      if (epi) {
        float sum[6];
#pragma unroll
        for (int t = 0; t < 6; ++t) {
          sum[t] = 0.0f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w)
            sum[t] += red[((w * 6 + t) * 4 + e) * 32 + src];
        }
        const float rg = sigmoidf_(sum[0] + xbv[0] + (sum[3] + bhv[0]));
        const float zg = sigmoidf_(sum[1] + xbv[1] + (sum[4] + bhv[1]));
        const float ng = tanhf(sum[2] + xbv[2] + rg * (sum[5] + bhv[2]));
        const size_t idx = (size_t)(r0 + rl) * H + j;
        const float h_new = (1.0f - zg) * ng + zg * h_old;
        h_out[idx] = h_new;
        res_out[idx] = x_old + h_new;
      }
      __syncthreads();
    }
  }
}

// The GRU stage for the operand type: tensor cores for bf16, f32 FMA for
// exact f32.
template <typename T>
__device__ __forceinline__ void gru(const WrArgs<T>& a, const T* w_ih,
                                    const T* w_hh, const float* x_in,
                                    const float* h_in, const float* xb,
                                    size_t xb_stride, const float* b_hh,
                                    float* h_out, float* res_out, T* smem,
                                    float* red) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    gru_stage_mma(a, w_ih, w_hh, x_in, h_in, xb, xb_stride, b_hh, h_out,
                  res_out, smem, red);
  else
    gru_stage(a, w_ih, w_hh, x_in, h_in, xb, xb_stride, b_hh, h_out,
              res_out, smem, red);
}

// rows of the staging buffers for the operand type
template <typename T>
__host__ __device__ constexpr int staged_rows() {
  return std::is_same_v<T, __nv_bfloat16> ? kRowsMma : kRB;
}

// Dense ReLU stage: out = relu(in @ w + pre), pre(row, col) =
// pre[row * pre_stride + col]; units and K split as in gru_stage.
template <typename T>
__device__ void dense_relu_stage(const WrArgs<T>& a, const T* w,
                                 const float* in, int K, int N,
                                 const float* pre, size_t pre_stride,
                                 float* out, T* smem, float* red) {
  const int B = a.B;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp % kUnits, part = warp / kUnits;
  const int kpart = K / kSplit, k0 = part * kpart;
  if (blockIdx.x * kUnits >= N) return;
  for (int r0 = 0; r0 < B; r0 += kRB) {
    const int nr = min(kRB, B - r0);
    stage_rows(smem, in, r0, nr, K);
    __syncthreads();
    for (int j0 = blockIdx.x * kUnits; j0 < N; j0 += gridDim.x * kUnits) {
      const int j = j0 + slot;
      const bool epi = part == 0 && j < N && lane < nr;
      const float pv = epi ? __ldg(pre + (size_t)(r0 + lane) * pre_stride + j)
                           : 0.0f;
      if (j < N) {
        float acc[1][kRB] = {};
        const T* const wc[1] = {w + (size_t)j * K};
        warp_dot(wc, smem, K, k0, k0 + kpart, nr, acc);
        warp_sum_to_smem(acc[0], red + warp * kRB);
      }
      __syncthreads();
      if (epi) {
        float sum = 0.0f;
#pragma unroll
        for (int p = 0; p < kSplit; ++p)
          sum += red[(p * kUnits + slot) * kRB + lane];
        out[(size_t)(r0 + lane) * N + j] = fmaxf(sum + pv, 0.0f);
      }
      __syncthreads();
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) wr_kernel(WrArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int B = a.B, rd = a.rd, fc = a.fc, S = a.S;
  const int steps = a.fpf * S;
  const size_t BR = (size_t)B * rd, BF = (size_t)B * fc;
  float* xI = a.state;                // (B, rd)
  float* h1 = xI + BR;                // (2, B, rd)
  float* h2 = h1 + 2 * BR;            // (2, B, rd)
  float* x1 = h2 + 2 * BR;            // (B, rd)
  float* x2 = x1 + BR;                // (B, rd)
  float* x3 = x2 + BR;                // (B, fc)
  float* x4 = x3 + BF;                // (B, fc)
  const int maxd = rd > fc ? rd : fc;
  float* red = reinterpret_cast<float*>(
      smem_raw + (size_t)2 * staged_rows<T>() * maxd * sizeof(T));
  float* logits_s = red + kRedFloats;
  __shared__ float sample_s;

  // init: zero both GRU states; xI of step 0 (x starts at 0)
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < 4 * BR;
       i += (size_t)gridDim.x * blockDim.x)
    h1[i] = 0.0f;  // h1 and h2 are adjacent: 4 * B * rd floats
  for (int b = blockIdx.x; b < B; b += gridDim.x) compute_xI(a, b, 0, 0.0f, xI);
  grid_sync(a.bar);

  for (int t = 0; t < steps; ++t) {
    const int q = t / S;
    const size_t cur = (size_t)(t & 1) * BR, nxt = (size_t)((t + 1) & 1) * BR;
    // GRU1
    gru(a, a.w_ih1, a.w_hh1, xI, h1 + cur, a.b_ih1, 0, a.b_hh1, h1 + nxt, x1,
        smem, red);
    grid_sync(a.bar);
    // GRU2: input projection of x1 plus the hoisted pre_r2 (aux + b_ih)
    gru(a, a.w_ih2, a.w_hh2, x1, h2 + cur, a.pre_r2 + (size_t)q * 3 * rd,
        (size_t)a.fpf * 3 * rd, a.b_hh2, h2 + nxt, x2, smem, red);
    grid_sync(a.bar);
    dense_relu_stage(a, a.w_fc1, x2, rd, fc, a.pre_f1 + (size_t)q * fc,
                     (size_t)a.fpf * fc, x3, smem, red);
    grid_sync(a.bar);
    dense_relu_stage(a, a.w_fc2, x3, fc, fc, a.pre_f2 + (size_t)q * fc,
                     (size_t)a.fpf * fc, x4, smem, red);
    grid_sync(a.bar);
    // fc3 + sampling + the next step's xI: one row per block
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
      stage_rows(smem, x4, b, 1, fc);
      __syncthreads();
      // logits: each warp takes 4 classes (cidx, +8, +16, +24) at once
      for (int c0 = warp; c0 < a.n_classes; c0 += 4 * kWarps) {
        float acc[4][kRB] = {};
        const T* wc[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int cidx = c0 + u * kWarps;
          wc[u] = a.w_fc3 + (size_t)(cidx < a.n_classes ? cidx : c0) * fc;
        }
        warp_dot(wc, smem, fc, 0, fc, 1, acc);
        float v[4] = {acc[0][0], acc[1][0], acc[2][0], acc[3][0]};
        warp_sum_to_smem(v, red + warp * 4);
        if (lane < 4 && c0 + lane * kWarps < a.n_classes)
          logits_s[c0 + lane * kWarps] =
              red[warp * 4 + lane] + __ldg(a.b_fc3 + c0 + lane * kWarps);
        __syncwarp();
      }
      __syncthreads();
      if (warp == 0) {
        // Gumbel-max over the pick lanes, one lane per class; ties go to
        // the lowest index (as jnp.argmax)
        const float* gn = a.gumbel + ((size_t)t * B + b) * a.pick_dim;
        const float lg = lane == 0 ? __ldg(a.logistic + (size_t)t * B + b)
                                   : 0.0f;
        float best = __int_as_float(0xff800000);  // -inf
        int pick = 0x7fffffff;
        for (int c = lane; c < a.pick_dim; c += 32) {
          const float v = logits_s[c] + __ldg(gn + c);
          if (v > best) {
            best = v;
            pick = c;
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ob = __shfl_xor_sync(0xffffffffu, best, off);
          const int op = __shfl_xor_sync(0xffffffffu, pick, off);
          if (ob > best || (ob == best && op < pick)) {
            best = ob;
            pick = op;
          }
        }
        if (lane == 0) {
          float sample;
          if (a.raw_mode) {
            sample = 2.0f * (float)pick / ((float)a.n_classes - 1.0f) - 1.0f;
          } else {
            const float means = logits_s[a.nr_mix + pick];
            const float log_scales =
                fmaxf(logits_s[2 * a.nr_mix + pick], kLogScaleMin);
            sample = fminf(fmaxf(means + expf(log_scales) * lg, -1.0f), 1.0f);
          }
          a.out[(size_t)b * steps + t] = sample;
          sample_s = sample;
        }
      }
      __syncthreads();
      if (t + 1 < steps) compute_xI(a, b, t + 1, sample_s, xI);
      __syncthreads();
    }
    grid_sync(a.bar);
  }
}

template <typename T>
static int launch(const void* const* p, const int* n, cudaStream_t stream) {
  WrArgs<T> a{static_cast<const float*>(p[0]), static_cast<const float*>(p[1]),
              static_cast<const float*>(p[2]), static_cast<const float*>(p[3]),
              static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
              static_cast<const float*>(p[6]), static_cast<const T*>(p[7]),
              static_cast<const T*>(p[8]), static_cast<const T*>(p[9]),
              static_cast<const T*>(p[10]), static_cast<const T*>(p[11]),
              static_cast<const T*>(p[12]), static_cast<const T*>(p[13]),
              static_cast<const float*>(p[14]), static_cast<const float*>(p[15]),
              static_cast<const float*>(p[16]), static_cast<const float*>(p[17]),
              static_cast<const float*>(p[18]), static_cast<const float*>(p[19]),
              const_cast<float*>(static_cast<const float*>(p[20])),
              const_cast<float*>(static_cast<const float*>(p[21])),
              const_cast<unsigned int*>(static_cast<const unsigned int*>(p[22])),
              n[0], n[1], n[2], n[3], n[4], n[5], n[6], n[7], n[8], n[9]};
  const int maxd = a.rd > a.fc ? a.rd : a.fc;
  const size_t smem = (size_t)2 * staged_rows<T>() * maxd * sizeof(T) +
                      (size_t)(kRedFloats + a.n_classes) * sizeof(float);
  const int want = (maxd + kUnits - 1) / kUnits;
  return launch_cooperative(wr_kernel<T>, a, want, smem, stream);
}

}  // namespace avc

// C interface (ctypes).  ptrs: the 23 pointers of WrArgs in declaration
// order (mf .. bar); ints: B, fpf, S, W, rd, fc, n_classes, nr_mix,
// pick_dim, raw_mode.  bf16 != 0 selects bf16 weights and operands.
// Returns a cudaError_t value (0 on success).
extern "C" int wavernn_sample_launch(const void* const* ptrs, const int* ints,
                                     int bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? avc::launch<__nv_bfloat16>(ptrs, ints, st)
              : avc::launch<float>(ptrs, ints, st);
}
