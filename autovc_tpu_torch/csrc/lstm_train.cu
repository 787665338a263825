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
// rounds, each a product of B <= 64 rows with every layer's weights (8 MB
// per matrix in bf16 for the 2 x 1024 decoder stack), so a round is
// latency-bound, never compute-bound; the saved state (~210 MB per call at
// lstm2, B = 16, T = 400) must leave and come back through HBM.  The dW
// products are the only dense work (3 x 54 GFLOP at lstm2) and are
// compute-bound.  What the design does about it: the forward is the
// layer-skewed routine of lstm_fwd.cuh (T + L - 1 rounds, one grid barrier
// each; a block owns a fixed set of units; all rows in one tensor-core
// pass; weight rows resident in shared memory; h exchanged through a ring
// in L2), saving the state with streaming stores so it does not evict the
// ring.  The backward's recurrence costs ONE product, one epilogue and one
// grid barrier per (step, layer): a block owns a fixed set of units, all
// rows go through one tensor-core pass (bf16), the block's weight rows
// stay in shared memory for the whole call, the operand da is read from a
// bf16 ring in L2, and the epilogue's owner of (row, unit) keeps the
// carried dc / dh in registers and loads the next round's saved state
// before the barrier (details at kernel 7 (a) below).  The dW products run
// after the recurrence as one launch of independent tiles.
#include "dw_tiles.cuh"
#include "lstm_fwd.cuh"

namespace avc {

// ---------------------------------------------------------------------------
// kernel 7 (a): the reverse-time recurrence
// ---------------------------------------------------------------------------
//
// Round (t, l) forms dh_rec = da_{l,t} W_hh[l]^T (for step t-1) and, for
// l >= 1, dh_below = da_{l,t} W_ih[l]^T (for layer l-1 at step t); its
// epilogue turns them into the top layer's gate derivatives at t-1 and
// layer l-1's at t.  One product, one epilogue and one grid barrier a
// round:
//   * a block owns `units` consecutive hidden units (a multiple of 8, one
//     n8 tile each; 8 while H / 8 <= the SM count) for the whole call, and
//     all rows of a row group go through the product in one pass;
//   * bf16: mma.sync m16n8k16 over ceil(rows / 16) M-tiles (rows past the
//     group read as zero), the K = 4H contraction split over the 8 warps,
//     whose partial sums meet once in shared memory.  A comes straight
//     from a bf16 ring of da (two slots by t parity, written by the
//     epilogue with ordinary stores so it stays in L2; a warp reads only
//     its own K chunks), B from the param-layout weights (row j = unit j's
//     4H weights: the col-major B operand), resident in shared memory for
//     the whole call where they fit (route "mma_smem"), else read from L2
//     ("mma_l2").  The operand rounding is the old staging's and the JAX
//     kernel's `a.astype(cdt)`: da rounded to bf16, f32 accumulation;
//   * f32 ("fma"): the f32 ring staged 8 rows at a time, FMA dot products
//     by a warp pair per unit (kernel 3's product);
//   * the epilogue: thread i owns the (row, unit) pairs i, i + 256, ...,
//     units fastest, so a row's loads and stores coalesce over the block's
//     units; the carried dc of every layer, and the dh each layer hands
//     from step t+1 to step t, stay in the owner's registers; the next
//     round's epilogue inputs (saved acts, c_t, c_{t-1}, dys: nothing the
//     recurrence computes) are loaded before this round's barrier, so their
//     HBM latency hides behind it and behind the next product.
// The launch plan (units, rows per group, route, shared-memory bytes) is
// computed by ops/lstm_train_kernels.py (bwd_plan); a batch whose pairs
// exceed 4 a thread runs the recurrence once per group of rows (rows are
// independent sequences).

constexpr int kMaxLayers = 4;   // layers whose carried state a thread holds
constexpr int kChunk = 32;      // K values of one mma chunk (two k16 steps)
constexpr int kPitchPad = 32;   // resident weight row pitch 4H + 32 values:
                                // conflict-free 16-byte fragment loads

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
  WT* ring;             // (2, L, B, 4H) scratch: da in WT, slot t & 1
  unsigned int* bar;    // (2,): grid barrier, bar[0] == 0 at launch
  int T, B, H, L;
  int units;            // hidden units per block, a multiple of 8
  int rows;             // rows per group
  int mpad;             // rows padded to the row tile (16 mma, 8 fma)
  int resident;         // bf16: the weights live in shared memory
};

// Shared-memory layout in bytes: [resident weights (bf16) | f32 stage and
// warp sums (f32)], then the partial sums (parts, kWarps or kSplit of
// them, each (2, mpad, units) f32).  bwd_plan computes the same sizes.
__host__ __device__ inline size_t bwd_weights_bytes(int H, int L, int units) {
  return (size_t)(2 * L - 1) * units * (4 * H + kPitchPad) * 2;
}
__host__ __device__ inline size_t bwd_parts_offset(bool mma, int resident,
                                                   int H, int L, int units) {
  if (mma) return resident ? bwd_weights_bytes(H, L, units) : 0;
  return ((size_t)kRB * 4 * H + kWarps * 2 * kRB) * sizeof(float);
}
__host__ __device__ inline size_t bwd_smem_bytes(bool mma, int resident,
                                                 int H, int L, int units,
                                                 int mpad) {
  const int nparts = mma ? kWarps : kSplit;
  return bwd_parts_offset(mma, resident, H, L, units) +
         (size_t)nparts * 2 * mpad * units * sizeof(float);
}

// The saved forward state one gate-derivative update reads: unit j, row
// `row` of layer l at step t (dy: the cotangent of ys, top layer only).
struct GateIn {
  float i, f, g, o, c_t, c_p, dy;
};

template <typename WT>
__device__ __forceinline__ GateIn load_gate_in(const TrainBwdArgs<WT>& a,
                                               int l, int t, int row, int j) {
  const int H = a.H;
  const size_t BH = (size_t)a.B * H;
  const size_t at = ((size_t)l * a.T + t) * BH + (size_t)row * H;  // (l,t,row)
  const WT* ac = a.acts + at * 4 + j;
  GateIn in;
  in.i = ld_stream(ac);
  in.f = ld_stream(ac + H);
  in.g = ld_stream(ac + 2 * H);
  in.o = ld_stream(ac + 3 * H);
  in.c_t = __ldcs(a.cs + at + j);
  in.c_p = t > 0 ? __ldcs(a.cs + at - BH + j) : 0.0f;
  in.dy = l == a.L - 1
      ? __ldcs(a.dys + (size_t)t * BH + (size_t)row * H + j) : 0.0f;
  return in;
}

// Gate derivatives of one (row, unit) of a layer at a step, given its total
// dh; updates the carried dc.  Arithmetic and order of
// lstm_train_pallas._bwd_kernel (ops/rnn._lstm_core_bwd); both dtypes.
__device__ __forceinline__ void gate_grads(const GateIn& in, float dh,
                                           float& dc_carry, float (&d)[4]) {
  const float i_ = in.i, f_ = in.f, g_ = in.g, o_ = in.o;
  const float c_t = in.c_t, c_p = in.c_p;
  const float tc = tanhf(c_t);
  const float da_o = dh * tc * o_ * (1.0f - o_);
  const float dc = dc_carry + dh * o_ * (1.0f - tc * tc);
  const float da_i = dc * g_ * i_ * (1.0f - i_);
  const float da_g = dc * i_ * (1.0f - g_ * g_);
  const float da_f = dc * c_p * f_ * (1.0f - f_);
  d[0] = da_i;
  d[1] = da_f;
  d[2] = da_g;
  d[3] = da_o;
  dc_carry = dc * f_;
}

// da of (l, t, row), unit j: in f32 by streaming stores (read only by the
// dW products, and returned as dxp0) and in WT into ring slot t & 1 (the
// operand of the next rounds' products, read from L2).
template <typename WT>
__device__ __forceinline__ void store_da(const TrainBwdArgs<WT>& a, int l,
                                         int t, int row, int j,
                                         const float (&d)[4]) {
  const int H = a.H;
  const size_t K = 4 * (size_t)H;
  float* o = a.da + (((size_t)l * a.T + t) * a.B + row) * K + j;
  WT* r = a.ring + (((size_t)(t & 1) * a.L + l) * a.B + row) * K + j;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    __stcs(o + g * H, d[g]);
    r[g * H] = from_float<WT>(d[g]);
  }
}

// Round (t, l)'s operand da_{l,t} in the ring, from row g0 of the batch.
template <typename WT>
__device__ __forceinline__ const WT* ring_rows(const TrainBwdArgs<WT>& a,
                                               int l, int t, int g0) {
  const int slot = t & 1;  // the slot store_da wrote da_{l,t} to
  return a.ring + ((size_t)(slot * a.L + l) * a.B + g0) * 4 * a.H;
}

// bf16 product of round (t, l): each warp's partial sums of dh_rec (m = 0)
// and dh_below (m = 1) over its K chunks c = warp, warp + 8, ..., for every
// M-tile and n8 tile of the block, to parts[((warp * 2 + m) * mpad + row) *
// units + unit].  k order: in a 32-value chunk lane (gid, tq) loads values
// 8 tq .. 8 tq + 7 of its two A rows and of its B unit (one 16-byte load
// each) and feeds values 4 s .. 4 s + 3 to k16 step s as the fragment's k =
// (2 tq, 2 tq + 1, 2 tq + 8, 2 tq + 9): A and B take the same permutation
// of k, so the sum is the same.  kBatch chunks' loads are issued together.
template <int kBatch>
__device__ __forceinline__ void bwd_product_mma(
    const TrainBwdArgs<__nv_bfloat16>& a, int l, int t, int g0, int rows_g,
    int j0, int nu, const __nv_bfloat16* wsm, float* parts) {
  using WT = __nv_bfloat16;
  const int H = a.H, K = 4 * H, U = a.units;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tq = lane & 3;
  const bool do_h = t > 0, do_b = l > 0;
  const WT* A = ring_rows(a, l, t, g0) + 8 * tq;
  // B rows: resident (pitch 4H + kPitchPad) or the weights in L2 (pitch 4H)
  const WT* wh;
  const WT* wb;
  size_t wp;
  if (a.resident) {
    wp = K + kPitchPad;
    wh = wsm + (size_t)l * U * wp;
    wb = l > 0 ? wsm + (size_t)(a.L + l - 1) * U * wp : wh;
  } else {
    wp = K;
    wh = a.whh + ((size_t)l * H + j0) * K;
    wb = l > 0 ? a.wih + ((size_t)(l - 1) * H + j0) * K : wh;
  }
  const int nch = K / kChunk, mtiles = a.mpad / 16, ntiles = nu / 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int mt = 0; mt < mtiles; ++mt) {
    const int rlo = mt * 16 + gid, rhi = rlo + 8;
    const bool lo_ok = rlo < rows_g, hi_ok = rhi < rows_g;
    const WT* alo = A + (size_t)rlo * K;
    const WT* ahi = A + (size_t)rhi * K;
    for (int nt = 0; nt < ntiles; ++nt) {
      const int u = nt * 8 + gid;
      const WT* bh = wh + (size_t)u * wp + 8 * tq;
      const WT* bb = wb + (size_t)u * wp + 8 * tq;
      float acc[2][4] = {};
      for (int c0 = warp; c0 < nch; c0 += kWarps * kBatch) {
        uint4 xlo[kBatch], xhi[kBatch], yh[kBatch], yb[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const bool in = c0 + q * kWarps < nch;
          const int k = (c0 + q * kWarps) * kChunk;
          xlo[q] = in && lo_ok ? __ldcg(reinterpret_cast<const uint4*>(alo + k))
                               : zero;
          xhi[q] = in && hi_ok ? __ldcg(reinterpret_cast<const uint4*>(ahi + k))
                               : zero;
          yh[q] = in && do_h ? ld_w16(bh + k, a.resident) : zero;
          yb[q] = in && do_b ? ld_w16(bb + k, a.resident) : zero;
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const uint32_t s0[4] = {xlo[q].x, xhi[q].x, xlo[q].y, xhi[q].y};
          const uint32_t s1[4] = {xlo[q].z, xhi[q].z, xlo[q].w, xhi[q].w};
          if (do_h) {
            mma_bf16(acc[0], s0, yh[q].x, yh[q].y);
            mma_bf16(acc[0], s1, yh[q].z, yh[q].w);
          }
          if (do_b) {
            mma_bf16(acc[1], s0, yb[q].x, yb[q].y);
            mma_bf16(acc[1], s1, yb[q].z, yb[q].w);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        float* p = parts + (size_t)(warp * 2 + m) * a.mpad * U + nt * 8 +
                   2 * tq;
        p[rlo * U] = acc[m][0];
        p[rlo * U + 1] = acc[m][1];
        p[rhi * U] = acc[m][2];
        p[rhi * U + 1] = acc[m][3];
      }
    }
  }
}

// f32 product of round (t, l): 8 rows of the ring at a time staged in
// shared memory, a warp pair (the two halves of K) per unit; the pair's two
// sums go to parts[(part * 2 + m) ...] as in bwd_product_mma.
__device__ __forceinline__ void bwd_product_fma(
    const TrainBwdArgs<float>& a, int l, int t, int g0, int rows_g, int j0,
    int nu, float* stage, float* red, float* parts) {
  const int H = a.H, K = 4 * H, U = a.units;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int V = 2 * kRB;
  const int slot = warp % kUnits, part = warp / kUnits;
  const int kpart = K / kSplit, k0 = part * kpart;
  const float* A = ring_rows(a, l, t, g0);
  const float* wh = a.whh + (size_t)l * H * K;
  const float* wb = l > 0 ? a.wih + (size_t)(l - 1) * H * K : wh;
  float* rw = red + warp * V;
  for (int r0 = 0; r0 < rows_g; r0 += kRB) {
    const int nr = min(kRB, rows_g - r0);
    stage_rows(stage, A, r0, nr, K);
    __syncthreads();
    for (int u = slot; u < nu; u += kUnits) {
      const int j = j0 + u;
      float acc_h[1][kRB] = {}, acc_b[1][kRB] = {};
      if (t > 0) {
        const float* const w[1] = {wh + (size_t)j * K};
        warp_dot(w, stage, K, k0, k0 + kpart, nr, acc_h);
      }
      if (l > 0) {
        const float* const w[1] = {wb + (size_t)j * K};
        warp_dot(w, stage, K, k0, k0 + kpart, nr, acc_b);
      }
      float v[V];
#pragma unroll
      for (int r = 0; r < kRB; ++r) {
        v[r] = acc_h[0][r];
        v[kRB + r] = acc_b[0][r];
      }
      warp_sum_to_smem(v, rw);
      if (lane < nr) {
        const size_t at = (size_t)(r0 + lane) * U + u;
        parts[(size_t)(part * 2) * a.mpad * U + at] = rw[lane];
        parts[(size_t)(part * 2 + 1) * a.mpad * U + at] = rw[kRB + lane];
      }
      __syncwarp();
    }
    __syncthreads();
  }
}

// The epilogue inputs of round (t, l), for this thread's pairs: the top
// layer's at t - 1 (t > 0) and layer l - 1's at t (l > 0).
template <typename WT, int P>
__device__ __forceinline__ void load_round_inputs(
    const TrainBwdArgs<WT>& a, int l, int t, int g0, int j0,
    const bool (&ok)[P], const int (&prow)[P], const int (&punit)[P],
    GateIn (&top)[P], GateIn (&low)[P]) {
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (!ok[k]) continue;
    const int row = g0 + prow[k], j = j0 + punit[k];
    if (t > 0 && l == a.L - 1) top[k] = load_gate_in(a, l, t - 1, row, j);
    if (l > 0) low[k] = load_gate_in(a, l - 1, t, row, j);
  }
}

// Round (t, l)'s epilogue, LI = L - 1 - l (compile-time, so the carried
// state's indices are too and it stays in registers): state index 0 is the
// top layer, LI + 1 the layer below l.
template <int LI, typename WT, int P>
__device__ __forceinline__ void bwd_epilogue(
    const TrainBwdArgs<WT>& a, int l, int t, int g0, int j0,
    const float* parts, int nparts, const bool (&ok)[P], const int (&prow)[P],
    const int (&punit)[P], const GateIn (&top)[P], const GateIn (&low)[P],
    float (&dc)[kMaxLayers][P], float (&dh)[kMaxLayers][P]) {
  const size_t MU = (size_t)a.mpad * a.units;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (!ok[k]) continue;
    const int row = g0 + prow[k], j = j0 + punit[k];
    const size_t at = (size_t)prow[k] * a.units + punit[k];
    float dh_rec = 0.0f, dh_below = 0.0f;
    for (int p = 0; p < nparts; ++p) {
      dh_rec += parts[2 * p * MU + at];
      dh_below += parts[(2 * p + 1) * MU + at];
    }
    float d[4];
    if (t > 0) {
      if constexpr (LI == 0) {   // the top layer at t - 1
        gate_grads(top[k], dh_rec + top[k].dy, dc[0][k], d);
        store_da(a, l, t - 1, row, j, d);
      } else {                   // layer l's dh for its step t - 1
        dh[LI][k] = dh_rec;
      }
    }
    if constexpr (LI + 1 < kMaxLayers) {
      if (l > 0) {               // layer l - 1 at t
        gate_grads(low[k], dh[LI + 1][k] + dh_below, dc[LI + 1][k], d);
        store_da(a, l - 1, t, row, j, d);
      }
    }
  }
}

template <typename WT, int P>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_train_bwd_kernel(TrainBwdArgs<WT> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool kMma = sizeof(WT) == 2;
  const int H = a.H, L = a.L, T = a.T, K = 4 * H, U = a.units;
  const int j0 = blockIdx.x * U, nu = min(U, H - j0);
  WT* wsm = reinterpret_cast<WT*>(smem_raw);
  float* stage = reinterpret_cast<float*>(smem_raw);
  float* red = stage + kRB * K;
  float* parts = reinterpret_cast<float*>(
      smem_raw + bwd_parts_offset(kMma, a.resident, H, L, U));
  const int nparts = kMma ? kWarps : kSplit;
  if constexpr (kMma) {
    if (a.resident) {   // this block's rows of W_hh (every layer), W_ih
      const int vec = K / 8, pitch = K + kPitchPad;
      for (int i = threadIdx.x; i < (2 * L - 1) * U * vec; i += kThreads) {
        const int v = i % vec, r = i / vec, u = r % U, m = r / U;
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (u < nu) {
          const WT* src = m < L ? a.whh + ((size_t)m * H + j0 + u) * K
                                : a.wih + ((size_t)(m - L) * H + j0 + u) * K;
          x = __ldg(reinterpret_cast<const uint4*>(src) + v);
        }
        *reinterpret_cast<uint4*>(wsm + (size_t)r * pitch + 8 * v) = x;
      }
      __syncthreads();
    }
  }
  int prow[P], punit[P];
  bool pin[P];   // the pair lies in the padded tile and in this block
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int p = threadIdx.x + k * kThreads;
    prow[k] = p / U;
    punit[k] = p % U;
    pin[k] = p < a.mpad * U && punit[k] < nu;
  }
  for (int g0 = 0; g0 < a.B; g0 += a.rows) {
    const int rows_g = min(a.rows, a.B - g0);
    bool ok[P];
#pragma unroll
    for (int k = 0; k < P; ++k) ok[k] = pin[k] && prow[k] < rows_g;
    float dc[kMaxLayers][P], dh[kMaxLayers][P];
    GateIn top[P], low[P];
#pragma unroll
    for (int s = 0; s < kMaxLayers; ++s) {
#pragma unroll
      for (int k = 0; k < P; ++k) dc[s][k] = dh[s][k] = 0.0f;
    }
    // the top layer at the last step: dh = dh_fin + dys[T-1], dc = dc_fin
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (!ok[k]) continue;
      const int row = g0 + prow[k], j = j0 + punit[k];
      const size_t idx = (size_t)row * H + j;
      const GateIn in = load_gate_in(a, L - 1, T - 1, row, j);
      float d[4];
      dc[0][k] = a.dc_fin[idx];
      gate_grads(in, a.dh_fin[idx] + in.dy, dc[0][k], d);
      store_da(a, L - 1, T - 1, row, j, d);
    }
    load_round_inputs(a, L - 1, T - 1, g0, j0, ok, prow, punit, top, low);
    grid_sync(a.bar);
    for (int t = T - 1; t >= 0; --t) {
      for (int l = L - 1; l >= 0 && (t > 0 || l > 0); --l) {
        if constexpr (kMma)
          bwd_product_mma<P == 1 ? 8 : 4>(a, l, t, g0, rows_g, j0, nu, wsm,
                                          parts);
        else
          bwd_product_fma(a, l, t, g0, rows_g, j0, nu, stage, red, parts);
        __syncthreads();
        switch (L - 1 - l) {
          case 0:
            bwd_epilogue<0>(a, l, t, g0, j0, parts, nparts, ok, prow, punit,
                            top, low, dc, dh);
            break;
          case 1:
            bwd_epilogue<1>(a, l, t, g0, j0, parts, nparts, ok, prow, punit,
                            top, low, dc, dh);
            break;
          case 2:
            bwd_epilogue<2>(a, l, t, g0, j0, parts, nparts, ok, prow, punit,
                            top, low, dc, dh);
            break;
          default:
            bwd_epilogue<3>(a, l, t, g0, j0, parts, nparts, ok, prow, punit,
                            top, low, dc, dh);
        }
        // the next round's inputs, in flight across the barrier
        const int nl = l > 0 ? l - 1 : L - 1, nt = l > 0 ? t : t - 1;
        load_round_inputs(a, nl, nt, g0, j0, ok, prow, punit, top, low);
        grid_sync(a.bar);
      }
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

// Kernel 7 (a) on the plan of bwd_plan (units per block, rows per group,
// resident weights, shared-memory bytes: checked against the kernel's own
// layout), then (b).
template <typename WT>
static int bwd_launch(const void* acts, const void* hs, const void* cs,
                      const void* dys, const void* dh_fin, const void* dc_fin,
                      const void* whh, const void* wih, void* da, void* ring,
                      void* dwhh, void* dwih, void* db, void* bar, int T,
                      int B, int H, int L, int units, int rows, int resident,
                      int smem_bytes, cudaStream_t stream) {
  constexpr bool mma = sizeof(WT) == 2;
  if (units < 8 || units % 8 || rows < 1 || L < 1 || L > kMaxLayers ||
      (resident && !mma))
    return cudaErrorInvalidValue;
  const int tile = mma ? 16 : kRB;
  const int mpad = (rows + tile - 1) / tile * tile;
  const int pairs = (mpad * units + kThreads - 1) / kThreads;
  const size_t smem = bwd_smem_bytes(mma, resident, H, L, units, mpad);
  if (smem != (size_t)smem_bytes) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int blocks = (H + units - 1) / units;
  if (blocks > sms) return cudaErrorInvalidValue;   // every unit needs a block
  TrainBwdArgs<WT> a{static_cast<const WT*>(acts),
                     static_cast<const float*>(cs),
                     static_cast<const float*>(dys),
                     static_cast<const float*>(dh_fin),
                     static_cast<const float*>(dc_fin),
                     static_cast<const WT*>(whh), static_cast<const WT*>(wih),
                     static_cast<float*>(da), static_cast<WT*>(ring),
                     static_cast<unsigned int*>(bar), T, B, H, L, units, rows,
                     mpad, resident};
  const int e =
      pairs <= 1   ? launch_cooperative(lstm_train_bwd_kernel<WT, 1>, a,
                                        blocks, smem, stream)
      : pairs <= 2 ? launch_cooperative(lstm_train_bwd_kernel<WT, 2>, a,
                                        blocks, smem, stream)
      : pairs <= 4 ? launch_cooperative(lstm_train_bwd_kernel<WT, 4>, a,
                                        blocks, smem, stream)
                   : cudaErrorInvalidValue;
  if (e != 0) return e;
  return launch_dw(
      lstm_dw_problems(static_cast<const float*>(hs),
                       static_cast<const float*>(da), static_cast<float*>(dwhh),
                       static_cast<float*>(dwih), static_cast<float*>(db), T, B,
                       H, L),
      mma, stream);
}

}  // namespace avc

// C interface (ctypes).  bf16 != 0 selects bf16 weights, operands and saved
// activations.  Returns a cudaError_t value (0 on success).
extern "C" int lstm_train_fwd_launch(const void* xp0, const void* whh,
                                     const void* wih, const void* bias,
                                     void* ys, void* hs, void* cs, void* acts,
                                     void* ring, void* bar, int T, int B,
                                     int H, int L, int units, int rows,
                                     int resident, int smem_bytes, int bf16,
                                     void* stream) {
  return avc::lstm_fwd_entry<true>(xp0, whh, wih, bias, ys, hs, cs, acts,
                                   ring, bar, T, B, H, L, units, rows,
                                   resident, smem_bytes, bf16, stream);
}

extern "C" int lstm_train_bwd_launch(const void* acts, const void* hs,
                                     const void* cs, const void* dys,
                                     const void* dh_fin, const void* dc_fin,
                                     const void* whh, const void* wih,
                                     void* da, void* ring, void* dwhh,
                                     void* dwih, void* db, void* bar, int T,
                                     int B, int H, int L, int units, int rows,
                                     int resident, int smem_bytes, int bf16,
                                     void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? avc::bwd_launch<__nv_bfloat16>(
                    acts, hs, cs, dys, dh_fin, dc_fin, whh, wih, da, ring,
                    dwhh, dwih, db, bar, T, B, H, L, units, rows, resident,
                    smem_bytes, st)
              : avc::bwd_launch<float>(acts, hs, cs, dys, dh_fin, dc_fin, whh,
                                       wih, da, ring, dwhh, dwih, db, bar, T,
                                       B, H, L, units, rows, resident,
                                       smem_bytes, st);
}
