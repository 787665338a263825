// The layer-skewed LSTM-stack forward for Hopper (sm_90a), shared by
// kernel 6 (the training forward, lstm_train.cu: saves h, c and the i, f,
// g, o activations) and kernel 3 (inference at more than 8 rows,
// lstm_stack.cu: the top layer's h only).
//
// Replaces autovc_tpu/ops/lstm_train_pallas.py:_fwd_call (kernel 6) and
// autovc_tpu/ops/lstm_pallas.py:lstm_stack_stream (kernel 3).
//
// What bounds it on an H100: a dependent chain of rounds, each a product
// of B <= 64 rows with the block's slice of every layer's weights (a few
// MFLOP a block) and a cell update: latency-bound (grid barrier, L2 round
// trips of the h operand), never compute- or HBM-bound.  What the design
// does about it:
//   * skewed schedule: round s advances layer l at step t = s - l, so the
//     stack runs in T + L - 1 rounds with ONE grid barrier each; layer l
//     at step t reads its own h at t - 1 and layer l - 1's h at t, both
//     written in round s - 1;
//   * fixed ownership: a block owns `units` hidden units (a multiple of 8)
//     of every layer for the whole call; its columns are the 4 gates x
//     units;
//   * bf16: one mma.sync m16n8k16 pass over all rows of a row group (MT
//     16-row M-tiles), the K-chunk loop outermost so each B fragment
//     feeds every M-tile.  A round's active layers go in waves of at most
//     8; in a wave each warp takes one contiguous range of 32-value K
//     chunks of ONE layer (W_hh chunks unless t = 0, then W_ih chunks;
//     warps shared out by chunk count), so the partial sums of a warp are
//     one (rows x 4 units) tile.  Per M-tile the warps write their tiles
//     to shared memory and the epilogue's owner of (layer, row, unit) sums
//     its layer's warps in a fixed order (deterministic, no atomics: f32
//     shared-memory atomics are compare-and-swap loops on this card);
//   * the block's weight rows of every layer stay resident in shared
//     memory where they fit (route "mma_smem", pitch H + 32 values:
//     conflict-free 16-byte fragment loads), else are read from L2
//     ("mma_l2"); f32 ("fma") reads them from L2 and runs kernel 3's old
//     FMA product, 8 staged rows at a time, a warp pair per unit;
//   * h is exchanged through a two-slot ring in L2 (slot s & 1 written in
//     round s, slot (s + 1) & 1 read), one entry per layer, in the compute
//     dtype, written with ordinary stores so it stays in L2; the saved
//     state and ys leave by streaming stores;
//   * the epilogue: c of every layer stays in shared memory for the whole
//     call (the block owns its units), and layer 0's pre-activations of
//     the next round are loaded before this round's barrier.
// The launch plan (route, units, rows per group, shared-memory bytes) is
// computed by ops/lstm_kernels.py:fwd_plan; the kernel recomputes its
// layout and refuses a plan that disagrees.  Rows past the batch are
// masked; batches above one group run the rounds once per row group
// (rows are independent sequences).
#pragma once

#include "common.cuh"

namespace avc {

constexpr int kFwdPitchPad = 32;  // resident weight row pitch H + 32 values
constexpr int kFwdMaxMTiles = 4;  // 16-row M-tiles of one row group
constexpr int kFwdSumsPad = 8;    // partial-sum row pitch 4 units + 8 f32:
                                  // conflict-free epilogue reads

template <typename WT>
struct FwdArgs {
  const float* xp0;   // (T, B, 4H) f32: layer-0 gate pre-activations
  const WT* whh;      // (L, 4H, H): W_hh transposed, per layer
  const WT* wih;      // (L-1, 4H, H): W_ih transposed, layers >= 1
  const float* bias;  // (L-1, 4H): b_ih + b_hh, layers >= 1
  float* ys;          // (T, B, H): the top layer's h
  float* hs;          // (L, T, B, H): saved h (training only)
  float* cs;          // (L, T, B, H): saved c (training only)
  WT* acts;           // (L, T, B, 4H): saved i, f, g, o (training only)
  WT* ring;           // (2, L, B, H) scratch: h in WT, slot = round & 1
  unsigned int* bar;  // (2,): grid barrier, bar[0] == 0 at launch
  int T, B, H, L;
  int units;          // hidden units per block, a multiple of 8
  int rows;           // rows per group
  int mpad;           // rows padded to the row tile (16 mma, 8 fma)
  int resident;       // bf16: the weights live in shared memory
};

// Shared-memory layout in bytes.  mma: [resident weights (bf16)] then the
// warps' partial tiles (8, 16, 4 units + 8) f32; fma: [f32 stage and warp
// sums] then the gate sums (L, mpad, 4 units) f32.  Both end with the
// carried c (L, mpad, units) f32.  fwd_plan computes the same sizes.
__host__ __device__ inline size_t fwd_sums_offset(bool mma, int resident,
                                                  int H, int L, int units) {
  if (mma)
    return resident ? (size_t)(2 * L - 1) * 4 * units * (H + kFwdPitchPad) * 2
                    : 0;
  return ((size_t)2 * kRB * H + kWarps * 4 * kRB) * sizeof(float);
}
__host__ __device__ inline size_t fwd_c_offset(bool mma, int resident, int H,
                                               int L, int units, int mpad) {
  const size_t sums = mma ? (size_t)kWarps * 16 * (4 * units + kFwdSumsPad)
                          : (size_t)L * mpad * 4 * units;
  return fwd_sums_offset(mma, resident, H, L, units) + sums * sizeof(float);
}
__host__ __device__ inline size_t fwd_smem_bytes(bool mma, int resident,
                                                 int H, int L, int units,
                                                 int mpad) {
  return fwd_c_offset(mma, resident, H, L, units, mpad) +
         (size_t)L * mpad * units * sizeof(float);
}

// The ring slot round s reads (written in round s - 1); it writes s & 1.
__device__ __forceinline__ int fwd_read_slot(int s) { return (s + 1) & 1; }
// The slot of the layer below's h at this layer's step (also written in
// round s - 1).
__device__ __forceinline__ int fwd_below_slot(int s) {
  return fwd_read_slot(s);
}
// Whether layer l at step t has a W_hh product (h_{t-1} = 0 at t = 0).
__device__ __forceinline__ bool fwd_has_hh(int t) { return t > 0; }

// Rows g0.. of layer `src`'s h in ring slot `slot`.
template <typename WT>
__device__ __forceinline__ const WT* ring_rows(const FwdArgs<WT>& a,
                                               int slot, int src, int g0) {
  return a.ring + ((size_t)(slot * a.L + src) * a.B + g0) * a.H;
}

// One wave of round s: layers lw .. lw + n - 1 (n <= kWarps, all active).
// ch[i]: layer lw + i's K chunks this round (W_hh unless t = 0, W_ih
// unless l = 0; 32 values each); nw[i]: the warps it gets, at least one
// where it has chunks, the rest one at a time to the layer with the most
// chunks a warp.  Every thread computes the same plan (registers only).
struct FwdWave {
  int ch[kWarps], nw[kWarps];
};

__device__ __forceinline__ FwdWave fwd_wave(int s, int lw, int n, int nch) {
  FwdWave w;
  int used = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const int l = lw + i;
    w.ch[i] = i < n ? nch * ((fwd_has_hh(s - l) ? 1 : 0) + (l > 0 ? 1 : 0))
                    : 0;
    w.nw[i] = w.ch[i] > 0 ? 1 : 0;
    used += w.nw[i];
  }
  for (; used > 0 && used < kWarps; ++used) {
    int best = 0, bc = w.ch[0], bn = max(w.nw[0], 1);
#pragma unroll
    for (int i = 1; i < kWarps; ++i) {
      if (w.nw[i] > 0 && w.ch[i] * bn > bc * w.nw[i]) {
        best = i;
        bc = w.ch[i];
        bn = w.nw[i];
      }
    }
#pragma unroll
    for (int i = 0; i < kWarps; ++i) w.nw[i] += i == best ? 1 : 0;
  }
  return w;
}

// Warp `warp`'s piece of a wave: wave entry `li` (-1: none) and its chunk
// range [c0, c1) in the layer's chunk list (W_hh chunks, then W_ih).
__device__ __forceinline__ void fwd_piece(const FwdWave& w, int warp,
                                          int& li, int& c0, int& c1) {
  li = -1;
  c0 = c1 = 0;
  int first = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    if (li < 0 && warp < first + w.nw[i]) {
      const int k = warp - first;
      li = i;
      c0 = k * w.ch[i] / w.nw[i];
      c1 = (k + 1) * w.ch[i] / w.nw[i];
    }
    first += w.nw[i];
  }
}

// The bf16 product of one warp's piece: layer l at step t, chunks [c0, c1)
// of its list, for every M-tile of the row group, into acc[mt][g] (the
// m16n8 tile of gate g of the column group cg).  In a chunk lane (gid, tq)
// loads values 8 tq .. 8 tq + 7 of its A rows and of its B column with
// one 16-byte load each and feeds them to two k16 steps as the fragment's
// k = (2 tq, 2 tq + 1, 2 tq + 8, 2 tq + 9): A and B take the same
// permutation of k, so the sum is the same.  K chunks past H (H % 32 ==
// 16) read as zero, as do rows past the group and units past the block.
template <int MT>
__device__ void fwd_piece_mma(const FwdArgs<__nv_bfloat16>& a, int s, int l,
                              int c0, int c1, int g0, int rows_g, int j0,
                              int nu, int cg, const __nv_bfloat16* wsm,
                              float (&acc)[MT][4][4]) {
  using WT = __nv_bfloat16;
  constexpr int KB = MT == 1 ? 8 : MT == 2 ? 4 : 2;  // chunks in flight
  const int H = a.H, L = a.L, U = a.units, t = s - l;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tq = lane & 3;
  const int nch = (H + 31) / 32;
  const size_t wp = a.resident ? (size_t)H + kFwdPitchPad : (size_t)H;
  const int u = cg * 8 + gid;      // this lane's B column (unit)
  const bool u_ok = u < nu;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][g][e] = 0.0f;
    }
  }
  int base = 0;
  for (int ih = 0; ih < 2; ++ih) {
    if (ih == 0 ? !fwd_has_hh(t) : l == 0) continue;
    const int lo = max(c0, base) - base, hi = min(c1, base + nch) - base;
    base += nch;
    if (lo >= hi) continue;
    const WT* A = ih ? ring_rows(a, fwd_below_slot(s), l - 1, g0)
                     : ring_rows(a, fwd_read_slot(s), l, g0);
    const WT* W;   // row of gate 0, unit u; gate g is g * rstride on
    size_t rstride;
    if (a.resident) {
      W = wsm + (size_t)(ih ? L + l - 1 : l) * 4 * U * wp + (size_t)u * wp;
      rstride = (size_t)U * wp;
    } else {
      W = (ih ? a.wih + (size_t)(l - 1) * 4 * H * H
              : a.whh + (size_t)l * 4 * H * H) + (size_t)(j0 + u) * H;
      rstride = (size_t)H * H;
    }
    for (int c = lo; c < hi; c += KB) {
      uint4 x[KB][MT][2];
#pragma unroll
      for (int q = 0; q < KB; ++q) {
        const int k = (c + q) * 32 + 8 * tq;
        const bool in = c + q < hi && k < H;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int rlo = mt * 16 + gid, rhi = rlo + 8;
          x[q][mt][0] = in && rlo < rows_g
              ? __ldcg(reinterpret_cast<const uint4*>(A + rlo * H + k))
              : zero;
          x[q][mt][1] = in && rhi < rows_g
              ? __ldcg(reinterpret_cast<const uint4*>(A + rhi * H + k))
              : zero;
        }
      }
#pragma unroll
      for (int q = 0; q < KB; ++q) {
        if (c + q >= hi) break;
        const int k = (c + q) * 32 + 8 * tq;
        const bool in = k < H && u_ok;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const uint4 b = in ? ld_w16(W + g * rstride + k, a.resident) : zero;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const uint4* xa = x[q][mt];
            const uint32_t s0[4] = {xa[0].x, xa[1].x, xa[0].y, xa[1].y};
            const uint32_t s1[4] = {xa[0].z, xa[1].z, xa[0].w, xa[1].w};
            mma_bf16(acc[mt][g], s0, b.x, b.y);
            mma_bf16(acc[mt][g], s1, b.z, b.w);
          }
        }
      }
    }
  }
}

// The cell update of layer l at step t for row gr, unit j, from its four
// gate pre-activations; c_{t-1} and c_t at *cp.  Writes h to ring slot
// `ws`, ys for the top layer, and (SAVE) h, c, i, f, g, o.
template <typename WT, bool SAVE>
__device__ __forceinline__ void fwd_cell(const FwdArgs<WT>& a, int l, int t,
                                         int gr, int j, const float (&pre)[4],
                                         float* cp, int ws) {
  const int H = a.H;
  const float ig = sigmoidf_(pre[0]);
  const float fg = sigmoidf_(pre[1]);
  const float gg = tanhf(pre[2]);
  const float og = sigmoidf_(pre[3]);
  const float c_old = t > 0 ? *cp : 0.0f;
  const float c = fg * c_old + ig * gg;
  const float h = og * tanhf(c);
  *cp = c;
  a.ring[((size_t)(ws * a.L + l) * a.B + gr) * H + j] = from_float<WT>(h);
  if constexpr (SAVE) {
    const size_t at = (((size_t)l * a.T + t) * a.B + gr) * H + j;
    store_cs(a.hs + at, h);
    store_cs(a.cs + at, c);
    WT* act = a.acts + (at - j) * 4 + j;   // row (l, t, gr), gate 0, unit j
    store_cs(act, ig);
    store_cs(act + H, fg);
    store_cs(act + 2 * H, gg);
    store_cs(act + 3 * H, og);
  }
  if (l == a.L - 1) store_cs(a.ys + ((size_t)t * a.B + gr) * H + j, h);
}

// The f32 products of round s: for each active layer, 8 rows at a time of
// its own h (t > 0) and the layer below's staged in shared memory, a warp
// pair (the two halves of K) per unit over the 4 gate columns (kernel 3's
// old product), the pair's sums written to the gate sums.
__device__ void fwd_product_fma(const FwdArgs<float>& a, int s, int g0,
                                int rows_g, int j0, int nu, float* stage,
                                float* red, float* gates) {
  const int H = a.H, L = a.L, U = a.units;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int V = 4 * kRB;
  const int slot = warp % kUnits, part = warp / kUnits;
  const int kpart = H / kSplit, k0 = part * kpart;
  float* hsm = stage;
  float* ysm = stage + kRB * H;
  for (int l = 0; l < L; ++l) {
    const int t = s - l;
    if (t < 0 || t >= a.T) continue;
    const bool hh = fwd_has_hh(t);
    const float* whh = a.whh + (size_t)l * 4 * H * H;
    const float* wih = l > 0 ? a.wih + (size_t)(l - 1) * 4 * H * H : nullptr;
    for (int r0 = 0; r0 < rows_g; r0 += kRB) {
      const int nr = min(kRB, rows_g - r0);
      if (hh) stage_rows(hsm, ring_rows(a, fwd_read_slot(s), l, g0), r0, nr, H);
      if (l > 0)
        stage_rows(ysm, ring_rows(a, fwd_below_slot(s), l - 1, g0), r0, nr, H);
      __syncthreads();
      for (int u0 = 0; u0 < nu; u0 += kUnits) {
        const int u = u0 + slot, j = j0 + u;
        if (u < nu) {
          float acc[4][kRB] = {};
          if (hh) {
            const float* const wh[4] = {
                whh + (size_t)j * H, whh + (size_t)(H + j) * H,
                whh + (size_t)(2 * H + j) * H, whh + (size_t)(3 * H + j) * H};
            warp_dot(wh, hsm, H, k0, k0 + kpart, nr, acc);
          }
          if (l > 0) {
            const float* const wi[4] = {
                wih + (size_t)j * H, wih + (size_t)(H + j) * H,
                wih + (size_t)(2 * H + j) * H, wih + (size_t)(3 * H + j) * H};
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
        if (part == 0 && u < nu && lane < nr) {
#pragma unroll
          for (int g = 0; g < 4; ++g)
            gates[((size_t)l * a.mpad + r0 + lane) * 4 * U + g * U + u] =
                red[slot * V + g * kRB + lane] +
                red[(kUnits + slot) * V + g * kRB + lane];
        }
        __syncthreads();
      }
    }
  }
}

// Layer 0's pre-activations at step t for the epilogue items its threads
// 0 .. 127 own at 8 units a block (item r * 8 + u of each M-tile), loaded
// ahead of the round that uses them.
template <int MT>
__device__ __forceinline__ void fwd_load_x0(const FwdArgs<__nv_bfloat16>& a,
                                            int t, int g0, int rows_g,
                                            int j0, int nu,
                                            float (&xin)[MT][4]) {
  const int r = threadIdx.x / 8, u = threadIdx.x % 8;
  const size_t G = 4 * (size_t)a.H;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int row = mt * 16 + r;
    const bool ok = a.units == 8 && threadIdx.x < 128 && row < rows_g &&
                    u < nu;
#pragma unroll
    for (int g = 0; g < 4; ++g)
      xin[mt][g] = ok ? __ldg(a.xp0 + ((size_t)t * a.B + g0 + row) * G +
                              g * a.H + j0 + u)
                      : 0.0f;
  }
}

// The forward over all rounds.  SAVE: kernel 6 (h, c, i/f/g/o saved),
// else kernel 3 (ys only).  MT: the M-tiles of a row group (bf16).
template <typename WT, int MT, bool SAVE>
__global__ void __launch_bounds__(kThreads, 1) lstm_fwd_kernel(FwdArgs<WT> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool kMma = sizeof(WT) == 2;
  const int H = a.H, L = a.L, T = a.T, B = a.B, U = a.units;
  const int j0 = blockIdx.x * U, nu = min(U, H - j0);
  const size_t G = 4 * (size_t)H;
  WT* wsm = reinterpret_cast<WT*>(smem_raw);
  float* sums = reinterpret_cast<float*>(
      smem_raw + fwd_sums_offset(kMma, a.resident, H, L, U));
  float* cst = reinterpret_cast<float*>(
      smem_raw + fwd_c_offset(kMma, a.resident, H, L, U, a.mpad));
  if constexpr (kMma) {
    if (a.resident) {   // this block's 4 x units rows of every matrix
      const int vec = H / 8, pitch = H + kFwdPitchPad;
      for (int i = threadIdx.x; i < (2 * L - 1) * 4 * U * vec; i += kThreads) {
        const int v = i % vec, r = i / vec, u = r % U, g = (r / U) % 4,
                  m = r / (4 * U);
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (u < nu) {
          const size_t row = (size_t)g * H + j0 + u;
          const WT* src = m < L ? a.whh + ((size_t)m * 4 * H + row) * H
                                : a.wih + ((size_t)(m - L) * 4 * H + row) * H;
          x = __ldg(reinterpret_cast<const uint4*>(src) + v);
        }
        *reinterpret_cast<uint4*>(wsm + (size_t)r * pitch + 8 * v) = x;
      }
      __syncthreads();
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nch = (H + 31) / 32;
  const int SP = 4 * U + kFwdSumsPad;   // partial-sum row pitch (mma)
  unsigned int nbar = 0;                // barriers passed
  for (int g0 = 0; g0 < B; g0 += a.rows) {
    const int rows_g = min(a.rows, B - g0);
    if constexpr (kMma) {
      // layer 0's pre-activations of the round ahead, loaded before the
      // barrier that precedes the round (at 8 units a block)
      float xin[MT][4];
      fwd_load_x0(a, 0, g0, rows_g, j0, nu, xin);
      for (int s = 0; s < T + L - 1; ++s) {
        const int ws = s & 1;   // the ring slot this round writes
        const int lmin = max(0, s - T + 1), lmax = min(L - 1, s);
        for (int lw = lmin; lw <= lmax; lw += kWarps) {
          const int n = min(kWarps, lmax - lw + 1);
          const FwdWave w = fwd_wave(s, lw, n, nch);
          int li, c0, c1;
          fwd_piece(w, warp, li, c0, c1);
          for (int cg = 0; cg < U / 8; ++cg) {
            float acc[MT][4][4];
            if (li >= 0)
              fwd_piece_mma<MT>(a, s, lw + li, c0, c1, g0, rows_g, j0, nu, cg,
                                wsm, acc);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              // this warp's m16 x (4 gates x 8 units) tile of M-tile mt
              if (li >= 0) {
                const int gid = lane >> 2, tq = lane & 3;
#pragma unroll
                for (int g = 0; g < 4; ++g) {
#pragma unroll
                  for (int e = 0; e < 4; ++e)
                    sums[((size_t)warp * 16 + gid + (e & 2) * 4) * SP +
                         g * U + cg * 8 + 2 * tq + (e & 1)] = acc[mt][g][e];
                }
              }
              __syncthreads();
              // the epilogue of M-tile mt: item q = (wave entry, row, unit
              // of the column group)
              for (int q = threadIdx.x; q < n * 16 * 8; q += kThreads) {
                const int i = q / 128, r = (q / 8) % 16;
                const int u = cg * 8 + q % 8, row = mt * 16 + r;
                if (row >= rows_g || u >= nu) continue;
                const int l = lw + i, t = s - l;
                int first = 0, cnt = 0;
#pragma unroll
                for (int e = 0; e < kWarps; ++e) {
                  first += e < i ? w.nw[e] : 0;
                  cnt = e == i ? w.nw[e] : cnt;
                }
                float pre[4];
#pragma unroll
                for (int g = 0; g < 4; ++g) {
                  float sum = 0.0f;
                  for (int p = first; p < first + cnt; ++p)
                    sum += sums[((size_t)p * 16 + r) * SP + g * U + u];
                  pre[g] = sum;
                }
                if (l == 0 && U == 8) {   // this thread's prefetched item
#pragma unroll
                  for (int g = 0; g < 4; ++g) pre[g] += xin[mt][g];
                } else if (l == 0) {
#pragma unroll
                  for (int g = 0; g < 4; ++g)
                    pre[g] += __ldg(a.xp0 + ((size_t)t * B + g0 + row) * G +
                                    g * H + j0 + u);
                } else {
#pragma unroll
                  for (int g = 0; g < 4; ++g)
                    pre[g] += __ldg(a.bias + (size_t)(l - 1) * G + g * H + j0 +
                                    u);
                }
                fwd_cell<WT, SAVE>(a, l, t, g0 + row, j0 + u, pre,
                                   cst + ((size_t)l * a.mpad + row) * U + u,
                                   ws);
              }
              __syncthreads();
            }
          }
        }
        if (s + 1 < T) fwd_load_x0(a, s + 1, g0, rows_g, j0, nu, xin);
        grid_sync_count(a.bar, nbar);
      }
    } else {
      for (int s = 0; s < T + L - 1; ++s) {
        float* stage = reinterpret_cast<float*>(smem_raw);
        fwd_product_fma(a, s, g0, rows_g, j0, nu, stage, stage + 2 * kRB * H,
                        sums);
        const int ws = s & 1;
        const int lmin = max(0, s - T + 1), lmax = min(L - 1, s);
        const int n = lmax - lmin + 1;
        for (int q = threadIdx.x; q < n * rows_g * U; q += kThreads) {
          const int l = lmin + q / (rows_g * U), row = (q / U) % rows_g,
                    u = q % U, t = s - l;
          if (u >= nu) continue;
          float pre[4];
          float* gs = sums + ((size_t)l * a.mpad + row) * 4 * U + u;
#pragma unroll
          for (int g = 0; g < 4; ++g)
            pre[g] = gs[g * U] +
                     (l == 0 ? __ldg(a.xp0 + ((size_t)t * B + g0 + row) * G +
                                     g * H + j0 + u)
                             : __ldg(a.bias + (size_t)(l - 1) * G + g * H +
                                     j0 + u));
          fwd_cell<WT, SAVE>(a, l, t, g0 + row, j0 + u, pre,
                             cst + ((size_t)l * a.mpad + row) * U + u, ws);
        }
        grid_sync_count(a.bar, nbar);
      }
    }
  }
}

// Launch on the plan of ops/lstm_kernels.py:fwd_plan (units per block,
// rows per group, resident weights, shared-memory bytes: checked against
// the kernel's own layout).  Returns a cudaError_t value.
template <typename WT, bool SAVE>
int lstm_fwd_launch(const FwdArgs<WT>& args, int smem_bytes,
                    cudaStream_t stream) {
  constexpr bool mma = sizeof(WT) == 2;
  FwdArgs<WT> a = args;
  if (a.units < 8 || a.units % 8 || a.rows < 1 || a.L < 1 || a.H % 16 ||
      (a.resident && !mma))
    return cudaErrorInvalidValue;
  const int tile = mma ? 16 : kRB;
  a.mpad = (a.rows + tile - 1) / tile * tile;
  if (a.mpad > 16 * kFwdMaxMTiles)
    return cudaErrorInvalidValue;
  const size_t smem = fwd_smem_bytes(mma, a.resident, a.H, a.L, a.units,
                                     a.mpad);
  if (smem != (size_t)smem_bytes) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int blocks = (a.H + a.units - 1) / a.units;
  if (blocks > sms) return cudaErrorInvalidValue;   // every unit needs a block
  if constexpr (!mma) {
    return launch_cooperative(lstm_fwd_kernel<WT, 1, SAVE>, a, blocks, smem,
                              stream);
  } else {
    switch (a.mpad / 16) {
      case 1:
        return launch_cooperative(lstm_fwd_kernel<WT, 1, SAVE>, a, blocks,
                                  smem, stream);
      case 2:
        return launch_cooperative(lstm_fwd_kernel<WT, 2, SAVE>, a, blocks,
                                  smem, stream);
      case 3:
        return launch_cooperative(lstm_fwd_kernel<WT, 3, SAVE>, a, blocks,
                                  smem, stream);
      default:
        return launch_cooperative(lstm_fwd_kernel<WT, 4, SAVE>, a, blocks,
                                  smem, stream);
    }
  }
}

// The C entry points' body: untyped pointers, bf16 != 0 selecting bf16
// weights, operands, ring and saved activations.
template <bool SAVE>
int lstm_fwd_entry(const void* xp0, const void* whh, const void* wih,
                   const void* bias, void* ys, void* hs, void* cs,
                   void* acts, void* ring, void* bar, int T, int B, int H,
                   int L, int units, int rows, int resident, int smem_bytes,
                   int bf16, void* stream) {
  auto run = [&](auto tag) {
    using WT = decltype(tag);
    FwdArgs<WT> a{static_cast<const float*>(xp0), static_cast<const WT*>(whh),
                  static_cast<const WT*>(wih), static_cast<const float*>(bias),
                  static_cast<float*>(ys), static_cast<float*>(hs),
                  static_cast<float*>(cs), static_cast<WT*>(acts),
                  static_cast<WT*>(ring), static_cast<unsigned int*>(bar),
                  T, B, H, L, units, rows, 0, resident};
    return lstm_fwd_launch<WT, SAVE>(a, smem_bytes,
                                     static_cast<cudaStream_t>(stream));
  };
  return bf16 ? run(__nv_bfloat16{}) : run(0.0f);
}

}  // namespace avc
