// WaveRNN autoregressive sampling loop for Hopper (sm_90a): kernel 1.
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
// (about 7.4 MB in bf16 at rnn_dims = fc_dims = 512) for only B <= 64
// rows of work, through a chain of dependent products, 12100 steps per
// 11000-sample fold: the latency of a step, not FLOPs or bytes.
//
// The design (the plan is ops/wavernn_kernels.py:wr_plan, checked here):
//   * one persistent cooperative grid for the whole loop, in two roles of
//     g blocks each: an R1 block owns `units` hidden units of GRU1 and
//     `fc_units` columns of fc1, an R2 block the same units of GRU2 (and
//     those columns of pre_I) and `fc_units` columns of fc2.  Each block's
//     weight rows (and, in R1 blocks, all of fc3) stay in shared memory
//     for the whole launch (pitch K + 32 against bank conflicts), unless
//     the plan routes them through L2.  So does each block's per-row
//     state (its h products, GRU state, frame slices, samples), unless
//     the rows are too many: then it lives in the block's part of an L2
//     scratch (state_smem = 0), and any row count fits;
//   * a step is four stages, each ending in one exchange through a ring
//     of two slots in L2 (slot t & 1 for step t) and one monotonic arrival
//     counter that only its producers bump (wr_arrives) and only its
//     consumers wait on:
//       A (R1): logits of every row from x4 of step t - 1 (fc3, each R1
//          block for itself, in one fixed order, so all of them pick the
//          same samples), the Gumbel-max pick, xI, then xI @ W_ih1 and
//          the GRU1 cell -> h1, x1                        -> counter c1
//          Where the pick is over fc3's classes themselves (RAW) and fc3
//          does not fit in shared memory, A's pick is split by class
//          (the SPLIT instantiation): R1 block b holds fc3 rows of its
//          slice_classes classes, takes every row's best of them and
//          publishes it as one epoch-tagged 64-bit key a row (atomicMax
//          into the two-slot key ring)                    -> counter cs
//          then every R1 block reads the keys: each row's sample.
//       B (R2): x1 @ W_ih2x and the GRU2 cell -> h2, x2    -> counter c2
//       C (R1): fc1 -> x3                                  -> counter c3
//       D (R2): fc2 -> x4                                  -> counter c4
//     Off the critical path: R1 blocks compute h1_t @ W_hh1 for step t + 1
//     while B runs, R2 blocks h2_t @ W_hh2 while C and D run and pre_I of
//     step t + 1 (their column slice) while A runs; the noise and pre_I
//     of the next step are prefetched into shared memory before the wait,
//     the frame-rate inputs and biases once a frame;
//   * every product runs on the tensor cores in bf16 (mma.sync m16n8k16,
//     f32 accumulation), each warp over one eighth of K for up to four
//     n-tiles, K chunks outermost so that one B fragment feeds every
//     16-row M-tile and one A fragment every n-tile.  The A fragments come
//     straight from the ring in L2 (16-byte loads, no staging pass and no
//     block barrier before the product; stage A forms bf16(x w_x + pre_I)
//     as it loads them).  A stage is short dependent phases on 8 warps,
//     so the design cuts phases: no separate logits pass (the pick sums
//     the K parts), index math in shifts (units a power of two).  The f32
//     (parity) route runs the same schedule with staged operands and FMA
//     products, its weights read from L2;
//   * the GRU state, the residuals x1 and x2, pre_I, mf and the sampling
//     math stay f32; operands are rounded to bf16 as the producer writes
//     them into the ring (the same rounding as at the consumer's matmul),
//     beside an f32 copy of x1 for the residual.
#include <type_traits>

#include "common.cuh"

namespace avc {

constexpr float kLogScaleMin = -32.23619130191664f;  // log(1e-14)
constexpr int kMaxTaps = 9;        // W = 2J + 1 upsample taps at most
constexpr int kWrPad = 32;         // bf16 pitch padding of resident rows
constexpr int kWrMaxMTiles = 4;    // rows per pass <= 64
constexpr int kWrItems = 4;        // epilogue items a thread, at most
// arrival counters: the four stages, the prologue's barrier, the split
// pick's class slices
constexpr int kC1 = 0, kC2 = 1, kC3 = 2, kC4 = 3, kCPro = 4, kCS = 5;
constexpr int kCounters = 6;

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
  float* state;           // f32 ring: pre_I, x1, each (2, B, rd)
  T* ring;                // operand ring: h1, x1, h2, x2 (2, B, rd);
                          // x3, x4 (2, B, fc)
  unsigned int* bar;      // (kCounters,) arrival counters, 0 at launch
  float* spill;           // per-row block state where it is not in shared
                          // memory: wr_spill_floats a block
  unsigned long long* keys;   // the split pick's candidates: (2, B)
  int B, fpf, S, W, rd, fc, n_classes, nr_mix, pick_dim, raw_mode;
  // the plan
  int units, fc_units, rows, passes, resident, fc3_resident, pre_smem,
      noise_smem, state_smem, slice_classes;
  unsigned int prod[kCounters];   // each counter's producers (arrivals an
                                  // epoch)
  int mpad, g, steps, ushift, fshift;   // log2 units, log2 fc_units
  int cbits;              // the split pick's class field: bits of n_classes - 1
};

// ---------------------------------------------------------------------------
// shared-memory layout (bytes), the same as wr_plan's
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t wr_up16(size_t n) { return (n + 15) / 16 * 16; }
__host__ __device__ inline int wr_ntiles_pad(int n) { return (n + 7) / 8 * 8; }
// A bf16 product's warps: each takes a group of up to kWrGroup n-tiles
// over one of kp K parts (kp = 8 for up to 4 n-tiles)
constexpr int kWrGroup = 4;
__host__ __device__ inline int wr_groups(int nt) {
  return (nt + kWrGroup - 1) / kWrGroup;
}
__host__ __device__ inline int wr_kparts(int nt) {
  return wr_groups(nt) >= kWarps ? 1 : kWarps / wr_groups(nt);
}

struct WrSmem {
  size_t wg, wf, w3, A, parts, hh, hown, pre, noise, xs, red, cst, frm,
      total;
};

// The per-row block state (the h product, the GRU state, the frame's
// slices, the samples) of B rows, in floats: in shared memory, or where
// it does not fit (state_smem = 0) in the block's part of `spill`.
__host__ __device__ inline size_t wr_spill_floats(int B, int u, int uf) {
  return (size_t)B * (7 * u + uf + 1);
}

// slice: the split pick's classes a block (0: each R1 block picks from
// all of fc3; its slice then holds those fc3 rows, and its logits stay in
// registers).
__host__ __device__ inline WrSmem wr_smem(int B, int rd, int fc, int ncls,
                                          int pick, int u, int uf, int mpad,
                                          int bf16, int resident,
                                          int fc3_res, int pre_smem,
                                          int noise_smem, int state_smem,
                                          int slice) {
  const int maxk = rd > fc ? rd : fc;
  const int n3 = wr_ntiles_pad(ncls);
  const int nps[3] = {3 * u, uf, slice ? uf : n3};
  size_t parts = 0;
  for (int i = 0; i < 3; ++i) {
    const int kp = bf16 ? wr_kparts(nps[i] / 8) : 1;
    const size_t s = (size_t)kp * mpad * nps[i] * 4;
    parts = s > parts ? s : parts;
  }
  WrSmem m;
  size_t o = 0;
  m.wg = o;
  o += resident ? wr_up16((size_t)2 * 3 * u * (rd + kWrPad) * 2) : 0;
  m.wf = o;
  o += resident ? wr_up16((size_t)uf * (maxk + kWrPad) * 2) : 0;
  m.w3 = o;
  o += slice ? wr_up16((size_t)slice * (fc + kWrPad) * 2)
       : fc3_res ? wr_up16((size_t)ncls * (fc + kWrPad) * 2) : 0;
  m.A = o;   // f32: the pass's staged operand rows
  o += bf16 ? 0 : wr_up16((size_t)mpad * maxk * 4);
  m.parts = o;
  o += wr_up16(parts);
  const int Bs = state_smem ? B : 0;   // rows of state held here
  m.hh = o;
  o += wr_up16((size_t)Bs * 3 * u * 4);
  m.hown = o;
  o += wr_up16((size_t)Bs * u * 4);
  m.pre = o;
  o += pre_smem ? wr_up16((size_t)B * rd * 4) : 0;
  m.noise = o;
  o += noise_smem ? wr_up16((size_t)B * (slice ? slice : pick + 1) * 4) : 0;
  m.xs = o;
  o += wr_up16((size_t)Bs * 4);
  m.red = o;
  o += kWarps * kRB * 4;
  m.cst = o;
  o += wr_up16((size_t)(6 * u + ncls) * 4);
  m.frm = o;
  o += wr_up16((size_t)Bs * (3 * u + uf) * 4);
  m.total = o;
  return m;
}

// ---------------------------------------------------------------------------
// the ring, the counters, the staging copies
// ---------------------------------------------------------------------------

// The ring slot step t writes; a consumer of step t's value reads the
// same slot, and the writer of step t + 2 reuses it.
__device__ __forceinline__ int wr_slot(int t) { return t & 1; }

enum WrOp { kOpH1 = 0, kOpX1 = 1, kOpH2 = 2, kOpX2 = 3, kOpX3 = 4, kOpX4 = 5 };

// Operand buffer `op` of slot `slot`: (B, rd) for h1, x1, h2, x2, (B, fc)
// for x3, x4.
template <typename T>
__device__ __forceinline__ T* wr_op(const WrArgs<T>& a, int op, int slot) {
  const size_t BR = (size_t)a.B * a.rd, BF = (size_t)a.B * a.fc;
  return op < kOpX3 ? a.ring + (size_t)(op * 2 + slot) * BR
                    : a.ring + 8 * BR + (size_t)((op - kOpX3) * 2 + slot) * BF;
}
template <typename T>
__device__ __forceinline__ float* wr_pre(const WrArgs<T>& a, int slot) {
  return a.state + (size_t)slot * a.B * a.rd;
}
template <typename T>
__device__ __forceinline__ float* wr_x1f(const WrArgs<T>& a, int slot) {
  return a.state + (size_t)(2 + slot) * a.B * a.rd;
}

// A producer's arrival: every thread's writes of the stage (ordered
// before thread 0's by the block barrier), then one release reduction on
// the stage's counter (cumulative: it publishes them all).
__device__ __forceinline__ void wr_arrive(unsigned int* c) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(c)
                 : "memory");
  }
}

// A consumer's wait until counter c reaches `target` arrivals (acquire);
// a wait that never ends aborts the launch after ~2^26 polls.
__device__ __forceinline__ void wr_wait(const unsigned int* c,
                                        unsigned int target) {
  if (threadIdx.x == 0) {
    unsigned int v, polls = 0;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(v)
                   : "l"(c)
                   : "memory");
      if (++polls == (1u << 26)) __trap();
    } while (v < target);
  }
  __syncthreads();
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Rows [0, nr) of a (rows, K) array in L2 -> shared memory of pitch K,
// 16-byte copies all in flight at once (cp.async, through L2 only: the
// ring is written by other SMs).  The caller waits (wr_staged).
template <typename T>
__device__ __forceinline__ void wr_stage(T* dst, const T* src, int K, int nr) {
  constexpr int V = 16 / sizeof(T);
  const int n = nr * K / V;
  for (int i = threadIdx.x; i < n; i += kThreads)
    cp_async16(dst + (size_t)i * V, src + (size_t)i * V);
}
__device__ __forceinline__ void wr_staged() {
  cp_async_wait_all();
  __syncthreads();
}

// ---------------------------------------------------------------------------
// products: parts[p][row][n] = sum over K part p of A[row] . W[n]
// ---------------------------------------------------------------------------

// Where the B rows of a product live: with gstride, row n of the product
// is row (n >> shift) * gstride + (n & (2^shift - 1)) of `base` (pitch
// ld) and is zero unless its low part is < nv (the GRU's r, z, n rows of
// the block's units); without, row n, zero unless n < nv.  Resident rows
// are in shared memory, others in L2.
template <typename T>
struct WrW {
  const T* base;
  int ld, shift, gstride, nv, resident;
  __device__ __forceinline__ bool ok(int n) const {
    return gstride ? (n & ((1 << shift) - 1)) < nv : n < nv;
  }
  __device__ __forceinline__ const T* row(int n) const {
    return base + (size_t)(gstride ? (n >> shift) * gstride +
                                         (n & ((1 << shift) - 1))
                                   : n) * ld;
  }
};

// A 16-byte fragment of shared memory through a generic pointer (the
// row maps point at shared memory or at L2, so the compiler cannot tell).
__device__ __forceinline__ uint4 lds16(const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a));
  return v;
}
__device__ __forceinline__ float4 lds16f(const float* p) {
  const uint4 v = lds16(p);
  return make_float4(__uint_as_float(v.x), __uint_as_float(v.y),
                     __uint_as_float(v.z), __uint_as_float(v.w));
}

// The A operand of a bf16 product: 8 bf16 values of row r (of the pass)
// at k, as one 16-byte fragment register set; rows past nr read zero.
struct WrARing {   // rows of a bf16 ring buffer in L2 (pitch K)
  const __nv_bfloat16* p;
  int K, nr;
  __device__ __forceinline__ uint4 load(int r, int k) const {
    return r < nr ? __ldcg(reinterpret_cast<const uint4*>(p + (size_t)r * K +
                                                           k))
                  : make_uint4(0u, 0u, 0u, 0u);
  }
};

__device__ __forceinline__ unsigned int wr_pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned int*>(&v);
}

// xI = x w_x + pre_I of stage A (rounded to bf16 here, as the plain loop
// rounds the matmul operand): pre_I from shared memory or from L2.
struct WrAXi {
  const float* pre;   // (rows, rd) of the pass
  const float* xs;    // the pass's samples
  const float* wx;
  int rd, nr, pre_smem;
  __device__ __forceinline__ uint4 load(int r, int k) const {
    if (r >= nr) return make_uint4(0u, 0u, 0u, 0u);
    const float4* pp = reinterpret_cast<const float4*>(pre + (size_t)r * rd + k);
    const float4 p0 = pre_smem ? lds16f(pre + (size_t)r * rd + k) : __ldcg(pp);
    const float4 p1 =
        pre_smem ? lds16f(pre + (size_t)r * rd + k + 4) : __ldcg(pp + 1);
    const float4 w0 = __ldg(reinterpret_cast<const float4*>(wx + k));
    const float4 w1 = __ldg(reinterpret_cast<const float4*>(wx + k) + 1);
    const float x = xs[r];
    return make_uint4(wr_pack2(fmaf(x, w0.x, p0.x), fmaf(x, w0.y, p0.y)),
                      wr_pack2(fmaf(x, w0.z, p0.z), fmaf(x, w0.w, p0.w)),
                      wr_pack2(fmaf(x, w1.x, p1.x), fmaf(x, w1.y, p1.y)),
                      wr_pack2(fmaf(x, w1.z, p1.z), fmaf(x, w1.w, p1.w)));
  }
};

// bf16: warp w takes n-tile group w / kp (up to kWrGroup n-tiles) over K
// part w % kp; lane (gid, tq) loads values 8 tq .. 8 tq + 7 of a 32-wide
// K chunk of its A rows and of its B rows (one 16-byte load each) and
// feeds them to two k16 steps as k = (2 tq, 2 tq + 1, 2 tq + 8, 2 tq + 9):
// A and B take the same permutation of k, so the sum is the same.  K
// chunks outermost, KB of them in flight: each A fragment feeds every
// n-tile of the group, each B fragment every M-tile.  Np (a multiple of
// 8) columns; parts (kp, mpad, Np).
template <int MT, typename AL>
__device__ void wr_product(const AL& A, int K, const WrW<__nv_bfloat16>& w,
                           int Np, int mpad, float* parts) {
  constexpr int KB = MT <= 2 ? 2 : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tq = lane & 3;
  const int nt = Np / 8, ng = wr_groups(nt), kp = wr_kparts(nt);
  const int nch = (K + 31) / 32;
  const int p = warp % kp, c0 = p * nch / kp, c1 = (p + 1) * nch / kp;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int grp = warp / kp; grp < ng; grp += kWarps / kp) {
    const __nv_bfloat16* wr[kWrGroup];
    bool nok[kWrGroup];
#pragma unroll
    for (int jj = 0; jj < kWrGroup; ++jj) {
      const int n = (grp * kWrGroup + jj) * 8 + gid;
      nok[jj] = n < Np && w.ok(n);
      wr[jj] = w.row(n);
    }
    float acc[kWrGroup][MT][4];
#pragma unroll
    for (int jj = 0; jj < kWrGroup; ++jj) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jj][mt][e] = 0.0f;
      }
    }
    for (int c = c0; c < c1; c += KB) {
      uint4 y[KB][kWrGroup], x[KB][MT][2];
#pragma unroll
      for (int q = 0; q < KB; ++q) {
        const int k = (c + q) * 32 + 8 * tq;
        const bool in = c + q < c1 && k < K;
#pragma unroll
        for (int jj = 0; jj < kWrGroup; ++jj)
          y[q][jj] = !(in && nok[jj]) ? zero
                     : w.resident
                         ? lds16(wr[jj] + k)
                         : __ldg(reinterpret_cast<const uint4*>(wr[jj] + k));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          x[q][mt][0] = in ? A.load(mt * 16 + gid, k) : zero;
          x[q][mt][1] = in ? A.load(mt * 16 + gid + 8, k) : zero;
        }
      }
#pragma unroll
      for (int q = 0; q < KB; ++q) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint4* xa = x[q][mt];
          const uint32_t s0[4] = {xa[0].x, xa[1].x, xa[0].y, xa[1].y};
          const uint32_t s1[4] = {xa[0].z, xa[1].z, xa[0].w, xa[1].w};
#pragma unroll
          for (int jj = 0; jj < kWrGroup; ++jj) {
            if (grp * kWrGroup + jj >= nt) break;
            mma_bf16(acc[jj][mt], s0, y[q][jj].x, y[q][jj].y);
            mma_bf16(acc[jj][mt], s1, y[q][jj].z, y[q][jj].w);
          }
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < kWrGroup; ++jj) {
      const int j = grp * kWrGroup + jj;
      if (j >= nt) break;
      float* o = parts + (size_t)p * mpad * Np + j * 8 + 2 * tq;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int rlo = mt * 16 + gid;
        *reinterpret_cast<float2*>(o + (size_t)rlo * Np) =
            make_float2(acc[jj][mt][0], acc[jj][mt][1]);
        *reinterpret_cast<float2*>(o + (size_t)(rlo + 8) * Np) =
            make_float2(acc[jj][mt][2], acc[jj][mt][3]);
      }
    }
  }
}

// f32: a warp per column (full K) and 8-row register tile, weights from
// L2, the warp's sums meeting in `red`; one part.  A has pitch K.
__device__ void wr_product_fma(const float* A, int K, const WrW<float>& w,
                               int Np, float* parts, int nr, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int n = warp; n < Np; n += kWarps) {
    const bool nok = w.ok(n);
    const float* const wc[1] = {w.row(n)};
    for (int r0 = 0; r0 < nr; r0 += kRB) {
      const int rows = min(kRB, nr - r0);
      float acc[1][kRB] = {};
      if (nok) warp_dot(wc, A + (size_t)r0 * K, K, 0, K, rows, acc);
      float v[kRB];
#pragma unroll
      for (int i = 0; i < kRB; ++i) v[i] = acc[0][i];
      float* rw = red + warp * kRB;
      warp_sum_to_smem(v, rw);
      if (lane < rows) parts[(size_t)(r0 + lane) * Np + n] = rw[lane];
      __syncwarp();
    }
  }
}

// The sum of a product's K parts at (row, n), in part order (kp <= 8).
__device__ __forceinline__ float wr_psum(const float* parts, int kp, int mpad,
                                         int Np, int row, int n) {
  const float* q = parts + (size_t)row * Np + n;
  const size_t step = (size_t)mpad * Np;
  float v[kWarps];
#pragma unroll
  for (int p = 0; p < kWarps; ++p) v[p] = p < kp ? q[p * step] : 0.0f;
  float s = 0.0f;
#pragma unroll
  for (int p = 0; p < kWarps; ++p) s += v[p];
  return s;
}

template <typename T>
__device__ __forceinline__ int wr_kp(int Np) {
  return std::is_same_v<T, __nv_bfloat16> ? wr_kparts(Np / 8) : 1;
}

// One product of the block over nr rows (from the pass's first) of a ring
// buffer `src` (rows of K): bf16 reads the fragments from L2; f32 stages
// the rows into shared memory first.  Ends with a block barrier.
template <typename T, int MT>
__device__ __forceinline__ void wr_mul(const WrArgs<T>& a, float* smA,
                                       const T* src, int K, int nr,
                                       const WrW<T>& w, int Np, float* parts,
                                       float* red) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    wr_product<MT>(WrARing{src, K, nr}, K, w, Np, a.mpad, parts);
  } else {
    wr_stage(smA, src, K, nr);
    wr_staged();
    wr_product_fma(smA, K, w, Np, parts, nr, red);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// the block's roles and shared regions
// ---------------------------------------------------------------------------

template <typename T>
struct WrShared {
  T* wg;          // resident GRU rows: W_ih (3 units), then W_hh
  T* wf;          // resident fc1 (R1) or fc2 (R2) rows
  T* w3;          // resident fc3 (R1), or the block's slice of it
  float* A;       // f32: the pass's staged operand rows
  float* parts;   // the product's K parts
  // per-row state, in shared memory or (state_smem = 0) in L2:
  float* hh;      // (B, 3 units) h @ W_hh for the next step
  float* hown;    // (B, units) the block's GRU state
  float* pre;     // (B, rd) pre_I of the step (prefetched), or unused
  float* noise;   // (B, pick_dim + 1) Gumbel lanes and the logistic value
                  // (split pick: (B, slice_classes), the slice's lanes)
  float* xs;      // (B,) the samples fed back
  float* red;     // (kWarps, kRB) warp sums (f32 products)
  float* cst;     // b_ih, b_hh of the block's units (3 units each), b_fc3
  float* frm;     // the frame's pre_r2 (B, 3 units) and pre_f (B, fc_units)
                  // slices of the block
};

// What a block owns: GRU units j0 .. j0 + nu - 1 (GRU1 in R1 blocks,
// GRU2 and those pre_I columns in R2 blocks) and fc columns c0 .. c0 +
// nf - 1 (fc1 in R1, fc2 in R2; nf may be 0); on the split pick, classes
// k0 .. k0 + nk - 1 (R1; nk may be 0, and is 0 without the split).
struct WrRole {
  bool r1;
  int j0, nu, c0, nf, k0, nk;
};

// Block `blk`'s role: the first g blocks R1, the next g R2.  The launch
// checks from this function that every unit and column has one owner.
template <typename T>
__host__ __device__ inline WrRole wr_role(const WrArgs<T>& a, int blk) {
  WrRole r;
  r.r1 = blk < a.g;
  const int b = r.r1 ? blk : blk - a.g;
  r.j0 = b * a.units;
  r.nu = a.rd - r.j0 < a.units ? a.rd - r.j0 : a.units;
  r.c0 = b * a.fc_units;
  r.nf = a.fc - r.c0 < a.fc_units ? a.fc - r.c0 : a.fc_units;
  r.nf = r.nf > 0 ? r.nf : 0;
  r.k0 = b * a.slice_classes;
  r.nk = a.n_classes - r.k0 < a.slice_classes ? a.n_classes - r.k0
                                               : a.slice_classes;
  r.nk = r.r1 && r.nk > 0 ? r.nk : 0;
  return r;
}

// Whether a block of role r bumps counter c after its stage: every R1
// block c1, every R2 block c2, the blocks that own fc columns c3 (R1) and
// c4 (R2), every block the prologue's, the R1 blocks that own classes cs
// (none without the split pick).  The kernel arrives where this
// says and nowhere else, and the launch counts each counter's producers
// from it and holds them to the plan's, the wait targets (epoch e waits
// for e x producers).
__host__ __device__ inline bool wr_arrives(const WrRole& r, int c) {
  switch (c) {
    case kC1: return r.r1;
    case kC2: return !r.r1;
    case kC3: return r.r1 && r.nf > 0;
    case kC4: return !r.r1 && r.nf > 0;
    case kCS: return r.nk > 0;
    default: return true;
  }
}

// The GRU matrix `hh` (0: W_ih, 1: W_hh) of the block, resident or in L2:
// product row gate * units + unit.
template <typename T>
__device__ __forceinline__ WrW<T> wr_gru_w(const WrArgs<T>& a,
                                           const WrShared<T>& s,
                                           const WrRole& r, int hh) {
  const int u = a.units;
  if (a.resident)
    return {s.wg + (size_t)hh * 3 * u * (a.rd + kWrPad), a.rd + kWrPad,
            a.ushift, u, r.nu, 1};
  const T* m = r.r1 ? (hh ? a.w_hh1 : a.w_ih1) : (hh ? a.w_hh2 : a.w_ih2);
  return {m + (size_t)r.j0 * a.rd, a.rd, a.ushift, a.rd, r.nu, 0};
}
// The block's fc rows (fc1 in R1 with K = rd, fc2 in R2 with K = fc).
template <typename T>
__device__ __forceinline__ WrW<T> wr_fc_w(const WrArgs<T>& a,
                                          const WrShared<T>& s,
                                          const WrRole& r) {
  const int K = r.r1 ? a.rd : a.fc;
  if (a.resident) return {s.wf, K + kWrPad, 0, 0, r.nf, 1};
  return {(r.r1 ? a.w_fc1 : a.w_fc2) + (size_t)r.c0 * K, K, 0, 0, r.nf, 0};
}
template <typename T>
__device__ __forceinline__ WrW<T> wr_fc3_w(const WrArgs<T>& a,
                                           const WrShared<T>& s) {
  if (a.fc3_resident) return {s.w3, a.fc + kWrPad, 0, 0, a.n_classes, 1};
  return {a.w_fc3, a.fc, 0, 0, a.n_classes, 0};
}

// Rows 0 .. n - 1 of an L2 row map -> shared memory of pitch K + kWrPad
// (rows it does not own zero).
__device__ void wr_load_rows(__nv_bfloat16* dst, const WrW<__nv_bfloat16>& w,
                             int n, int K) {
  const int vpr = K / 8;
  for (int i = threadIdx.x; i < n * vpr; i += kThreads) {
    const int row = i / vpr, v = i - row * vpr;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (w.ok(row)) x = __ldg(reinterpret_cast<const uint4*>(w.row(row)) + v);
    *reinterpret_cast<uint4*>(dst + (size_t)row * (K + kWrPad) + 8 * v) = x;
  }
}

// ---------------------------------------------------------------------------
// the stages
// ---------------------------------------------------------------------------

// The block's biases (prologue): b_ih1, b_hh1 and b_fc3 (R1), b_hh2 (R2).
template <typename T>
__device__ void wr_consts(const WrArgs<T>& a, const WrShared<T>& s,
                          const WrRole& r) {
  const int u = a.units;
  for (int i = threadIdx.x; i < 6 * u + a.n_classes; i += kThreads) {
    float v = 0.0f;
    if (i < 6 * u) {
      const int hh = i / (3 * u), gt = i % (3 * u) / u, jl = i % u;
      const float* b = r.r1 ? (hh ? a.b_hh1 : a.b_ih1) : (hh ? a.b_hh2 : nullptr);
      if (b != nullptr && jl < r.nu) v = __ldg(b + gt * a.rd + r.j0 + jl);
    } else if (r.r1) {
      v = __ldg(a.b_fc3 + i - 6 * u);
    }
    s.cst[i] = v;
  }
}

// The frame-rate inputs of frame q the block's epilogues read: pre_r2
// (R2) and pre_f1 (R1) or pre_f2 (R2) of its units and columns.  Loaded
// at the frame's first step, before the block's first wait.
template <typename T>
__device__ void wr_frame(const WrArgs<T>& a, const WrShared<T>& s,
                         const WrRole& r, int q) {
  const int u = a.units, uf = a.fc_units, B = a.B;
  if (!r.r1) {
    for (int i = threadIdx.x; i < B * 3 * u; i += kThreads) {
      const int b = i / (3 * u), gt = i % (3 * u) / u, jl = i % u;
      s.frm[i] = jl < r.nu ? __ldg(a.pre_r2 + ((size_t)b * a.fpf + q) * 3 *
                                                  a.rd + gt * a.rd + r.j0 + jl)
                           : 0.0f;
    }
  }
  const float* pf = r.r1 ? a.pre_f1 : a.pre_f2;
  for (int i = threadIdx.x; i < B * uf; i += kThreads) {
    const int b = i / uf, c = i % uf;
    s.frm[B * 3 * u + i] =
        c < r.nf ? __ldg(pf + ((size_t)b * a.fpf + q) * a.fc + r.c0 + c) : 0.0f;
  }
}

// pre_I of step tt for the block's column slice (R2), into ring slot
// wr_slot(tt); read by stage A of step tt.
template <typename T>
__device__ void wr_pre_slice(const WrArgs<T>& a, const WrRole& r, int tt) {
  const int q = tt / a.S, p = tt % a.S, rd = a.rd;
  const int Fq = a.fpf + a.W - 1;
  float* dst = wr_pre(a, wr_slot(tt));
  for (int i = threadIdx.x; i < a.B * r.nu; i += kThreads) {
    const int b = i / r.nu, j = r.j0 + i % r.nu;
    const float* mf = a.mf + ((size_t)b * Fq + q) * rd + j;
    float pre = __ldg(a.base + ((size_t)b * a.fpf + q) * rd + j);
#pragma unroll
    for (int w = 0; w < kMaxTaps; ++w)
      if (w < a.W)
        pre = pre + __ldg(mf + (size_t)w * rd) * __ldg(a.ktab + w * a.S + p);
    dst[(size_t)b * rd + j] = pre;
  }
}

// Stage A's first half: the sample of step ts for every row, from x4 of
// step ts: fc3, then the Gumbel-max pick (ties go to the lowest index, as
// jnp.argmax), into xs; block 0 writes it out.  A warp takes a row, a
// lane its classes: the logit (the K parts summed in order, then the
// bias) plus the Gumbel lane, and for MOL the class's mean and log-scale
// logits, carried through the reduction with it.
template <typename T, int MT>
__device__ void wr_pick(const WrArgs<T>& a, const WrShared<T>& s, int ts) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int fc = a.fc, n3 = wr_ntiles_pad(a.n_classes), kp3 = wr_kp<T>(n3);
  const int pd = a.pick_dim, nm = a.nr_mix;
  const T* x4 = wr_op(a, kOpX4, wr_slot(ts));
  const WrW<T> w3 = wr_fc3_w(a, s);
  const float* b3 = s.cst + 6 * a.units;
  for (int r0 = 0; r0 < a.B; r0 += a.rows) {
    const int nr = min(a.rows, a.B - r0);
    wr_mul<T, MT>(a, s.A, x4 + (size_t)r0 * fc, fc, nr, w3, n3, s.parts,
                  s.red);
    // logit c of pass row r: its K parts in order, then the bias
#define WR_LOGIT(r, c) (wr_psum(s.parts, kp3, a.mpad, n3, (r), (c)) + b3[c])
    // L lanes a row (the pick lanes rounded up to 8, 16 or 32): 32 / L
    // rows a warp at once
    const int L = pd <= 8 ? 8 : pd <= 16 ? 16 : 32;
    const int sub = lane / L, sl = lane % L;
    for (int rb = warp * (32 / L); rb < nr; rb += kWarps * (32 / L)) {
      const int r = rb + sub, row = r0 + r;
      const bool live = r < nr;
      const float* gn = a.noise_smem ? s.noise + (size_t)row * (pd + 1)
                                     : a.gumbel + ((size_t)ts * a.B + row) * pd;
      float best = __int_as_float(0xff800000);  // -inf
      float mean = 0.0f, lsc = 0.0f;
      int pick = 0x7fffffff;
      for (int c = sl; live && c < pd; c += L) {
        const float v = WR_LOGIT(r, c) + gn[c];
        const float m = a.raw_mode ? 0.0f : WR_LOGIT(r, nm + c);
        const float l = a.raw_mode ? 0.0f : WR_LOGIT(r, 2 * nm + c);
        if (v > best) {
          best = v;
          pick = c;
          mean = m;
          lsc = l;
        }
      }
      for (int off = L / 2; off > 0; off >>= 1) {   // within the L lanes
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int op = __shfl_xor_sync(0xffffffffu, pick, off);
        const float om = __shfl_xor_sync(0xffffffffu, mean, off);
        const float ol = __shfl_xor_sync(0xffffffffu, lsc, off);
        if (ob > best || (ob == best && op < pick)) {
          best = ob;
          pick = op;
          mean = om;
          lsc = ol;
        }
      }
      if (sl == 0 && live) {
        pick = min(pick, pd - 1);   // no lane saw a number (NaN logits)
        float sample;
        if (a.raw_mode) {
          sample = 2.0f * (float)pick / ((float)a.n_classes - 1.0f) - 1.0f;
        } else {
          const float lg = a.noise_smem ? gn[pd]
                                        : a.logistic[(size_t)ts * a.B + row];
          sample = fminf(
              fmaxf(mean + expf(fmaxf(lsc, kLogScaleMin)) * lg, -1.0f), 1.0f);
        }
        s.xs[row] = sample;
        if (blockIdx.x == 0) a.out[(size_t)row * a.steps + ts] = sample;
      }
    }
#undef WR_LOGIT
    __syncthreads();
  }
}

// The split pick's order of a value: unsigned, larger for larger floats
// (-0 as +0, so that equal values tie); NaN never gets here.
__device__ __forceinline__ unsigned int wr_order(float v) {
  const unsigned int u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : u | 0x80000000u;
}

// The split pick's first half, in an R1 block that owns classes k0 .. k0 +
// nk - 1: their logits for every row from x4 of step ts (a warp a 16-row
// M-tile and n-tile, the K chunks in order: wr_product's order at kp =
// 1, so each logit is the whole pick's, bit for bit), plus the bias and
// the Gumbel lane; each row's best (the largest value, the lowest class
// among equal ones; NaN and -inf never) goes into the row's key of slot
// wr_slot(ts) as (epoch ts + 1, the value's order, the inverted class),
// an atomicMax: the word then holds the best of every slice, and a
// stale word (an older epoch) loses to any of them.
template <int MT>
__device__ void wr_slice(const WrArgs<__nv_bfloat16>& a,
                         const WrShared<__nv_bfloat16>& s, const WrRole& r,
                         int ts) {
  constexpr int KB = 4;   // K chunks in flight
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tq = lane & 3;
  const int fc = a.fc, sc = a.slice_classes, nts = sc / 8;
  const int nch = (fc + 31) / 32;
  const __nv_bfloat16* x4 = wr_op(a, kOpX4, wr_slot(ts));
  unsigned long long* keys = a.keys + (size_t)wr_slot(ts) * a.B;
  const float* b3 = s.cst + 6 * a.units + r.k0;
  const unsigned long long tag = (unsigned long long)(ts + 1)
                                 << (32 + a.cbits);
  const unsigned int cmask = (1u << a.cbits) - 1u;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int r0 = 0; r0 < a.B; r0 += a.rows) {
    const int nr = min(a.rows, a.B - r0);
    const WrARing A{x4 + (size_t)r0 * fc, fc, nr};
    for (int i = warp; i < MT * nts; i += kWarps) {
      const int mt = i / nts, j = i - mt * nts;
      const __nv_bfloat16* wrow = s.w3 + (size_t)(j * 8 + gid) * (fc + kWrPad);
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int c = 0; c < nch; c += KB) {
        uint4 y[KB], x[KB][2];
#pragma unroll
        for (int q = 0; q < KB; ++q) {
          const int k = (c + q) * 32 + 8 * tq;
          const bool in = c + q < nch && k < fc;
          y[q] = in ? lds16(wrow + k) : zero;
          x[q][0] = in ? A.load(mt * 16 + gid, k) : zero;
          x[q][1] = in ? A.load(mt * 16 + gid + 8, k) : zero;
        }
#pragma unroll
        for (int q = 0; q < KB; ++q) {
          if (c + q >= nch) break;
          const uint32_t s0[4] = {x[q][0].x, x[q][1].x, x[q][0].y, x[q][1].y};
          const uint32_t s1[4] = {x[q][0].z, x[q][1].z, x[q][0].w, x[q][1].w};
          mma_bf16(acc, s0, y[q].x, y[q].y);
          mma_bf16(acc, s1, y[q].z, y[q].w);
        }
      }
      // lane (gid, tq) holds rows gid and gid + 8 of the M-tile, classes
      // j * 8 + 2 tq and + 1 of the slice; a row's 8 are the quad's
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = mt * 16 + gid + 8 * h, row = r0 + rr;
        float best = __int_as_float(0xff800000);  // -inf
        int pick = 0x7fffffff;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = j * 8 + 2 * tq + e;
          if (rr < nr && c < r.nk) {
            const float gn =
                a.noise_smem ? s.noise[(size_t)row * sc + c]
                             : __ldg(a.gumbel + ((size_t)ts * a.B + row) *
                                                    a.pick_dim + r.k0 + c);
            const float v = acc[2 * h + e] + b3[c] + gn;
            if (v > best) {
              best = v;
              pick = r.k0 + c;
            }
          }
        }
        for (int off = 1; off < 4; off <<= 1) {
          const float ob = __shfl_xor_sync(0xffffffffu, best, off);
          const int op = __shfl_xor_sync(0xffffffffu, pick, off);
          if (ob > best || (ob == best && op < pick)) {
            best = ob;
            pick = op;
          }
        }
        if (tq == 0 && pick != 0x7fffffff)
          atomicMax(keys + row,
                    tag | (unsigned long long)wr_order(best) << a.cbits |
                        (cmask - (unsigned int)pick));
      }
    }
  }
}

// The split pick's second half (every R1 block, after every slice's
// arrival on cs): the sample of step ts for every row from its key, as
// wr_pick's RAW rule (pick_dim - 1 where no slice saw a number above
// -inf: then the word is still an older epoch's), into xs; block 0
// writes it out.
__device__ void wr_merge(const WrArgs<__nv_bfloat16>& a,
                         const WrShared<__nv_bfloat16>& s, int ts) {
  const unsigned long long* keys = a.keys + (size_t)wr_slot(ts) * a.B;
  const unsigned int cmask = (1u << a.cbits) - 1u;
  for (int row = threadIdx.x; row < a.B; row += kThreads) {
    const unsigned long long k = __ldcg(keys + row);
    const int pick = (k >> (32 + a.cbits)) == (unsigned long long)(ts + 1)
                         ? (int)(cmask - (unsigned int)(k & cmask))
                         : a.pick_dim - 1;
    const float sample =
        2.0f * (float)pick / ((float)a.n_classes - 1.0f) - 1.0f;
    s.xs[row] = sample;
    if (blockIdx.x == 0) a.out[(size_t)row * a.steps + ts] = sample;
  }
  __syncthreads();
}

// The noise of step ts (on the split pick the Gumbel lanes of the block's
// classes), and pre_I of step ts + 1, into shared memory ahead of stage A
// (the copies of pre_I stay in flight: stage A waits).
template <typename T, bool SPLIT>
__device__ void wr_prefetch(const WrArgs<T>& a, const WrShared<T>& s,
                            const WrRole& r, int ts) {
  const int pd = a.pick_dim;
  if constexpr (SPLIT) {
    const int sc = a.slice_classes;
    if (a.noise_smem && ts >= 0 && r.nk > 0) {
      for (int i = threadIdx.x; i < a.B * sc; i += kThreads) {
        const int b = i / sc, c = i - b * sc;
        s.noise[i] = c < r.nk ? __ldg(a.gumbel + ((size_t)ts * a.B + b) * pd +
                                      r.k0 + c)
                              : 0.0f;
      }
    }
  } else if (a.noise_smem && ts >= 0) {
    for (int i = threadIdx.x; i < a.B * (pd + 1); i += kThreads) {
      const int b = i / (pd + 1), c = i - b * (pd + 1);
      s.noise[i] = c < pd ? __ldg(a.gumbel + ((size_t)ts * a.B + b) * pd + c)
                          : __ldg(a.logistic + (size_t)ts * a.B + b);
    }
  }
  if (a.pre_smem && ts + 1 < a.steps)
    wr_stage(s.pre, wr_pre(a, wr_slot(ts + 1)), a.rd, a.B);
}

// Stage A's second half (R1): xI = x w_x + pre_I of step t, xI @ W_ih1,
// the GRU1 cell with the h1 product of stage hh1, h1 and x1 out.
template <typename T, int MT>
__device__ void wr_gru1(const WrArgs<T>& a, const WrShared<T>& s,
                        const WrRole& r, int t) {
  const int rd = a.rd, u = a.units, sh = a.ushift;
  const int slot = wr_slot(t), kp = wr_kp<T>(3 * u);
  const float* pre = a.pre_smem ? s.pre : wr_pre(a, slot);
  const WrW<T> wih = wr_gru_w(a, s, r, 0);
  T* h1o = wr_op(a, kOpH1, slot);
  T* x1o = wr_op(a, kOpX1, slot);
  float* x1f = wr_x1f(a, slot);
  cp_async_wait_all();   // the prefetched pre_I
  __syncthreads();
  for (int r0 = 0; r0 < a.B; r0 += a.rows) {
    const int nr = min(a.rows, a.B - r0);
    // the block's units' xI, in flight with the product
    float xiv[kWrItems];
#pragma unroll
    for (int k = 0; k < kWrItems; ++k) {
      const int i = threadIdx.x + k * kThreads, row = r0 + (i >> sh);
      const int j = r.j0 + (i & (u - 1));
      if (i < nr << sh && (i & (u - 1)) < r.nu) {
        const size_t at = (size_t)row * rd + j;
        xiv[k] = fmaf(s.xs[row], __ldg(a.w_x + j),
                      a.pre_smem ? pre[at] : __ldcg(pre + at));
      }
    }
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      wr_product<MT>(WrAXi{pre + (size_t)r0 * rd, s.xs + r0, a.w_x, rd, nr,
                           a.pre_smem},
                     rd, wih, 3 * u, a.mpad, s.parts);
    } else {
      for (int i = threadIdx.x; i < nr * rd; i += kThreads) {
        const int rr = i / rd, k = i - rr * rd;
        const size_t at = (size_t)(r0 + rr) * rd + k;
        s.A[i] = fmaf(s.xs[r0 + rr], __ldg(a.w_x + k),
                      a.pre_smem ? pre[at] : __ldcg(pre + at));
      }
      __syncthreads();
      wr_product_fma(s.A, rd, wih, 3 * u, s.parts, nr, s.red);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kWrItems; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i >= nr << sh) break;
      const int rr = i >> sh, jl = i & (u - 1), row = r0 + rr;
      if (jl >= r.nu) continue;
      const int j = r.j0 + jl;
      const size_t at = (size_t)row * rd + j;
      float ih[3], hh[3];
#pragma unroll
      for (int gt = 0; gt < 3; ++gt) {
        ih[gt] = wr_psum(s.parts, kp, a.mpad, 3 * u, rr, gt * u + jl) +
                 s.cst[gt * u + jl];
        hh[gt] = s.hh[(size_t)row * 3 * u + gt * u + jl] +
                 s.cst[3 * u + gt * u + jl];
      }
      const float rg = sigmoidf_(ih[0] + hh[0]);
      const float zg = sigmoidf_(ih[1] + hh[1]);
      const float ng = tanhf(ih[2] + rg * hh[2]);
      float* hp = s.hown + (size_t)row * u + jl;
      const float h = (1.0f - zg) * ng + zg * *hp;
      *hp = h;
      const float x1 = xiv[k] + h;
      h1o[at] = from_float<T>(h);
      x1f[at] = x1;
      x1o[at] = from_float<T>(x1);
    }
    __syncthreads();
  }
}

// Stage B (R2): x1 @ W_ih2x + pre_r2, the GRU2 cell with the h2 product
// of stage hh2, h2 and x2 = x1 + h2 out.
template <typename T, int MT>
__device__ void wr_gru2(const WrArgs<T>& a, const WrShared<T>& s,
                        const WrRole& r, int t) {
  const int rd = a.rd, u = a.units, sh = a.ushift;
  const int slot = wr_slot(t), kp = wr_kp<T>(3 * u);
  const WrW<T> wih = wr_gru_w(a, s, r, 0);
  const T* x1o = wr_op(a, kOpX1, slot);
  const float* x1f = wr_x1f(a, slot);
  T* h2o = wr_op(a, kOpH2, slot);
  T* x2o = wr_op(a, kOpX2, slot);
  for (int r0 = 0; r0 < a.B; r0 += a.rows) {
    const int nr = min(a.rows, a.B - r0);
    float x1v[kWrItems];   // the residual's x1, in flight with the product
#pragma unroll
    for (int k = 0; k < kWrItems; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < nr << sh && (i & (u - 1)) < r.nu)
        x1v[k] = __ldcg(x1f + (size_t)(r0 + (i >> sh)) * rd + r.j0 +
                        (i & (u - 1)));
    }
    wr_mul<T, MT>(a, s.A, x1o + (size_t)r0 * rd, rd, nr, wih, 3 * u, s.parts,
                  s.red);
#pragma unroll
    for (int k = 0; k < kWrItems; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i >= nr << sh) break;
      const int rr = i >> sh, jl = i & (u - 1), row = r0 + rr;
      if (jl >= r.nu) continue;
      const int j = r.j0 + jl;
      const size_t at = (size_t)row * rd + j;
      const float* xb = s.frm + (size_t)row * 3 * u + jl;
      float ih[3], hh[3];
#pragma unroll
      for (int gt = 0; gt < 3; ++gt) {
        ih[gt] = wr_psum(s.parts, kp, a.mpad, 3 * u, rr, gt * u + jl) +
                 xb[gt * u];
        hh[gt] = s.hh[(size_t)row * 3 * u + gt * u + jl] +
                 s.cst[3 * u + gt * u + jl];
      }
      const float rg = sigmoidf_(ih[0] + hh[0]);
      const float zg = sigmoidf_(ih[1] + hh[1]);
      const float ng = tanhf(ih[2] + rg * hh[2]);
      float* hp = s.hown + (size_t)row * u + jl;
      const float h = (1.0f - zg) * ng + zg * *hp;
      *hp = h;
      h2o[at] = from_float<T>(h);
      x2o[at] = from_float<T>(x1v[k] + h);
    }
    __syncthreads();
  }
}

// Stages hh1 / hh2 (off the critical path): h_t @ W_hh of the block's
// units for step t + 1, from the ring slot step t wrote, into s.hh.
template <typename T, int MT>
__device__ void wr_hh(const WrArgs<T>& a, const WrShared<T>& s,
                      const WrRole& r, const T* h) {
  const int rd = a.rd, u = a.units, kp = wr_kp<T>(3 * u);
  const WrW<T> whh = wr_gru_w(a, s, r, 1);
  for (int r0 = 0; r0 < a.B; r0 += a.rows) {
    const int nr = min(a.rows, a.B - r0);
    wr_mul<T, MT>(a, s.A, h + (size_t)r0 * rd, rd, nr, whh, 3 * u, s.parts,
                  s.red);
    for (int i = threadIdx.x; i < nr * 3 * u; i += kThreads) {
      const int rr = i / (3 * u), n = i - rr * 3 * u;
      s.hh[(size_t)(r0 + rr) * 3 * u + n] =
          wr_psum(s.parts, kp, a.mpad, 3 * u, rr, n);
    }
    __syncthreads();
  }
}

// Stages C (fc1, R1) and D (fc2, R2): out = relu(in @ W + pre) for the
// block's columns.
template <typename T, int MT>
__device__ void wr_dense(const WrArgs<T>& a, const WrShared<T>& s,
                         const WrRole& r, const T* in, int K, T* out) {
  const int fc = a.fc, uf = a.fc_units, sh = a.fshift, kp = wr_kp<T>(uf);
  const float* pre = s.frm + (size_t)a.B * 3 * a.units;
  const WrW<T> w = wr_fc_w(a, s, r);
  for (int r0 = 0; r0 < a.B; r0 += a.rows) {
    const int nr = min(a.rows, a.B - r0);
    wr_mul<T, MT>(a, s.A, in + (size_t)r0 * K, K, nr, w, uf, s.parts, s.red);
#pragma unroll
    for (int k = 0; k < kWrItems; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i >= nr << sh) break;
      const int rr = i >> sh, c = i & (uf - 1), row = r0 + rr;
      if (c >= r.nf) continue;
      const float v = wr_psum(s.parts, kp, a.mpad, uf, rr, c) +
                      pre[(size_t)row * uf + c];
      out[(size_t)row * fc + r.c0 + c] = from_float<T>(fmaxf(v, 0.0f));
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// SPLIT: the split pick (bf16 only); without it the R1 blocks each pick
// from all classes (wr_pick), and nothing of the split is compiled.
template <typename T, int MT, bool SPLIT>
__global__ void __launch_bounds__(kThreads, 1) wr_kernel(WrArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool kBf16 = sizeof(T) == 2;
  const WrSmem L = wr_smem(a.B, a.rd, a.fc, a.n_classes, a.pick_dim,
                           a.units, a.fc_units, a.mpad, kBf16, a.resident,
                           a.fc3_resident, a.pre_smem, a.noise_smem,
                           a.state_smem, SPLIT ? a.slice_classes : 0);
  WrShared<T> s;
  s.wg = reinterpret_cast<T*>(smem_raw + L.wg);
  s.wf = reinterpret_cast<T*>(smem_raw + L.wf);
  s.w3 = reinterpret_cast<T*>(smem_raw + L.w3);
  s.A = reinterpret_cast<float*>(smem_raw + L.A);
  s.parts = reinterpret_cast<float*>(smem_raw + L.parts);
  s.pre = reinterpret_cast<float*>(smem_raw + L.pre);
  s.noise = reinterpret_cast<float*>(smem_raw + L.noise);
  s.red = reinterpret_cast<float*>(smem_raw + L.red);
  s.cst = reinterpret_cast<float*>(smem_raw + L.cst);
  const int B = a.B, rd = a.rd, u = a.units, steps = a.steps;
  if (a.state_smem) {
    s.hh = reinterpret_cast<float*>(smem_raw + L.hh);
    s.hown = reinterpret_cast<float*>(smem_raw + L.hown);
    s.frm = reinterpret_cast<float*>(smem_raw + L.frm);
    s.xs = reinterpret_cast<float*>(smem_raw + L.xs);
  } else {   // the block's part of spill, in wr_smem's order
    float* st = a.spill + blockIdx.x * wr_spill_floats(B, u, a.fc_units);
    s.hh = st;
    s.hown = st + (size_t)B * 3 * u;
    s.frm = st + (size_t)B * 4 * u;
    s.xs = st + (size_t)B * (7 * u + a.fc_units);
  }
  const WrRole r = wr_role(a, blockIdx.x);
  unsigned int* bar = a.bar;

  // prologue: resident weights, zero state, pre_I of step 0
  if constexpr (kBf16) {
    if (a.resident) {
      for (int hh = 0; hh < 2; ++hh) {
        const __nv_bfloat16* m = r.r1 ? (hh ? a.w_hh1 : a.w_ih1)
                                      : (hh ? a.w_hh2 : a.w_ih2);
        wr_load_rows(s.wg + (size_t)hh * 3 * u * (rd + kWrPad),
                     {m + (size_t)r.j0 * rd, rd, a.ushift, rd, r.nu, 0}, 3 * u,
                     rd);
      }
      const int K = r.r1 ? rd : a.fc;
      wr_load_rows(s.wf, {(r.r1 ? a.w_fc1 : a.w_fc2) + (size_t)r.c0 * K, K,
                          0, 0, r.nf, 0},
                   a.fc_units, K);
    }
    if (r.r1 && a.fc3_resident)
      wr_load_rows(s.w3, {a.w_fc3, a.fc, 0, 0, a.n_classes, 0},
                   a.n_classes, a.fc);
    if constexpr (SPLIT) {
      if (r.nk > 0)
        wr_load_rows(s.w3, {a.w_fc3 + (size_t)r.k0 * a.fc, a.fc, 0, 0, r.nk, 0},
                     a.slice_classes, a.fc);
    }
  }
  for (int i = threadIdx.x; i < B * 3 * u; i += kThreads) s.hh[i] = 0.0f;
  for (int i = threadIdx.x; i < B * u; i += kThreads) s.hown[i] = 0.0f;
  for (int i = threadIdx.x; i < B; i += kThreads) s.xs[i] = 0.0f;  // x_0
  wr_consts(a, s, r);
  if (!r.r1) wr_pre_slice(a, r, 0);
  if (wr_arrives(r, kCPro)) wr_arrive(bar + kCPro);
  wr_wait(bar + kCPro, a.prod[kCPro]);

  if (r.r1) {
    wr_prefetch<T, SPLIT>(a, s, r, -1);   // pre_I of step 0
    for (int t = 0; t < steps; ++t) {
      const unsigned int e = t + 1;   // the epoch of step t's counters
      if (t % a.S == 0) wr_frame(a, s, r, t / a.S);
      // A: the sample of step t - 1 (x_0 = 0), then GRU1
      if constexpr (SPLIT) {
        if (t > 0) {
          if (wr_arrives(r, kCS)) {
            wr_wait(bar + kC4, t * a.prod[kC4]);   // x4 of step t - 1
            wr_slice<MT>(a, s, r, t - 1);
            wr_arrive(bar + kCS);
          }
          wr_wait(bar + kCS, t * a.prod[kCS]);   // every slice's best
          wr_merge(a, s, t - 1);
        }
      } else if (t > 0) {
        wr_wait(bar + kC4, t * a.prod[kC4]);   // x4 of step t - 1
        wr_pick<T, MT>(a, s, t - 1);
      }
      wr_gru1<T, MT>(a, s, r, t);
      if (wr_arrives(r, kC1)) wr_arrive(bar + kC1);
      // hh1: h1_t @ W_hh1 for step t + 1, while B runs
      if (t + 1 < steps) {
        wr_wait(bar + kC1, e * a.prod[kC1]);   // h1 of step t, all
                                              // units
        wr_hh<T, MT>(a, s, r, wr_op(a, kOpH1, wr_slot(t)));
      }
      // C: fc1 (pre_I of step t + 1 is written before c2)
      wr_wait(bar + kC2, e * a.prod[kC2]);   // x2 of step t
      if (wr_arrives(r, kC3)) {
        wr_dense<T, MT>(a, s, r, wr_op(a, kOpX2, wr_slot(t)), rd,
                        wr_op(a, kOpX3, wr_slot(t)));
        wr_arrive(bar + kC3);
      }
      wr_prefetch<T, SPLIT>(a, s, r, t);
    }
    // the last sample
    if constexpr (SPLIT) {
      if (wr_arrives(r, kCS)) {
        wr_wait(bar + kC4, steps * a.prod[kC4]);
        wr_slice<MT>(a, s, r, steps - 1);
        wr_arrive(bar + kCS);
      }
      if (blockIdx.x == 0) {
        wr_wait(bar + kCS, steps * a.prod[kCS]);
        wr_merge(a, s, steps - 1);
      }
    } else if (blockIdx.x == 0) {
      wr_wait(bar + kC4, steps * a.prod[kC4]);
      wr_pick<T, MT>(a, s, steps - 1);
    }
  } else {
    for (int t = 0; t < steps; ++t) {
      const unsigned int e = t + 1;
      if (t % a.S == 0) wr_frame(a, s, r, t / a.S);
      // pre_I of step t + 1 (its slice), while A runs
      if (t + 1 < steps) wr_pre_slice(a, r, t + 1);
      // B: GRU2
      wr_wait(bar + kC1, e * a.prod[kC1]);   // x1 of step t
      wr_gru2<T, MT>(a, s, r, t);
      if (wr_arrives(r, kC2)) wr_arrive(bar + kC2);
      // hh2: h2_t @ W_hh2 for step t + 1, while C runs
      if (t + 1 < steps) {
        wr_wait(bar + kC2, e * a.prod[kC2]);   // h2 of step t, all
                                              // units
        wr_hh<T, MT>(a, s, r, wr_op(a, kOpH2, wr_slot(t)));
      }
      // D: fc2
      if (wr_arrives(r, kC4)) {
        wr_wait(bar + kC3, e * a.prod[kC3]);   // x3 of step t
        wr_dense<T, MT>(a, s, r, wr_op(a, kOpX3, wr_slot(t)), a.fc,
                        wr_op(a, kOpX4, wr_slot(t)));
        wr_arrive(bar + kC4);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int MT, bool SPLIT>
static int wr_go(WrArgs<T>& a, int blocks, size_t smem, cudaStream_t st) {
  return launch_cooperative(wr_kernel<T, MT, SPLIT>, a, blocks, smem, st);
}

// The plan of wr_plan (units, fc columns and rows a pass, the routes,
// the split pick's classes a block, each counter's producers,
// shared-memory bytes), checked against the kernel's own layout,
// ownership (wr_role) and arrivals (wr_arrives).
template <typename T>
static int launch(const void* const* p, const int* n, cudaStream_t stream) {
  constexpr bool bf16 = sizeof(T) == 2;
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
              const_cast<T*>(static_cast<const T*>(p[22])),
              const_cast<unsigned int*>(static_cast<const unsigned int*>(p[23])),
              const_cast<float*>(static_cast<const float*>(p[24])),
              reinterpret_cast<unsigned long long*>(const_cast<void*>(p[25])),
              n[0], n[1], n[2], n[3], n[4], n[5], n[6], n[7], n[8], n[9],
              n[10], n[11], n[12], n[13], n[14], n[15], n[16], n[17], n[18],
              n[19]};
  for (int c = 0; c < kCounters; ++c) a.prod[c] = (unsigned int)n[20 + c];
  const int smem_bytes = n[20 + kCounters];
  if (a.B < 1 || a.rd % 16 || a.fc % 16 || a.W < 1 || a.W > kMaxTaps ||
      a.units < 8 || (a.units & (a.units - 1)) || a.fc_units < 8 ||
      (a.fc_units & (a.fc_units - 1)) ||
      a.rows < 1 || a.passes < 1 || a.pick_dim < 1 ||
      a.pick_dim > a.n_classes ||
      (!bf16 && (a.resident || a.fc3_resident)))
    return cudaErrorInvalidValue;
  // the split pick: bf16, RAW, fc3 not whole in each block, 8-class tiles,
  // and every step's epoch fits above the value and the class
  a.cbits = a.n_classes > 1 ? 32 - __builtin_clz(a.n_classes - 1) : 0;
  if (a.slice_classes &&
      (!bf16 || !a.raw_mode || a.pick_dim != a.n_classes || a.fc3_resident ||
       a.slice_classes % 8 || a.keys == nullptr || a.cbits > 24 ||
       (long long)a.fpf * a.S >= (1ll << (32 - a.cbits))))
    return cudaErrorInvalidValue;
  const int tile = bf16 ? 16 : kRB;
  a.mpad = (a.rows + tile - 1) / tile * tile;
  a.g = (a.rd + a.units - 1) / a.units;
  a.steps = a.fpf * a.S;
  a.ushift = __builtin_ctz(a.units);
  a.fshift = __builtin_ctz(a.fc_units);
  if (a.mpad > 16 * kWrMaxMTiles || (a.B + a.rows - 1) / a.rows != a.passes ||
      (a.fc + a.fc_units - 1) / a.fc_units > a.g ||
      a.mpad * (a.units > a.fc_units ? a.units : a.fc_units) >
          kWrItems * kThreads)
    return cudaErrorInvalidValue;
  const int blocks = 2 * a.g;
  // every GRU unit and fc column of each role has exactly one owner, in
  // order, and each counter's producers are the plan's
  int next[2][2] = {{0, 0}, {0, 0}};   // [R1, R2][unit, column]
  int next_class = 0;                  // the split pick's classes
  unsigned int prod[kCounters] = {0, 0, 0, 0, 0, 0};
  for (int b = 0; b < blocks; ++b) {
    const WrRole r = wr_role(a, b);
    int* nx = next[r.r1 ? 0 : 1];
    if (r.j0 != nx[0] || r.nu < 1 || (r.nf > 0 && r.c0 != nx[1]) ||
        (r.nk > 0 && r.k0 != next_class))
      return cudaErrorInvalidValue;
    nx[0] += r.nu;
    nx[1] += r.nf;
    next_class += r.nk;
    for (int c = 0; c < kCounters; ++c) prod[c] += wr_arrives(r, c);
  }
  for (int k = 0; k < 2; ++k)
    if (next[k][0] != a.rd || next[k][1] != a.fc) return cudaErrorInvalidValue;
  if (next_class != (a.slice_classes ? a.n_classes : 0))
    return cudaErrorInvalidValue;
  // every counter has producers but cs, which has them on the split only
  for (int c = 0; c < kCounters; ++c)
    if (prod[c] != a.prod[c] ||
        (prod[c] < 1 && (c != kCS || a.slice_classes)))
      return cudaErrorInvalidValue;
  if (!a.state_smem && a.spill == nullptr) return cudaErrorInvalidValue;
  const WrSmem L = wr_smem(a.B, a.rd, a.fc, a.n_classes, a.pick_dim, a.units,
                           a.fc_units, a.mpad, bf16, a.resident,
                           a.fc3_resident, a.pre_smem, a.noise_smem,
                           a.state_smem, a.slice_classes);
  if (L.total != (size_t)smem_bytes) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (blocks > sms) return cudaErrorInvalidValue;  // every unit needs a block
  if constexpr (!bf16) {
    return wr_go<T, 1, false>(a, blocks, L.total, stream);
  } else if (a.slice_classes) {
    switch (a.mpad / 16) {
      case 1: return wr_go<T, 1, true>(a, blocks, L.total, stream);
      case 2: return wr_go<T, 2, true>(a, blocks, L.total, stream);
      case 3: return wr_go<T, 3, true>(a, blocks, L.total, stream);
      default: return wr_go<T, 4, true>(a, blocks, L.total, stream);
    }
  } else {
    switch (a.mpad / 16) {
      case 1: return wr_go<T, 1, false>(a, blocks, L.total, stream);
      case 2: return wr_go<T, 2, false>(a, blocks, L.total, stream);
      case 3: return wr_go<T, 3, false>(a, blocks, L.total, stream);
      default: return wr_go<T, 4, false>(a, blocks, L.total, stream);
    }
  }
}

}  // namespace avc

// C interface (ctypes).  ptrs: the 26 pointers of WrArgs in declaration
// order (mf .. keys); ints: B, fpf, S, W, rd, fc, n_classes, nr_mix,
// pick_dim, raw_mode, then the plan: units, fc_units, rows, passes,
// resident, fc3_resident, pre_smem, noise_smem, state_smem,
// slice_classes, the producers of c1, c2, c3, c4, the prologue's counter
// and cs, smem_bytes.
// bf16 != 0 selects bf16 weights and operands.  Returns a cudaError_t
// value (0 on success).
extern "C" int wavernn_sample_launch(const void* const* ptrs, const int* ints,
                                     int bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? avc::launch<__nv_bfloat16>(ptrs, ints, st)
              : avc::launch<float>(ptrs, ints, st);
}
