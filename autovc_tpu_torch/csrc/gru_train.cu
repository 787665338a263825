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
// What bounds them on an H100: the recurrences are dependent chains of
// rounds, each a product of B rows (8 on the training path) with up to
// two 512 x 1536 weight blocks (1.5 MB each in bf16), so a round is
// latency-bound (operand loads, products, a grid barrier), never compute-
// or HBM-bound; the saved state (~243 MB per call at 8 x 2475) and the
// streams of the backward must leave and come back through HBM.  The dW
// products are the only dense work (3 x 31 GFLOP at 8 x 2475).  What the
// designs do about it: one persistent cooperative grid, the saved state
// written with streaming stores so it does not evict what stays in L2,
// rows and steps not padded (the TPU's 8-row / 32-step blocks were for
// VMEM).  Both chains are layer-skewed: one round a step for both
// layers, T barriers in all, all rows in one tensor-core pass in bf16,
// each block's weight columns (kernel 4) or rows (kernel 5) resident in
// shared memory, the operands exchanged through a bf16 ring in L2
// (details at kernel 4 and kernel 5 (a) below).  dhp, which the
// recurrence and the dW products both need, is the dxp stream with its n
// lane times the saved r: the recurrence writes it to the ring, the dW
// products form it as they stage.
#include "dw_tiles.cuh"

namespace avc {

// ---------------------------------------------------------------------------
// kernel 4: the forward, layer-skewed
// ---------------------------------------------------------------------------
//
// Layer 1 at step t needs only h1_{t-1}; layer 2 at t needs h1_t (through
// W_ih2x) and h2_{t-1}.  So round s does layer 1 at step s and layer 2 at
// step s - 1, and every operand comes from round s - 1:
//   * round 0: layer 1 at step 0 from xp1_0 alone (h1_{-1} = 0: no
//     product);
//   * round s = 1 .. T: layer 1 at s (s < T) from h1_{s-1} W_hh1; layer 2
//     at s - 1 from h1_{s-1} W_ih2x and h2_{s-2} W_hh2 (the second product
//     from s = 2 on: h2_{-1} = 0);
//   * a grid barrier after rounds 0 .. T - 1: T barriers, where two stages
//     a step took 2 T.
// The arithmetic and rounding are gru_train_pallas._fwd_kernel's: h1 and
// h2 rounded to the compute dtype as product operands, f32 accumulation,
// b_hh inside the reset product (hn = h W_hn + b_hn), the gates and h in
// f32, r, z, n, hn stored in the compute dtype.
//
//   * h1 and h2 pass between rounds through a two-slot ring in L2 in the
//     compute dtype, (2, 2, B, H): round s writes slot s & 1 and reads
//     (s + 1) & 1, with ordinary stores so it stays in L2; hs and acts
//     leave by streaming stores;
//   * a block owns `units` hidden units (a multiple of 8, one n8 tile per
//     8 units and gate) for the whole call: of ONE layer where both
//     layers' blocks fit on the card ("split": 64 + 64 blocks at H = 512,
//     layer 1's first; a layer-1 block runs one product a round, a
//     layer-2 block two), else of both;
//   * bf16: mma.sync m16n8k16 over ceil(rows / 16) M-tiles, rows past the
//     group read as zero.  Of a round's n active products, warp w takes
//     product w % n and, among the warps on it, one contiguous range of
//     its 32-value K chunks, so a warp's partial sums are one (rows x 3
//     gates x 8 units) tile of one product; the K loop is outermost, so
//     each B fragment feeds every M-tile.  A fragments come straight from
//     the ring in L2 (no staging pass, no block barrier before the
//     product).  B is pack_fwd's (3H, H) layout (column c of W
//     contiguous: the col-major B operand), the block's 3 x units columns
//     of each matrix resident in shared memory for the whole call
//     ("mma_smem", pitch H + 32 values: conflict-free 16-byte fragment
//     loads) or read from L2 ("mma_l2");
//   * f32 ("fma"): each product's operand staged 8 rows at a time, FMA
//     dot products by a warp pair per unit over the two halves of K;
//   * the epilogue: thread i owns the (layer, row, unit) items i, i + 256,
//     ..., units fastest; it keeps each item's f32 h_{t-1} and b_hh in
//     registers, sums the warps' partial tiles in a fixed order (no
//     shared-memory atomics: they compile to compare-and-swap loops), and
//     loads the next round's xp1 / base2 slices before the barrier.
// The launch plan (route, split, units, rows per group, shared-memory
// bytes) is ops/gru_train_kernels.py:gru_fwd_plan, the schedule
// gru_fwd_schedule; the kernel recomputes its layout and refuses a plan
// that disagrees.  Batches above one group run the rounds once per row
// group (rows are independent sequences).

constexpr int kGruFwdPitchPad = 32;  // resident weight column pitch H + 32
constexpr int kGruFwdMaxMTiles = 4;  // 16-row M-tiles of one row group
constexpr int kGruFwdMaxItems = 4;   // (layer, row, unit) items a thread
// The products in matrix order: W_hh1 <- h1 (layer 1), W_ih2x <- h1 and
// W_hh2 <- h2 (layer 2).
constexpr int kFwdWhh1 = 0, kFwdWih2x = 1, kFwdWhh2 = 2, kFwdMats = 3;

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
  WT* ring;            // (2, 2, B, H) scratch: h1, h2 by slot
  unsigned int* bar;   // arrival count, 0 at launch
  int T, B, H;
  int units;           // hidden units per block, a multiple of 8
  int rows;            // rows per group
  int mpad;            // rows padded to the row tile (16 mma, 8 fma)
  int resident;        // bf16: the weights live in shared memory
  int split;           // a block holds one layer (else both)
};

// Shared-memory layout in bytes: [resident weight columns (bf16) | f32
// stage and warp sums (fma)], then the partial tiles, each (mpad, 3 gates,
// units) f32: one a warp (mma), or one per K half and matrix (fma).
// gru_fwd_plan computes the same sizes.
__host__ __device__ inline int fwd_block_mats(int split) {
  return split ? 2 : 3;   // the most matrices a block holds
}
__host__ __device__ inline size_t fwd_parts_offset(bool mma, int resident,
                                                   int H, int units,
                                                   int split) {
  if (mma)
    return resident ? (size_t)fwd_block_mats(split) * 3 * units *
                          (H + kGruFwdPitchPad) * 2
                    : 0;
  return ((size_t)kRB * H + kWarps * 3 * kRB) * sizeof(float);
}
__host__ __device__ inline size_t fwd_smem_bytes(bool mma, int resident,
                                                 int H, int units, int mpad,
                                                 int split) {
  const int tiles = mma ? kWarps : kSplit * fwd_block_mats(split);
  return fwd_parts_offset(mma, resident, H, units, split) +
         (size_t)tiles * mpad * 3 * units * sizeof(float);
}

// The schedule.  Layer index 0 is layer 1, 1 is layer 2.  The step layer l finishes in round s (valid when 0 <= step < T).
__device__ __forceinline__ int fwd_step(int l, int s) {
  return l ? s - 1 : s;
}
// Whether round s runs the product of matrix m.
__device__ __forceinline__ bool fwd_job(int m, int s, int T) {
  return m == kFwdWhh1 ? s >= 1 && s < T : m == kFwdWih2x ? s >= 1 : s >= 2;
}
// The ring slot round s writes, the slot it reads (written in round
// s - 1), and the slot of layer 2's h1 (also written in round s - 1); the
// ring entry matrix m multiplies (0: h1, 1: h2).
__device__ __forceinline__ int fwd_write_slot(int s) { return s & 1; }
__device__ __forceinline__ int fwd_read_slot(int s) { return (s + 1) & 1; }
__device__ __forceinline__ int fwd_x_slot(int s) { return fwd_read_slot(s); }
__device__ __forceinline__ int fwd_entry(int m) { return m == kFwdWhh2; }

template <typename WT>
__device__ __forceinline__ const WT* fwd_ring_rows(const GruFwdArgs<WT>& a,
                                                   int slot, int entry,
                                                   int g0) {
  return a.ring + ((size_t)(slot * 2 + entry) * a.B + g0) * a.H;
}

template <typename WT>
__device__ __forceinline__ const WT* fwd_weights(const GruFwdArgs<WT>& a,
                                                 int m) {
  return m == kFwdWhh1 ? a.whh1 : m == kFwdWih2x ? a.wih2x : a.whh2;
}

// What a block owns: units j0 .. j0 + nu - 1 of layers llo .. llo + nl - 1,
// the matrices mlo .. mhi - 1.  Split: layer 1's blocks first.
struct FwdRole {
  int j0, nu, llo, nl, mlo, mhi;
};

template <typename WT>
__device__ __forceinline__ FwdRole fwd_role(const GruFwdArgs<WT>& a) {
  const int per = (a.H + a.units - 1) / a.units;   // blocks per layer
  FwdRole r;
  int b = blockIdx.x;
  r.llo = a.split && b >= per ? 1 : 0;
  r.nl = a.split ? 1 : 2;
  if (a.split) b %= per;
  r.j0 = b * a.units;
  r.nu = min(a.units, a.H - r.j0);
  r.mlo = r.llo ? kFwdWih2x : kFwdWhh1;
  r.mhi = a.split && !r.llo ? kFwdWih2x : kFwdMats;
  return r;
}

// Round s's active products in the block: how many, the matrix of the
// i-th (in matrix order), and the index of matrix m among them.
__device__ __forceinline__ int fwd_jobs(const FwdRole& r, int s, int T) {
  int n = 0;
  for (int m = r.mlo; m < r.mhi; ++m) n += fwd_job(m, s, T) ? 1 : 0;
  return n;
}
__device__ __forceinline__ int fwd_job_matrix(const FwdRole& r, int s,
                                              int T, int i) {
  for (int m = r.mlo; m < r.mhi; ++m) {
    if (fwd_job(m, s, T) && i-- == 0) return m;
  }
  return -1;
}
__device__ __forceinline__ int fwd_job_index(const FwdRole& r, int s, int T,
                                             int m) {
  int i = 0;
  for (int k = r.mlo; k < m; ++k) i += fwd_job(k, s, T) ? 1 : 0;
  return i;
}

// Chunks [lo, hi) of one product into acc (an m16n8 tile per M-tile and
// gate): lane (gid, tq) loads values 8 tq .. 8 tq + 7 of a chunk of its
// two A rows (one 16-byte load each, issued for KB chunks together) and
// of its B column of each gate, and feeds them to two k16 steps as the
// fragment's k = (2 tq, 2 tq + 1, 2 tq + 8, 2 tq + 9): A and B take the
// same permutation of k, so the sum is the same.  W is gate 0's column of
// the lane's unit, gate g's is g * gstride on; values past H, rows past
// the group and units past the block read as zero.
template <int MT>
__device__ __forceinline__ void fwd_chunks_mma(const __nv_bfloat16* A,
                                               int H, int rows_g,
                                               const __nv_bfloat16* W,
                                               size_t gstride, bool resident,
                                               bool u_ok, int lo, int hi,
                                               float (&acc)[MT][3][4]) {
  constexpr int KB = MT == 1 ? 8 : MT == 2 ? 4 : 2;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tq = lane & 3;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
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
            ? __ldcg(reinterpret_cast<const uint4*>(A + (size_t)rlo * H + k))
            : zero;
        x[q][mt][1] = in && rhi < rows_g
            ? __ldcg(reinterpret_cast<const uint4*>(A + (size_t)rhi * H + k))
            : zero;
      }
    }
#pragma unroll
    for (int q = 0; q < KB; ++q) {
      if (c + q >= hi) break;
      const int k = (c + q) * 32 + 8 * tq;
      const bool in = k < H && u_ok;
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const uint4 b = in ? ld_w16(W + g * gstride + k, resident) : zero;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint4* xm = x[q][mt];
          const uint32_t s0[4] = {xm[0].x, xm[1].x, xm[0].y, xm[1].y};
          const uint32_t s1[4] = {xm[0].z, xm[1].z, xm[0].w, xm[1].w};
          mma_bf16(acc[mt][g], s0, b.x, b.y);
          mma_bf16(acc[mt][g], s1, b.z, b.w);
        }
      }
    }
  }
}

// The bf16 products of round s: this warp's chunk range of its product
// (n > 0 active), every column group, each partial tile to parts[warp].
template <int MT>
__device__ void fwd_product_mma(const GruFwdArgs<__nv_bfloat16>& a,
                                const FwdRole& r, int s, int n, int g0,
                                int rows_g, const __nv_bfloat16* wsm,
                                float* parts) {
  const int H = a.H, U = a.units, nch = (H + 31) / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tq = lane & 3;
  const int i = warp % n, m = fwd_job_matrix(r, s, a.T, i);
  const int cnt = (kWarps - i + n - 1) / n, rank = warp / n;
  const int c0 = rank * nch / cnt, c1 = (rank + 1) * nch / cnt;
  const __nv_bfloat16* A = fwd_ring_rows(
      a, m == kFwdWih2x ? fwd_x_slot(s) : fwd_read_slot(s), fwd_entry(m), g0);
  const size_t wp = a.resident ? (size_t)H + kGruFwdPitchPad : (size_t)H;
  float* tile = parts + (size_t)warp * a.mpad * 3 * U;
  for (int cg = 0; cg < U / 8; ++cg) {
    const int u = cg * 8 + gid;   // this lane's B column (unit)
    const __nv_bfloat16* W =
        a.resident ? wsm + ((size_t)(m - r.mlo) * 3 * U + u) * wp
                   : fwd_weights(a, m) + (size_t)(r.j0 + u) * H;
    const size_t gstride = a.resident ? (size_t)U * wp : (size_t)H * H;
    float acc[MT][3][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int g = 0; g < 3; ++g) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][g][e] = 0.0f;
      }
    }
    fwd_chunks_mma<MT>(A, H, rows_g, W, gstride, a.resident, u < r.nu, c0,
                       c1, acc);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int rlo = mt * 16 + gid;
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        float* p = tile + g * U + cg * 8 + 2 * tq;
        *reinterpret_cast<float2*>(p + (size_t)rlo * 3 * U) =
            make_float2(acc[mt][g][0], acc[mt][g][1]);
        *reinterpret_cast<float2*>(p + (size_t)(rlo + 8) * 3 * U) =
            make_float2(acc[mt][g][2], acc[mt][g][3]);
      }
    }
  }
}

// The f32 products of round s: each product's operand staged 8 rows at a
// time, a warp pair (the two halves of K) per unit over its 3 gate
// columns; the pair's sums go to parts[(part, matrix)].
__device__ void fwd_product_fma(const GruFwdArgs<float>& a, const FwdRole& r,
                                int s, int g0, int rows_g, float* stage,
                                float* red, float* parts) {
  const int H = a.H, U = a.units, nm = r.mhi - r.mlo;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp % kUnits, part = warp / kUnits;
  const int kpart = H / kSplit, k0 = part * kpart;
  constexpr int V = 3 * kRB;
  for (int m = r.mlo; m < r.mhi; ++m) {
    if (!fwd_job(m, s, a.T)) continue;
    const float* A = fwd_ring_rows(
        a, m == kFwdWih2x ? fwd_x_slot(s) : fwd_read_slot(s), fwd_entry(m),
        g0);
    const float* W = fwd_weights(a, m);
    float* tile = parts + (size_t)(part * nm + m - r.mlo) * a.mpad * 3 * U;
    for (int r0 = 0; r0 < rows_g; r0 += kRB) {
      const int nr = min(kRB, rows_g - r0);
      stage_rows(stage, A, r0, nr, H);
      __syncthreads();
      for (int u = slot; u < r.nu; u += kUnits) {
        const int j = r.j0 + u;
        float acc[3][kRB] = {};
        const float* const w[3] = {W + (size_t)j * H, W + (size_t)(H + j) * H,
                                   W + (size_t)(2 * H + j) * H};
        warp_dot(w, stage, H, k0, k0 + kpart, nr, acc);
        float v[V];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
#pragma unroll
          for (int i = 0; i < kRB; ++i) v[g * kRB + i] = acc[g][i];
        }
        float* rw = red + warp * V;
        warp_sum_to_smem(v, rw);
        if (lane < nr) {
#pragma unroll
          for (int g = 0; g < 3; ++g)
            tile[(size_t)(r0 + lane) * 3 * U + g * U + u] = rw[g * kRB + lane];
        }
        __syncwarp();
      }
      __syncthreads();
    }
  }
}

// A product's sum at one (row, gate, unit) from its partial tiles p[i *
// tile], in a fixed order: mma: the warps on it, i = first, first + step,
// ... (first: its index among the round's step active products); fma: its
// two K halves, i = k * step + first (first: its matrix in the block,
// step: the block's matrices).
template <bool kMma>
__device__ __forceinline__ float fwd_part_sum(const float* p, size_t tile,
                                              int first, int step) {
  float sum = 0.0f;
  if constexpr (kMma) {
    for (int w = first; w < kWarps; w += step) sum += p[w * tile];
  } else {
#pragma unroll
    for (int k = 0; k < kSplit; ++k) sum += p[(k * step + first) * tile];
  }
  return sum;
}

// An item's input-side pre-activations of the round ahead (xp1_t for
// layer 1, base2_t for layer 2), each read once.
struct GruFwdIn {
  float x[3];
};

template <typename WT>
__device__ __forceinline__ void fwd_load_inputs(
    const GruFwdArgs<WT>& a, const FwdRole& r, int s, int g0,
    const bool (&ok)[kGruFwdMaxItems], const int (&pli)[kGruFwdMaxItems],
    const int (&prow)[kGruFwdMaxItems], const int (&punit)[kGruFwdMaxItems],
    GruFwdIn (&in)[kGruFwdMaxItems]) {
  const int H = a.H;
#pragma unroll
  for (int k = 0; k < kGruFwdMaxItems; ++k) {
    const int l = r.llo + pli[k], t = fwd_step(l, s);
    if (ok[k] && t >= 0 && t < a.T) {
      const float* x = (l ? a.base2 : a.xp1) +
                       ((size_t)t * a.B + g0 + prow[k]) * 3 * H + r.j0 +
                       punit[k];
#pragma unroll
      for (int g = 0; g < 3; ++g) in[k].x[g] = __ldcs(x + g * H);
    }
  }
}

// One GRU cell of layer l at step t, row `row`, unit j, from its input
// part xp and hidden part hp (b_hh included): h (f32) and r, z, n, hn by
// streaming stores, h in the compute dtype to ring slot ws.  Returns h.
template <typename WT>
__device__ __forceinline__ float fwd_cell(const GruFwdArgs<WT>& a, int l,
                                          int t, int row, int j,
                                          const float (&xp)[3],
                                          const float (&hp)[3], float h_prev,
                                          int ws) {
  const int H = a.H;
  const float r = sigmoidf_(xp[0] + hp[0]);
  const float z = sigmoidf_(xp[1] + hp[1]);
  const float n = tanhf(xp[2] + r * hp[2]);
  const float h = (1.0f - z) * n + z * h_prev;
  const size_t at = (((size_t)l * a.T + t) * a.B + row) * H;
  store_cs(a.hs + at + j, h);
  WT* act = a.acts + at * 4 + j;
  store_cs(act, r);
  store_cs(act + H, z);
  store_cs(act + 2 * H, n);
  store_cs(act + 3 * H, hp[2]);
  a.ring[((size_t)(ws * 2 + l) * a.B + row) * H + j] = from_float<WT>(h);
  return h;
}

template <typename WT, int MT>
__global__ void __launch_bounds__(kThreads, 1)
    gru_train_fwd_kernel(GruFwdArgs<WT> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool kMma = sizeof(WT) == 2;
  constexpr int P = kGruFwdMaxItems;
  const int H = a.H, T = a.T, U = a.units;
  const FwdRole r = fwd_role(a);
  WT* wsm = reinterpret_cast<WT*>(smem_raw);
  float* stage = reinterpret_cast<float*>(smem_raw);
  float* parts = reinterpret_cast<float*>(
      smem_raw + fwd_parts_offset(kMma, a.resident, H, U, a.split));
  if constexpr (kMma) {
    if (a.resident) {   // this block's 3 x units columns of its matrices
      const int vec = H / 8, pitch = H + kGruFwdPitchPad;
      for (int i = threadIdx.x; i < (r.mhi - r.mlo) * 3 * U * vec;
           i += kThreads) {
        const int v = i % vec, row = i / vec, u = row % U;
        const int g = row / U % 3, m = r.mlo + row / (3 * U);
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (u < r.nu)
          x = __ldg(reinterpret_cast<const uint4*>(
                        fwd_weights(a, m) + ((size_t)g * H + r.j0 + u) * H) +
                    v);
        *reinterpret_cast<uint4*>(wsm + (size_t)row * pitch + 8 * v) = x;
      }
      __syncthreads();
    }
  }
  const int MU = a.mpad * U;
  int pli[P], prow[P], punit[P];
  bool pin[P];      // the item lies in the padded tile and in this block
  float bhh[P][3];  // the item's b_hh
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int p = threadIdx.x + k * kThreads;
    pli[k] = p / MU;
    prow[k] = p % MU / U;
    punit[k] = p % U;
    pin[k] = pli[k] < r.nl && punit[k] < r.nu;
    const float* b = r.llo + pli[k] ? a.bhh2 : a.bhh1;
#pragma unroll
    for (int g = 0; g < 3; ++g)
      bhh[k][g] = pin[k] ? __ldg(b + g * H + r.j0 + punit[k]) : 0.0f;
  }
  unsigned int nbar = 0;   // grid barriers passed
  for (int g0 = 0; g0 < a.B; g0 += a.rows) {
    const int rows_g = min(a.rows, a.B - g0);
    bool ok[P];
    float h_prev[P];   // h_{t-1} of the item's layer
    GruFwdIn in[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      ok[k] = pin[k] && prow[k] < rows_g;
      h_prev[k] = 0.0f;
    }
    fwd_load_inputs(a, r, 0, g0, ok, pli, prow, punit, in);
    for (int s = 0; s <= T; ++s) {
      const int n = fwd_jobs(r, s, T);
      if constexpr (kMma) {
        if (n > 0) fwd_product_mma<MT>(a, r, s, n, g0, rows_g, wsm, parts);
      } else {
        fwd_product_fma(a, r, s, g0, rows_g, stage, stage + kRB * H, parts);
      }
      __syncthreads();
      // each layer's products: their partial tiles' first index and step
      const int step = kMma ? n : r.mhi - r.mlo;
      const int fx = kMma ? fwd_job_index(r, s, T, kFwdWih2x)
                          : kFwdWih2x - r.mlo;
      const int fh2 = kMma ? fwd_job_index(r, s, T, kFwdWhh2)
                           : kFwdWhh2 - r.mlo;
      const bool jh1 = fwd_job(kFwdWhh1, s, T), jx = fwd_job(kFwdWih2x, s, T),
                 jh2 = fwd_job(kFwdWhh2, s, T);
      const size_t tile = (size_t)a.mpad * 3 * U;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int l = r.llo + pli[k], t = fwd_step(l, s);
        if (!ok[k] || t < 0 || t >= T) continue;
        const int row = prow[k], u = punit[k];
        const float* p = parts + (size_t)row * 3 * U + u;
        float xp[3], hp[3];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          xp[g] = in[k].x[g];
          float h = 0.0f;
          if (l == 0) {
            // layer 1's one product is W_hh1, the block's first (fh1 = 0)
            if (jh1) h = fwd_part_sum<kMma>(p + g * U, tile, 0, step);
          } else {
            if (jx) xp[g] += fwd_part_sum<kMma>(p + g * U, tile, fx, step);
            if (jh2) h = fwd_part_sum<kMma>(p + g * U, tile, fh2, step);
          }
          hp[g] = h + bhh[k][g];
        }
        h_prev[k] = fwd_cell(a, l, t, g0 + row, r.j0 + u, xp, hp, h_prev[k],
                             fwd_write_slot(s));
      }
      if (s < T) {
        // the next round's inputs, in flight across the barrier
        fwd_load_inputs(a, r, s + 1, g0, ok, pli, prow, punit, in);
        grid_sync_count(a.bar, nbar);
      }
    }
    __syncthreads();   // the last epilogue's reads of parts
  }
}

// ---------------------------------------------------------------------------
// kernel 5 (a): the reverse-time chain, layer-skewed
// ---------------------------------------------------------------------------
//
// Layer 2's chain never reads layer 1: at step t it needs only dh2s[t] and,
// from itself at t + 1, dh2 z2 + dhp2 W_hh2^T.  Layer 1 at t needs dxp2_t
// W_ih2x^T (layer 2 at t) and dhp1_{t+1} W_hh1^T (itself at t + 1).  So
// round s does layer 2 at t = T - 1 - s and layer 1 at t + 1 = T - s, and
// every operand comes from round s - 1:
//   * round 0 (the prologue): layer 2 at T - 1, from its cotangent alone;
//   * round s = 1 .. T: layer 2 at T - 1 - s (s < T), from dhp2_{t+1}
//     W_hh2^T; layer 1 at T - s, from dxp2_{T-s} W_ih2x^T + dhp1_{T-s+1}
//     W_hh1^T (the second product from s = 2 on);
//   * a grid barrier after rounds 0 .. T - 1: T barriers, where a round per
//     (step, layer) took 2 T - 1.
// The arithmetic and operand rounding of each value are those of
// gru_train_pallas._bwd_kernel: dxp2, dhp2 and dhp1 rounded to the compute
// dtype as product operands, f32 accumulation, gate derivatives in f32.
//
//   * dxp2, dhp1 and dhp2 pass between rounds through a two-slot ring in L2
//     in the compute dtype, (2, 3, B, 3H): round s writes slot s & 1 and
//     reads (s + 1) & 1, written with ordinary stores so it stays in L2;
//     the f32 outputs dxp1, dxp2 (also the dW products' inputs) leave by
//     streaming stores;
//   * a block owns `units` hidden units (a multiple of 8, one n8 tile per
//     8) for the whole call: of ONE layer where both layers' blocks fit on
//     the card ("split": 64 + 64 blocks at H = 512; a layer-1 block runs
//     two products a round, a layer-2 block one), else of both;
//   * bf16: mma.sync m16n8k16 over ceil(rows / 16) M-tiles, rows past the
//     group read as zero.  The round's products are a list of 32-value K
//     chunks (48 per product at H = 512), split in 8 contiguous ranges,
//     one a warp; the K loop is outermost, so each B fragment feeds every
//     M-tile.  B is the param-layout weight row (row j = unit j's 3H
//     weights: the col-major B operand), resident in shared memory for the
//     whole call ("mma_smem", pitch 3H + 32 values: conflict-free 16-byte
//     fragment loads) or read from L2 ("mma_l2");
//   * f32 ("fma"): each product's operand staged 8 rows at a time, FMA dot
//     products by a warp pair per unit over the two halves of K;
//   * the epilogue: thread i owns the (layer, row, unit) items i, i + 256,
//     ..., units fastest; it keeps each item's carried dh z in a register,
//     sums the warps' partial tiles in a fixed order (no shared-memory
//     atomics: they compile to compare-and-swap loops), and loads the next
//     round's saved r, z, n, hn, h_{t-1} and cotangent before the barrier.
// Kernel 7's product (lstm_train.cu:bwd_product_mma) is not shared: it
// runs the M-tiles outermost and feeds two weight matrices from one A
// operand, where this round feeds each matrix its own A; sharing it would
// change kernel 7's loop order and its measured times (a separate
// redesign).
// The launch plan (route, split, units, rows per group, shared-memory
// bytes) is ops/gru_train_kernels.py:gru_bwd_plan; the kernel recomputes
// its layout and refuses a plan that disagrees.  Batches above one group
// run the rounds once per row group (rows are independent sequences).

constexpr int kBwdPitchPad = 32;    // resident weight row pitch 3H + 32
constexpr int kBwdMaxMTiles = 4;    // 16-row M-tiles of one row group
constexpr int kBwdMaxPairs = 4;     // (layer, row, unit) items a thread
// Matrix m multiplies ring entry m: W_ih2x <- dxp2 and W_hh1 <- dhp1
// (layer 1's dh), W_hh2 <- dhp2 (layer 2's).
constexpr int kMatX = 0, kMatH1 = 1, kMatH2 = 2, kMats = 3;

template <typename WT>
struct GruBwdArgs {
  const WT* acts;      // (2, T, B, 4H): saved r, z, n, hn
  const float* hs;     // (2, T, B, H): saved h1, h2
  const float* dh1s;   // (T, B, H): cotangent of h1
  const float* dh2s;   // (T, B, H): cotangent of h2
  const WT* wih2x;     // (H, 3H) in the param layout (row j = unit j's 3H
  const WT* whh1;      //   weights, contiguous)
  const WT* whh2;
  float* dxp1;         // (T, B, 3H) out
  float* dxp2;         // (T, B, 3H) out: dbase2
  WT* ring;            // (2, 3, B, 3H) scratch: dxp2, dhp1, dhp2 by slot
  unsigned int* bar;   // arrival count, 0 at launch
  int T, B, H;
  int units;           // hidden units per block, a multiple of 8
  int rows;            // rows per group
  int mpad;            // rows padded to the row tile (16 mma, 8 fma)
  int resident;        // bf16: the weights live in shared memory
  int split;           // a block holds one layer (else both)
};

// Shared-memory layout in bytes: [resident weight rows (bf16) | f32 stage
// and warp sums (f32)], then the partial sums (parts, 8 warps or kSplit
// halves of them, each (layers, mpad, units) f32).  gru_bwd_plan computes
// the same sizes.
__host__ __device__ inline int bwd_block_layers(int split) {
  return split ? 1 : 2;
}
__host__ __device__ inline size_t bwd_parts_offset(bool mma, int resident,
                                                   int H, int units,
                                                   int split) {
  const size_t K = 3 * (size_t)H;
  if (mma)
    return resident ? (size_t)(split ? 2 : 3) * units * (K + kBwdPitchPad) * 2
                    : 0;
  return ((size_t)kRB * K + kWarps * kRB) * sizeof(float);
}
__host__ __device__ inline size_t bwd_smem_bytes(bool mma, int resident,
                                                 int H, int units, int mpad,
                                                 int split) {
  const int nparts = mma ? kWarps : kSplit;
  return bwd_parts_offset(mma, resident, H, units, split) +
         (size_t)nparts * bwd_block_layers(split) * mpad * units *
             sizeof(float);
}

// The schedule.  Layer index 0 is layer 1, 1 is layer 2.
__device__ __forceinline__ int bwd_layer(int m) { return m == kMatH2; }
// The step layer l finishes in round s (valid when 0 <= step < T).
__device__ __forceinline__ int bwd_step(int l, int s, int T) {
  return l ? T - 1 - s : T - s;
}
// Whether round s runs the product of matrix m.
__device__ __forceinline__ bool bwd_job(int m, int s, int T) {
  return m == kMatX ? s >= 1 : m == kMatH1 ? s >= 2 : s >= 1 && s < T;
}
// The ring slot round s writes, the slot it reads (written in round
// s - 1), and the slot of layer 1's dxp2 (also written in round s - 1).
__device__ __forceinline__ int bwd_write_slot(int s) { return s & 1; }
__device__ __forceinline__ int bwd_read_slot(int s) { return (s + 1) & 1; }
__device__ __forceinline__ int bwd_x_slot(int s) { return bwd_read_slot(s); }

template <typename WT>
__device__ __forceinline__ WT* ring_entry(const GruBwdArgs<WT>& a, int slot,
                                          int m, int row) {
  return a.ring + ((size_t)(slot * kMats + m) * a.B + row) * 3 * a.H;
}

template <typename WT>
__device__ __forceinline__ const WT* bwd_weights(const GruBwdArgs<WT>& a,
                                                 int m) {
  return m == kMatX ? a.wih2x : m == kMatH1 ? a.whh1 : a.whh2;
}

// What a block owns: units j0 .. j0 + nu - 1 of layers llo .. llo + nl - 1,
// the matrices mlo .. mhi - 1.  Split: layer 2's blocks first.
struct BwdRole {
  int j0, nu, llo, nl, mlo, mhi;
};

template <typename WT>
__device__ __forceinline__ BwdRole bwd_role(const GruBwdArgs<WT>& a) {
  const int per = (a.H + a.units - 1) / a.units;   // blocks per layer
  BwdRole r;
  int b = blockIdx.x;
  r.llo = a.split && b < per ? 1 : 0;
  r.nl = bwd_block_layers(a.split);
  if (a.split) b %= per;
  r.j0 = b * a.units;
  r.nu = min(a.units, a.H - r.j0);
  r.mlo = r.llo ? kMatH2 : kMatX;
  r.mhi = r.llo + r.nl - 1 ? kMats : kMatH2;
  return r;
}

// Chunks [lo, hi) of one product into acc (one m16n8 tile per M-tile):
// lane (gid, tq) loads values 8 tq .. 8 tq + 7 of a chunk of its two A
// rows and of its B row (one 16-byte load each) and feeds them to two k16
// steps as the fragment's k = (2 tq, 2 tq + 1, 2 tq + 8, 2 tq + 9): A and
// B take the same permutation of k, so the sum is the same.  KB chunks'
// loads are issued together; values past K and rows past the group read
// as zero.
template <int MT>
__device__ __forceinline__ void bwd_chunks_mma(const __nv_bfloat16* A,
                                               int K, int rows_g,
                                               const __nv_bfloat16* W,
                                               bool resident, bool u_ok,
                                               int lo, int hi,
                                               float (&acc)[MT][4]) {
  constexpr int KB = MT == 1 ? 8 : MT == 2 ? 4 : 2;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tq = lane & 3;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int c = lo; c < hi; c += KB) {
    uint4 x[KB][MT][2], y[KB];
#pragma unroll
    for (int q = 0; q < KB; ++q) {
      const int k = (c + q) * 32 + 8 * tq;
      const bool in = c + q < hi && k < K;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int rlo = mt * 16 + gid, rhi = rlo + 8;
        x[q][mt][0] = in && rlo < rows_g
            ? __ldcg(reinterpret_cast<const uint4*>(A + (size_t)rlo * K + k))
            : zero;
        x[q][mt][1] = in && rhi < rows_g
            ? __ldcg(reinterpret_cast<const uint4*>(A + (size_t)rhi * K + k))
            : zero;
      }
      y[q] = in && u_ok ? ld_w16(W + k, resident) : zero;
    }
#pragma unroll
    for (int q = 0; q < KB; ++q) {
      if (c + q >= hi) break;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint4* xa = x[q][mt];
        const uint32_t s0[4] = {xa[0].x, xa[1].x, xa[0].y, xa[1].y};
        const uint32_t s1[4] = {xa[0].z, xa[1].z, xa[0].w, xa[1].w};
        mma_bf16(acc[mt], s0, y[q].x, y[q].y);
        mma_bf16(acc[mt], s1, y[q].z, y[q].w);
      }
    }
  }
}

// The bf16 products of round s for n8 tile cg of the block's units: this
// warp's range of the round's K chunks (the active products' chunk lists,
// in matrix order) into acc[li] (li: the block's layer).
template <int MT>
__device__ void bwd_product_mma(const GruBwdArgs<__nv_bfloat16>& a,
                                const BwdRole& r, int s, int g0, int rows_g,
                                int cg, const __nv_bfloat16* wsm,
                                float (&acc)[2][MT][4]) {
  using WT = __nv_bfloat16;
  const int K = 3 * a.H, nch = (K + 31) / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int li = 0; li < 2; ++li) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[li][mt][e] = 0.0f;
    }
  }
  int jobs = 0;
  for (int m = r.mlo; m < r.mhi; ++m) jobs += bwd_job(m, s, a.T) ? 1 : 0;
  const int n = jobs * nch;
  const int c0 = warp * n / kWarps, c1 = (warp + 1) * n / kWarps;
  const int u = cg * 8 + (lane >> 2);   // this lane's B row (unit)
  const size_t wp = a.resident ? (size_t)K + kBwdPitchPad : (size_t)K;
  int base = 0;
  for (int m = r.mlo; m < r.mhi; ++m) {
    if (!bwd_job(m, s, a.T)) continue;
    const int lo = max(c0, base) - base, hi = min(c1, base + nch) - base;
    base += nch;
    if (lo >= hi) continue;
    const int slot = m == kMatX ? bwd_x_slot(s) : bwd_read_slot(s);
    const WT* A = ring_entry(a, slot, m, g0);
    const WT* W = a.resident
        ? wsm + (size_t)(m - r.mlo) * a.units * wp + (size_t)u * wp
        : bwd_weights(a, m) + (size_t)(r.j0 + u) * K;
    if (bwd_layer(m) == r.llo)
      bwd_chunks_mma<MT>(A, K, rows_g, W, a.resident, u < r.nu, lo, hi,
                         acc[0]);
    else
      bwd_chunks_mma<MT>(A, K, rows_g, W, a.resident, u < r.nu, lo, hi,
                         acc[1]);
  }
}

// The f32 products of round s: each product's operand staged 8 rows at a
// time, a warp pair (the two halves of K) per unit; the pair's sums are
// added to parts[(part * nl + li) ...] (layer 1's two products in matrix
// order).
__device__ void bwd_product_fma(const GruBwdArgs<float>& a, const BwdRole& r,
                                int s, int g0, int rows_g, float* stage,
                                float* red, float* parts) {
  const int K = 3 * a.H, U = a.units;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp % kUnits, part = warp / kUnits;
  const int kpart = K / kSplit, k0 = part * kpart;
  for (int i = threadIdx.x; i < kSplit * r.nl * a.mpad * U; i += kThreads)
    parts[i] = 0.0f;
  for (int m = r.mlo; m < r.mhi; ++m) {
    if (!bwd_job(m, s, a.T)) continue;
    const int li = bwd_layer(m) - r.llo;
    const float* A = ring_entry(
        a, m == kMatX ? bwd_x_slot(s) : bwd_read_slot(s), m, g0);
    const float* W = bwd_weights(a, m);
    for (int r0 = 0; r0 < rows_g; r0 += kRB) {
      const int nr = min(kRB, rows_g - r0);
      stage_rows(stage, A, r0, nr, K);
      __syncthreads();
      for (int u = slot; u < r.nu; u += kUnits) {
        float acc[1][kRB] = {};
        const float* const w[1] = {W + (size_t)(r.j0 + u) * K};
        warp_dot(w, stage, K, k0, k0 + kpart, nr, acc);
        float v[kRB];
#pragma unroll
        for (int i = 0; i < kRB; ++i) v[i] = acc[0][i];
        float* rw = red + warp * kRB;
        warp_sum_to_smem(v, rw);
        if (lane < nr)
          parts[((size_t)(part * r.nl + li) * a.mpad + r0 + lane) * U + u] +=
              rw[lane];
        __syncwarp();
      }
      __syncthreads();
    }
  }
}

// The saved forward state one gate-derivative update reads: layer l, step
// t, row `row`, unit j (dy: the cotangent of h).
struct GruIn {
  float r, z, n, hn, hp, dy;
};

template <typename WT>
__device__ __forceinline__ GruIn load_gru_in(const GruBwdArgs<WT>& a, int l,
                                             int t, int row, int j) {
  const int H = a.H;
  const size_t BH = (size_t)a.B * H;
  const size_t at = ((size_t)l * a.T + t) * BH + (size_t)row * H;
  const WT* ac = a.acts + at * 4 + j;
  GruIn in;
  in.r = ld_stream(ac);
  in.z = ld_stream(ac + H);
  in.n = ld_stream(ac + 2 * H);
  in.hn = ld_stream(ac + 3 * H);
  in.hp = t > 0 ? __ldcs(a.hs + at - BH + j) : 0.0f;
  in.dy = __ldcs((l ? a.dh2s : a.dh1s) + (size_t)t * BH + (size_t)row * H +
                 j);
  return in;
}

// Gate derivatives (da_r, da_z, da_n) of one item given its total dh
// (arithmetic and order of gru_train_pallas._bwd_kernel); returns dh z,
// the part of the earlier step's dh that does not go through W_hh.
__device__ __forceinline__ float gate_grads(const GruIn& in, float dh,
                                            float (&d)[3]) {
  const float r = in.r, z = in.z, n = in.n;
  const float da_n = dh * (1.0f - z) * (1.0f - n * n);
  const float da_z = dh * (in.hp - n) * z * (1.0f - z);
  d[0] = da_n * in.hn * r * (1.0f - r);
  d[1] = da_z;
  d[2] = da_n;
  return dh * z;
}

// dxp of (l, t, row), unit j: f32 by streaming stores, and into ring slot
// bwd_write_slot(s) as dhp (the n lane times r) and, for layer 2, dxp.
template <typename WT>
__device__ __forceinline__ void store_grads(const GruBwdArgs<WT>& a, int l,
                                            int t, int s, int row, int j,
                                            const float (&d)[3], float r) {
  const int H = a.H;
  float* o = (l ? a.dxp2 : a.dxp1) + ((size_t)t * a.B + row) * 3 * H + j;
  __stcs(o, d[0]);
  __stcs(o + H, d[1]);
  __stcs(o + 2 * H, d[2]);
  const int ws = bwd_write_slot(s);
  WT* p = ring_entry(a, ws, l ? kMatH2 : kMatH1, row) + j;
  p[0] = from_float<WT>(d[0]);
  p[H] = from_float<WT>(d[1]);
  p[2 * H] = from_float<WT>(d[2] * r);
  if (l) {
    WT* x = ring_entry(a, ws, kMatX, row) + j;
    x[0] = from_float<WT>(d[0]);
    x[H] = from_float<WT>(d[1]);
    x[2 * H] = from_float<WT>(d[2]);
  }
}

// The epilogue inputs of round s for this thread's items.
template <typename WT>
__device__ __forceinline__ void load_round_inputs(
    const GruBwdArgs<WT>& a, const BwdRole& r, int s, int g0,
    const bool (&ok)[kBwdMaxPairs], const int (&pli)[kBwdMaxPairs],
    const int (&prow)[kBwdMaxPairs], const int (&punit)[kBwdMaxPairs],
    GruIn (&in)[kBwdMaxPairs]) {
#pragma unroll
  for (int k = 0; k < kBwdMaxPairs; ++k) {
    const int l = r.llo + pli[k], t = bwd_step(l, s, a.T);
    if (ok[k] && t >= 0 && t < a.T)
      in[k] = load_gru_in(a, l, t, g0 + prow[k], r.j0 + punit[k]);
  }
}

template <typename WT, int MT>
__global__ void __launch_bounds__(kThreads, 1)
    gru_train_bwd_kernel(GruBwdArgs<WT> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool kMma = sizeof(WT) == 2;
  constexpr int P = kBwdMaxPairs;
  const int H = a.H, T = a.T, K = 3 * H, U = a.units;
  const BwdRole r = bwd_role(a);
  WT* wsm = reinterpret_cast<WT*>(smem_raw);
  float* stage = reinterpret_cast<float*>(smem_raw);
  float* parts = reinterpret_cast<float*>(
      smem_raw + bwd_parts_offset(kMma, a.resident, H, U, a.split));
  const int nparts = kMma ? kWarps : kSplit;
  if constexpr (kMma) {
    if (a.resident) {   // this block's rows of its matrices
      const int vec = K / 8, pitch = K + kBwdPitchPad;
      for (int i = threadIdx.x; i < (r.mhi - r.mlo) * U * vec;
           i += kThreads) {
        const int v = i % vec, row = i / vec, u = row % U;
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (u < r.nu)
          x = __ldg(reinterpret_cast<const uint4*>(
                        bwd_weights(a, r.mlo + row / U) +
                        (size_t)(r.j0 + u) * K) + v);
        *reinterpret_cast<uint4*>(wsm + (size_t)row * pitch + 8 * v) = x;
      }
      __syncthreads();
    }
  }
  const int MU = a.mpad * U;
  int pli[P], prow[P], punit[P];
  bool pin[P];   // the item lies in the padded tile and in this block
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int p = threadIdx.x + k * kThreads;
    pli[k] = p / MU;
    prow[k] = p % MU / U;
    punit[k] = p % U;
    pin[k] = pli[k] < r.nl && punit[k] < r.nu;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned int nbar = 0;   // barriers passed
  for (int g0 = 0; g0 < a.B; g0 += a.rows) {
    const int rows_g = min(a.rows, a.B - g0);
    bool ok[P];
    float carry[P];   // dh z of the item's layer, handed to its next step
    GruIn in[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      ok[k] = pin[k] && prow[k] < rows_g;
      carry[k] = 0.0f;
    }
    load_round_inputs(a, r, 0, g0, ok, pli, prow, punit, in);
    for (int s = 0; s <= T; ++s) {
      if constexpr (kMma) {
        for (int cg = 0; cg < U / 8; ++cg) {
          float acc[2][MT][4];
          bwd_product_mma<MT>(a, r, s, g0, rows_g, cg, wsm, acc);
          const int gid = lane >> 2, tq = lane & 3;
#pragma unroll
          for (int li = 0; li < 2; ++li) {
            if (li >= r.nl) break;
            float* p = parts + (size_t)(warp * r.nl + li) * MU + cg * 8 +
                       2 * tq;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              const int rlo = mt * 16 + gid, rhi = rlo + 8;
              p[rlo * U] = acc[li][mt][0];
              p[rlo * U + 1] = acc[li][mt][1];
              p[rhi * U] = acc[li][mt][2];
              p[rhi * U + 1] = acc[li][mt][3];
            }
          }
        }
      } else {
        bwd_product_fma(a, r, s, g0, rows_g, stage, stage + kRB * K, parts);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int l = r.llo + pli[k], t = bwd_step(l, s, T);
        if (!ok[k] || t < 0 || t >= T) continue;
        float dh_prod = 0.0f;
        for (int p = 0; p < nparts; ++p)
          dh_prod += parts[((size_t)(p * r.nl + pli[k]) * a.mpad + prow[k]) *
                               U + punit[k]];
        const float dh = in[k].dy + (carry[k] + dh_prod);
        float d[3];
        carry[k] = gate_grads(in[k], dh, d);
        store_grads(a, l, t, s, g0 + prow[k], r.j0 + punit[k], d, in[k].r);
      }
      if (s < T) {
        // the next round's inputs, in flight across the barrier
        load_round_inputs(a, r, s + 1, g0, ok, pli, prow, punit, in);
        grid_sync_count(a.bar, nbar);
      }
    }
    __syncthreads();   // the last epilogue's reads of parts
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

// Kernel 4 on the plan of gru_fwd_plan (route, split, units per block,
// rows per group, shared-memory bytes: checked against the kernel's own
// layout).
template <typename WT>
static int fwd_launch(const void* xp1, const void* base2, const void* whh1,
                      const void* wih2x, const void* whh2, const void* bhh1,
                      const void* bhh2, void* hs, void* acts, void* ring,
                      void* bar, int T, int B, int H, int units, int rows,
                      int resident, int split, int smem_bytes,
                      cudaStream_t stream) {
  constexpr bool mma = sizeof(WT) == 2;
  if (T < 1 || B < 1 || H % 16 || units < 8 || units % 8 || rows < 1 ||
      (resident && !mma))
    return cudaErrorInvalidValue;
  const int tile = mma ? 16 : kRB;
  const int mpad = (rows + tile - 1) / tile * tile;
  if (mpad > 16 * kGruFwdMaxMTiles ||
      (split ? 1 : 2) * mpad * units > kGruFwdMaxItems * kThreads)
    return cudaErrorInvalidValue;
  const size_t smem = fwd_smem_bytes(mma, resident, H, units, mpad, split);
  if (smem != (size_t)smem_bytes) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int blocks = (split ? 2 : 1) * ((H + units - 1) / units);
  if (blocks > sms) return cudaErrorInvalidValue;   // every unit needs a block
  GruFwdArgs<WT> a{static_cast<const float*>(xp1),
                   static_cast<const float*>(base2),
                   static_cast<const WT*>(whh1), static_cast<const WT*>(wih2x),
                   static_cast<const WT*>(whh2),
                   static_cast<const float*>(bhh1),
                   static_cast<const float*>(bhh2), static_cast<float*>(hs),
                   static_cast<WT*>(acts), static_cast<WT*>(ring),
                   static_cast<unsigned int*>(bar), T, B, H, units, rows,
                   mpad, resident, split};
  if constexpr (!mma) {
    return launch_cooperative(gru_train_fwd_kernel<WT, 1>, a, blocks, smem,
                              stream);
  } else {
    switch (mpad / 16) {
      case 1:
        return launch_cooperative(gru_train_fwd_kernel<WT, 1>, a, blocks,
                                  smem, stream);
      case 2:
        return launch_cooperative(gru_train_fwd_kernel<WT, 2>, a, blocks,
                                  smem, stream);
      case 3:
        return launch_cooperative(gru_train_fwd_kernel<WT, 3>, a, blocks,
                                  smem, stream);
      default:
        return launch_cooperative(gru_train_fwd_kernel<WT, 4>, a, blocks,
                                  smem, stream);
    }
  }
}

// Kernel 5 (a) on the plan of gru_bwd_plan (route, split, units per block,
// rows per group, shared-memory bytes: checked against the kernel's own
// layout), then (b).
template <typename WT>
static int bwd_launch(const void* acts, const void* hs, const void* dh1s,
                      const void* dh2s, const void* whh1, const void* wih2x,
                      const void* whh2, void* dxp1, void* dxp2, void* dwhh1,
                      void* dwih2x, void* dwhh2, void* dbhh1, void* dbhh2,
                      void* ring, void* bar, int T, int B, int H, int units,
                      int rows, int resident, int split, int smem_bytes,
                      cudaStream_t stream) {
  constexpr bool mma = sizeof(WT) == 2;
  if (T < 1 || B < 1 || H % 16 || units < 8 || units % 8 || rows < 1 ||
      (resident && !mma))
    return cudaErrorInvalidValue;
  const int tile = mma ? 16 : kRB;
  const int mpad = (rows + tile - 1) / tile * tile;
  if (mpad > 16 * kBwdMaxMTiles ||
      bwd_block_layers(split) * mpad * units > kBwdMaxPairs * kThreads)
    return cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes(mma, resident, H, units, mpad, split);
  if (smem != (size_t)smem_bytes) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int blocks = (split ? 2 : 1) * ((H + units - 1) / units);
  if (blocks > sms) return cudaErrorInvalidValue;   // every unit needs a block
  GruBwdArgs<WT> a{static_cast<const WT*>(acts),
                   static_cast<const float*>(hs),
                   static_cast<const float*>(dh1s),
                   static_cast<const float*>(dh2s),
                   static_cast<const WT*>(wih2x), static_cast<const WT*>(whh1),
                   static_cast<const WT*>(whh2), static_cast<float*>(dxp1),
                   static_cast<float*>(dxp2), static_cast<WT*>(ring),
                   static_cast<unsigned int*>(bar), T, B, H, units, rows,
                   mpad, resident, split};
  int e;
  if constexpr (!mma) {
    e = launch_cooperative(gru_train_bwd_kernel<WT, 1>, a, blocks, smem,
                           stream);
  } else {
    switch (mpad / 16) {
      case 1:
        e = launch_cooperative(gru_train_bwd_kernel<WT, 1>, a, blocks, smem,
                               stream);
        break;
      case 2:
        e = launch_cooperative(gru_train_bwd_kernel<WT, 2>, a, blocks, smem,
                               stream);
        break;
      case 3:
        e = launch_cooperative(gru_train_bwd_kernel<WT, 3>, a, blocks, smem,
                               stream);
        break;
      default:
        e = launch_cooperative(gru_train_bwd_kernel<WT, 4>, a, blocks, smem,
                               stream);
    }
  }
  if (e != 0) return e;
  return launch_dw(
      gru_dw_problems(static_cast<const WT*>(acts),
                      static_cast<const float*>(hs),
                      static_cast<const float*>(dxp1),
                      static_cast<const float*>(dxp2),
                      static_cast<float*>(dwhh1), static_cast<float*>(dwih2x),
                      static_cast<float*>(dwhh2), static_cast<float*>(dbhh1),
                      static_cast<float*>(dbhh2), T, B, H),
      mma, stream);
}

}  // namespace avc

// C interface (ctypes).  bf16 != 0 selects bf16 weights, operands and saved
// activations.  Returns a cudaError_t value (0 on success).
extern "C" int gru_train_fwd_launch(const void* xp1, const void* base2,
                                    const void* whh1, const void* wih2x,
                                    const void* whh2, const void* bhh1,
                                    const void* bhh2, void* hs, void* acts,
                                    void* ring, void* bar, int T, int B, int H,
                                    int units, int rows, int resident,
                                    int split, int smem_bytes, int bf16,
                                    void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? avc::fwd_launch<__nv_bfloat16>(
                    xp1, base2, whh1, wih2x, whh2, bhh1, bhh2, hs, acts, ring,
                    bar, T, B, H, units, rows, resident, split, smem_bytes, st)
              : avc::fwd_launch<float>(xp1, base2, whh1, wih2x, whh2, bhh1,
                                       bhh2, hs, acts, ring, bar, T, B, H,
                                       units, rows, resident, split,
                                       smem_bytes, st);
}

extern "C" int gru_train_bwd_launch(const void* acts, const void* hs,
                                    const void* dh1s, const void* dh2s,
                                    const void* whh1, const void* wih2x,
                                    const void* whh2, void* dxp1, void* dxp2,
                                    void* dwhh1, void* dwih2x, void* dwhh2,
                                    void* dbhh1, void* dbhh2, void* ring,
                                    void* bar, int T, int B, int H, int units,
                                    int rows, int resident, int split,
                                    int smem_bytes, int bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? avc::bwd_launch<__nv_bfloat16>(
                    acts, hs, dh1s, dh2s, whh1, wih2x, whh2, dxp1, dxp2,
                    dwhh1, dwih2x, dwhh2, dbhh1, dbhh2, ring, bar, T, B, H,
                    units, rows, resident, split, smem_bytes, st)
              : avc::bwd_launch<float>(acts, hs, dh1s, dh2s, whh1, wih2x,
                                       whh2, dxp1, dxp2, dwhh1, dwih2x, dwhh2,
                                       dbhh1, dbhh2, ring, bar, T, B, H,
                                       units, rows, resident, split,
                                       smem_bytes, st);
}
