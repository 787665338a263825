// Decoder LSTM-stack inference kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of autovc_tpu/ops/lstm_pallas.py:
//   * lstm_stack_skewed_launch  <- lstm_stack_pallas / _stack_core / _kernel
//     (<= 8 rows): lstm_small_kernel below (kernel 2);
//   * lstm_stack_stream_launch  <- lstm_stack_stream / _stream_kernel
//     (> 8 rows): the layer-skewed tensor-core routine of lstm_fwd.cuh,
//     shared with kernel 6, saving nothing but the top layer's h (kernel 3).
// The layer-0 input projection over all T (plus both biases) is hoisted
// by the caller (one large matmul); the kernels' own work is h @ W_hh for
// every layer, y_{l-1} @ W_ih (+ b_ih + b_hh) for layers >= 1, and the
// cell update.
//
// Kernel 2.  What bounds it on an H100: a dependent chain of T + L - 1
// rounds (401 for the 2 x 1024 decoder lstm2 at T = 400), each a product
// of B <= 8 rows with the whole stack's recurrent weights (25 MB in bf16)
// and a cell update.  At 1 row a round is ~1.6 MFLOP a block (N padded to
// 8), so its latency (grid barrier, an L2 round trip for h, shared-memory
// reads of the weights, the tensor-core chain, the epilogue) is the cost,
// never HBM or the tensor cores' peak.  What the design does about it:
//   * layer-skewed rounds: round s runs layer l at step t = s - l (the JAX
//     _kernel's schedule), every operand written in round s - 1, one grid
//     barrier after every round but the last, on the monotonic arrival
//     count (grid_sync_count, without the fence that kernels 3-6 put
//     before the arrival: the block barrier and the release reduction
//     order the block's writes, common.cuh).  A round runs only its live
//     layers (no layer 0 from s = T on, no layer l before s = l): nothing
//     is copied across;
//   * ownership: a block owns `units` hidden units (8 or 16) for the whole
//     call, of every layer, or of one layer where every layer's blocks of
//     8 units fit on the card ("split");
//   * bf16: mma.sync m16n8k16 with the block's gate rows of W as A, in
//     16-row M-tiles (gates i and f of 8 units, then g and o of the same
//     units), and the h rows as B with N = 8: 1-8 rows take one N-tile,
//     nothing is padded to 16 rows.  Lane (gid, tq) so ends holding all
//     four gates of unit gid for rows 2 tq and 2 tq + 1, and the cell
//     update needs no exchange but the sum of the warps' partial tiles.
//     A comes from the block's weight rows, resident in shared memory for
//     the whole call where they fit ("mma_smem"), stored in A-fragment
//     order so that one conflict-free 16-byte load is one fragment (no
//     register moves, no predicates), else from L2 ("mma_l2"); B straight
//     from a two-slot bf16 ring in L2 (no staging pass);
//   * few partial tiles: a round's live layers share the 8 warps by their
//     32-value K chunks (W_hh chunks unless t = 0, then W_ih chunks unless
//     l = 0; lstm_fwd.cuh's fwd_wave, recomputed only when the live set
//     changes), each warp one contiguous range of one layer, so a layer's
//     W_ih and W_hh products add into the same accumulators; two
//     accumulators a tile (the even and the odd k16 steps) keep two
//     tensor-core chains in flight; warp (l - first layer) % 8 sums layer
//     l's partial tiles in a fixed order, without atomics, and runs its
//     cells (fast exponentials: bf16 operands bound the error);
//   * c stays in shared memory for the whole call, in the accumulator
//     layout of the lane that owns (unit, rows); h goes to the ring with
//     ordinary stores (it stays in L2), the top layer's y leaves with
//     streaming stores after the barrier, rows past the batch are masked;
//     layer 0's pre-activations are loaded at the start of the round and
//     arrive during its product;
//   * f32 ("fma", the parity mode: the 2 x 1024 stack's 50 MB cannot be
//     resident): the same rounds, each live layer's operands staged in
//     shared memory and multiplied by a warp pair per unit over the two
//     halves of K, the weights read from L2.
// The launch plan (route, split, units, shared-memory bytes) is
// ops/lstm_kernels.py:small_plan, the rounds small_schedule; the kernel
// recomputes its layout and refuses a plan that disagrees.
#include "lstm_fwd.cuh"

namespace avc {

constexpr int kSmallRows = 8;       // rows a call at most: one mma N-tile
constexpr int kSmallMaxGroups = 2;  // 8-unit column groups a block
constexpr int kSmallKB = 16;        // K chunks whose h loads are in flight
                                    // (half of it on the L2 route)

template <typename WT>
struct SmallArgs {
  const float* xp0;   // (T, B, 4H) f32: layer-0 gate pre-activations
  const WT* whh;      // (L, 4H, H): W_hh transposed, per layer
  const WT* wih;      // (L-1, 4H, H): W_ih transposed, layers >= 1
  const float* bias;  // (L-1, 4H): b_ih + b_hh, layers >= 1
  float* ys;          // (T, B, H): the top layer's h
  WT* ring;           // (2, L, B, H) scratch: h in WT, slot = round & 1
  unsigned int* bar;  // arrival count, 0 at launch
  int T, B, H, L;
  int units;          // hidden units per block: 8 or 16
  int split;          // a block owns one layer (else every layer)
  int resident;       // bf16: the weight rows live in shared memory
};

// The layers and the matrices (W_hh, W_ih) a block holds at most.
__host__ __device__ inline int small_layers(int L, int split) {
  return split ? 1 : L;
}
__host__ __device__ inline int small_mats(int L, int split) {
  return split ? (L > 1 ? 2 : 1) : 2 * L - 1;
}

// Shared-memory layout in bytes.  mma: [resident weight rows (bf16), in
// A-fragment order: small_frag], then the warps' partial tiles (8 warps,
// units / 8 column groups, 2 M-tiles, 32 lanes) float4; fma: [two staged
// 8-row f32 operands, the warp sums (8, 32)], then the gate sums (layers,
// 8 rows, 4 gates, units) f32.  Both end with the carried c, (layers, 8
// rows, units) f32.  small_plan computes the same sizes.
__host__ __device__ inline size_t small_sums_offset(bool mma, int resident,
                                                    int H, int L, int U,
                                                    int split) {
  if (mma)
    return resident ? (size_t)small_mats(L, split) * 4 * U *
                          ((H + 31) / 32 * 32) * 2
                    : 0;
  return ((size_t)2 * kSmallRows * H + kWarps * 32) * sizeof(float);
}
__host__ __device__ inline size_t small_c_offset(bool mma, int resident,
                                                 int H, int L, int U,
                                                 int split) {
  const size_t sums =
      mma ? (size_t)kWarps * 32 * U
          : (size_t)small_layers(L, split) * kSmallRows * 4 * U;
  return small_sums_offset(mma, resident, H, L, U, split) +
         sums * sizeof(float);
}
__host__ __device__ inline size_t small_smem_bytes(bool mma, int resident,
                                                   int H, int L, int U,
                                                   int split) {
  return small_c_offset(mma, resident, H, L, U, split) +
         (size_t)small_layers(L, split) * kSmallRows * U * sizeof(float);
}

// The resident weights in A-fragment order: for matrix m, M-tile mt (2 a
// column group), 32-value K chunk c, k16 step p and lane (gid, tq), the
// 16 bytes {W[lo][k], W[lo][k + 1]}, {W[hi][k], W[hi][k + 1]}, {W[lo][k +
// 2], W[lo][k + 3]}, {W[hi][k + 2], W[hi][k + 3]} (k = 32 c + 8 tq + 4 p;
// lo and hi the tile's rows gid and gid + 8): one conflict-free 16-byte
// load is one k16 step's A fragment, with values past H and units past the
// block zero.  The uint4 index of (m, mt, c, p, lane):
__device__ __forceinline__ size_t small_frag(int m, int mt, int c, int p,
                                             int lane, int mts, int nch) {
  return (((size_t)(m * mts + mt) * nch + c) * 2 + p) * 32 + lane;
}

// Round s writes ring slot s & 1 and reads slot (s + 1) & 1, written in
// round s - 1: the B rows of layer l's own h_{t-1} (ih = 0) and of the
// layer below's h_t (ih = 1).
__device__ __forceinline__ int small_write_slot(int s) { return s & 1; }
__device__ __forceinline__ int small_read_slot(int s) { return (s + 1) & 1; }
template <typename WT>
__device__ __forceinline__ const WT* small_ring_in(const SmallArgs<WT>& a,
                                                   int s, int l, int ih) {
  return a.ring + (size_t)(small_read_slot(s) * a.L + l - ih) * a.B * a.H;
}

// The LSTM cell: pre-activations (i, f, g, o) and c_{t-1} -> c_t, h_t.
// kFast (bf16): the gates from __expf and a fast divide (relative error
// ~1e-6, far inside the bf16 rounding of the operands).
template <bool kFast>
__device__ __forceinline__ float small_sigmoid(float x) {
  return kFast ? __fdividef(1.0f, 1.0f + __expf(-x)) : sigmoidf_(x);
}
template <bool kFast>
__device__ __forceinline__ float small_tanh(float x) {
  return kFast ? 1.0f - __fdividef(2.0f, 1.0f + __expf(2.0f * x)) : tanhf(x);
}
template <bool kFast>
__device__ __forceinline__ void small_cell(const float (&pre)[4], float c_old,
                                           float& c, float& h) {
  const float ig = small_sigmoid<kFast>(pre[0]);
  const float fg = small_sigmoid<kFast>(pre[1]);
  const float gg = small_tanh<kFast>(pre[2]);
  const float og = small_sigmoid<kFast>(pre[3]);
  c = fg * c_old + ig * gg;
  h = og * small_tanh<kFast>(c);
}

// What a block owns: units j0 .. j0 + nu - 1 of layers llo .. llo + nl - 1.
struct SmallRole {
  int j0, nu, llo, nl;
};

template <typename WT>
__device__ __forceinline__ SmallRole small_role(const SmallArgs<WT>& a) {
  const int per = (a.H + a.units - 1) / a.units;   // blocks per layer
  SmallRole r;
  r.llo = a.split ? blockIdx.x / per : 0;
  r.nl = small_layers(a.L, a.split);
  r.j0 = blockIdx.x % per * a.units;
  r.nu = min(a.units, a.H - r.j0);
  return r;
}

// Layer l's W_hh (ih = 0) or W_ih (ih = 1): in global memory, and its
// index among the block's resident matrices (every layer's W_hh, then the
// W_ih of layers >= 1; split: the block's layer's W_hh, then its W_ih).
template <typename WT>
__device__ __forceinline__ const WT* small_weights(const SmallArgs<WT>& a,
                                                   int l, int ih) {
  return ih ? a.wih + (size_t)(l - 1) * 4 * a.H * a.H
            : a.whh + (size_t)l * 4 * a.H * a.H;
}
__device__ __forceinline__ int small_mat(int l, int ih, int L, int split) {
  return split ? ih : ih ? L + l - 1 : l;
}

// d += A * B on the tensor cores, A one k16 fragment in a uint4.
__device__ __forceinline__ void mma_u4(float (&d)[4], const uint4& a,
                                       uint32_t b0, uint32_t b1) {
  const uint32_t f[4] = {a.x, a.y, a.z, a.w};
  mma_bf16(d, f, b0, b1);
}

// The bf16 product of one warp's piece of round s: layer l at step t = s -
// l, chunks [c0, c1) of its list (W_hh chunks unless t = 0, then W_ih
// chunks unless l = 0; 32 values each), into acc[mt][parity]: the m16n8
// tile of M-tile mt (column group mt / 2; rows gates 2 (mt % 2) and 2 (mt
// % 2) + 1 of its 8 units) over the k16 steps of that parity.  Lane (gid,
// tq) loads values 8 tq .. 8 tq + 7 of a chunk of its B column (row gid of
// h: one 16-byte load from the ring in L2, issued for up to kSmallKB
// chunks together) and feeds them to two k16 steps as the fragment's k =
// (2 tq, 2 tq + 1, 2 tq + 8, 2 tq + 9), the A fragments taking the same
// permutation of k: resident (kRes), one 16-byte load each in fragment
// order (small_frag); else rows gid and gid + 8 of each M-tile from L2,
// 16 bytes each.  Values past H, rows past the batch and units past the
// block are zero.
template <int NG, bool kRes>
__device__ __forceinline__ void small_piece_mma(
    const SmallArgs<__nv_bfloat16>& a, const SmallRole& r, int s, int l,
    int c0, int c1, const uint4* wsm, float (&acc)[2 * NG][2][4]) {
  using WT = __nv_bfloat16;
  constexpr int MT = 2 * NG, KB = kRes ? kSmallKB : kSmallKB / 2;
  const int H = a.H, t = s - l;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tq = lane & 3;
  const int nch = (H + 31) / 32;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][p][e] = 0.0f;
    }
  }
  int base = 0;
  for (int ih = 0; ih < 2; ++ih) {
    if (ih == 0 ? !fwd_has_hh(t) : l == 0) continue;
    const int lo = max(c0, base) - base, hi = min(c1, base + nch) - base;
    base += nch;
    if (lo >= hi) continue;
    const WT* hrow = small_ring_in(a, s, l, ih) + (size_t)gid * H;
    const bool row_in = gid < a.B;
    const int m = small_mat(l, ih, a.L, a.split);
    // L2: the A row of gate 0, unit gid of column group 0; gate g is g *
    // H * H on, column group cg is 8 * cg * H on
    const WT* W = small_weights(a, l, ih) + (size_t)(r.j0 + gid) * H;
    for (int c = lo; c < hi; c += KB) {
      uint4 xb[KB];
#pragma unroll
      for (int q = 0; q < KB; ++q) {
        const int k = (c + q) * 32 + 8 * tq;
        xb[q] = c + q < hi && k < H && row_in
            ? __ldcg(reinterpret_cast<const uint4*>(hrow + k))
            : zero;
      }
#pragma unroll
      for (int q = 0; q < KB; ++q) {
        if (c + q >= hi) break;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint4 f0, f1;
          if constexpr (kRes) {
            f0 = wsm[small_frag(m, mt, c + q, 0, lane, MT, nch)];
            f1 = wsm[small_frag(m, mt, c + q, 1, lane, MT, nch)];
          } else {
            const int k = (c + q) * 32 + 8 * tq;
            const bool in = k < H && mt / 2 * 8 + gid < r.nu;
            const WT* w = W + (size_t)(mt / 2) * 8 * H +
                          (size_t)(2 * (mt % 2)) * H * H + k;
            const uint4 wlo = in ? __ldg(reinterpret_cast<const uint4*>(w))
                                 : zero;
            const uint4 whi = in ? __ldg(reinterpret_cast<const uint4*>(
                                       w + (size_t)H * H))
                                 : zero;
            f0 = make_uint4(wlo.x, whi.x, wlo.y, whi.y);
            f1 = make_uint4(wlo.z, whi.z, wlo.w, whi.w);
          }
          mma_u4(acc[mt][0], f0, xb[q].x, xb[q].y);
          mma_u4(acc[mt][1], f1, xb[q].z, xb[q].w);
        }
      }
    }
  }
}

// Layer 0's pre-activations at step t for the items of warp 0 of a block
// that holds layer 0 (unit cg * 8 + gid, rows 2 tq and 2 tq + 1), loaded
// at the start of the round, in flight across its product.
template <int NG>
__device__ __forceinline__ void small_load_x0(
    const SmallArgs<__nv_bfloat16>& a, const SmallRole& r, int t,
    float (&xin)[NG][4][2]) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tq = lane & 3;
  const bool mine = threadIdx.x < 32 && r.llo == 0 && t < a.T;
  const size_t G = 4 * (size_t)a.H;
#pragma unroll
  for (int cg = 0; cg < NG; ++cg) {
    const int u = cg * 8 + gid;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = 2 * tq + e;
        xin[cg][g][e] = mine && u < r.nu && row < a.B
            ? __ldg(a.xp0 + ((size_t)t * a.B + row) * G + g * a.H + r.j0 + u)
            : 0.0f;
      }
    }
  }
}

// The top layer's h of the lane's items, kept from its epilogue until
// after the round's barrier (streaming stores that the barrier need not
// wait for); t < 0: none.
template <int NG>
struct SmallPendingY {
  float h[NG][2];
  int t;
};

template <int NG>
__device__ __forceinline__ void small_flush_y(
    const SmallArgs<__nv_bfloat16>& a, const SmallRole& r,
    SmallPendingY<NG>& y) {
  if (y.t < 0) return;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int cg = 0; cg < NG; ++cg) {
    const int u = cg * 8 + gid;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = 2 * tq + e;
      if (u < r.nu && row < a.B)
        __stcs(a.ys + ((size_t)y.t * a.B + row) * a.H + r.j0 + u,
               y.h[cg][e]);
    }
  }
  y.t = -1;
}

// The epilogue of layer l at step t = s - l: for each column group, the
// lane's items (unit cg * 8 + gid, rows 2 tq and 2 tq + 1) sum the
// layer's partial tiles (those of warps first .. first + cnt - 1, in
// order), add layer 0's pre-activations or the bias, carry c in shared
// memory and write h to ring slot s & 1; the top layer's h is kept for
// small_flush_y.
template <int NG>
__device__ __forceinline__ void small_epilogue_mma(
    const SmallArgs<__nv_bfloat16>& a, const SmallRole& r, int s, int l,
    int first, int cnt, const float4* parts, float2* cst,
    const float (&xin)[NG][4][2], SmallPendingY<NG>& y) {
  const int H = a.H, t = s - l;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tq = lane & 3;
  const int ws = small_write_slot(s);
#pragma unroll
  for (int cg = 0; cg < NG; ++cg) {
    const int u = cg * 8 + gid, j = r.j0 + u;
    float in[4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
      in[g] = l > 0 && u < r.nu
          ? __ldg(a.bias + (size_t)(l - 1) * 4 * H + g * H + j)
          : 0.0f;
    float2* cp = cst + ((l - r.llo) * NG + cg) * 32 + lane;
    const float2 c_old = t > 0 ? *cp : make_float2(0.0f, 0.0f);
    // (i r0, i r1, f r0, f r1) and (g r0, g r1, o r0, o r1)
    float4 p[2] = {make_float4(0.f, 0.f, 0.f, 0.f),
                   make_float4(0.f, 0.f, 0.f, 0.f)};
    for (int q = first; q < first + cnt; ++q) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float4 v = parts[((q * NG + cg) * 2 + half) * 32 + lane];
        p[half].x += v.x;
        p[half].y += v.y;
        p[half].z += v.z;
        p[half].w += v.w;
      }
    }
    float c[2], h[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float pre[4] = {e ? p[0].y : p[0].x, e ? p[0].w : p[0].z,
                      e ? p[1].y : p[1].x, e ? p[1].w : p[1].z};
#pragma unroll
      for (int g = 0; g < 4; ++g) pre[g] += l == 0 ? xin[cg][g][e] : in[g];
      small_cell<true>(pre, e ? c_old.y : c_old.x, c[e], h[e]);
      if (l == a.L - 1) y.h[cg][e] = h[e];
    }
    *cp = make_float2(c[0], c[1]);
    if (u < r.nu) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = 2 * tq + e;
        if (row < a.B)   // the N-tile's columns past the batch are not stored
          a.ring[((size_t)(ws * a.L + l) * a.B + row) * H + j] =
              __float2bfloat16_rn(h[e]);
      }
    }
  }
  if (l == a.L - 1) y.t = t;
}

// The block's weight rows of each of its matrices, to shared memory in
// A-fragment order (small_frag), once a call.
template <int NG>
__device__ void small_load_weights(const SmallArgs<__nv_bfloat16>& a,
                                   const SmallRole& r, uint4* wsm) {
  constexpr int MT = 2 * NG;
  const int H = a.H, L = a.L, nch = (H + 31) / 32;
  const int nm = a.split && r.llo == 0 ? 1 : small_mats(L, a.split);
  const int n = nm * MT * nch * 64;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int lane = i % 32, p = i / 32 % 2, c = i / 64 % nch;
    const int mt = i / (64 * nch) % MT, m = i / (64 * nch * MT);
    const int gid = lane >> 2, tq = lane & 3, k = 32 * c + 8 * tq + 4 * p;
    const int u = mt / 2 * 8 + gid, g = 2 * (mt % 2);
    const int ih = a.split ? m : m >= L;
    const int l = a.split ? r.llo : ih ? m - L + 1 : m;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (u < r.nu && k < H) {
      const __nv_bfloat16* w = small_weights(a, l, ih) +
                               ((size_t)g * H + r.j0 + u) * H + k;
      const uint2 lo = __ldg(reinterpret_cast<const uint2*>(w));
      const uint2 hi =
          __ldg(reinterpret_cast<const uint2*>(w + (size_t)H * H));
      x = make_uint4(lo.x, hi.x, lo.y, hi.y);
    }
    wsm[i] = x;
  }
  __syncthreads();
}

// The f32 products of round s for one live layer l: its own h_{t-1} (t >
// 0) and the layer below's h_t (l > 0) staged in shared memory, a warp
// pair (the two halves of K) per unit over the 4 gate columns, the pair's
// sums written to the layer's gate sums.
__device__ void small_product_fma(const SmallArgs<float>& a,
                                  const SmallRole& r, int s, int l,
                                  float* stage, float* gsum) {
  const int H = a.H, B = a.B, U = a.units, t = s - l;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp % kUnits, part = warp / kUnits;
  const int kpart = H / kSplit, k0 = part * kpart;
  const bool hh = fwd_has_hh(t), ih = l > 0;
  float* hsm = stage;
  float* ysm = stage + kSmallRows * H;
  float* red = stage + 2 * kSmallRows * H;
  if (hh)
    stage_rows(hsm, small_ring_in(a, s, l, 0), 0, B, H);
  if (ih) stage_rows(ysm, small_ring_in(a, s, l, 1), 0, B, H);
  __syncthreads();
  const float* whh = small_weights(a, l, 0);
  const float* wih = ih ? small_weights(a, l, 1) : nullptr;
  for (int u0 = 0; u0 < U; u0 += kUnits) {
    const int u = u0 + slot, j = r.j0 + u;
    if (u < r.nu) {
      float acc[4][kRB] = {};
      if (hh) {
        const float* const wc[4] = {
            whh + (size_t)j * H, whh + (size_t)(H + j) * H,
            whh + (size_t)(2 * H + j) * H, whh + (size_t)(3 * H + j) * H};
        warp_dot(wc, hsm, H, k0, k0 + kpart, B, acc);
      }
      if (ih) {
        const float* const wc[4] = {
            wih + (size_t)j * H, wih + (size_t)(H + j) * H,
            wih + (size_t)(2 * H + j) * H, wih + (size_t)(3 * H + j) * H};
        warp_dot(wc, ysm, H, k0, k0 + kpart, B, acc);
      }
      float v[4 * kRB];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
#pragma unroll
        for (int q = 0; q < kRB; ++q) v[g * kRB + q] = acc[g][q];
      }
      warp_sum_to_smem(v, red + warp * 4 * kRB);
    }
    __syncthreads();
    if (part == 0 && u < r.nu && lane < B) {
#pragma unroll
      for (int g = 0; g < 4; ++g)
        gsum[(((l - r.llo) * kSmallRows + lane) * 4 + g) * U + u] =
            red[slot * 4 * kRB + g * kRB + lane] +
            red[(kUnits + slot) * 4 * kRB + g * kRB + lane];
    }
    __syncthreads();
  }
}

template <typename WT, int NG, bool kRes>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_small_kernel(SmallArgs<WT> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool kMma = sizeof(WT) == 2;
  const int H = a.H, L = a.L, T = a.T, B = a.B, U = a.units;
  const SmallRole r = small_role(a);
  float* sums = reinterpret_cast<float*>(
      smem_raw + small_sums_offset(kMma, kRes, H, L, U, a.split));
  float* cst = reinterpret_cast<float*>(
      smem_raw + small_c_offset(kMma, kRes, H, L, U, a.split));
  const int warp = threadIdx.x >> 5;
  const int rounds = T + L - 1;
  unsigned int nbar = 0;   // grid barriers passed
  if constexpr (kMma) {
    constexpr int MT = 2 * NG;
    const uint4* wsm = reinterpret_cast<const uint4*>(smem_raw);
    if constexpr (kRes)
      small_load_weights<NG>(a, r, reinterpret_cast<uint4*>(smem_raw));
    const int nch = (H + 31) / 32, lane = threadIdx.x & 31;
    float xin[NG][4][2];
    SmallPendingY<NG> y;
    y.t = -1;
    // this warp's piece of the wave (wave entry li, chunks [c0, c1)) and,
    // for the layer whose epilogue it runs, that layer's warps; recomputed
    // only when the wave changes (its first layer, its size, or a layer at
    // t = 0)
    int key = -1, li = -1, c0 = 0, c1 = 0, first = 0, cnt = 0;
    for (int s = 0; s < rounds; ++s) {
      const int lmin = max(r.llo, s - T + 1);
      const int lmax = min(r.llo + r.nl - 1, s);
      small_load_x0<NG>(a, r, s, xin);
      for (int lw = lmin; lw <= lmax; lw += kWarps) {
        const int n = min(kWarps, lmax - lw + 1);
        const int i = (warp - (lw - r.llo) % kWarps + kWarps) % kWarps;
        const int wkey = (lw * (kWarps + 1) + n) * 2 + (s - lw - n + 1 == 0);
        if (wkey != key) {
          key = wkey;
          const FwdWave w = fwd_wave(s, lw, n, nch);
          fwd_piece(w, warp, li, c0, c1);
          first = cnt = 0;
#pragma unroll
          for (int e = 0; e < kWarps; ++e) {
            first += e < i ? w.nw[e] : 0;
            cnt = e == i ? w.nw[e] : cnt;
          }
        }
        if (li >= 0) {
          float acc[MT][2][4];
          small_piece_mma<NG, kRes>(a, r, s, lw + li, c0, c1, wsm, acc);
          float4* mine = reinterpret_cast<float4*>(sums);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const float* x = acc[mt][0];
            const float* z = acc[mt][1];
            mine[(warp * MT + mt) * 32 + lane] = make_float4(
                x[0] + z[0], x[1] + z[1], x[2] + z[2], x[3] + z[3]);
          }
        }
        __syncthreads();
        // layer l's epilogue runs on warp (l - llo) % 8
        if (i < n)
          small_epilogue_mma<NG>(a, r, s, lw + i, first, cnt,
                                 reinterpret_cast<const float4*>(sums),
                                 reinterpret_cast<float2*>(cst), xin, y);
        if (lw + kWarps <= lmax) __syncthreads();   // the tiles are reused
      }
      if (s + 1 < rounds) {
        grid_sync_count<false>(a.bar, nbar);
        small_flush_y<NG>(a, r, y);
      }
    }
    small_flush_y<NG>(a, r, y);
  } else {
    float* stage = reinterpret_cast<float*>(smem_raw);
    const size_t G = 4 * (size_t)H;
    for (int s = 0; s < rounds; ++s) {
      const int lmin = max(r.llo, s - T + 1);
      const int lmax = min(r.llo + r.nl - 1, s);
      for (int l = lmin; l <= lmax; ++l) {
        if (fwd_has_hh(s - l) || l > 0)
          small_product_fma(a, r, s, l, stage, sums);
      }
      const int ws = small_write_slot(s);
      const int items = (lmax - lmin + 1) * B * U;
      for (int q = threadIdx.x; q < items; q += kThreads) {
        const int l = lmin + q / (B * U), row = q / U % B, u = q % U;
        const int t = s - l, j = r.j0 + u, li = l - r.llo;
        if (u >= r.nu) continue;
        const bool prod = fwd_has_hh(t) || l > 0;
        float pre[4];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          pre[g] = (prod ? sums[((li * kSmallRows + row) * 4 + g) * U + u]
                         : 0.0f) +
                   (l == 0 ? __ldg(a.xp0 + ((size_t)t * B + row) * G +
                                   g * H + j)
                           : __ldg(a.bias + (size_t)(l - 1) * G + g * H + j));
        float* cp = cst + (li * kSmallRows + row) * U + u;
        float c, h;
        small_cell<false>(pre, t > 0 ? *cp : 0.0f, c, h);
        *cp = c;
        if (row >= B) continue;
        a.ring[((size_t)(ws * L + l) * B + row) * H + j] = h;
        if (l == L - 1) __stcs(a.ys + ((size_t)t * B + row) * H + j, h);
      }
      if (s + 1 < rounds) grid_sync_count<false>(a.bar, nbar);
    }
  }
}

// Launch on the plan of ops/lstm_kernels.py:small_plan (units per block,
// split, resident weights, shared-memory bytes: checked against the
// kernel's own layout).  Returns a cudaError_t value.
template <typename WT>
int lstm_small_launch(const SmallArgs<WT>& a, int smem_bytes,
                      cudaStream_t stream) {
  constexpr bool mma = sizeof(WT) == 2;
  if (a.B < 1 || a.B > kSmallRows || a.L < 1 || a.T < 0 || a.H < 16 ||
      a.H % 16 || a.units < 8 || a.units % 8 ||
      a.units > 8 * kSmallMaxGroups || (a.resident && !mma))
    return cudaErrorInvalidValue;
  if (small_smem_bytes(mma, a.resident, a.H, a.L, a.units, a.split) !=
      (size_t)smem_bytes)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int blocks =
      (a.split ? a.L : 1) * ((a.H + a.units - 1) / a.units);
  if (blocks > sms) return cudaErrorInvalidValue;   // every unit needs a block
  SmallArgs<WT> args = a;
  if constexpr (!mma) {
    return launch_cooperative(lstm_small_kernel<WT, 1, false>, args, blocks,
                              smem_bytes, stream);
  } else if (a.units == 8) {
    return a.resident
        ? launch_cooperative(lstm_small_kernel<WT, 1, true>, args, blocks,
                             smem_bytes, stream)
        : launch_cooperative(lstm_small_kernel<WT, 1, false>, args, blocks,
                             smem_bytes, stream);
  } else {
    return a.resident
        ? launch_cooperative(lstm_small_kernel<WT, 2, true>, args, blocks,
                             smem_bytes, stream)
        : launch_cooperative(lstm_small_kernel<WT, 2, false>, args, blocks,
                             smem_bytes, stream);
  }
}

}  // namespace avc

// C interface (ctypes).  bf16 != 0 selects bf16 weights, operands and
// ring.  Returns a cudaError_t value (0 on success).
extern "C" int lstm_stack_skewed_launch(const void* xp0, const void* whh,
                                        const void* wih, const void* bias,
                                        void* out, void* ring, void* bar,
                                        int T, int B, int H, int L, int units,
                                        int split, int resident,
                                        int smem_bytes, int bf16,
                                        void* stream) {
  auto run = [&](auto tag) {
    using WT = decltype(tag);
    avc::SmallArgs<WT> a{static_cast<const float*>(xp0),
                         static_cast<const WT*>(whh),
                         static_cast<const WT*>(wih),
                         static_cast<const float*>(bias),
                         static_cast<float*>(out), static_cast<WT*>(ring),
                         static_cast<unsigned int*>(bar), T, B, H, L, units,
                         split, resident};
    return avc::lstm_small_launch<WT>(a, smem_bytes,
                                      static_cast<cudaStream_t>(stream));
  };
  return bf16 ? run(__nv_bfloat16{}) : run(0.0f);
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
