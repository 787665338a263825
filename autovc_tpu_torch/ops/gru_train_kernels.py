"""WaveRNN GRU-pair training: kernels 4 and 5 and their plain versions.

Counterpart of ``autovc_tpu/ops/gru_train_pallas.py``.  :func:`gru_pair`
keeps the JAX contract: time-major hoisted projections ``xp1`` and
``base2`` (T, B, 3H) in, ``(h1s, h2s)`` (T, B, H) out, with

    h1_t = GRU(h1_{t-1}; xp1_t)                    hp1 = h1_{t-1} W_hh1 + b_hh1
    h2_t = GRU(h2_{t-1}; base2_t + h1_t W_ih2x)    hp2 = h2_{t-1} W_hh2 + b_hh2

(PyTorch gate semantics, ``b_hh`` inside the reset product; zero initial
states), differentiable in all seven inputs.  The pair is a
``torch.autograd.Function`` (:class:`GruPair`):

  * on a CUDA tensor its forward launches kernel 4
    (``gru_train_fwd_launch`` of ``csrc/gru_train.cu``: the layer-skewed
    forward on :func:`gru_fwd_plan` and :func:`gru_fwd_schedule`) and its
    backward kernel 5 (``gru_train_bwd_launch``: the layer-skewed
    reverse-time chain on :func:`gru_bwd_plan` and
    :func:`gru_bwd_schedule`, then the hand-written dW / db products), or
    raises;
  * on a CPU tensor it runs :func:`gru_pair_fwd_plain` and
    :func:`gru_pair_bwd_plain`, the same arithmetic in PyTorch (the CPU path
    and the kernels' oracle).

Compute dtype: ``PREC.rec_dtype(mode, B, H)``, the gate of the JAX scan
(bf16 under the bf16 policy when H >= 256 and B >= 2, else f32).  The JAX
kernel rounds to bf16 under the bf16 policy at any H and row count; the
port follows the scan's gate on purpose, so that the kernel and the scan
it replaces compute one function.  In bf16 the rounding points are the JAX
kernel's: the weights, and h1, h2, dhp, dxp as matmul operands, with f32
accumulation; the saved r, z, n, hn stored in bf16; h, the dh chain and db
in f32; the dW products from bf16 operands with f32 accumulation.

Saved state (time-major): ``hs`` (2, T, B, H) f32 — h1 and h2, which are
also the outputs — and ``acts`` (2, T, B, 4H) in the compute dtype: r, z,
n, hn of each layer (hn = h_{t-1} W_hn + b_hn).  The weights change every
step, so they are packed per call.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from autovc_tpu_torch.ops import _build
from autovc_tpu_torch.ops import precision as PREC
from autovc_tpu_torch.ops import rnn as R
from autovc_tpu_torch.parallel import tensor as TP

_P, _I = ctypes.c_void_p, ctypes.c_int
FWD = _build.Kernel("gru_train.cu", "gru_train_fwd_launch",
                    [_P] * 11 + [_I] * 9 + [_P])
BWD = _build.Kernel("gru_train.cu", "gru_train_bwd_launch",
                    [_P] * 16 + [_I] * 9 + [_P])


def pack_fwd(whh1: torch.Tensor, wih2x: torch.Tensor, whh2: torch.Tensor,
             dtype: torch.dtype):
    """Kernel 4's weights: W_hh1, W_ih2x, W_hh2 (H, 3H) transposed to
    (3H, H) and cast to ``dtype``."""
    return tuple(w.T.to(dtype).contiguous() for w in (whh1, wih2x, whh2))


def pack_bwd(whh1: torch.Tensor, wih2x: torch.Tensor, whh2: torch.Tensor,
             dtype: torch.dtype):
    """Kernel 5's weights: the param layout (H, 3H) cast to ``dtype`` (row j
    holds unit j's 3H weights, the row the backward reads)."""
    return tuple(w.to(dtype).contiguous() for w in (whh1, wih2x, whh2))


def _op(bf16: bool):
    return PREC.round_bf16 if bf16 else (lambda a: a)


def _cell(xp, hp, h):
    """One GRU step from its pre-activations: (h, [r, z, n, hn])."""
    xr, xz, xn = xp.chunk(3, dim=-1)
    hr, hz, hn = hp.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h, torch.cat([r, z, n, hn], dim=-1)


def gru_pair_fwd_plain(xp1: torch.Tensor, base2: torch.Tensor,
                       whh1: torch.Tensor, wih2x: torch.Tensor,
                       whh2: torch.Tensor, bhh1: torch.Tensor,
                       bhh2: torch.Tensor):
    """Kernel 4's function in PyTorch: ``xp1``, ``base2`` (T, B, 3H) f32,
    weights as :func:`pack_fwd` gives them, ``bhh1``, ``bhh2`` (3H,) f32.
    Returns the saved ``hs`` (2, T, B, H) f32 and ``acts`` (2, T, B, 4H) in
    the weights' dtype.  Differentiable by autograd in f32 (the oracle of
    the plain backward)."""
    T, B, H3 = xp1.shape
    H = H3 // 3
    op = _op(whh1.dtype == torch.bfloat16)
    w1, wx, w2 = (w.float().T for w in (whh1, wih2x, whh2))    # (H, 3H)
    h1 = h2 = xp1.new_zeros(B, H)
    hs, acts = [[], []], [[], []]
    for t in range(T):
        h1, a1 = _cell(xp1[t], torch.matmul(op(h1), w1) + bhh1, h1)
        xp2 = base2[t] + torch.matmul(op(h1), wx)
        h2, a2 = _cell(xp2, torch.matmul(op(h2), w2) + bhh2, h2)
        for l, (h, a) in enumerate(((h1, a1), (h2, a2))):
            hs[l].append(h)
            acts[l].append(a.to(whh1.dtype))
    return (torch.stack([torch.stack(v) for v in hs]),
            torch.stack([torch.stack(v) for v in acts]))


def _gate_grads(acts_t, h_prev, dh):
    """Gate derivatives of one layer at one step (``_bwd_kernel:275-292``):
    (dxp, dhp) (B, 3H), dhp being dxp with the n lane times r."""
    r, z, n, hn = acts_t.float().chunk(4, dim=-1)
    da_n = dh * (1.0 - z) * (1.0 - n * n)
    da_z = dh * (h_prev - n) * z * (1.0 - z)
    da_r = da_n * hn * r * (1.0 - r)
    return (torch.cat([da_r, da_z, da_n], dim=-1),
            torch.cat([da_r, da_z, da_n * r], dim=-1))


def _with_reset(dxp: torch.Tensor, acts: torch.Tensor) -> torch.Tensor:
    """dhp from dxp and the saved r: the n lane times r."""
    H = acts.shape[-1] // 4
    return torch.cat([dxp[..., :2 * H],
                      dxp[..., 2 * H:] * acts[..., :H].float()], dim=-1)


def gru_pair_bwd_plain(acts: torch.Tensor, hs: torch.Tensor,
                       dh1s: torch.Tensor, dh2s: torch.Tensor,
                       whh1: torch.Tensor, wih2x: torch.Tensor,
                       whh2: torch.Tensor):
    """Kernel 5's function in PyTorch: the saved state of
    :func:`gru_pair_fwd_plain`, cotangents ``dh1s``, ``dh2s`` (T, B, H),
    weights as :func:`pack_bwd` gives them.  Returns the JAX VJP's order:
    ``dxp1``, ``dbase2`` (T, B, 3H), ``dwih2x``, ``dwhh1``, ``dbhh1``,
    ``dwhh2``, ``dbhh2``."""
    _, T, B, H = hs.shape
    op = _op(whh1.dtype == torch.bfloat16)
    w1t, wxt, w2t = (w.float().T for w in (whh1, wih2x, whh2))  # (3H, H)
    dh1c = torch.zeros_like(dh1s[0])
    dh2c = torch.zeros_like(dh2s[0])
    dxp1 = torch.empty(T, B, 3 * H, dtype=hs.dtype, device=hs.device)
    dxp2 = torch.empty_like(dxp1)
    zero = torch.zeros_like(dh1c)
    for t in range(T - 1, -1, -1):
        h1p, h2p = (hs[0, t - 1], hs[1, t - 1]) if t > 0 else (zero, zero)
        dh2 = dh2s[t] + dh2c
        dxp2[t], dhp2 = _gate_grads(acts[1, t], h2p, dh2)
        z2 = acts[1, t, :, H:2 * H].float()
        dh2c = dh2 * z2 + torch.matmul(op(dhp2), w2t)
        # layer 1's dh takes dxp2 W_ih2x^T of the same step
        dh1 = dh1s[t] + dh1c + torch.matmul(op(dxp2[t]), wxt)
        dxp1[t], dhp1 = _gate_grads(acts[0, t], h1p, dh1)
        z1 = acts[0, t, :, H:2 * H].float()
        dh1c = dh1 * z1 + torch.matmul(op(dhp1), w1t)
    return (dxp1, dxp2, *gru_weight_grads(acts, hs, dxp1, dxp2, op))


def gru_weight_grads(acts: torch.Tensor, hs: torch.Tensor,
                     dxp1: torch.Tensor, dxp2: torch.Tensor, op):
    """Kernel 5 (b) in PyTorch: the weight and bias gradients over all (t,
    b) from the chain's dxp1, dxp2 (``op`` rounds the products' operands):
    h_{t-1} (zero at t = 0) against dhp, h1_t against dxp2.  Returns
    ``dwih2x``, ``dwhh1``, ``dbhh1``, ``dwhh2``, ``dbhh2``."""
    h_prev = torch.cat([torch.zeros_like(hs[:, :1]), hs[:, :-1]], dim=1)
    dhp1 = _with_reset(dxp1, acts[0])
    dhp2 = _with_reset(dxp2, acts[1])
    dw = "tbh,tbk->hk"
    return (torch.einsum(dw, op(hs[0]), op(dxp2)),
            torch.einsum(dw, op(h_prev[0]), op(dhp1)), dhp1.sum(dim=(0, 1)),
            torch.einsum(dw, op(h_prev[1]), op(dhp2)), dhp2.sum(dim=(0, 1)))


def _check_geometry(H: int, dtype: torch.dtype) -> None:
    if H % 16:
        raise ValueError(f"unsupported GRU hidden size H={H}: kernels 4/5 "
                         f"split H and 3H in two 8-aligned halves (H % 16 "
                         f"== 0)")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("weights must be f32 or bf16")


# The launch geometry of kernel 4 and kernel 5 (a) (csrc/gru_train.cu):
# 256 threads a block, at most 4 (layer, row, unit) items a thread and 4
# M-tiles of 16 rows, resident weight rows of pitch K + 32 values, an
# H100's opt-in shared memory per block.  Kernel 4's products in matrix
# order, each with the ring entry it multiplies: W_hh1 h1 (layer 1),
# W_ih2x h1 and W_hh2 h2 (layer 2); kernel 5's ring entries, in its matrix
# order: W_ih2x multiplies dxp2, W_hh1 dhp1, W_hh2 dhp2.
THREADS, WARPS, SPLIT, ROW_TILE_F32 = 256, 8, 2, 8
MAX_PAIRS, MAX_ROWS, PITCH_PAD = 4, 64, 32
SMEM_MAX = 232448
FWD_PRODUCTS = (("whh1", "h1"), ("wih2x", "h1"), ("whh2", "h2"))
ENTRIES = ("dxp2", "dhp1", "dhp2")


@dataclass(frozen=True)
class FwdRound:
    """Round ``s`` of kernel 4's layer-skewed forward: the step each layer
    finishes (None: none), the products it runs as (matrix, ring entry,
    slot), the slot it writes, and whether a grid barrier follows."""
    s: int
    layer1_step: int | None
    layer2_step: int | None
    reads: tuple            # ((matrix, entry, slot), ...) in matrix order
    write_slot: int
    barrier: bool


def gru_fwd_schedule(T: int) -> list[FwdRound]:
    """The T + 1 rounds of kernel 4: round 0 does layer 1 at step 0 from
    xp1 alone; round s = 1 .. T does layer 1 at s (from h1_{s-1} W_hh1,
    s < T) and layer 2 at s - 1 (from h1_{s-1} W_ih2x, and h2_{s-2} W_hh2
    from s = 2 on), every operand from the ring slot round s - 1 wrote; T
    barriers."""
    if T < 1:
        raise ValueError(f"kernel 4 needs T >= 1, not {T}")
    rounds = []
    for s in range(T + 1):
        read = (s + 1) % 2
        reads = tuple((m, e, read) for (m, e), on in zip(
            FWD_PRODUCTS, (1 <= s < T, s >= 1, s >= 2)) if on)
        rounds.append(FwdRound(s=s, layer1_step=s if s < T else None,
                               layer2_step=s - 1 if s >= 1 else None,
                               reads=reads, write_slot=s % 2,
                               barrier=s < T))
    return rounds


@dataclass(frozen=True)
class GruFwdPlan:
    """How kernel 4 covers a (B, H) pair.

    ``route``: "mma_smem" (bf16 tensor-core products, the block's weight
    columns resident in shared memory), "mma_l2" (the same, weights read
    from L2: they do not fit) or "fma" (f32).  ``split``: a block holds
    one layer (layer 1's blocks first, then layer 2's), else both.  A
    block owns ``units`` hidden units of its layers; ``rows`` rows go
    through the products at once (``m_tiles`` 16-row tiles in bf16),
    ``groups`` times over the batch, each group on the rounds of
    :func:`gru_fwd_schedule` (the same for every plan)."""
    route: str
    split: bool
    units: int
    blocks: int
    rows: int
    groups: int
    m_tiles: int
    items: int             # (layer, row, unit) items a thread owns
    resident_bytes: int
    smem_bytes: int

    def block_units(self, H: int) -> list[tuple[int, int, int]]:
        """(layer, first unit, units) of each block, layers 1 and 2."""
        per = self.blocks // (2 if self.split else 1)
        out = []
        for b in range(self.blocks):
            j0 = b % per * self.units
            nu = min(self.units, H - j0)
            layers = ((1 if b < per else 2,) if self.split else (1, 2))
            out += [(layer, j0, nu) for layer in layers]
        return out


def gru_fwd_plan(B: int, H: int, bf16: bool, sms: int) -> GruFwdPlan:
    """Kernel 4's plan for ``sms`` streaming multiprocessors: each layer
    its own blocks of 8 units where both fit on the card, else blocks of
    both layers; the fewest row groups that fit; resident weight columns
    where they fit beside the partial tiles."""
    if H % 16 or B < 1 or H < 16:
        raise ValueError(f"bad GRU geometry: B={B}, H={H} (H % 16 == 0)")
    split = sms >= 2 * -(-H // 8)          # both layers' blocks fit
    units = 8 if split else 8 * -(-H // (8 * sms))
    layers, mats = (1, 2) if split else (2, 3)
    tile = 16 if bf16 else ROW_TILE_F32
    tiles = WARPS if bf16 else SPLIT * mats
    weights = mats * 3 * units * (H + PITCH_PAD) * 2
    cap = min(MAX_ROWS, MAX_PAIRS * THREADS // (layers * units) // tile
              * tile)
    if cap < 1:
        raise ValueError(f"H={H} needs {units} units a block: too many for "
                         f"kernel 4's items")
    groups = -(-B // cap)
    while True:
        rows = -(-B // groups)
        mpad = -(-rows // tile) * tile
        parts = tiles * mpad * 3 * units * 4
        if not bf16:
            route, base = "fma", (ROW_TILE_F32 * H + WARPS * 3
                                  * ROW_TILE_F32) * 4
        elif weights + parts <= SMEM_MAX:
            route, base = "mma_smem", weights
        else:
            route, base = "mma_l2", 0
        if base + parts <= SMEM_MAX:
            break
        if rows == 1:
            raise ValueError(f"kernel 4 does not fit H={H} in shared memory")
        groups += 1
    return GruFwdPlan(route=route, split=split, units=units,
                      blocks=(2 if split else 1) * -(-H // units), rows=rows,
                      groups=groups, m_tiles=mpad // 16 if bf16 else 0,
                      items=-(-layers * mpad * units // THREADS),
                      resident_bytes=base if route == "mma_smem" else 0,
                      smem_bytes=base + parts)


def device_fwd_plan(B: int, H: int, bf16: bool, dev) -> GruFwdPlan:
    """:func:`gru_fwd_plan` for the SM count of CUDA device ``dev``."""
    return gru_fwd_plan(
        B, H, bf16, torch.cuda.get_device_properties(dev).multi_processor_count)


def fwd_launch(xp1: torch.Tensor, base2: torch.Tensor, whh1: torch.Tensor,
               wih2x: torch.Tensor, whh2: torch.Tensor, bhh1: torch.Tensor,
               bhh2: torch.Tensor):
    """Kernel 4 on CUDA tensors (checked here), on the device's
    :func:`gru_fwd_plan`; the same results as :func:`gru_pair_fwd_plain`."""
    T, B, H3 = xp1.shape
    H = H3 // 3
    _check_geometry(H, whh1.dtype)
    if tuple(base2.shape) != (T, B, 3 * H) or H3 != 3 * H:
        raise ValueError("xp1 and base2 must both be (T, B, 3H)")
    for w in (whh1, wih2x, whh2):
        if tuple(w.shape) != (3 * H, H) or w.dtype != whh1.dtype:
            raise ValueError("weights must be (3H, H), all of one dtype")
    for t in (xp1, base2, bhh1, bhh2):
        if t.dtype != torch.float32:
            raise ValueError("xp1, base2 and the biases must be float32")
    dev = xp1.device
    _build.check_inputs((xp1, base2, whh1, wih2x, whh2, bhh1, bhh2), dev)
    bf16 = whh1.dtype == torch.bfloat16
    plan = device_fwd_plan(B, H, bf16, dev)
    hs = torch.empty(2, T, B, H, device=dev)
    acts = torch.empty(2, T, B, 4 * H, device=dev, dtype=whh1.dtype)
    ring = torch.empty(2, 2, B, H, device=dev, dtype=whh1.dtype)
    bar = torch.zeros(1, dtype=torch.int32, device=dev)   # arrival count
    # the C side launches on the current device
    with torch.cuda.device(dev):
        FWD(xp1.data_ptr(), base2.data_ptr(), whh1.data_ptr(),
            wih2x.data_ptr(), whh2.data_ptr(), bhh1.data_ptr(),
            bhh2.data_ptr(), hs.data_ptr(), acts.data_ptr(), ring.data_ptr(),
            bar.data_ptr(), T, B, H, plan.units, plan.rows,
            int(plan.route == "mma_smem"), int(plan.split), plan.smem_bytes,
            int(bf16), torch.cuda.current_stream(dev).cuda_stream)
    return hs, acts


@dataclass(frozen=True)
class BwdRound:
    """Round ``s`` of kernel 5's layer-skewed chain: the step each layer
    finishes (None: none), the ring entries its products read with their
    slots, the slot it writes, and whether a grid barrier follows."""
    s: int
    layer2_step: int | None
    layer1_step: int | None
    reads: tuple            # ((entry, slot), ...) in matrix order
    write_slot: int
    barrier: bool


def gru_bwd_schedule(T: int) -> list[BwdRound]:
    """The T + 1 rounds of kernel 5 (a): round 0 does layer 2 at T - 1
    from its cotangent; round s = 1 .. T does layer 2 at T - 1 - s (from
    dhp2 W_hh2^T, s < T) and layer 1 at T - s (from dxp2 W_ih2x^T, and
    dhp1 W_hh1^T from s = 2 on), every operand from the ring slot round
    s - 1 wrote; T barriers."""
    if T < 1:
        raise ValueError(f"kernel 5 needs T >= 1, not {T}")
    rounds = []
    for s in range(T + 1):
        read = (s + 1) % 2
        reads = tuple((e, read) for e, on in zip(
            ENTRIES, (s >= 1, s >= 2, 1 <= s < T)) if on)
        rounds.append(BwdRound(s=s, layer2_step=T - 1 - s if s < T else None,
                               layer1_step=T - s if s >= 1 else None,
                               reads=reads, write_slot=s % 2,
                               barrier=s < T))
    return rounds


@dataclass(frozen=True)
class GruBwdPlan:
    """How kernel 5's chain covers a (B, H) pair.

    ``route``: "mma_smem" (bf16 tensor-core products, the block's weight
    rows resident in shared memory), "mma_l2" (the same, weights read
    from L2: they do not fit) or "fma" (f32).  ``split``: a block holds
    one layer (layer 2's blocks first, then layer 1's), else both.  A
    block owns ``units`` hidden units of its layers; ``rows`` rows go
    through the products at once (``m_tiles`` 16-row tiles in bf16),
    ``groups`` times over the batch, each group on the rounds of
    :func:`gru_bwd_schedule` (the same for every plan)."""
    route: str
    split: bool
    units: int
    blocks: int
    rows: int
    groups: int
    m_tiles: int
    pairs: int             # (layer, row, unit) items a thread owns
    resident_bytes: int
    smem_bytes: int

    def block_units(self, H: int) -> list[tuple[int, int, int]]:
        """(layer, first unit, units) of each block, layers 1 and 2."""
        per = self.blocks // (2 if self.split else 1)
        out = []
        for b in range(self.blocks):
            j0 = b % per * self.units
            nu = min(self.units, H - j0)
            layers = ((2 if b < per else 1,) if self.split else (1, 2))
            out += [(layer, j0, nu) for layer in layers]
        return out


def gru_bwd_plan(B: int, H: int, bf16: bool, sms: int) -> GruBwdPlan:
    """Kernel 5's plan for ``sms`` streaming multiprocessors: each layer
    its own blocks of 8 units where both fit on the card, else blocks of
    both layers; the fewest row groups that fit; resident weights where
    they fit beside the partial sums."""
    if H % 16 or B < 1 or H < 16:
        raise ValueError(f"bad GRU geometry: B={B}, H={H} (H % 16 == 0)")
    split = 2 * -(-H // 8) <= sms
    units = 8 if split else 8 * -(-H // (8 * sms))
    layers, mats = (1, 2) if split else (2, 3)
    tile = 16 if bf16 else ROW_TILE_F32
    nparts = WARPS if bf16 else SPLIT
    weights = mats * units * (3 * H + PITCH_PAD) * 2
    cap = min(MAX_ROWS, MAX_PAIRS * THREADS // (layers * units) // tile
              * tile)
    if cap < 1:
        raise ValueError(f"H={H} needs {units} units a block: too many for "
                         f"kernel 5's items")
    groups = -(-B // cap)
    while True:
        rows = -(-B // groups)
        mpad = -(-rows // tile) * tile
        parts = nparts * layers * mpad * units * 4
        if not bf16:
            route, base = "fma", (ROW_TILE_F32 * 3 * H + WARPS
                                  * ROW_TILE_F32) * 4
        elif weights + parts <= SMEM_MAX:
            route, base = "mma_smem", weights
        else:
            route, base = "mma_l2", 0
        if base + parts <= SMEM_MAX:
            break
        if rows == 1:
            raise ValueError(f"kernel 5 does not fit H={H} in shared memory")
        groups += 1
    return GruBwdPlan(route=route, split=split, units=units,
                      blocks=(2 if split else 1) * -(-H // units), rows=rows,
                      groups=groups, m_tiles=mpad // 16 if bf16 else 0,
                      pairs=-(-layers * mpad * units // THREADS),
                      resident_bytes=base if route == "mma_smem" else 0,
                      smem_bytes=base + parts)


def device_bwd_plan(B: int, H: int, bf16: bool, dev) -> GruBwdPlan:
    """:func:`gru_bwd_plan` for the SM count of CUDA device ``dev``."""
    return gru_bwd_plan(
        B, H, bf16, torch.cuda.get_device_properties(dev).multi_processor_count)


def bwd_launch(acts: torch.Tensor, hs: torch.Tensor, dh1s: torch.Tensor,
               dh2s: torch.Tensor, whh1: torch.Tensor, wih2x: torch.Tensor,
               whh2: torch.Tensor):
    """Kernel 5 on CUDA tensors (checked here), on the device's
    :func:`gru_bwd_plan`; the same results as :func:`gru_pair_bwd_plain`."""
    _, T, B, H = hs.shape
    _check_geometry(H, whh1.dtype)
    for w in (whh1, wih2x, whh2):
        if tuple(w.shape) != (H, 3 * H) or w.dtype != whh1.dtype:
            raise ValueError("weights must be (H, 3H), all of one dtype")
    if tuple(hs.shape) != (2, T, B, H) or acts.dtype != whh1.dtype \
            or tuple(acts.shape) != (2, T, B, 4 * H):
        raise ValueError("saved state must be hs (2, T, B, H) f32 and acts "
                         "(2, T, B, 4H) in the weights' dtype")
    for t in (hs, dh1s, dh2s):
        if t.dtype != torch.float32:
            raise ValueError("saved h and the cotangents must be float32")
    for t in (dh1s, dh2s):
        if tuple(t.shape) != (T, B, H):
            raise ValueError(f"cotangents must be (T, B, H), got "
                             f"{tuple(t.shape)}")
    dev = hs.device
    _build.check_inputs((acts, hs, dh1s, dh2s, whh1, wih2x, whh2), dev)
    bf16 = whh1.dtype == torch.bfloat16
    plan = device_bwd_plan(B, H, bf16, dev)
    dxp1 = torch.empty(T, B, 3 * H, device=dev)
    dxp2 = torch.empty(T, B, 3 * H, device=dev)
    dw = [torch.empty(H, 3 * H, device=dev) for _ in range(3)]
    db = [torch.empty(3 * H, device=dev) for _ in range(2)]
    ring = torch.empty(2, len(ENTRIES), B, 3 * H, device=dev, dtype=whh1.dtype)
    bar = torch.zeros(1, dtype=torch.int32, device=dev)   # arrival count
    with torch.cuda.device(dev):
        BWD(acts.data_ptr(), hs.data_ptr(), dh1s.data_ptr(), dh2s.data_ptr(),
            whh1.data_ptr(), wih2x.data_ptr(), whh2.data_ptr(),
            dxp1.data_ptr(), dxp2.data_ptr(),
            *(t.data_ptr() for t in (*dw, *db)), ring.data_ptr(),
            bar.data_ptr(), T, B, H, plan.units, plan.rows,
            int(plan.route == "mma_smem"), int(plan.split), plan.smem_bytes,
            int(bf16), torch.cuda.current_stream(dev).cuda_stream)
    dwhh1, dwih2x, dwhh2 = dw
    return dxp1, dxp2, dwih2x, dwhh1, db[0], dwhh2, db[1]


class GruPair(torch.autograd.Function):
    """:func:`gru_pair`'s recurrence: kernel 4 forward and kernel 5
    backward on CUDA, the plain versions on the CPU.  Inputs: the seven
    tensors of :func:`gru_pair` (f32 params) and the compute dtype;
    outputs ``h1s``, ``h2s`` (T, B, H)."""

    @staticmethod
    def forward(ctx, xp1, base2, wih2x, whh1, bhh1, whh2, bhh2, dtype):
        wf = pack_fwd(whh1, wih2x, whh2, dtype)
        bias = (bhh1.float().contiguous(), bhh2.float().contiguous())
        if xp1.device.type == "cuda":
            hs, acts = fwd_launch(xp1.contiguous(), base2.contiguous(), *wf,
                                  *bias)
        elif xp1.device.type == "cpu":
            hs, acts = gru_pair_fwd_plain(xp1, base2, *wf, *bias)
        else:
            raise ValueError(f"unsupported device {xp1.device}")
        ctx.save_for_backward(hs, acts, whh1, wih2x, whh2)
        ctx.dtype = dtype
        return hs[0].clone(), hs[1].clone()

    @staticmethod
    def backward(ctx, dh1s, dh2s):
        hs, acts, whh1, wih2x, whh2 = ctx.saved_tensors
        dh1s = torch.zeros_like(hs[0]) if dh1s is None else dh1s.contiguous()
        dh2s = torch.zeros_like(hs[1]) if dh2s is None else dh2s.contiguous()
        wb = pack_bwd(whh1, wih2x, whh2, ctx.dtype)
        run = bwd_launch if hs.device.type == "cuda" else gru_pair_bwd_plain
        return (*run(acts, hs, dh1s, dh2s, *wb), None)


def gru_pair(xp1: torch.Tensor, base2: torch.Tensor, wih2x: torch.Tensor,
             whh1: torch.Tensor, bhh1: torch.Tensor, whh2: torch.Tensor,
             bhh2: torch.Tensor, mode: str = "f32", model=None):
    """Fused teacher-forced GRU pair, time-major: ``xp1``/``base2`` (T, B,
    3H) f32 hoisted projections (input biases folded in), weights (H, 3H),
    ``bhh`` (3H,) -> ``(h1s, h2s)``, each (T, B, H) f32.  ``mode`` is the
    precision policy ("f32" or "bf16"); the JAX function reads it from its
    context.  ``model`` (a ``parallel.tensor.ModelAxis``) whose shards
    hold the weights: the tensor-parallel per-step loop
    ``rnn.gru_pair_tp``, on this rank's gate columns, not kernels 4/5."""
    B, H = xp1.shape[1], whh1.shape[0]
    if TP.of(model, whh1) is not None:
        return R.gru_pair_tp(xp1, base2, wih2x, whh1, bhh1, whh2, bhh2,
                             PREC.rec_dtype(mode, B, H), model)
    return GruPair.apply(xp1, base2, wih2x, whh1, bhh1, whh2, bhh2,
                         PREC.rec_dtype(mode, B, H))
