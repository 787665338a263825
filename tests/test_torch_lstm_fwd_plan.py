"""The layer-skewed forward's launch plan (``lstm_kernels.fwd_plan``), on
the CPU.

Kernels 6 (the training forward) and 3 (inference at more than 8 rows)
run one routine, ``csrc/lstm_fwd.cuh``, on this plan: units per block,
rows per group and M-tiles, whether the weight rows are resident in shared
memory, and the shared-memory bytes the kernel checks against its own
layout.  The kernels themselves run only on the card
(``tests/test_torch_kernels_on_card.py``)."""
import pytest

from autovc_tpu_torch.ops import lstm_kernels as LK

H100_SMS = 132


def _state(L, mpad, bf16=True, units=8):
    """The warps' 16-row partial tiles (8, 16, 4 units + 8) in bf16, the
    gate sums (L, mpad, 4 units) in f32, then the carried c (L, mpad,
    units), all f32."""
    sums = 8 * 16 * (4 * units + 8) if bf16 else L * mpad * 4 * units
    return (sums + L * mpad * units) * 4


def _weights(L, H, units=8):
    """The block's 4 x units rows of 2L - 1 matrices, pitch H + 32, bf16."""
    return (2 * L - 1) * 4 * units * (H + 32) * 2


@pytest.mark.parametrize("name,B,H,L,blocks,m_tiles", [
    # kernel 6: decoder lstm2 and lstm1 at the training batch, the speaker
    # encoder's stack at 48 rows; kernel 3: lstm2 at 9 and 24 chunks
    ("lstm2", 16, 1024, 2, 128, 1), ("lstm1", 16, 512, 1, 64, 1),
    ("speaker_encoder", 48, 256, 3, 32, 3),
    ("stream_9", 9, 1024, 2, 128, 1), ("stream_24", 24, 1024, 2, 128, 2),
])
def test_bf16_plans_at_the_main_geometries(name, B, H, L, blocks, m_tiles):
    plan = LK.fwd_plan(B, H, L, True, H100_SMS)
    assert plan.route == "mma_smem"
    assert (plan.units, plan.blocks, plan.m_tiles, plan.groups) == (
        8, blocks, m_tiles, 1)
    assert plan.rows == B
    assert plan.resident_bytes == _weights(L, H)
    assert plan.smem_bytes == _weights(L, H) + _state(L, 16 * m_tiles)


def test_lstm2_fits_resident_beside_its_partial_sums():
    plan = LK.fwd_plan(16, 1024, 2, True, H100_SMS)
    # 3 matrices x 32 rows x 1056 values x 2 B, then 20 KB of partial
    # sums and 1 KB of c
    assert plan.resident_bytes == 202752
    assert plan.smem_bytes == 224256 <= LK.SMEM_MAX
    # the ragged 33 rows and a full 64-row group stay resident too
    for B in (33, 64):
        assert LK.fwd_plan(B, 1024, 2, True, H100_SMS).route == "mma_smem"


@pytest.mark.parametrize("B,H,L", [(16, 1024, 2), (16, 512, 1),
                                   (48, 256, 3), (24, 1024, 2), (5, 128, 3)])
def test_f32_is_never_resident(B, H, L):
    plan = LK.fwd_plan(B, H, L, False, H100_SMS)
    assert plan.route == "fma" and plan.resident_bytes == 0
    assert plan.m_tiles == 0
    # two staged 8-row f32 operands and the warp sums, then the state
    mpad = -(-plan.rows // 8) * 8
    assert plan.smem_bytes == (2 * 8 * H + 8 * 4 * 8) * 4 + _state(
        L, mpad, bf16=False)


@pytest.mark.parametrize("L", [3, 4])
def test_deep_wide_stacks_read_their_weights_from_l2(L):
    plan = LK.fwd_plan(16, 1024, L, True, H100_SMS)
    assert _weights(L, 1024) > LK.SMEM_MAX
    assert plan.route == "mma_l2" and plan.resident_bytes == 0
    assert plan.smem_bytes == _state(L, 16)


def test_large_batch_runs_in_row_groups():
    # the speaker encoder's training batch (64 speakers x 10 utterances)
    plan = LK.fwd_plan(640, 256, 3, True, H100_SMS)
    assert plan.groups == 10 and plan.rows == 64 and plan.m_tiles == 4
    assert plan.route == "mma_smem"
    assert LK.fwd_plan(100, 256, 2, True, H100_SMS).groups == 2


def test_wide_stack_takes_more_units_a_block():
    plan = LK.fwd_plan(16, 2048, 1, True, H100_SMS)
    assert plan.units == 16 and plan.blocks == 128


@pytest.mark.parametrize("sms", [132, 114, 78])
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("B,H,L", [
    (1, 16, 1), (3, 64, 1), (9, 1024, 2), (11, 256, 2), (16, 512, 1),
    (16, 1024, 2), (24, 1024, 2), (33, 1024, 2), (48, 256, 3),
    (64, 1024, 2), (129, 1024, 2), (16, 1024, 4), (640, 256, 3),
    (16, 1056, 4), (7, 1536, 2), (20, 272, 2), (9, 256, 6)])
def test_every_plan_fits_the_card(sms, bf16, B, H, L):
    plan = LK.fwd_plan(B, H, L, bf16, sms)
    assert plan.smem_bytes <= LK.SMEM_MAX
    assert plan.blocks <= sms and plan.blocks * plan.units >= H
    assert plan.units % 8 == 0
    tile = 16 if bf16 else 8
    mpad = -(-plan.rows // tile) * tile
    assert mpad <= LK.MAX_ROWS
    assert plan.groups * plan.rows >= B > (plan.groups - 1) * plan.rows
    if bf16:
        assert 1 <= plan.m_tiles <= LK.MAX_ROWS // 16
        assert plan.m_tiles * 16 >= plan.rows > (plan.m_tiles - 1) * 16


@pytest.mark.parametrize("B,H,L", [(4, 100, 1), (4, 24, 2), (0, 64, 1),
                                   (4, 64, 0)])
def test_unsupported_geometries_raise(B, H, L):
    with pytest.raises(ValueError):
        LK.fwd_plan(B, H, L, True, H100_SMS)


@pytest.mark.parametrize("L", [5, 8, 12])
def test_kernel3_has_no_depth_limit(L):
    # inference through lstm_stack_rec takes any depth; only training
    # (kernel 7) carries at most MAX_LAYERS layers
    plan = LK.fwd_plan(9, 256, L, True, H100_SMS)
    assert plan.groups == 1 and plan.smem_bytes <= LK.SMEM_MAX
