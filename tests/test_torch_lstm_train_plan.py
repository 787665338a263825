"""Kernel 7's launch plan (``lstm_train_kernels.bwd_plan``), on the CPU.

The plan decides how the recurrence covers an (L, B, H) stack on the card:
units per block, row tiles, whether the weight rows are resident in shared
memory, and the shared-memory bytes the kernel checks against its own
layout.  The kernel itself runs only on the card
(``tests/test_torch_kernels_on_card.py``)."""
import pytest

from autovc_tpu_torch.ops import lstm_train_kernels as LT

H100_SMS = 132


@pytest.mark.parametrize("name,B,H,L,units,blocks,m_tiles,resident", [
    # decoder lstm2 at the training batch: 8 units (one n8 tile) a block,
    # 128 blocks, one M-tile, W_hh of both layers and W_ih of layer 1
    ("lstm2", 16, 1024, 2, 8, 128, 1, 3 * 8 * (4096 + 32) * 2),
    ("lstm1", 16, 512, 1, 8, 64, 1, 1 * 8 * (2048 + 32) * 2),
    ("speaker_encoder", 48, 256, 3, 8, 32, 3, 5 * 8 * (1024 + 32) * 2),
    ("ragged", 33, 1024, 2, 8, 128, 3, 3 * 8 * (4096 + 32) * 2),
])
def test_bf16_plans_at_the_main_geometries(name, B, H, L, units, blocks,
                                           m_tiles, resident):
    plan = LT.bwd_plan(B, H, L, True, H100_SMS)
    assert plan.route == "mma_smem"
    assert (plan.units, plan.blocks, plan.m_tiles, plan.groups) == (
        units, blocks, m_tiles, 1)
    assert plan.rows == B
    assert plan.resident_bytes == resident
    # 64 H (2L - 1) bytes of weights, plus each row's 32-value pad
    assert resident == 64 * H * (2 * L - 1) + (2 * L - 1) * 8 * 32 * 2
    # resident weights, then one (2, 16 m_tiles, 8) f32 block of partial
    # sums per warp
    assert plan.smem_bytes == resident + 8 * 2 * 16 * m_tiles * units * 4


def test_lstm2_plan_fits_beside_its_partial_sums():
    plan = LT.bwd_plan(16, 1024, 2, True, H100_SMS)
    assert plan.smem_bytes == 206336 <= LT.SMEM_MAX
    assert plan.pairs == 1


@pytest.mark.parametrize("B,H,L", [(16, 1024, 2), (16, 512, 1),
                                   (48, 256, 3), (5, 128, 3)])
def test_f32_is_never_resident(B, H, L):
    plan = LT.bwd_plan(B, H, L, False, H100_SMS)
    assert plan.route == "fma" and plan.resident_bytes == 0
    assert plan.m_tiles == 0
    # the 8-row f32 stage and warp sums, then two halves' partial sums
    mpad = -(-plan.rows // 8) * 8
    assert plan.smem_bytes == (8 * 4 * H + 8 * 2 * 8) * 4 + \
        2 * 2 * mpad * plan.units * 4


def test_weights_too_large_stay_in_l2():
    # three 2 x 1024 layers: 5 weight matrices, 330,240 B for 8 units
    plan = LT.bwd_plan(16, 1024, 3, True, H100_SMS)
    assert plan.route == "mma_l2" and plan.resident_bytes == 0
    assert plan.smem_bytes == 8 * 2 * 16 * 8 * 4


def test_wide_stack_takes_more_units_a_block():
    plan = LT.bwd_plan(16, 2048, 1, True, H100_SMS)
    assert plan.units == 16 and plan.blocks == 128
    assert plan.route == "mma_l2"


def test_large_batch_runs_in_row_groups():
    # the speaker encoder's training batch (64 speakers x 10 utterances)
    plan = LT.bwd_plan(640, 256, 3, True, H100_SMS)
    assert plan.groups == 5 and plan.rows == 128 and plan.m_tiles == 8
    assert plan.pairs == 4
    assert plan.groups * plan.rows >= 640


@pytest.mark.parametrize("sms", [132, 114, 78])
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("B,H,L", [
    (1, 16, 1), (3, 64, 1), (11, 256, 2), (16, 512, 1), (16, 1024, 2),
    (33, 1024, 2), (48, 256, 3), (64, 1024, 2), (129, 1024, 2),
    (16, 1024, 3), (640, 256, 3), (16, 1056, 4), (7, 1536, 2)])
def test_every_plan_fits_the_card(sms, bf16, B, H, L):
    plan = LT.bwd_plan(B, H, L, bf16, sms)
    assert plan.smem_bytes <= LT.SMEM_MAX
    assert plan.blocks <= sms and plan.blocks * plan.units >= H
    assert plan.units % 8 == 0
    assert 1 <= plan.pairs <= LT.MAX_PAIRS
    assert plan.groups * plan.rows >= B > (plan.groups - 1) * plan.rows
    if bf16:
        assert plan.m_tiles * 16 >= plan.rows > (plan.m_tiles - 1) * 16


@pytest.mark.parametrize("B,H,L,bf16", [
    (4, 100, 1, True), (4, 64, 5, True), (0, 64, 1, True),
    # f32 stages 8 rows of 4H f32 values: 256 KB at H = 2048
    (7, 2048, 2, False)])
def test_unsupported_geometries_raise(B, H, L, bf16):
    with pytest.raises(ValueError):
        LT.bwd_plan(B, H, L, bf16, H100_SMS)


def test_depth_check_matches_the_plan():
    # the check StackTrain's forward makes before kernel 6 launches
    LT.check_depth(LT.MAX_LAYERS)
    LT.bwd_plan(16, 256, LT.MAX_LAYERS, True, H100_SMS)
    with pytest.raises(ValueError, match="at most"):
        LT.check_depth(LT.MAX_LAYERS + 1)
