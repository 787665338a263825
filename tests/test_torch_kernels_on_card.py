"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  A CUDA kernel has no CPU mode, so every test here is marked
``cuda`` and skips where no GPU is present.  The file imports nothing of
JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_on_card.py

Kernel 1 is held over every step with pinned noise: one Gumbel lane per
step and row raised by 1e3, so the sampled mixture component does not hang
on the logits' last bits and the kernel and the plain loop (which sum in
another order) stay on one sample path."""
import dataclasses

import pytest
import torch

from autovc_tpu_torch.config import SpeakerEncoderConfig, WaveRNNConfig
from autovc_tpu_torch.models import speaker_encoder as SE
from autovc_tpu_torch.models import wavernn as WR
from autovc_tpu_torch.ops import gru_train_kernels as GT
from autovc_tpu_torch.ops import lstm_kernels as LK
from autovc_tpu_torch.ops import lstm_train_kernels as LT
from autovc_tpu_torch.ops import precision as PREC
from autovc_tpu_torch.ops import rnn as R
from autovc_tpu_torch.ops import wavernn_kernels as WK
from autovc_tpu_torch.train import loop as TL
from autovc_tpu_torch.train import schedules as TS
from autovc_tpu_torch.utils import tree_leaves
from autovc_tpu_torch.utils.bridge import from_jax_params

SMALL = dict(compute_dims=16, res_out_dims=16, res_blocks=2,
             upsample_factors=(2, 2), hop_length=4)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    PREC.exact_f32()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,kernel", [(2, "SKEWED"), (24, "STREAM")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_kernel_matches_plain(cuda_device, rows, kernel, dtype):
    gen = torch.Generator().manual_seed(5)
    params = from_jax_params(R.init_lstm_stack(gen, 64, 256, 2), cuda_device)
    x = torch.randn(rows, 40, 64, generator=gen).to(cuda_device)
    xp0 = LK.hoist_xp0(params[0], x, "f32")
    whh, wih, bias = LK.pack_stack(params, dtype)
    out = LK.launch(getattr(LK, kernel), xp0, whh, wih, bias)
    ref = LK.lstm_stack_plain(xp0, whh, wih, bias)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    else:
        assert float((out - ref).abs().max()) < 2e-2 * float(ref.abs().max())


def _small_case(dev, L, rows, H, dtype, T=23, I=64):
    """Kernel 2 against the plain version on its device plan: f32 at atol
    1e-4, bf16 within 2e-2 of max |ref|.  Returns the plan."""
    gen = torch.Generator().manual_seed(L * 1000 + rows * 10 + H)
    params = from_jax_params(R.init_lstm_stack(gen, I, H, L), dev)
    x = torch.randn(rows, T, I, generator=gen).to(dev)
    xp0 = LK.hoist_xp0(params[0], x, "f32")
    packed = LK.pack_stack(params, dtype)
    LK.SKEWED.launches = 0
    out = LK.launch(LK.SKEWED, xp0, *packed)
    assert LK.SKEWED.launches == 1
    ref = LK.lstm_stack_plain(xp0, *packed)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    else:
        _close(out, ref, lambda s: 2e-2 * s)
    return LK.device_small_plan(rows, H, L, dtype == torch.bfloat16, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 2, 3])
@pytest.mark.parametrize("rows", [1, 2, 5, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_small_stack_kernel_matches_plain(cuda_device, L, rows, dtype):
    """Kernel 2 at 1-8 rows and depths 1-3, H = 128 (every layer its own
    blocks where L > 1)."""
    plan = _small_case(cuda_device, L, rows, 128, dtype)
    assert plan.split == (L > 1)


@pytest.mark.cuda
@pytest.mark.parametrize("L,rows,H,dtype,route,split,units", [
    # blocks of every layer: lstm2's width, three layers at 512 (192
    # one-layer blocks do not fit), resident or from L2 (three layers at
    # 1024); 16 units a block (H = 1072 > 8 x 132); H % 32 == 16
    (2, 1, 1024, torch.bfloat16, "mma_smem", False, 8),
    (2, 8, 1024, torch.float32, "fma", False, 8),
    (3, 8, 512, torch.bfloat16, "mma_smem", False, 8),
    (3, 2, 1024, torch.bfloat16, "mma_l2", False, 8),
    (1, 3, 1072, torch.bfloat16, "mma_smem", False, 16),
    (1, 7, 1072, torch.float32, "fma", False, 16),
    (2, 4, 272, torch.bfloat16, "mma_smem", True, 8)])
def test_small_stack_kernel_at_its_plan_edges(cuda_device, L, rows, H, dtype,
                                              route, split, units):
    plan = _small_case(cuda_device, L, rows, H, dtype, T=11)
    if torch.cuda.get_device_properties(
            cuda_device).multi_processor_count == 132:
        assert (plan.route, plan.split, plan.units) == (route, split, units)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_small_launch_refuses_a_plan_that_disagrees(cuda_device, dtype):
    """Kernel 2's C launch recomputes the kernel's layout from the plan it
    is given and refuses one that disagrees (shared-memory bytes, a layer
    split that does not match them, more than 16 units, a resident route
    in f32): it returns an error, which the wrapper raises, and nothing
    runs."""
    T, B, H, L = 5, 3, 64, 2
    dev = cuda_device
    bf16 = dtype == torch.bfloat16
    xp0 = torch.zeros(T, B, 4 * H, device=dev)
    whh = torch.zeros(L, 4 * H, H, device=dev, dtype=dtype)
    wih = torch.zeros(L - 1, 4 * H, H, device=dev, dtype=dtype)
    bias = torch.zeros(L - 1, 4 * H, device=dev)
    out = torch.full((T, B, H), 7.0, device=dev)
    ring = torch.empty(2, L, B, H, device=dev, dtype=dtype)

    def launch(p):
        bar = torch.zeros(1, dtype=torch.int32, device=dev)
        LK.SKEWED(xp0.data_ptr(), whh.data_ptr(), wih.data_ptr(),
                  bias.data_ptr(), out.data_ptr(), ring.data_ptr(),
                  bar.data_ptr(), T, B, H, L, p.units, int(p.split),
                  int(p.route == "mma_smem"), p.smem_bytes, int(bf16),
                  torch.cuda.current_stream(dev).cuda_stream)

    plan = LK.device_small_plan(B, H, L, bf16, dev)
    bad = [dataclasses.replace(plan, smem_bytes=plan.smem_bytes + 16),
           dataclasses.replace(plan, split=not plan.split),
           dataclasses.replace(plan, units=24)]
    if not bf16:
        bad.append(dataclasses.replace(plan, route="mma_smem"))
    LK.SKEWED.launches = 0
    for p in bad:
        with pytest.raises(RuntimeError, match="lstm_stack_skewed_launch"):
            launch(p)
    torch.cuda.synchronize()
    assert LK.SKEWED.launches == 0 and bool((out == 7.0).all())
    launch(plan)
    torch.cuda.synchronize()
    # zero weights and pre-activations: c = 0, so h = 0 at every step
    assert LK.SKEWED.launches == 1 and bool((out == 0.0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("L,B,H,dtype", [
    (1, 3, 64, torch.float32), (2, 11, 256, torch.float32),
    (3, 5, 128, torch.float32), (2, 11, 256, torch.bfloat16),
    (1, 16, 512, torch.bfloat16),
    # kernels 6/7's bf16 edges: lstm2 width, a ragged M-tile, the speaker
    # encoder's stack (3 M-tiles), weights too large to be resident (the
    # "mma_l2" route, up to the deepest stack StackTrain takes), row groups
    # (kernel 6: 3 groups at 150 rows, 2 at 100)
    (2, 16, 1024, torch.bfloat16), (2, 33, 1024, torch.bfloat16),
    (3, 48, 256, torch.bfloat16), (3, 16, 1024, torch.bfloat16),
    (4, 16, 1024, torch.bfloat16), (1, 150, 256, torch.bfloat16),
    (2, 100, 256, torch.bfloat16),
    # H % 32 == 16: the forward's last K chunk is half full
    (2, 20, 272, torch.bfloat16)])
def test_lstm_train_kernels_match_plain(cuda_device, L, B, H, dtype):
    """Kernels 6 and 7 against their plain versions, with cotangents on ys,
    h_fin and c_fin: f32 forward at atol 1e-5 and each gradient within 1e-4
    of its max |ref| (dW sums T * B products in another order); bf16
    within 2e-2 of max |ref|."""
    T = 13
    gen = torch.Generator().manual_seed(L * 100 + H)

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(cuda_device)

    xp0 = rand(T, B, 4 * H)
    whh, wih = rand(L, H, 4 * H, scale=H ** -0.5), rand(L - 1, H, 4 * H,
                                                        scale=H ** -0.5)
    bias = rand(L - 1, 4 * H, scale=0.1)
    wf = LT.pack_fwd(whh, wih, dtype)
    out = LT.fwd_launch(xp0, *wf, bias)
    ref = LT.lstm_train_fwd_plain(xp0, *wf, bias)
    bf16 = dtype == torch.bfloat16

    def close(a, b, fwd):
        assert a.shape == b.shape
        if not b.numel():          # dW_ih of a one-layer stack
            return
        a, b = a.float(), b.float()
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        bar = 2e-2 * scale if bf16 else (1e-5 if fwd else 1e-4 * scale)
        assert err <= bar, (err, scale)

    for a, b in zip(out, ref):
        close(a, b, True)
    cts = (rand(T, B, H), rand(B, H), rand(B, H))
    wb = LT.pack_bwd(whh, wih, dtype)
    got = LT.bwd_launch(ref[5], ref[3], ref[4], *cts, *wb)
    want = LT.lstm_train_bwd_plain(ref[5], ref[3], ref[4], *cts, *wb)
    for a, b in zip(got, want):
        close(a, b, False)


@pytest.mark.cuda
def test_lstm_train_kernels_at_the_ge2e_batch(cuda_device):
    """Kernels 6 and 7 at the speaker encoder's training geometry: 3 x 256
    on 40 mels, a GE2E batch of 64 speakers x 8 utterances (512 rows) of
    160 frames, bf16, the cotangent on h_fin only (the loss reads the last
    layer's final h).  Both kernels take more than one row group here
    (kernel 6 8 x 64 rows, kernel 7 4 x 128 on 132 SMs).  Within 2e-2 of
    max |ref| of the plain versions."""
    L, H, I, B, T = 3, 256, 40, 512, 160
    gen = torch.Generator().manual_seed(11)
    params = from_jax_params(R.init_lstm_stack(gen, I, H, L), cuda_device)
    x = torch.randn(B, T, I, generator=gen).to(cuda_device)
    xp0 = LK.hoist_xp0(params[0], x, "bf16")
    whh = torch.stack([p["w_hh"] for p in params])
    wih = torch.stack([p["w_ih"] for p in params[1:]])
    bias = torch.stack([p["b_ih"] + p["b_hh"] for p in params[1:]])
    sms = torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    assert LK.fwd_plan(B, H, L, True, sms).groups > 1
    assert LT.bwd_plan(B, H, L, True, sms).groups > 1
    wf = LT.pack_fwd(whh, wih, torch.bfloat16)
    out = LT.fwd_launch(xp0, *wf, bias)
    ref = LT.lstm_train_fwd_plain(xp0, *wf, bias)
    for a, b in zip(out, ref):
        _close(a, b, lambda s: 2e-2 * s)
    cts = (torch.zeros(T, B, H, device=cuda_device),
           torch.randn(B, H, generator=gen).to(cuda_device),
           torch.zeros(B, H, device=cuda_device))
    wb = LT.pack_bwd(whh, wih, torch.bfloat16)
    got = LT.bwd_launch(ref[5], ref[3], ref[4], *cts, *wb)
    want = LT.lstm_train_bwd_plain(ref[5], ref[3], ref[4], *cts, *wb)
    for a, b in zip(got, want):
        _close(a, b, lambda s: 2e-2 * s)


@pytest.mark.cuda
def test_bf16_se_step_on_the_card(cuda_device):
    """One bf16 GE2E step of ``make_se_step`` at the speaker encoder's full
    width and a GE2E batch (64 speakers x 8 utterances x 160 frames):
    kernels 6 and 7 launch once each, the loss and every gradient are
    finite, and the step moves the weights."""
    cfg = SpeakerEncoderConfig()
    gen = torch.Generator().manual_seed(12)
    params = from_jax_params(SE.init(gen, cfg), cuda_device)
    protos = 4.0 * torch.rand(64, 1, 1, 40, generator=gen)
    batch = protos + torch.rand(64, 8, 160, 40, generator=gen)
    LT.FWD.launches = LT.BWD.launches = 0
    loss, grads = TL.se_loss_and_grads(params, batch, "bf16")
    assert (LT.FWD.launches, LT.BWD.launches) == (1, 1)
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    tx = TS.make_optimizer(cfg.optimizer, 8, dim_model=cfg.embedding_size)
    before = params["lstm"][2]["w_hh"].clone()
    _, state, aux = TL.make_se_step(cfg, tx)(
        params, tx.init(tree_leaves(params)), batch)
    assert state["count"] == 1 and bool(torch.isfinite(aux["grad_norm"]))
    assert not torch.equal(before, params["lstm"][2]["w_hh"])


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [9, 33])
def test_lstm_stream_at_lstm2_width(cuda_device, rows):
    """Kernel 3 at the decoder lstm2's width (2 x 1024, input 512), bf16:
    one M-tile at 9 rows, a ragged third at 33; within 2e-2 of max |ref|."""
    gen = torch.Generator().manual_seed(rows)
    params = from_jax_params(R.init_lstm_stack(gen, 512, 1024, 2),
                             cuda_device)
    x = torch.randn(rows, 24, 512, generator=gen).to(cuda_device)
    xp0 = LK.hoist_xp0(params[0], x, "bf16")
    packed = LK.pack_stack(params, torch.bfloat16)
    LK.STREAM.launches = 0
    out = LK.launch(LK.STREAM, xp0, *packed)
    assert LK.STREAM.launches == 1
    _close(out, LK.lstm_stack_plain(xp0, *packed), lambda s: 2e-2 * s)


@pytest.mark.cuda
def test_lstm_stack_train_runs_the_kernels(cuda_device):
    """On CUDA tensors ``lstm_stack_train`` launches kernel 6 once forward
    and kernel 7 once backward, and its gradients match the CPU path's."""
    gen = torch.Generator().manual_seed(5)
    params = R.init_lstm_stack(gen, 24, 64, 2)
    x = torch.randn(3, 17, 24, generator=gen)
    grads = {}
    for dev in ("cpu", cuda_device):
        p = [{k: v.to(dev, copy=True).requires_grad_(True)
              for k, v in lp.items()} for lp in params]
        LT.FWD.launches = LT.BWD.launches = 0
        ys, (h, c) = LT.lstm_stack_train(p, x.to(dev), "f32")
        (torch.sum(torch.sin(ys)) + torch.sum(h * c)).backward()
        launched = (LT.FWD.launches, LT.BWD.launches)
        assert launched == ((0, 0) if dev == "cpu" else (1, 1))
        grads[str(dev)] = [v.grad.cpu() for lp in p for v in lp.values()]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.cuda
def test_lstm_stack_train_refuses_a_deep_stack_before_launching(cuda_device):
    """Kernel 7 carries at most ``MAX_LAYERS`` layers' state: a deeper
    stack raises in the forward, before kernel 6 launches."""
    gen = torch.Generator().manual_seed(6)
    params = from_jax_params(
        R.init_lstm_stack(gen, 16, 32, LT.MAX_LAYERS + 1), cuda_device)
    x = torch.randn(2, 5, 16, generator=gen).to(cuda_device)
    LT.FWD.launches = 0
    with pytest.raises(ValueError, match="at most"):
        LT.lstm_stack_train(params, x, "f32")
    assert LT.FWD.launches == 0


def _close(a, b, bar_of):
    assert a.shape == b.shape
    a, b = a.float(), b.float()
    err, scale = float((a - b).abs().max()), float(b.abs().max())
    assert err <= bar_of(scale), (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,dtype,T", [
    (3, 64, torch.float32, 13), (11, 128, torch.float32, 13),
    (8, 512, torch.float32, 13), (10, 256, torch.bfloat16, 13),
    (8, 512, torch.bfloat16, 13),
    # kernel 5's plan and schedule: one, two and three M-tiles (16, 17
    # and 33 rows, the last two ragged), one row, H % 32 == 16 (a K chunk
    # half past 3H), a block of both layers (H = 1024: 2 x 128 blocks do
    # not fit the card), and T = 1 and 2 (the first and last rounds alone)
    (1, 64, torch.bfloat16, 13), (16, 128, torch.bfloat16, 13),
    (17, 128, torch.bfloat16, 13), (33, 128, torch.bfloat16, 13),
    (33, 128, torch.float32, 13), (16, 48, torch.float32, 13),
    (16, 48, torch.bfloat16, 13), (5, 1024, torch.bfloat16, 6),
    (5, 1024, torch.float32, 6), (17, 128, torch.bfloat16, 1),
    (17, 128, torch.float32, 1), (1, 64, torch.bfloat16, 2),
    (33, 128, torch.float32, 2),
    # four M-tiles, and two row groups of 33
    (64, 64, torch.bfloat16, 4), (65, 64, torch.bfloat16, 5)])
def test_gru_train_kernels_match_plain(cuda_device, B, H, dtype, T):
    """Kernels 4 and 5 against their plain versions, cotangents on h1 and
    h2: f32 forward atol 1e-5 and each gradient within 1e-4 of its max
    |ref| (dW sums T * B products in another order); bf16 within 2e-2 of
    max |ref|.  B = 10, 11 take two 8-row tiles of the f32 products."""
    gen = torch.Generator().manual_seed(B * 1000 + H)

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(cuda_device)

    xp1, base2 = rand(T, B, 3 * H), rand(T, B, 3 * H)
    whh1, wih2x, whh2 = (rand(H, 3 * H, scale=H ** -0.5) for _ in range(3))
    bhh1, bhh2 = rand(3 * H, scale=0.1), rand(3 * H, scale=0.1)
    bf16 = dtype == torch.bfloat16
    wf = GT.pack_fwd(whh1, wih2x, whh2, dtype)
    out = GT.fwd_launch(xp1, base2, *wf, bhh1, bhh2)
    ref = GT.gru_pair_fwd_plain(xp1, base2, *wf, bhh1, bhh2)
    for a, b in zip(out, ref):
        _close(a, b, (lambda s: 2e-2 * s) if bf16 else (lambda s: 1e-5))
    cts = (rand(T, B, H), rand(T, B, H))
    wb = GT.pack_bwd(whh1, wih2x, whh2, dtype)
    got = GT.bwd_launch(ref[1], ref[0], *cts, *wb)
    want = GT.gru_pair_bwd_plain(ref[1], ref[0], *cts, *wb)
    for a, b in zip(got, want):
        _close(a, b, (lambda s: 2e-2 * s) if bf16 else (lambda s: 1e-4 * s))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,dtype,T,route,split,m_tiles,groups", [
    # kernel 4's plan: one row, ragged 17 / 33 rows (two and three
    # M-tiles), four M-tiles, two row groups (65 rows), H = 1024 (blocks
    # of both layers: 2 x 128 one-layer blocks do not fit the card), the
    # first and last rounds alone (T = 1, 2), H % 32 == 16, and f32
    (1, 64, torch.bfloat16, 9, "mma_smem", True, 1, 1),
    (17, 128, torch.bfloat16, 9, "mma_smem", True, 2, 1),
    (33, 128, torch.bfloat16, 9, "mma_smem", True, 3, 1),
    (64, 64, torch.bfloat16, 5, "mma_smem", True, 4, 1),
    (65, 64, torch.bfloat16, 5, "mma_smem", True, 3, 2),
    (5, 1024, torch.bfloat16, 6, "mma_smem", False, 1, 1),
    (17, 128, torch.bfloat16, 1, "mma_smem", True, 2, 1),
    (1, 64, torch.bfloat16, 2, "mma_smem", True, 1, 1),
    (16, 48, torch.bfloat16, 7, "mma_smem", True, 1, 1),
    (1, 64, torch.float32, 9, "fma", True, 0, 1),
    (33, 128, torch.float32, 2, "fma", True, 0, 1),
    (65, 64, torch.float32, 5, "fma", True, 0, 2),
    (5, 1024, torch.float32, 6, "fma", False, 0, 1)])
def test_gru_fwd_kernel_at_its_plan_edges(cuda_device, B, H, dtype, T,
                                          route, split, m_tiles, groups):
    """Kernel 4 (h and the saved r, z, n, hn) against its plain version on
    the plan each geometry takes (asserted): f32 atol 1e-5, bf16 2e-2 of
    max |ref|."""
    gen = torch.Generator().manual_seed(B * 100 + H + T)

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(cuda_device)

    xp1, base2 = rand(T, B, 3 * H), rand(T, B, 3 * H)
    ws = [rand(H, 3 * H, scale=H ** -0.5) for _ in range(3)]
    bhh1, bhh2 = rand(3 * H, scale=0.1), rand(3 * H, scale=0.1)
    bf16 = dtype == torch.bfloat16
    plan = GT.device_fwd_plan(B, H, bf16, cuda_device)
    assert (plan.route, plan.split, plan.m_tiles, plan.groups) == (
        route, split, m_tiles, groups)
    wf = GT.pack_fwd(*ws, dtype)
    GT.FWD.launches = 0
    out = GT.fwd_launch(xp1, base2, *wf, bhh1, bhh2)
    assert GT.FWD.launches == 1
    ref = GT.gru_pair_fwd_plain(xp1, base2, *wf, bhh1, bhh2)
    for a, b in zip(out, ref):
        _close(a, b, (lambda s: 2e-2 * s) if bf16 else (lambda s: 1e-5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gru_fwd_launch_refuses_a_plan_that_disagrees(cuda_device, dtype):
    """Kernel 4's C launch recomputes the kernel's layout from the plan it
    is given and refuses one that disagrees (shared-memory bytes, a layer
    split that does not match them, a resident route in f32): it returns
    an error, which the wrapper raises, and nothing runs."""
    B, T, H = 8, 3, 64
    dev = cuda_device
    bf16 = dtype == torch.bfloat16
    xp1 = torch.zeros(T, B, 3 * H, device=dev)
    wf = GT.pack_fwd(*(torch.zeros(H, 3 * H, device=dev) for _ in range(3)),
                     dtype)
    b = torch.zeros(3 * H, device=dev)
    hs = torch.full((2, T, B, H), 7.0, device=dev)
    acts = torch.empty(2, T, B, 4 * H, device=dev, dtype=dtype)
    ring = torch.empty(2, 2, B, H, device=dev, dtype=dtype)
    bar = torch.zeros(1, dtype=torch.int32, device=dev)

    def launch(p):
        GT.FWD(xp1.data_ptr(), xp1.data_ptr(), *(w.data_ptr() for w in wf),
               b.data_ptr(), b.data_ptr(), hs.data_ptr(), acts.data_ptr(),
               ring.data_ptr(), bar.data_ptr(), T, B, H, p.units, p.rows,
               int(p.route == "mma_smem"), int(p.split), p.smem_bytes,
               int(bf16), torch.cuda.current_stream(dev).cuda_stream)

    plan = GT.device_fwd_plan(B, H, bf16, dev)
    bad = [dataclasses.replace(plan, smem_bytes=plan.smem_bytes + 16),
           dataclasses.replace(plan, split=not plan.split)]
    if not bf16:
        bad.append(dataclasses.replace(plan, route="mma_smem"))
    GT.FWD.launches = 0
    for p in bad:
        with pytest.raises(RuntimeError, match="gru_train_fwd_launch"):
            launch(p)
    torch.cuda.synchronize()
    assert GT.FWD.launches == 0 and bool((hs == 7.0).all())
    launch(plan)
    torch.cuda.synchronize()
    assert GT.FWD.launches == 1 and bool((hs == 0.0).all())


@pytest.mark.cuda
def test_gru_pair_runs_the_kernels(cuda_device):
    """On CUDA tensors ``gru_pair`` launches kernel 4 once forward and
    kernel 5 once backward, and its gradients match the CPU path's."""
    B, T, H = 4, 21, 64
    gen = torch.Generator().manual_seed(9)
    args = [torch.randn(T, B, 3 * H, generator=gen),
            torch.randn(T, B, 3 * H, generator=gen)] + [
        0.1 * torch.randn(*s, generator=gen)
        for s in ((H, 3 * H), (H, 3 * H), (3 * H,), (H, 3 * H), (3 * H,))]
    grads = {}
    for dev in ("cpu", cuda_device):
        a = [t.to(dev, copy=True).requires_grad_(True) for t in args]
        GT.FWD.launches = GT.BWD.launches = 0
        h1, h2 = GT.gru_pair(*a)
        (torch.sum(torch.sin(h2)) + torch.sum(h1 * h1)).backward()
        launched = (GT.FWD.launches, GT.BWD.launches)
        assert launched == ((0, 0) if dev == "cpu" else (1, 1))
        grads[str(dev)] = [t.grad.cpu() for t in a]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        _close(a, b, lambda s: 1e-4 * s)


@pytest.mark.cuda
@pytest.mark.parametrize("L,I,H,rows,kernel", [
    (3, 40, 256, 3, "SKEWED"), (1, 320, 512, 9, "STREAM"),
    # kernel 3 at the speaker encoder's stack, and deeper than kernel 7's
    # MAX_LAYERS (at 9 layers a round's layers take two waves of warps):
    # inference has no depth limit
    (3, 40, 256, 12, "STREAM"), (5, 64, 256, 10, "STREAM"),
    (9, 32, 256, 10, "STREAM")])
def test_bf16_scan_stacks_run_the_kernels(cuda_device, L, I, H, rows,
                                          kernel):
    """The speaker encoder's stack and decoder lstm1 at inference under the
    bf16 policy: kernel 2 (<= 8 rows) or 3 in bf16, against the plain
    version on the CPU within 2e-2 of max |ref|."""
    gen = torch.Generator().manual_seed(L)
    params = R.init_lstm_stack(gen, I, H, L)
    x = torch.randn(rows, 30, I, generator=gen)
    ref = LK.lstm_stack_rec(params, x, "bf16")
    k = getattr(LK, kernel)
    k.launches = 0
    out = LK.lstm_stack_rec(from_jax_params(params, cuda_device),
                            x.to(cuda_device), "bf16")
    assert k.launches == 1
    _close(out.cpu(), ref, lambda s: 2e-2 * s)


def _sampling_case(device, fast_math: bool, dims: int, rows: int,
                   pinned: bool = True, **over):
    """Kernel 1 against the plain loop at rnn_dims = fc_dims = ``dims``,
    ``rows`` x 10 frames, pinned noise: f32 at atol 1e-3, bf16 at 1e-2.
    With drawn noise (``pinned=False``) the first frame is held so (a pick
    that one side flips on a near-tie later decorrelates the streams), and
    in RAW every sample is one of the classes' values.  Returns the plan
    it ran on."""
    cfg = WaveRNNConfig().with_overrides(rnn_dims=dims, fc_dims=dims,
                                         **SMALL, **over)
    gen = torch.Generator().manual_seed(1)
    params = from_jax_params(WR.init(gen, cfg), device)
    J = WR._upsample_margin(params["upsample"]["up_convs"],
                            cfg.upsample_factors)
    frames = 10
    mel_rows = torch.rand(rows, frames + 2 * J, cfg.feat_dims, generator=gen)
    aux_rows = torch.randn(rows, frames, cfg.res_out_dims, generator=gen)
    inp = WK.prepare_rows(params, mel_rows.to(device),
                          aux_rows.to(device), cfg, fast_math)
    noise_gen = torch.Generator(device=device).manual_seed(0)
    gum, lgs = WK.draw_noise(inp.steps, rows, inp.pick_dim, noise_gen,
                             device)
    lane = torch.randint(0, inp.pick_dim, (inp.steps, rows, 1), generator=gen)
    if pinned:
        gum = gum.scatter(-1, lane.to(device), 1e3)
    if fast_math:
        gum, lgs = PREC.round_bf16(gum), PREC.round_bf16(lgs)
    gum, lgs = gum.contiguous(), lgs.contiguous()
    out = WK.launch(inp, gum, lgs)
    ref = WK.sample_rows_plain(inp, gum, lgs)
    held = slice(None) if pinned else slice(0, cfg.total_scale)
    torch.testing.assert_close(out[:, held], ref[:, held],
                               atol=1e-2 if fast_math else 1e-3, rtol=0)
    if inp.raw_mode:
        pick = (out + 1.0) * (inp.n_classes - 1) / 2
        torch.testing.assert_close(pick, pick.round(), atol=1e-3, rtol=0)
    return WK.device_plan(inp, device)


@pytest.mark.cuda
@pytest.mark.parametrize("fast_math,dims,rows", [
    (False, 64, 3), (True, 128, 3), (True, 128, 16), (True, 512, 16),
    (True, 512, 48), (True, 512, 64), (True, 1024, 64)])
def test_sampling_kernel_matches_plain(cuda_device, fast_math, dims, rows):
    """f32 at atol 1e-3; bf16 (tensor-core products) at atol 1e-2, at the
    main path's row buckets 16, 48 and 64 (1, 3 and 4 M-tiles), and at
    rnn_dims = fc_dims = 1024, 64 rows, where the plan reads the GRU and
    fc rows from L2."""
    plan = _sampling_case(cuda_device, fast_math, dims, rows)
    if dims == 1024:
        assert plan.route == "mma_l2"


@pytest.mark.cuda
@pytest.mark.parametrize("fast_math", [False, True])
@pytest.mark.parametrize("rows,passes,state_smem", [
    (72, 2, True), (128, 2, True), (1000, 16, False)])
def test_sampling_kernel_in_several_passes(cuda_device, fast_math, rows,
                                           passes, state_smem):
    """More rows than one pass takes (64): a ragged count (72), 128 rows,
    and 1000 rows (an ~8-minute wav's folds), where the blocks' per-row
    state lives in L2; rnn_dims = fc_dims = 512, the bars above."""
    plan = _sampling_case(cuda_device, fast_math, 512, rows)
    assert (plan.passes, plan.state_smem) == (passes, state_smem)


@pytest.mark.cuda
def test_sampling_kernel_noise_from_l2(cuda_device):
    """RAW with 9 bits at 64 rows: fc3 (512 x 544 bf16) does not fit
    beside the GRU and fc rows, so the pick is split by class: each of the
    64 R1 blocks holds its 8 fc3 rows and prefetches their Gumbel lanes,
    and a step reads neither fc3 nor the noise from L2."""
    plan = _sampling_case(cuda_device, True, 512, 64, mode="RAW", bits=9)
    assert plan.slice_classes == 8 and plan.producers[-1] == 64
    assert plan.noise_smem and not plan.fc3_resident
    assert "fc3" not in plan.from_l2 and "noise" not in plan.from_l2


@pytest.mark.cuda
@pytest.mark.parametrize("pinned", [True, False])
@pytest.mark.parametrize("rows", [32, 64, 128])
def test_sampling_kernel_raw9_split_pick(cuda_device, rows, pinned):
    """RAW with 9 bits on the split pick at 32, 64 and 128 rows (two
    passes), rnn_dims = fc_dims = 512: pinned noise over every step, drawn
    noise over the first frame (bf16, atol 1e-2)."""
    plan = _sampling_case(cuda_device, True, 512, rows, pinned, mode="RAW",
                          bits=9)
    assert plan.slice_classes == 8 and plan.passes == -(-rows // 64)


@pytest.mark.cuda
def test_sampling_kernel_raw9_tie_goes_to_the_lower_class(cuda_device):
    """The split pick's tie rule within one R1 block's slice and across
    two: the fc3 rows and biases of classes 102 and 300 are class 100's
    and their Gumbel lanes are raised by 1e3 (exact in bf16), so every
    pick ties; every sample is class 100's, as ``torch.argmax`` (the
    first maximal index) picks."""
    cfg = WaveRNNConfig().with_overrides(rnn_dims=512, fc_dims=512, **SMALL,
                                         mode="RAW", bits=9)
    gen = torch.Generator().manual_seed(2)
    params = from_jax_params(WR.init(gen, cfg), cuda_device)
    for c in (102, 300):
        params["fc3"]["w"][c] = params["fc3"]["w"][100]
        params["fc3"]["b"][c] = params["fc3"]["b"][100]
    J = WR._upsample_margin(params["upsample"]["up_convs"],
                            cfg.upsample_factors)
    rows, frames = 32, 10
    mel_rows = torch.rand(rows, frames + 2 * J, cfg.feat_dims, generator=gen)
    aux_rows = torch.randn(rows, frames, cfg.res_out_dims, generator=gen)
    inp = WK.prepare_rows(params, mel_rows.to(cuda_device),
                          aux_rows.to(cuda_device), cfg, True)
    gum, lgs = WK.draw_noise(inp.steps, rows, inp.pick_dim,
                             torch.Generator(device=cuda_device).manual_seed(0),
                             cuda_device)
    gum = PREC.round_bf16(gum)
    gum[:, :, [100, 102, 300]] = 1e3
    gum, lgs = gum.contiguous(), PREC.round_bf16(lgs).contiguous()
    assert WK.device_plan(inp, cuda_device).slice_classes == 8
    out = WK.launch(inp, gum, lgs)
    want = torch.full_like(out, 2.0 * 100 / 511 - 1.0)
    torch.testing.assert_close(out, want, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,groups", [(128, 2), (256, 4)])
def test_lstm_stream_at_serving_slabs(cuda_device, rows, groups):
    """Kernel 3 at batch serving's largest slabs, lstm2's width (2 x 1024,
    input 512), bf16: 128 and 256 rows run 2 and 4 row groups one after
    another; within 2e-2 of max |ref|."""
    gen = torch.Generator().manual_seed(rows)
    params = from_jax_params(R.init_lstm_stack(gen, 512, 1024, 2),
                             cuda_device)
    x = torch.randn(rows, 24, 512, generator=gen).to(cuda_device)
    xp0 = LK.hoist_xp0(params[0], x, "bf16")
    packed = LK.pack_stack(params, torch.bfloat16)
    assert LK.device_plan(rows, 1024, 2, True, cuda_device).groups == groups
    LK.STREAM.launches = 0
    out = LK.launch(LK.STREAM, xp0, *packed)
    assert LK.STREAM.launches == 1
    _close(out, LK.lstm_stack_plain(xp0, *packed), lambda s: 2e-2 * s)


@pytest.mark.cuda
def test_sampling_kernel_f32_at_the_serving_slab(cuda_device):
    """Kernel 1 in f32 at batch serving's 64-row slab, rnn_dims = fc_dims
    = 512, pinned noise: atol 1e-3."""
    _sampling_case(cuda_device, False, 512, WR._MAX_SLAB_ROWS)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_small_stack_kernel_over_an_unchunked_utterance(cuda_device, dtype):
    """Kernel 2 at lstm2 (2 x 1024, input 512), one row, over the 1925
    frames of a 24 s wav's unchunked mel (``convert(cut=False)``): f32 at
    atol 1e-4, bf16 within 2e-2 of max |ref|."""
    _small_case(cuda_device, 2, 1, 1024, dtype, T=1925, I=512)


@pytest.mark.cuda
def test_convert_batch_on_the_card(cuda_device, tmp_path):
    """``convert_batch`` of three wavs (4, 8 and 12 s: 9 chunks) at the
    default config on the card: kernel 1 runs, and decoder lstm2 runs
    kernel 3 on the plan's slabs above 8 rows (kernel 2 at 8); finite
    waveforms as long as ``convert``'s."""
    import numpy as np

    from autovc_tpu_torch import Audio, VoiceConverter
    from autovc_tpu_torch.audio import dsp, io
    from autovc_tpu_torch.models import autoencoder as AE

    sr = 22050
    rng = np.random.default_rng(0)
    paths = []
    for k, sec in enumerate((4.0, 8.0, 12.0)):
        t = np.arange(int(sec * sr)) / sr
        wav = (0.2 * np.sin(2 * np.pi * (120 + 40 * k) * t)
               + 0.01 * rng.standard_normal(len(t))).astype(np.float32)
        paths.append(str(tmp_path / f"s{k}.wav"))
        io.save_wav(paths[-1], wav, sr)
    vc = VoiceConverter(verbose=False)
    mel_cfg = vc.AE.config.spectrogram
    rows = sum(len(dsp.compute_partial_slices(
        int(sec * sr), sr,
        partial_utterance_n_frames=mel_cfg.partial_utterance_n_frames,
        mel_window_step=mel_cfg.mel_window_step)[1])
        for sec in (4.0, 8.0, 12.0))
    plan = AE._slab_plan(rows)
    target = Audio(paths[0], sr)
    WK.SAMPLE.launches = LK.STREAM.launches = LK.SKEWED.launches = 0
    outs = vc.convert_batch(paths, target)
    assert WK.SAMPLE.launches >= 1
    assert (LK.STREAM.launches >= 1) == (max(plan) > 8), plan
    assert (LK.SKEWED.launches >= 1) == (min(plan) == 8), plan
    for p, out in zip(paths, outs):
        one = vc.convert(p, target, save_name=False)
        assert np.all(np.isfinite(out.wav))
        assert out.wav.shape == one.wav.shape
