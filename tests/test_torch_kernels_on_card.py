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
import pytest
import torch

from autovc_tpu_torch.config import WaveRNNConfig
from autovc_tpu_torch.models import wavernn as WR
from autovc_tpu_torch.ops import lstm_kernels as LK
from autovc_tpu_torch.ops import precision as PREC
from autovc_tpu_torch.ops import rnn as R
from autovc_tpu_torch.ops import wavernn_kernels as WK
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


@pytest.mark.cuda
@pytest.mark.parametrize("fast_math,dims,rows", [
    (False, 64, 3), (True, 128, 3), (True, 128, 16), (True, 512, 16)])
def test_sampling_kernel_matches_plain(cuda_device, fast_math, dims, rows):
    """f32 at atol 1e-3; bf16 (rnn_dims a multiple of 128: the tensor-core
    GRU stages) at atol 1e-2."""
    cfg = WaveRNNConfig().with_overrides(rnn_dims=dims, fc_dims=dims,
                                         **SMALL)
    gen = torch.Generator().manual_seed(1)
    params = from_jax_params(WR.init(gen, cfg), cuda_device)
    J = WR._upsample_margin(params["upsample"]["up_convs"],
                            cfg.upsample_factors)
    frames = 10
    mel_rows = torch.rand(rows, frames + 2 * J, cfg.feat_dims, generator=gen)
    aux_rows = torch.randn(rows, frames, cfg.res_out_dims, generator=gen)
    inp = WK.prepare_rows(params, mel_rows.to(cuda_device),
                          aux_rows.to(cuda_device), cfg, fast_math)
    noise_gen = torch.Generator(device=cuda_device).manual_seed(0)
    gum, lgs = WK.draw_noise(inp.steps, rows, inp.pick_dim, noise_gen,
                             cuda_device)
    lane = torch.randint(0, inp.pick_dim, (inp.steps, rows, 1), generator=gen)
    gum = gum.scatter(-1, lane.to(cuda_device), 1e3)
    if fast_math:
        gum, lgs = PREC.round_bf16(gum), PREC.round_bf16(lgs)
    gum, lgs = gum.contiguous(), lgs.contiguous()
    out = WK.launch(inp, gum, lgs)
    ref = WK.sample_rows_plain(inp, gum, lgs)
    torch.testing.assert_close(out, ref, atol=1e-2 if fast_math else 1e-3,
                               rtol=0)
