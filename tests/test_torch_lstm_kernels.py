"""Kernels 2 and 3 (autovc_tpu_torch.ops.lstm_kernels): on CPU tensors the
wrappers take the plain version, held here against the JAX Pallas kernels
it replaces (``lstm_stack_pallas`` / ``lstm_stack_stream`` in interpret
mode) at the shapes of tests/test_lstm_pallas.py, rtol/atol 1e-5.  The
CUDA kernels are held against the plain version on the card in
tests/test_torch_kernels_on_card.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autovc_tpu.ops import lstm_pallas as LP
from autovc_tpu.ops import precision as JPREC
from autovc_tpu.ops import rnn as JR
from autovc_tpu_torch.ops import lstm_kernels as LK
from autovc_tpu_torch.utils.bridge import from_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path is thousands of small ops; one intra-op thread
    runs them fastest and keeps parallel test workers from contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(L, B, T, I, H, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    params = JR.init_lstm_stack(jax.random.PRNGKey(seed), I, H, L)
    x = (scale * rng.standard_normal((B, T, I))).astype(np.float32)
    return params, x


@pytest.mark.parametrize("L,B,T,I,H", [(1, 1, 13, 6, 8),
                                       (2, 3, 17, 10, 8),
                                       (3, 2, 9, 4, 16)])
def test_latency_plain_matches_pallas(L, B, T, I, H):
    params, x = _case(L, B, T, I, H, L * 100 + B)
    ref = LP.lstm_stack_pallas(params, jnp.asarray(x), interpret=True)
    out = LK.lstm_stack_latency(from_jax_params(params), torch.from_numpy(x))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("L,B,T,I,H", [(2, 12, 21, 10, 8),
                                       (1, 5, 40, 6, 16),
                                       (3, 9, 13, 4, 8)])
def test_stream_plain_matches_pallas(L, B, T, I, H):
    params, x = _case(L, B, T, I, H, L * 31 + B)
    ref = LP.lstm_stack_stream(params, jnp.asarray(x), interpret=True)
    out = LK.lstm_stack_stream(from_jax_params(params), torch.from_numpy(x))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_decoder_geometry_plain_matches_pallas():
    """The decoder lstm2 input width (512) and depth (2), reduced H and T."""
    params, x = _case(2, 1, 25, 512, 64, 0)
    ref = LP.lstm_stack_pallas(params, jnp.asarray(x), interpret=True)
    out = LK.lstm_stack_latency(from_jax_params(params), torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_bf16_plain_matches_pallas_bf16():
    """Under the bf16 policy at H >= 256 both sides round the operands to
    bf16 and accumulate in f32 (the kernels' deliberate deviation from the
    scan policy: bf16 at one row too)."""
    params, x = _case(2, 1, 12, 128, 256, 3, scale=0.5)
    with JPREC.compute("bf16"):
        ref = LP.lstm_stack_pallas(params, jnp.asarray(x), interpret=True)
    out = LK.lstm_stack_latency(from_jax_params(params), torch.from_numpy(x),
                                mode="bf16")
    # same roundings, other sum order: bf16-rounding flips of a few operands
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-3)
    f32 = LK.lstm_stack_latency(from_jax_params(params), torch.from_numpy(x))
    err = float((out - f32).abs().max())
    assert 0 < err < 2e-2 * float(f32.abs().max())


def test_latency_contract_rows():
    params, x = _case(1, 9, 4, 6, 8, 1)
    with pytest.raises(ValueError, match="at most 8 rows"):
        LK.lstm_stack_latency(from_jax_params(params), torch.from_numpy(x))


def test_pack_layout():
    """The kernels' layout: W (out, in) per layer, layers >= 1 biased by
    b_ih + b_hh."""
    params, _ = _case(2, 1, 1, 6, 8, 2)
    tp = from_jax_params(params)
    whh, wih, bias = LK.pack_stack(tp, torch.float32)
    assert whh.shape == (2, 32, 8) and wih.shape == (1, 32, 8)
    torch.testing.assert_close(whh[1], tp[1]["w_hh"].T)
    torch.testing.assert_close(bias[0], tp[1]["b_ih"] + tp[1]["b_hh"])


@pytest.mark.parametrize("rows", [2, 12])
def test_prepacked_weights_match_per_call_packing(rows):
    params, x = _case(2, rows, 11, 6, 16, 9)
    tp = from_jax_params(params)
    xt = torch.from_numpy(x)
    run = LK.lstm_stack_latency if rows <= LK.LATENCY_MAX_ROWS \
        else LK.lstm_stack_stream
    packed = LK.pack(tp, "f32")
    assert packed[0].dtype == torch.float32
    assert torch.equal(run(tp, xt, "f32", packed), run(tp, xt, "f32"))
