"""CPU parity of the port's plain ops (autovc_tpu_torch.ops: conv, rnn,
precision) and of its checkpoint reader + weight bridge against the JAX
package, in f32.  Inputs are made with numpy from fixed seeds; parameters
come from the JAX ``init`` functions through ``from_jax_params``."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from autovc_tpu.ops import conv as JC
from autovc_tpu.ops import precision as JPREC
from autovc_tpu.ops import rnn as JR
from autovc_tpu.utils import checkpoint as jckpt
from autovc_tpu_torch.ops import conv as TC
from autovc_tpu_torch.ops import precision as TPREC
from autovc_tpu_torch.ops import rnn as TR
from autovc_tpu_torch.utils import checkpoint as tckpt
from autovc_tpu_torch.utils.bridge import from_jax_params

# f32 on both sides; sums run in another order, so a few ulps of the
# O(1)-scaled outputs
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path is thousands of small ops; one intra-op thread
    runs them fastest and keeps parallel test workers from contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x)


def _random_bn(p, rng):
    c = p["bn"]["mean"].shape[0]
    return dict(p, bn={"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                       "bias": rng.normal(0, 0.1, c).astype(np.float32),
                       "mean": rng.normal(0, 0.2, c).astype(np.float32),
                       "var": rng.uniform(0.5, 2.0, c).astype(np.float32)})


@pytest.mark.parametrize("cin,cout,k,act", [(16, 24, 5, "relu"),
                                            (8, 8, 1, None),
                                            (12, 6, 5, "tanh")])
def test_conv_bn_parity(cin, cout, k, act):
    rng = np.random.default_rng(cin * 7 + k)
    jp = _random_bn(JC.init_conv_bn(jax.random.PRNGKey(cin), cin, cout, k),
                    rng)
    x = rng.standard_normal((2, cin, 19)).astype(np.float32)
    jact = {"relu": jax.nn.relu, "tanh": jnp.tanh, None: None}[act]
    tact = {"relu": torch.relu, "tanh": torch.tanh, None: None}[act]
    ref, _ = JC.conv_bn(jp, jnp.asarray(x), k, activation=jact)
    out = TC.conv_bn(from_jax_params(jp), torch.from_numpy(x), k,
                     activation=tact)
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=ATOL, rtol=1e-5)


def test_linear_parity():
    rng = np.random.default_rng(3)
    jp = JC.init_linear(jax.random.PRNGKey(3), 40, 24)
    x = rng.standard_normal((3, 7, 40)).astype(np.float32)
    ref = JC.linear(jp, jnp.asarray(x))
    out = TC.linear(from_jax_params(jp), torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("kind", ["layer", "stack", "skewed", "bilstm"])
def test_lstm_parity(kind):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 21, 10)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    if kind == "layer":
        jp = JR.init_lstm_layer(key, 10, 16)
        ref, (rh, rc) = JR.lstm_layer(jp, jnp.asarray(x))
        out, (h, c) = TR.lstm_layer(from_jax_params(jp), torch.from_numpy(x))
        np.testing.assert_allclose(h.numpy(), _np(rh), atol=ATOL)
        np.testing.assert_allclose(c.numpy(), _np(rc), atol=ATOL)
    elif kind in ("stack", "skewed"):
        jp = JR.init_lstm_stack(key, 10, 16, 3)
        jf = JR.lstm_stack if kind == "stack" else JR.lstm_stack_skewed
        tf = TR.lstm_stack if kind == "stack" else TR.lstm_stack_skewed
        ref, (rh, _), rfin = jf(jp, jnp.asarray(x))
        out, (h, _), fin = tf(from_jax_params(jp), torch.from_numpy(x))
        np.testing.assert_allclose(h.numpy(), _np(rh), atol=ATOL)
        np.testing.assert_allclose(fin.numpy(), _np(rfin), atol=ATOL)
    else:
        jp = JR.init_bilstm_stack(key, 10, 8, 2)
        ref = JR.bilstm_stack(jp, jnp.asarray(x))
        out = TR.bilstm_stack(from_jax_params(jp), torch.from_numpy(x))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=ATOL, rtol=1e-5)


def test_gru_parity():
    rng = np.random.default_rng(4)
    jp = JR.init_gru_layer(jax.random.PRNGKey(4), 12, 16)
    tp = from_jax_params(jp)
    xp = rng.standard_normal((2, 48)).astype(np.float32)
    h0 = rng.standard_normal((2, 16)).astype(np.float32)
    np.testing.assert_allclose(
        TR.gru_cell(tp, torch.from_numpy(xp), torch.from_numpy(h0)).numpy(),
        _np(JR.gru_cell(jp, jnp.asarray(xp), jnp.asarray(h0))), atol=ATOL)


def test_precision_policy():
    assert TPREC.resolve("auto", "cpu") == "f32"
    assert TPREC.resolve("auto", "cuda") == "bf16"
    assert TPREC.resolve("bf16", "cpu") == "bf16"
    with pytest.raises(ValueError):
        TPREC.resolve("fp16", "cpu")
    assert TPREC.REC_BF16_MIN_HIDDEN == JPREC.REC_BF16_MIN_HIDDEN
    assert TPREC.REC_BF16_MIN_ROWS == JPREC.REC_BF16_MIN_ROWS
    # the LSTM-stack kernels' gate: bf16 from H >= 256, at any row count
    assert TPREC.lstm_kernel_dtype("bf16", 256) == torch.bfloat16
    assert TPREC.lstm_kernel_dtype("bf16", 128) == torch.float32
    assert TPREC.lstm_kernel_dtype("f32", 1024) == torch.float32
    # bf16 operands, f32 accumulation: the same numbers as the JAX policy
    rng = np.random.default_rng(0)
    a = rng.standard_normal((5, 64)).astype(np.float32)
    b = rng.standard_normal((64, 7)).astype(np.float32)
    with JPREC.compute("bf16"):
        ref = JPREC.dot(jnp.asarray(a), jnp.asarray(b))
    out = TPREC.dot(torch.from_numpy(a), torch.from_numpy(b), "bf16")
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-5, rtol=1e-5)


def test_checkpoint_reader_and_bridge(tmp_path):
    """A .ckpt written by the JAX package reads back through the port's
    reader (bf16 via torch, no ml_dtypes) and the bridge, leaf for leaf."""
    rng = np.random.default_rng(2)
    params = {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
              "layers": [{"b": rng.standard_normal(5).astype(np.float32)},
                         {"b": rng.standard_normal(2).astype(np.float32)}],
              "scalar": np.float32(1.5)}
    half = rng.standard_normal((2, 3)).astype(ml_dtypes.bfloat16)
    path = str(tmp_path / "m.ckpt")
    jckpt.save_checkpoint(path, {"step": 7, "params": params, "half": half,
                                 "pair": (1, 2), "speakers": {}})
    blob = tckpt.load_checkpoint(path)
    assert blob["step"] == 7 and blob["pair"] == (1, 2)
    assert blob["half"].dtype == torch.bfloat16
    np.testing.assert_array_equal(blob["half"].float().numpy(),
                                  half.astype(np.float32))
    tp = from_jax_params(blob["params"])
    np.testing.assert_array_equal(tp["a"]["w"].numpy(), params["a"]["w"])
    for got, want in zip(tp["layers"], params["layers"]):
        np.testing.assert_array_equal(got["b"].numpy(), want["b"])
    assert float(tp["scalar"]) == 1.5
    assert tckpt.is_checkpoint(path)
    assert not tckpt.is_checkpoint(str(tmp_path / "missing.ckpt"))
    # the bridge takes JAX arrays (and bf16 numpy) directly, too
    jt = from_jax_params({"x": jnp.ones((2, 2)), "h": [half]})
    assert jt["x"].dtype == torch.float32
    assert jt["h"][0].dtype == torch.bfloat16
