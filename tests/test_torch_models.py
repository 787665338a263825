"""CPU parity of the port's models against the JAX package, f32: the AutoVC
generator at full width with a short T (post-mel MSE < 1e-6), the speaker
embedding through the device path (MSE < 1e-8), and the loader (a .ckpt
written by the JAX package; fresh inits with the JAX init's layout)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autovc_tpu import models as JM
from autovc_tpu.config import AutoEncoderConfig, SpeakerEncoderConfig
from autovc_tpu.config import WaveRNNConfig as JWCfg
from autovc_tpu.models import autoencoder as JAE
from autovc_tpu.models import speaker_encoder as JSE
from autovc_tpu_torch import models as TM
from autovc_tpu_torch.config import AutoEncoderConfig as TAECfg
from autovc_tpu_torch.config import SpeakerEncoderConfig as TSECfg
from autovc_tpu_torch.config import WaveRNNConfig as TWCfg
from autovc_tpu_torch.models import autoencoder as TAE
from autovc_tpu_torch.models import speaker_encoder as TSE
from autovc_tpu_torch.utils.bridge import from_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path is thousands of small ops; one intra-op thread
    runs them fastest and keeps parallel test workers from contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mse(a, b):
    return float(np.mean((np.asarray(a, np.float64)
                          - np.asarray(b, np.float64)) ** 2))


@pytest.fixture(scope="module")
def ae():
    params = JAE.init(jax.random.PRNGKey(0), AutoEncoderConfig())
    return params, from_jax_params(params)


def _embs(rng, n):
    e = rng.standard_normal((n, 256)).astype(np.float32)
    return e / np.linalg.norm(e, axis=-1, keepdims=True)


def test_ae_forward_parity(ae):
    jp, tp = ae
    rng = np.random.default_rng(0)
    x = rng.random((2, 80, 64), dtype=np.float32)
    c_org, c_trg = _embs(rng, 2), _embs(rng, 2)
    ref_dec, ref_post, ref_codes, _ = JAE.forward(
        jp, jnp.asarray(x), jnp.asarray(c_org), jnp.asarray(c_trg),
        AutoEncoderConfig())
    dec, post, codes = TAE.forward(tp, torch.from_numpy(x),
                                   torch.from_numpy(c_org),
                                   torch.from_numpy(c_trg), TAECfg())
    assert post.shape == ref_post.shape
    assert _mse(post.numpy(), ref_post) < 1e-6
    assert _mse(dec.numpy(), ref_dec) < 1e-6
    np.testing.assert_allclose(codes.numpy(), np.asarray(ref_codes),
                               atol=1e-4)


def test_ae_batch_forward_parity(ae):
    """Chunked conversion with the overlap-add merge; 9 chunks take the
    kernel-3 (> 8 rows) route of the decoder lstm2."""
    jp, tp = ae
    rng = np.random.default_rng(1)
    chunks = rng.random((9, 80, 32), dtype=np.float32)
    c_org, c_trg = _embs(rng, 1), _embs(rng, 1)
    ref = JAE.batch_forward_jit(jp, jnp.asarray(chunks), jnp.asarray(c_org),
                                jnp.asarray(c_trg), AutoEncoderConfig(), 0.5,
                                "f32")
    out = TAE.batch_forward(tp, torch.from_numpy(chunks),
                            torch.from_numpy(c_org), torch.from_numpy(c_trg),
                            TAECfg(), 0.5, "f32")
    assert out.shape == ref.shape == (80, 32 + 8 * 16)
    assert _mse(out.numpy(), ref) < 1e-6


def test_se_embedding_parity():
    params = JSE.init(jax.random.PRNGKey(1), SpeakerEncoderConfig())
    rng = np.random.default_rng(2)
    t = np.arange(int(2.3 * 16000)) / 16000
    wavs = [(0.3 * np.sin(2 * np.pi * f * t)
             + 0.03 * rng.standard_normal(len(t))).astype(np.float32)[:n]
            for f, n in ((150, len(t)), (230, 21000))]
    ref = JSE.embed_utterances(params, wavs, SpeakerEncoderConfig(),
                               device=True)
    out = TSE.embed_utterances(from_jax_params(params), wavs, TSECfg(),
                               "cpu")
    for o, r in zip(out, ref):
        assert o.shape == (256,)
        assert _mse(o, r) < 1e-8


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(np.shape(tree))


@pytest.mark.parametrize("model_type", ["auto_encoder", "speaker_encoder",
                                        "vocoder"])
def test_fresh_init_has_jax_layout(model_type):
    jax_params = JM._init_params(model_type, JM.default_config(model_type))
    torch_model = TM.load_model(model_type, device="cpu", verbose=False)
    assert _shapes(from_jax_params(jax_params)) == _shapes(
        torch_model.params)
    leaves = [torch_model.params]
    while leaves:
        node = leaves.pop()
        if isinstance(node, dict):
            leaves.extend(node.values())
        elif isinstance(node, list):
            leaves.extend(node)
        else:
            assert node.dtype == torch.float32 and node.device.type == "cpu"


def test_load_jax_checkpoint(tmp_path):
    cfg = JWCfg().with_overrides(rnn_dims=64, fc_dims=64)
    model = JM.load_model("vocoder", config=cfg, verbose=False)
    path = JM.save_model(model, "voc.ckpt", str(tmp_path))
    loaded = TM.load_model("vocoder", path, config=TWCfg().with_overrides(
        rnn_dims=64, fc_dims=64), device="cpu", verbose=False)
    ref = from_jax_params(model.params)
    assert _shapes(ref) == _shapes(loaded.params)
    torch.testing.assert_close(loaded.params["rnn1"]["w_hh"],
                               ref["rnn1"]["w_hh"], rtol=0, atol=0)
    torch.testing.assert_close(loaded.params["upsample"]["up_convs"][2],
                               ref["upsample"]["up_convs"][2], rtol=0, atol=0)
    with pytest.raises(FileNotFoundError):
        TM.load_model("vocoder", "missing.ckpt", str(tmp_path),
                      device="cpu", verbose=False)
    with pytest.raises(ValueError):
        TM.load_model("decoder", device="cpu")
