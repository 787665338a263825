"""CPU parity of the port's GE2E speaker-encoder training against the JAX
package: the similarity matrix, the GE2E loss and every gradient, the
equal error rate, the step's 0.01 scaling of the similarity weight and
bias gradients and its ``grad_norm``, f32 and bf16 trajectories of
``make_se_step``, the host SE mel and the GE2E dataset, the training
loop, checkpoints across the two packages, ``learn_speaker`` and
``VoiceConverter(device="cpu")``'s ``learn_speakers`` and ``train(...,
model_type="speaker_encoder")``.

Full SE width (3 x 256 on 40 mels, embedding 256) at small batches (S 3-4
speakers, U 2-3 utterances, T 40 frames).  Parameters come from the JAX
``init`` through the weight bridge and data from numpy seeds.  The JAX
side runs its scan path (``fast_kernels=False`` / ``make_se_step`` on the
CPU); the port runs kernels 6/7's plain versions.  Both packages' host
mels take their C++ cores; the tests that compare host mels switch both
off (``dsp.USE_NATIVE``), so both sides run the same numpy path, and
``use_native=True`` holds the two cores against each other."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autovc_tpu.audio import dsp as jdsp
from autovc_tpu.config import SpeakerEncoderConfig as JCfg
from autovc_tpu.models import speaker_encoder as JSE
from autovc_tpu.train import data as JD
from autovc_tpu.train import loop as JL
from autovc_tpu.train import schedules as JS
from autovc_tpu.utils import checkpoint as JCK
from autovc_tpu_torch.audio import dsp as tdsp
from autovc_tpu_torch.audio import io as TIO
from autovc_tpu_torch.config import ConverterConfig
from autovc_tpu_torch.config import SpeakerEncoderConfig as TCfg
from autovc_tpu_torch.models import speaker_encoder as TSE
from autovc_tpu_torch.train import data as TD
from autovc_tpu_torch.train import loop as TL
from autovc_tpu_torch.train import schedules as TS
from autovc_tpu_torch.utils import checkpoint as TCK
from autovc_tpu_torch.utils import tree_leaves
from autovc_tpu_torch.utils.bridge import from_jax_params

T = 40
SR = 16000
SMALL_VOCODER = {"rnn_dims": 32, "fc_dims": 32}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def numpy_mel(monkeypatch):
    """Both packages' host mels on their numpy paths."""
    monkeypatch.setattr(jdsp, "USE_NATIVE", False)
    monkeypatch.setattr(tdsp, "USE_NATIVE", False)


@pytest.fixture(scope="module")
def jax_params():
    return JSE.init(jax.random.PRNGKey(0), JCfg())


def _block(S, U, seed=0):
    """A mel block (S, U, T, 40): per-speaker prototypes plus noise."""
    rng = np.random.default_rng(seed)
    protos = 2.0 * rng.random((S, 1, 1, 40))
    return (protos + rng.random((S, U, T, 40))).astype(np.float32)


def _embeds(S, U, seed):
    e = np.random.default_rng(seed).standard_normal((S, U, 256))
    return (e / np.linalg.norm(e, axis=-1, keepdims=True)).astype(np.float32)


def _paths(tree):
    return [jax.tree_util.keystr(k)
            for k, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("S,U", [(3, 2), (4, 3)])
def test_similarity_and_ge2e_loss_match_jax(jax_params, S, U):
    """rtol 1e-5 (measured ~1e-7)."""
    e = _embeds(S, U, seed=S)
    tp = from_jax_params(jax_params)
    sim = TSE.similarity_matrix(tp, torch.from_numpy(e))
    np.testing.assert_allclose(
        sim.numpy(), np.asarray(JSE.similarity_matrix(jax_params,
                                                      jnp.asarray(e))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        float(TSE.ge2e_loss(tp, torch.from_numpy(e))),
        float(JSE.ge2e_loss(jax_params, jnp.asarray(e))), rtol=1e-5)


@pytest.mark.parametrize("source", ["random", "ge2e"])
def test_equal_error_rate_equals_jax(jax_params, source):
    """The same value on the same matrix: a random one, and the similarity
    matrix of separable embeddings (EER 0)."""
    if source == "random":
        sim = np.random.default_rng(1).standard_normal((5, 4, 5))
    else:
        e = _embeds(4, 3, seed=2)
        e[:, :, :4] += 4.0 * np.eye(4)[:, None, :]
        e /= np.linalg.norm(e, axis=-1, keepdims=True)
        sim = TSE.similarity_matrix(from_jax_params(jax_params),
                                    torch.from_numpy(e)).numpy()
    assert TSE.equal_error_rate(sim) == JSE.equal_error_rate(sim)


@pytest.mark.parametrize("S,U", [(3, 2), (4, 3)])
def test_batch_ge2e_loss_and_grads_match_jax(jax_params, S, U):
    """f32: the loss (rtol 1e-5) and every gradient leaf within 1e-4 of
    its max |ref| (measured ~3e-5).  The similarity bias shifts every
    logit of a row alike, so its gradient is analytically zero: both
    sides' must be rounding noise (below 1e-5 of the largest gradient)."""
    b = _block(S, U, seed=S)
    loss, grads = jax.value_and_grad(
        lambda p: JSE.batch_ge2e_loss(p, jnp.asarray(b),
                                      fast_kernels=False))(jax_params)
    tl, tg = TL.se_loss_and_grads(from_jax_params(jax_params), b, "f32")
    np.testing.assert_allclose(float(tl), float(loss), rtol=1e-5)
    ref = [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]
    noise = 1e-5 * max(np.abs(r).max() for r in ref)
    for path, a, r in zip(_paths(jax_params), tg, ref):
        a = a.numpy()
        if path == "['similarity_bias']":
            assert max(abs(float(a)), abs(float(r))) <= noise
        else:
            assert np.abs(a - r).max() <= 1e-4 * np.abs(r).max(), path


def test_se_step_scales_similarity_grads_like_jax(jax_params):
    """One f32 step of each ``make_se_step``: the loss and ``grad_norm``
    (rtol 1e-5), and ``grad_norm`` is the norm of the gradients after the
    similarity weight's and bias's are scaled by 0.01."""
    cfg = JCfg()
    b = _block(3, 2, seed=7)
    jtx = JS.make_optimizer(cfg.optimizer, 8, dim_model=256)
    _, _, jaux = JL.make_se_step(cfg, jtx, precision="f32")(
        jax_params, jtx.init(jax_params), jnp.asarray(b))
    params = from_jax_params(jax_params)
    _, grads = TL.se_loss_and_grads(params, b, "f32")
    scaled = [0.01 * g if p in ("['similarity_bias']",
                                "['similarity_weight']") else g
              for p, g in zip(_paths(jax_params), grads)]
    tx = TS.make_optimizer(TCfg().optimizer, 8, dim_model=256)
    _, state, aux = TL.make_se_step(TCfg(), tx, "f32")(
        params, tx.init(tree_leaves(params)), b)
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux["grad_norm"]),
                               float(jaux["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(
        float(aux["grad_norm"]),
        float(torch.sqrt(sum(torch.sum(g * g) for g in scaled))), rtol=1e-6)
    assert state["count"] == 1


N_STEPS, LR = 3, 1e-3


def _run_jax(jp, blocks, precision):
    tx = JS.make_optimizer(JCfg().optimizer, 8, dim_model=256)
    step = JL.make_se_step(JCfg(), tx, precision=precision)
    state, losses = tx.init(jp), []
    for b in blocks:
        jp, state, aux = step(jp, state, jnp.asarray(b))
        losses.append(float(aux["loss"]))
    return jp, np.asarray(losses)


def _run_torch(jp, blocks, precision):
    tx = TS.make_optimizer(TCfg().optimizer, 8, dim_model=256)
    params = from_jax_params(jp)
    step = TL.make_se_step(TCfg(), tx, precision)
    state, losses = tx.init(tree_leaves(params)), []
    for b in blocks:
        params, state, aux = step(params, state, b)
        losses.append(float(aux["loss"]))
    return params, np.asarray(losses)


@pytest.fixture(scope="module")
def trajectories(jax_params):
    """Three steps of each step function (S 3, U 2, T 40; lr 1e-3, the SE
    config's), f32 and bf16, from the same init."""
    blocks = [_block(3, 2, seed=20 + i) for i in range(N_STEPS)]
    return {(side, prec): run(jax_params, blocks, prec)
            for side, run in (("jax", _run_jax), ("torch", _run_torch))
            for prec in ("f32", "bf16")}


def test_f32_trajectory_matches_make_se_step(trajectories, jax_params):
    """Three f32 steps: the losses at rtol 1e-3, and each parameter leaf's
    change from the init within a relative L2 error of 1e-3 of the JAX
    change (measured <= 1.8e-4; Adam divides near-zero gradient elements
    by their own size, so single elements part by up to a few percent).
    The similarity bias's gradient is rounding noise on both sides, which
    Adam turns into up to lr a step: it is held within N_STEPS * lr of its
    start."""
    jp, jl = trajectories["jax", "f32"]
    tp, tl = trajectories["torch", "f32"]
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0]
    for path, a, r, p0 in zip(_paths(jp), tree_leaves(tp),
                              jax.tree_util.tree_leaves(jp),
                              jax.tree_util.tree_leaves(jax_params)):
        d_ref = np.asarray(r) - np.asarray(p0)
        d = a.numpy() - np.asarray(p0)
        if path == "['similarity_bias']":
            assert abs(float(d)) <= N_STEPS * LR * 1.001
        else:
            assert np.linalg.norm(d - d_ref) <= \
                1e-3 * np.linalg.norm(d_ref), path


def test_bf16_trajectory_tracks_f32_and_jax(trajectories):
    """rtol 0.05 against the port's f32 steps and the JAX bf16 steps (the
    JAX scan rounds its saved activations less than the kernels do)."""
    bf16 = trajectories["torch", "bf16"][1]
    assert np.isfinite(bf16).all()
    np.testing.assert_allclose(bf16, trajectories["torch", "f32"][1],
                               rtol=0.05)
    np.testing.assert_allclose(bf16, trajectories["jax", "bf16"][1],
                               rtol=0.05)
    assert not np.array_equal(bf16, trajectories["torch", "f32"][1])


def _wav(seconds, f0, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    tone = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in (1, 2, 3))
    return (0.2 * tone + 0.01 * rng.standard_normal(len(t))).astype(
        np.float32)


@pytest.mark.parametrize("seconds", [0.3, 2.45])
def test_sliced_speaker_mel_matches_jax(numpy_mel, seconds):
    """Exactly the JAX host path's partials and slices: one padded partial
    below a window, several overlapping ones above; on the numpy path and,
    with ``use_native=True``, through each package's C++ core."""
    wav = _wav(seconds, 150.0, seed=3)
    ref = jdsp.mel_spec_speaker_encoder_sliced(wav)
    out = tdsp.mel_spec_speaker_encoder_sliced(wav)
    np.testing.assert_array_equal(out[0], ref[0])
    assert out[1:] == ref[1:] and out[0].shape[1:] == (160, 40)
    ref = jdsp.mel_spec_speaker_encoder_sliced(wav, use_native=True)
    out = tdsp.mel_spec_speaker_encoder_sliced(wav, use_native=True)
    np.testing.assert_array_equal(out[0], ref[0])
    assert out[1:] == ref[1:]


def _speaker_dirs(tmp_path, seconds=(1.7, 1.7, 0.9)):
    """One directory of synthetic wavs per speaker, the last speaker with
    a single short file (fewer partials than utterances per speaker)."""
    out = {}
    for s, dur in enumerate(seconds):
        d = tmp_path / f"spk{s}"
        d.mkdir()
        for i in range(1 if dur < 1 else 2):
            TIO.save_wav(str(d / f"u{i}.wav"),
                         _wav(dur, 110.0 + 60.0 * s + 7.0 * i, seed=10 * s
                              + i), SR)
        out[f"spk{s}"] = str(d)
    return out


def test_dataset_batches_match_jax(numpy_mel, tmp_path):
    """The same partials per speaker and the same blocks from the same
    seed, the ``j % len`` wrap included."""
    data = _speaker_dirs(tmp_path)
    jds = JD.SpeakerEncoderDataset(data, verbose=False)
    tds = TD.SpeakerEncoderDataset(data, verbose=False)
    assert [len(d) for d in tds.datasets] == [len(d) for d in jds.datasets]
    assert min(len(d) for d in tds.datasets) < 4 and len(tds) == len(jds)
    got = list(tds.batches(4, n_batches=3, seed=5))
    want = list(jds.batches(4, n_batches=3, seed=5))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.shape == (3, 4, 160, 40) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


class SynthSpeakers:
    """S synthetic speakers with distinct spectral signatures: per-speaker
    prototypes plus uniform noise (as ``tests/test_training.py``'s)."""

    def __init__(self, S=3, seed=0):
        self.protos = 4.0 * np.random.default_rng(seed).random(
            (S, 1, 1, 40))
        self.seed = seed

    def batches(self, U, n_batches, seed=0):
        rng = np.random.default_rng((self.seed, seed))
        for _ in range(n_batches):
            yield (self.protos + rng.random(
                (len(self.protos), U, T, 40))).astype(np.float32)


class Cap:
    def __init__(self):
        self.records = []

    def log(self, m, step=None):
        self.records.append(m)


def test_train_speaker_encoder_reduces_loss(jax_params):
    """16 steps (4 epochs of 4) on 3 synthetic speakers: the loss falls,
    every ``grad_norm`` is finite, and the EER of each save epoch is in
    [0, 1] and below 0.5 by the end (``tests/test_training.py``'s bars)."""
    cap = Cap()
    _, info = TL.train_speaker_encoder(
        from_jax_params(jax_params), SynthSpeakers(), TCfg(), n_epochs=4,
        utterances_per_speaker=4, steps_per_epoch=4, log_freq=1,
        model_name="", logger=cap, verbose=False)
    losses = [m["loss"] for m in cap.records if "loss" in m]
    eers = [m["eer"] for m in cap.records if "eer" in m]
    assert info["step"] == len(losses) == 16
    assert losses[-1] < losses[0], losses
    assert all(np.isfinite(m["grad_norm"]) for m in cap.records
               if "grad_norm" in m)
    assert len(eers) == 4 and all(0.0 <= e <= 1.0 for e in eers)
    assert eers[-1] < 0.5


@pytest.mark.parametrize("writer,reader", [("torch", "torch"),
                                           ("torch", "jax"),
                                           ("jax", "torch")])
def test_resume_restores_step_and_speakers(tmp_path, jax_params, writer,
                                           reader):
    """Two steps written by one package's loop (with a ``speakers``
    registry), resumed for one more by either: the step continues at 3,
    the Adam count at 3, and the registry comes back."""
    ds = SynthSpeakers(seed=4)
    reg = {"alice": np.full(256, 0.0625, np.float32)}
    kw = dict(n_epochs=1, utterances_per_speaker=2, steps_per_epoch=2,
              model_name="se.ckpt", save_dir=str(tmp_path), verbose=False)
    if writer == "torch":
        TL.train_speaker_encoder(from_jax_params(jax_params), ds, TCfg(),
                                 speakers=dict(reg), **kw)
    else:
        JL.train_speaker_encoder(jax_params, ds, JCfg(), speakers=dict(reg),
                                 **kw)
    assert JCK.load_checkpoint(str(tmp_path / "se.ckpt"))["step"] == 2
    kw.update(steps_per_epoch=1, model_name="")
    got = {}
    if reader == "torch":
        params, info = TL.train_speaker_encoder(
            from_jax_params(jax_params), ds, TCfg(), speakers=got,
            resume=True, **kw)
        count = info["opt_state"]["count"]
        assert np.isfinite(float(params["similarity_weight"]))
    else:
        _, info = JL.train_speaker_encoder(jax_params, ds, JCfg(),
                                           speakers=got, resume=True, **kw)
        count = int(info["opt_state"][1].count)
    assert info["step"] == 3 and count == 3
    np.testing.assert_array_equal(np.asarray(got["alice"]), reg["alice"])


@pytest.mark.parametrize("form", ["dict", "strings"])
def test_learn_speakers_matches_jax(numpy_mel, tmp_path, jax_params, form):
    """``VoiceConverter(device="cpu").learn_speakers`` from a dict and from
    'name=path' strings, against the JAX ``learn_speaker`` on the same
    files and weights (f32 forward both): atol 1e-5 (measured ~1e-7)."""
    from autovc_tpu_torch import VoiceConverter
    data = _speaker_dirs(tmp_path, seconds=(1.7, 2.6))
    vc = VoiceConverter(config=ConverterConfig().with_overrides(
        vocoder=SMALL_VOCODER), device="cpu", verbose=False)
    vc.SE.params = from_jax_params(jax_params)
    arg = data if form == "dict" else [f"{k} = {v}" for k, v in data.items()]
    speakers = vc.learn_speakers(arg)
    assert speakers is vc.speakers and set(speakers) == set(data)
    for name, path in data.items():
        files = sorted(os.path.join(path, f) for f in os.listdir(path))
        ref = JSE.learn_speaker(jax_params, files, JCfg())
        np.testing.assert_allclose(speakers[name], ref, atol=1e-5)
        np.testing.assert_allclose(
            TSE.learn_speaker(vc.SE.params, files, TCfg(), "cpu"), ref,
            atol=1e-5)


def test_voice_converter_trains_speaker_encoder_on_cpu(tmp_path):
    """``VoiceConverter(device="cpu").train(..., model_type=
    "speaker_encoder")`` end to end on speaker directories (40-frame
    partials): the step count, finite losses, the EER, a checkpoint the
    JAX package reads with the registry, and ``save``."""
    from autovc_tpu_torch import VoiceConverter
    data = _speaker_dirs(tmp_path)
    cfg = ConverterConfig().with_overrides(
        speaker_encoder={"spectrogram": {"partial_utterance_n_frames": T}},
        vocoder=SMALL_VOCODER)
    vc = VoiceConverter(config=cfg, device="cpu", verbose=False)
    vc.speakers["bob"] = np.full(256, 0.0625, np.float32)
    cap = Cap()
    vc.logger = cap
    before = vc.SE.params["lstm"][0]["w_hh"].clone()
    info = vc.train(data, model_type="speaker_encoder", n_epochs=1,
                    steps_per_epoch=2, utterances_per_speaker=2,
                    model_name="se.ckpt", save_dir=str(tmp_path / "ckpt"))
    losses = [m["loss"] for m in cap.records if "loss" in m]
    assert info["step"] == vc.SE.step == len(losses) == 2
    eers = [m["eer"] for m in cap.records if "eer" in m]
    assert np.isfinite(losses).all() and len(eers) == 1
    assert 0.0 <= eers[0] <= 1.0
    assert not torch.equal(before, vc.SE.params["lstm"][0]["w_hh"])
    blob = JCK.load_checkpoint(str(tmp_path / "ckpt" / "se.ckpt"))
    assert blob["step"] == 2 and set(blob["speakers"]) == {"bob"}
    vc.logger = None
    saved = TCK.load_checkpoint(vc.save("speaker_encoder", "saved.ckpt",
                                        str(tmp_path)))
    assert saved["step"] == 2 and set(saved["speakers"]) == {"bob"}
