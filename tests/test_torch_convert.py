"""The whole slice on CPU: the port's ``VoiceConverter(device="cpu").convert``
against the JAX functions of the accelerator chain it mirrors, f32.

On the CPU the JAX ``VoiceConverter.convert`` takes its host-mel speaker
path and XLA vocoder scan, not the device chain, so the reference is built
from the JAX device-chain functions: ``embed_utterances(..., device=True)``,
``ops.melspec.mel_spec_auto_encoder_sliced`` (PCM16),
``autoencoder.batch_forward`` in f32 and ``wavernn.generate(...,
backend="pallas", interpret=True, fast_math=False)``.  Both sides load the
same .ckpt files written by the JAX package, and the port's sampling noise
is the JAX draw.  Bars: embedding MSE < 1e-8, post-mel MSE < 1e-6,
waveform atol 1e-3."""
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autovc_tpu import models as JM
from autovc_tpu.audio import Audio as JAudio
from autovc_tpu.audio import io as jio
from autovc_tpu.audio import tools as jtools
from autovc_tpu.config import ConverterConfig as JConv
from autovc_tpu.voice_converter import VoiceConverter as JVC
from autovc_tpu.models import autoencoder as JAE
from autovc_tpu.models import speaker_encoder as JSE
from autovc_tpu.models import wavernn as JW
from autovc_tpu.ops import melspec as JMEL
from autovc_tpu_torch import Audio, VoiceConverter
from autovc_tpu_torch.config import ConverterConfig as TConv
from autovc_tpu_torch.models import autoencoder as TAE
from autovc_tpu_torch.ops import melspec as TMEL
from autovc_tpu_torch.ops import wavernn_kernels as WK

SR = 22050
VOC = {"rnn_dims": 64, "fc_dims": 64,
       "generate": {"target": 1375, "overlap": 550}}
SEED = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path is thousands of small ops; one intra-op thread
    runs them fastest and keeps parallel test workers from contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wav(seconds, f0, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    tone = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in (1, 2, 3))
    env = 0.6 + 0.4 * np.sin(2 * np.pi * 2.5 * t)
    return (0.2 * tone * env + 0.01 * rng.standard_normal(len(t))).astype(
        np.float32)


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ckpt"))
    jcfg = JConv().with_overrides(vocoder=VOC)
    paths, models = {}, {}
    for i, (name, sub) in enumerate((("auto_encoder", jcfg.auto_encoder),
                                     ("speaker_encoder", jcfg.speaker_encoder),
                                     ("vocoder", jcfg.vocoder))):
        models[name] = JM.load_model(name, config=sub, seed=i, verbose=False)
        paths[name] = JM.save_model(models[name], f"{name}.ckpt", d)
    src, trg = _wav(1.0, 140.0, 0), _wav(1.2, 210.0, 1)

    # --- JAX reference: the device chain's functions --------------------
    src_p = np.asarray(jtools.normalize_volume(src, target_dBFS=-20),
                       np.float32)
    trg_p = np.asarray(jtools.normalize_volume(trg, target_dBFS=-20),
                       np.float32)
    se = models["speaker_encoder"]
    c_src, c_trg = JSE.embed_utterances(
        se.params, [jio.resample(w, SR, 16000) for w in (src_p, trg_p)],
        se.config, device=True)
    ae_cfg = models["auto_encoder"].config
    chunks, _ = JMEL.mel_spec_auto_encoder_sliced(src_p, ae_cfg.spectrogram,
                                                  overlap=0.5, pcm16=True)
    post = JAE.batch_forward_jit(models["auto_encoder"].params, chunks,
                                 jnp.asarray(c_src[None]),
                                 jnp.asarray(c_trg[None]), ae_cfg, 0.5, "f32")
    key = jax.random.PRNGKey(SEED)
    wav = JW.generate(models["vocoder"].params, np.asarray(post)[None],
                      models["vocoder"].config, key=key, backend="pallas",
                      interpret=True, fast_math=False, target=1375,
                      overlap=550)
    ref_wav = np.clip(np.round(wav * 32767.0), -32767, 32767) / 32767.0

    # --- the port, one convert on the CPU with the JAX noise --------------
    vc = VoiceConverter(paths["auto_encoder"], paths["speaker_encoder"],
                        paths["vocoder"], config=TConv().with_overrides(
                            vocoder=VOC), device="cpu", verbose=False)
    mp = pytest.MonkeyPatch()

    def draw(steps, rows, pick_dim, generator, device):
        k1, k2 = jax.random.split(key)
        u1 = jax.random.uniform(k1, (steps, rows, pick_dim), minval=1e-5,
                                maxval=1.0 - 1e-5)
        u2 = jax.random.uniform(k2, (steps, rows), minval=1e-5,
                                maxval=1.0 - 1e-5)
        return (torch.from_numpy(np.array(-jnp.log(-jnp.log(u1)))),
                torch.from_numpy(np.array(jnp.log(u2) - jnp.log(1.0 - u2))))

    mp.setattr(WK, "draw_noise", draw)
    vc.stage_times = {}
    try:
        out = vc.convert(Audio(src.copy(), sr_org=SR),
                         Audio(trg.copy(), sr_org=SR), outprocess=(),
                         save_name=False, seed=SEED)
    finally:
        mp.undo()
    stage_times, vc.stage_times = vc.stage_times, None
    return dict(vc=vc, paths=paths, src_p=src_p, trg_p=trg_p, c_src=c_src, c_trg=c_trg,
                post=np.asarray(post), ref_wav=ref_wav, out=out,
                stage_times=stage_times)


def test_slice_embeddings(slice_run):
    vc = slice_run["vc"]
    for wav, ref in ((slice_run["src_p"], slice_run["c_src"]),
                     (slice_run["trg_p"], slice_run["c_trg"])):
        emb = vc._embed(Audio(wav, sr_org=SR))
        assert np.mean((emb - ref) ** 2) < 1e-8


def test_slice_post_mel(slice_run):
    vc = slice_run["vc"]
    chunks, _ = TMEL.mel_spec_auto_encoder_sliced(
        slice_run["src_p"], vc.AE.config.spectrogram, overlap=0.5,
        pcm16=True, device="cpu")
    post = TAE.batch_forward(vc.AE.params, chunks,
                             torch.from_numpy(slice_run["c_src"][None]),
                             torch.from_numpy(slice_run["c_trg"][None]),
                             vc.AE.config, 0.5, "f32")
    assert post.shape == slice_run["post"].shape
    assert np.mean((post.numpy() - slice_run["post"]) ** 2) < 1e-6


def test_slice_waveform(slice_run):
    out, ref = slice_run["out"], slice_run["ref_wav"]
    assert out.sr == SR
    assert out.wav.shape == ref.shape == ((400 - 1) * 275,)
    assert np.all(np.isfinite(out.wav))
    assert np.sqrt(np.mean(out.wav ** 2)) > 1e-4
    np.testing.assert_allclose(out.wav, ref, atol=1e-3, rtol=0)


def test_slice_stage_times(slice_run):
    """With ``stage_times`` set, convert records every stage's wall."""
    times = slice_run["stage_times"]
    assert set(times) == {"preprocess", "embed_source", "embed_target", "mel",
                          "autoencoder", "vocoder", "download", "outprocess"}
    assert all(t >= 0.0 for t in times.values())


@pytest.mark.parametrize("save_dir,where", [
    ("x", "results/x"), ("results/x", "results/x"), (None, "results"),
    ("results", "results")])
def test_convert_saves_where_the_jax_package_does(slice_run, tmp_path,
                                                  monkeypatch, save_dir,
                                                  where):
    """``convert(save_name=..., save_dir=...)`` writes its wav to the same
    path relative to the working directory in both packages.  The JAX
    converter runs its own ``convert`` unchanged; only its model stages
    are stubbed with zeros (their outputs do not decide the path), and so
    are the port's."""
    monkeypatch.chdir(tmp_path)
    mel_n = 80
    jvc = JVC(slice_run["paths"]["auto_encoder"],
              slice_run["paths"]["speaker_encoder"],
              slice_run["paths"]["vocoder"],
              config=JConv().with_overrides(vocoder=VOC), verbose=False,
              ae_precision="f32", vocoder_backend="xla")
    emb = np.zeros(256, np.float32)
    monkeypatch.setattr(jvc, "_embed", lambda audio: emb)
    monkeypatch.setattr(jvc, "_speaker_embedding", lambda *a: emb)
    monkeypatch.setattr(JAE, "batch_forward_jit",
                        lambda *a, **k: jnp.zeros((mel_n, 10)))
    monkeypatch.setattr(JW, "generate",
                        lambda *a, **k: np.zeros(2750, np.float32))
    vc = slice_run["vc"]
    monkeypatch.setattr(vc, "_embed", lambda audio: emb)
    monkeypatch.setattr(vc, "_speaker_embedding", lambda *a: emb)
    monkeypatch.setattr(vc, "_fused_convert",
                        lambda *a, **k: np.zeros(2750, np.float32))
    src = slice_run["src_p"]
    written = {}
    for name, conv, audio_cls in (("jax", jvc, JAudio), ("torch", vc, Audio)):
        out = f"{name}.wav"
        conv.convert(audio_cls(src.copy(), sr_org=SR), "target",
                     save_name=out, save_dir=save_dir, preprocess=(),
                     outprocess=())
        found = sorted(str(p.relative_to(tmp_path))
                       for p in tmp_path.rglob(out))
        written[name] = [os.path.dirname(f) for f in found]
    assert written["jax"] == written["torch"] == [where]


@pytest.fixture
def stubbed_vc(monkeypatch, tmp_path):
    """A CPU converter whose model stages are stubbed with zeros (they do
    not decide where the audio goes), run from an empty directory."""
    monkeypatch.chdir(tmp_path)
    vc = VoiceConverter(config=TConv().with_overrides(vocoder=VOC),
                        device="cpu", verbose=False)
    emb = np.zeros(256, np.float32)
    monkeypatch.setattr(vc, "_embed", lambda audio: emb)
    monkeypatch.setattr(vc, "_speaker_embedding", lambda *a: emb)
    monkeypatch.setattr(vc, "_fused_convert",
                        lambda *a, **k: np.zeros(2750, np.float32))
    return vc


def test_convert_to_wandb_logs_and_writes_no_file(stubbed_vc, tmp_path,
                                                   monkeypatch):
    """``save_dir="wandb"`` hands the audio to the logger's live run (a
    stand-in run and ``wandb`` module: the package is not installed) and
    logs ``audio_log_dict``; no file appears under the working
    directory."""
    wandb = types.ModuleType("wandb")
    wandb.Audio = lambda wav, caption, sample_rate: (caption, sample_rate)
    monkeypatch.setitem(sys.modules, "wandb", wandb)
    logger = stubbed_vc.setup_logging()
    audio = []
    logger.run = type("Run", (), {"log": lambda self, m, step=None:
                                  audio.append(m)})()
    stubbed_vc.convert(Audio(_wav(0.2, 140.0, 4), sr_org=SR), "target",
                       save_name="a.wav", save_dir="wandb", preprocess=(),
                       outprocess=(), audio_log_dict={"epoch": 3})
    logger.run = None
    with open(logger.jsonl_path) as f:
        lines = [json.loads(line) for line in f]
    assert [r["epoch"] for r in lines] == [3]
    assert audio == [{"a": ("a.wav", SR)}, {"epoch": 3}]
    assert not list(tmp_path.rglob("*.wav"))


def test_convert_to_wandb_needs_setup_logging(stubbed_vc, tmp_path):
    with pytest.raises(AssertionError, match="setup_logging"):
        stubbed_vc.convert(Audio(_wav(0.2, 140.0, 4), sr_org=SR), "target",
                           save_name="a.wav", save_dir="wandb",
                           preprocess=(), outprocess=())
    assert not list(tmp_path.rglob("*.wav"))


def test_log_audio_writes_only_where_asked(tmp_path):
    """With no live run ``log_audio`` writes ``save_dir/name.wav`` when it
    has a ``save_dir``, else nothing, as the JAX logger."""
    from autovc_tpu_torch.utils.logging import MetricsLogger
    logger = MetricsLogger(log_dir=str(tmp_path / "logs"))
    wav = _wav(0.1, 140.0, 5)
    logger.log_audio("quiet", wav, SR)
    logger.log_audio("kept", wav, SR, save_dir=str(tmp_path / "out"))
    assert [p.name for p in tmp_path.rglob("*.wav")] == ["kept.wav"]


def test_constructor_takes_jax_positional_parameters(tmp_path):
    """The JAX constructor's positional order: the eighth parameter is
    ``wandb_params`` (merged into ``config.wandb``), the ninth
    ``verbose``; ``vocoder_backend`` None / "auto" / "pallas" are the one
    sampling path and "xla" raises."""
    vc = VoiceConverter(None, None, None, TConv().with_overrides(
        vocoder=VOC), None, None, None,
        {"mode": "disabled", "project": "positional"}, False, device="cpu")
    assert vc.config.wandb.project == "positional"
    assert vc.config.wandb.mode == "disabled" and vc.verbose is False
    for backend in ("auto", "pallas"):
        VoiceConverter(config=TConv().with_overrides(vocoder=VOC),
                       verbose=False, vocoder_backend=backend, device="cpu")
    with pytest.raises(NotImplementedError, match="one sampling path"):
        VoiceConverter(vocoder_backend="xla", verbose=False, device="cpu")


def test_speaker_encoder_training_repacks_nothing(tmp_path):
    """``train(model_type="speaker_encoder")`` trains the speaker encoder
    and leaves the auto-encoder's and the vocoder's packed weights as they
    were."""
    t = np.arange(int(1.0 * 16000)) / 16000
    data = {}
    for s in range(2):
        d = tmp_path / f"spk{s}"
        d.mkdir()
        jio.save_wav(str(d / "u.wav"), (0.2 * np.sin(
            2 * np.pi * (120.0 + 80.0 * s) * t)).astype(np.float32), 16000)
        data[f"spk{s}"] = str(d)
    cfg = TConv().with_overrides(
        vocoder=VOC,
        speaker_encoder={"spectrogram": {"partial_utterance_n_frames": 40}})
    vc = VoiceConverter(config=cfg, device="cpu", verbose=False)
    vc.logger = type("Cap", (), {"log": lambda self, m, step=None: None})()
    vocoder_packed, lstm2_packed = vc._vocoder_packed, vc._lstm2_packed
    info = vc.train(data, model_type="speaker_encoder", n_epochs=1,
                    steps_per_epoch=1, utterances_per_speaker=2,
                    model_name="")
    assert info["step"] == vc.SE.step == 1
    assert vc._vocoder_packed is vocoder_packed
    assert vc._lstm2_packed is lstm2_packed
