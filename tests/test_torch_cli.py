"""The port's command line (``autovc_tpu_torch/cli.py``, ``__main__.py``)
against the JAX package's: the same argvs give the same parsed namespaces
and the same calls on the converter; one real convert on the CPU through
``main(..., device="cpu")`` from ``.ckpt`` files the JAX package wrote,
resolved by name; the multi-device ``-convert_params`` keys refused;
``close`` and the ``setup_wandb`` alias."""
import inspect
import os

import numpy as np
import pytest
import torch

import autovc_tpu.__main__ as jmain
from autovc_tpu import cli as jcli
from autovc_tpu import models as JM
from autovc_tpu.config import ConverterConfig as JConv
from autovc_tpu.utils.logging import MetricsLogger as JLogger
from autovc_tpu.voice_converter import VoiceConverter as JVC
import autovc_tpu_torch.__main__ as tmain
from autovc_tpu_torch import cli as tcli
from autovc_tpu_torch.audio import dsp, io as tio
from autovc_tpu_torch.utils.logging import MetricsLogger as TLogger
from autovc_tpu_torch.voice_converter import VoiceConverter as TVC

SR = 22050
# tiny widths of tests/test_cli.py's end-to-end run
AE_PARAMS = ["spectrogram={'partial_utterance_n_frames': 64}"]
VOC_PARAMS = ["rnn_dims=32", "fc_dims=32", "compute_dims=16",
              "res_out_dims=16", "res_blocks=2",
              "generate={'target': 1100, 'overlap': 275}"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the port's CPU path is many small ops, and
    parallel test workers do not contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _parsed(cli, argv):
    """(init namespace, mode namespace) of ``argv``, or ("exit", code)."""
    try:
        vc_args, rest = cli.parse_vc_args(argv)
        return vars(vc_args), vars(cli.parse_mode_args(vc_args.mode, rest))
    except SystemExit as e:
        return "exit", e.code


PARSE_ARGVS = {
    "convert": ["-mode", "convert", "-auto_encoder", "x.ckpt",
                "-sources", "a.wav", "-targets", "b.wav"],
    "convert_flags": ["-mode", "convert", "-sources", "a.wav", "c.wav",
                      "-targets", "b.wav", "d.wav", "-match_method", "align",
                      "-bidirectional", "-sr", "16000", "-quiet"],
    "train": ["-mode", "train", "-data_path", "d1", "d2",
              "-model_type", "speaker_encoder", "-n_epochs", "3",
              "-batch_size", "4"],
    "parse_kwargs_literals": [
        "-mode", "train", "-auto_encoder_params", "dim_neck=16",
        "model_dir=models/x", "spectrogram={'partial_utterance_n_frames': 64}",
        "-wandb_params", "mode=disabled", "-data_path", "d",
        "-train_params", "steps_per_epoch=2", "precision=f32",
        "cut=True"],
    "string_to_none": ["-mode", "convert", "-sources", "a", "-targets", "b",
                       "-save_dir", "None", "-save_name", "none"],
    "mean_speaker_path": ["-mode", "convert", "-sources", "a",
                          "-targets", "hilde", "-mean_speaker_path",
                          "hilde=dir1", "bob=dir2"],
    "bad_mode": ["-mode", "bogus"],
    "unknown_convert_key": ["-mode", "convert", "-sources", "a",
                            "-targets", "b", "-convert_params",
                            "mel_kwargsss=1", "seed=3"],
    "kwarg_without_value": ["-mode", "train", "-auto_encoder_params",
                            "dim_neck", "-data_path", "d"],
    "bad_model_type": ["-mode", "train", "-data_path", "d",
                       "-model_type", "gan"],
}


@pytest.mark.parametrize("case", sorted(PARSE_ARGVS))
def test_parsers_match_the_jax_ones(case):
    argv = PARSE_ARGVS[case]
    assert _parsed(tcli, argv) == _parsed(jcli, argv)


class _Recorder:
    """Stands in for both packages' ``VoiceConverter``: records the
    constructor's keywords and the calls ``main`` makes."""

    def __init__(self, monkeypatch, cls):
        self.calls = []
        rec = self

        def init(self, **kw):
            kw.pop("device", None)          # the port's own keyword
            rec.calls.append(("__init__", kw))

        monkeypatch.setattr(cls, "__init__", init)
        for name in ("convert_multiple", "train", "learn_speakers", "close"):
            monkeypatch.setattr(
                cls, name,
                lambda self, *a, _n=name, **kw: rec.calls.append((_n, a, kw)))


DISPATCH_ARGVS = {
    "convert_one_target": [
        "-mode", "convert", "-auto_encoder", "ae.ckpt", "-sources", "a.wav",
        "b.wav", "-targets", "t.wav", "-save_dir", "out"],
    "convert_params": [
        "-mode", "convert", "-quiet", "-vocoder_params", "rnn_dims=32",
        "-sources", "a.wav", "-targets", "t1.wav", "t2.wav", "-sr", "16000",
        "-match_method", "align", "-bidirectional", "-convert_params",
        "seed=3", "cut=False", "preprocess=('normalize_volume',)",
        "fuse_dispatch=False"],
    "convert_mean_speaker": [
        "-mode", "convert", "-sources", "a.wav", "-targets", "hilde",
        "-mean_speaker_path", "hilde=dir1", "-save_name", "None"],
    "convert_unknown_key": [
        "-mode", "convert", "-sources", "a.wav", "-targets", "t.wav",
        "-convert_params", "mel_kwargsss=1"],
    "train_auto_encoder": [
        "-mode", "train", "-data_path", "wavs", "-n_epochs", "2",
        "-batch_size", "4", "-model_name", "ae.ckpt", "-save_dir", "m",
        "-train_params", "log_freq=1"],
    "train_speaker_encoder": [
        "-mode", "train", "-model_type", "speaker_encoder", "-data_path",
        "a = dir_a", "b=dir_b", "-model_name", "None"],
    "train_vocoder": [
        "-mode", "train", "-model_type", "vocoder", "-data_path", "d1", "d2",
        "-wandb_params", "mode=disabled", "-train_params",
        "steps_per_epoch=2", "seq_frames=3"],
}


def _dispatch(monkeypatch, mod, cls, argv):
    rec = _Recorder(monkeypatch, cls)
    try:
        mod.main(list(argv))
    except SystemExit as e:
        rec.calls.append(("exit", str(e)))
    return rec.calls


@pytest.mark.parametrize("case", sorted(DISPATCH_ARGVS))
def test_main_dispatches_as_the_jax_one(monkeypatch, case):
    """The same argv makes the same constructor keywords and the same
    calls (``learn_speakers``, ``convert_multiple`` / ``train``, then
    ``close``) on both packages' converters; an unknown
    ``-convert_params`` key stops both with the same message."""
    argv = DISPATCH_ARGVS[case]
    got = _dispatch(monkeypatch, tmain, TVC, argv)
    want = _dispatch(monkeypatch, jmain, JVC, argv)
    assert got == want
    names = [c[0] for c in got]
    assert names[-1] == ("exit" if case == "convert_unknown_key"
                         else "close")


def test_convert_accepts_the_jax_keys():
    """The ``-convert_params`` check reads ``convert``'s signature: the
    port's names the JAX one's parameters, so both CLIs accept and refuse
    the same keys."""
    assert (list(inspect.signature(TVC.convert).parameters)
            == list(inspect.signature(JVC.convert).parameters))


@pytest.mark.parametrize("key", ["parallel='chunks'", "mesh='data'"])
def test_multi_device_keys_raise_not_implemented(tmp_path, monkeypatch,
                                                 key):
    """The multi-device keys reach ``convert`` from the command line:
    ``parallel`` without a mesh takes the local CUDA devices and refuses
    to fall back to the CPU; a ``mesh`` that is not a ``Mesh`` (the
    command line cannot build one) is refused by type."""
    monkeypatch.chdir(tmp_path)
    src = str(tmp_path / "src.wav")
    tio.save_wav(src, _wav(0.3, 0), SR)
    error, match = ((RuntimeError, "no CUDA device") if "parallel" in key
                    else (TypeError, "Mesh"))
    with pytest.raises(error, match=match):
        tmain.main(["-mode", "convert", "-quiet", "-auto_encoder_params",
                    *AE_PARAMS, "-vocoder_params", *VOC_PARAMS,
                    "-sources", src, "-targets", src,
                    "-convert_params", key], device="cpu")


def _wav(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    tone = sum(np.sin(2 * np.pi * k * 150.0 * t) / k for k in (1, 2, 3))
    return (0.2 * tone + 0.01 * rng.standard_normal(len(t))).astype(
        np.float32)


def test_main_converts_on_the_cpu_from_jax_checkpoints_by_name(
        tmp_path, monkeypatch):
    """``main(..., device="cpu")`` converts a synthetic wav with the
    three models of ``.ckpt`` files written by the JAX package: the
    generator's by name in ``model_dir``, the speaker encoder's by name
    in ``AUTOVC_MODEL_CACHE``, the vocoder's by path.  The wav it writes
    is finite, as long as a ``cut=True`` conversion of the source gives,
    and not silent."""
    monkeypatch.chdir(tmp_path)
    jcfg = JConv().with_overrides(
        auto_encoder={"spectrogram": {"partial_utterance_n_frames": 64}},
        vocoder={"rnn_dims": 32, "fc_dims": 32, "compute_dims": 16,
                 "res_out_dims": 16, "res_blocks": 2})
    ae_dir, cache = tmp_path / "ae_models", tmp_path / "cache"
    for i, (name, cfg, where) in enumerate((
            ("auto_encoder", jcfg.auto_encoder, ae_dir),
            ("speaker_encoder", jcfg.speaker_encoder, cache),
            ("vocoder", jcfg.vocoder, tmp_path))):
        JM.save_model(JM.load_model(name, config=cfg, seed=i, verbose=False),
                      f"{name}.ckpt", str(where))
    monkeypatch.setenv("AUTOVC_MODEL_CACHE", str(cache))
    wav = _wav(0.5, 1)
    tio.save_wav(str(tmp_path / "src.wav"), wav, SR)
    tmain.main(["-mode", "convert", "-quiet",
                "-auto_encoder", "auto_encoder.ckpt",
                "-speaker_encoder", "speaker_encoder.ckpt",
                "-vocoder", str(tmp_path / "vocoder.ckpt"),
                "-auto_encoder_params", *AE_PARAMS, f"model_dir={ae_dir}",
                "-vocoder_params", *VOC_PARAMS,
                "-sources", "src.wav", "-targets", "src.wav",
                "-save_dir", "out", "-save_name", "out.wav",
                "-convert_params", "seed=2", "fuse_dispatch=False"],
               device="cpu")
    out, out_sr = tio.load_wav(str(tmp_path / "results" / "out" / "out.wav"))
    _, mel_slices = dsp.compute_partial_slices(
        len(wav), SR, partial_utterance_n_frames=64)
    frames = 64 + (len(mel_slices) - 1) * 32
    assert out_sr == SR
    assert out.shape == ((frames - 1) * 275,)
    assert np.isfinite(out).all() and np.sqrt(np.mean(out ** 2)) > 1e-4


class _Run:
    def __init__(self):
        self.finished = 0

    def finish(self):
        self.finished += 1


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_close_finishes_the_run_and_drops_the_logger(tmp_path, pkg):
    """``close`` finishes the logger's live run (a stand-in: wandb is not
    installed) once and drops the logger, and is a no-op after; the
    ``setup_wandb`` alias is ``setup_logging``.  Both packages alike."""
    cls, logger_cls = (JVC, JLogger) if pkg == "jax" else (TVC, TLogger)
    assert cls.setup_wandb is cls.setup_logging
    vc = cls.__new__(cls)
    vc.logger = logger_cls(log_dir=str(tmp_path / "logs"))
    run = vc.logger.run = _Run()
    vc.close()
    vc.close()
    assert run.finished == 1 and vc.logger is None
