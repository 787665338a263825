"""The port's model loader against the JAX package's: name resolution
(``resolve_artifact``: path, ``model_dir``, ``AUTOVC_MODEL_CACHE``, a live
wandb run), ``load_models``, the missing-name error and ``missing_ok``,
and reference PyTorch checkpoints in the three formats
(``tests/test_torch_checkpoints.py``'s files, built from
``tests/torch_mirrors.py``): the port's parameters are bitwise the
bridged JAX conversion, ``step`` and ``speakers`` ride along, and the
port's f32 forward on the CPU matches the mirror's."""
import os
import sys
import types

import numpy as np
import pytest
import torch

from autovc_tpu import models as JM
from autovc_tpu.config import WaveRNNConfig as JWRConfig
from autovc_tpu.utils import checkpoint as jckpt
from autovc_tpu_torch import models as TM
from autovc_tpu_torch.config import (AutoEncoderConfig, SpeakerEncoderConfig,
                                     WaveRNNConfig)
from autovc_tpu_torch.models import autoencoder as TAE
from autovc_tpu_torch.models import speaker_encoder as TSE
from autovc_tpu_torch.models import wavernn as TWR
from autovc_tpu_torch.utils import checkpoint as tckpt
from autovc_tpu_torch.utils import tree_leaves
from autovc_tpu_torch.utils.bridge import from_jax_params

from torch_mirrors import MirrorAutoVC, MirrorSpeakerEncoder, MirrorWaveRNN

# a narrow vocoder (the converters fix res_blocks = 10 and 3 upsample convs)
VOC = {"rnn_dims": 64, "fc_dims": 64}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Name resolution
# ---------------------------------------------------------------------------


@pytest.fixture
def layout(tmp_path, monkeypatch):
    """explicit/x.ckpt; models/{in_dir,both}.ckpt; cache/{in_cache,both}.ckpt
    with the cache as ``AUTOVC_MODEL_CACHE``."""
    for rel in ("explicit/x.ckpt", "models/in_dir.ckpt", "models/both.ckpt",
                "cache/in_cache.ckpt", "cache/both.ckpt"):
        p = tmp_path / rel
        p.parent.mkdir(exist_ok=True)
        p.write_bytes(b"")
    monkeypatch.setenv("AUTOVC_MODEL_CACHE", str(tmp_path / "cache"))
    return tmp_path


RESOLVE_CASES = {
    # name ("@" = the layout's root), model_dir in the layout, the answer
    "explicit_path": ("@/explicit/x.ckpt", "models", "@/explicit/x.ckpt"),
    "model_dir": ("in_dir.ckpt", "models", "@/models/in_dir.ckpt"),
    "model_dir_trailing_slash": ("in_dir.ckpt", "models/",
                                 "@/models/in_dir.ckpt"),
    "cache": ("in_cache.ckpt", "models", "@/cache/in_cache.ckpt"),
    "model_dir_before_cache": ("both.ckpt", "models", "@/models/both.ckpt"),
    "missing": ("missing.ckpt", "models", None),
}


@pytest.mark.parametrize("case", sorted(RESOLVE_CASES))
def test_resolve_artifact_matches_the_jax_one(layout, case):
    name, model_dir, want = (
        None if v is None else v.replace("@", str(layout))
        for v in RESOLVE_CASES[case])
    model_dir = os.path.join(str(layout), model_dir)
    got = TM.resolve_artifact(name, model_dir, verbose=False)
    assert got == JM.resolve_artifact(name, model_dir, verbose=False)
    assert (None if got is None else os.path.normpath(got)) == want
    assert TM.artifact_cache_dir() == JM.artifact_cache_dir()


def _stub_wandb(monkeypatch, calls, mode):
    """A ``wandb`` module whose run (live unless ``mode == "no_run"``)
    downloads ``artifacts/ae-v0/ae.ckpt`` under the root it is given, or
    fails (``mode == "fails"``)."""
    wandb = types.ModuleType("wandb")

    class Artifact:
        def download(self, root):
            calls.append(("download", root))
            d = os.path.join(root, "artifacts", "ae-v0")
            os.makedirs(d, exist_ok=True)
            open(os.path.join(d, "ae.ckpt"), "wb").close()
            return d

    class Run:
        def use_artifact(self, name):
            calls.append(("use_artifact", name))
            if mode == "fails":
                raise RuntimeError("no network")
            return Artifact()

    wandb.run = None if mode == "no_run" else Run()
    monkeypatch.setitem(sys.modules, "wandb", wandb)


@pytest.mark.parametrize("mode", ["live_run", "no_run", "fails"])
def test_resolve_artifact_fetches_from_a_live_wandb_run(tmp_path,
                                                        monkeypatch, mode):
    """A name found nowhere locally is fetched from the live run's artifact
    registry into the cache, as the JAX package does: the same calls, the
    same answer; no run, or a failed lookup, gives None."""
    monkeypatch.setenv("AUTOVC_MODEL_CACHE", str(tmp_path / "cache"))
    answers, calls = {}, {}
    for pkg, mod in (("jax", JM), ("torch", TM)):
        calls[pkg] = []
        _stub_wandb(monkeypatch, calls[pkg], mode)
        answers[pkg] = mod.resolve_artifact("ae.ckpt", str(tmp_path / "m"),
                                            verbose=False)
    assert answers["torch"] == answers["jax"]
    assert calls["torch"] == calls["jax"]
    if mode == "live_run":
        assert answers["torch"] == os.path.join(
            str(tmp_path / "cache"), "artifacts", "ae-v0", "ae.ckpt")
        assert calls["torch"] == [("use_artifact", "ae:latest"),
                                  ("download", str(tmp_path / "cache"))]
    else:
        assert answers["torch"] is None


def test_missing_name_raises_the_jax_error_and_missing_ok_inits(tmp_path,
                                                                monkeypatch):
    monkeypatch.setenv("AUTOVC_MODEL_CACHE", str(tmp_path / "empty"))
    errors = []
    for load in (JM.load_model, lambda *a, **k: TM.load_model(
            *a, device="cpu", **k)):
        with pytest.raises(FileNotFoundError) as e:
            load("vocoder", "WaveRNN_typo.pyt", model_dir=str(tmp_path),
                 verbose=False)
        errors.append(str(e.value))
    assert errors[1] == errors[0]
    assert "WaveRNN_typo.pyt" in errors[1]
    assert str(tmp_path / "empty") in errors[1]
    fresh = TM.load_model("vocoder", "WaveRNN_typo.pyt",
                          model_dir=str(tmp_path), verbose=False,
                          missing_ok=True, device="cpu",
                          config=WaveRNNConfig().with_overrides(**VOC))
    assert fresh.step == 0
    assert fresh.params["rnn1"]["w_hh"].shape == (64, 192)


# ---------------------------------------------------------------------------
# Reference PyTorch checkpoints (the formats of test_torch_checkpoints.py)
# ---------------------------------------------------------------------------


def _randomize_bn(module):
    for m in module.modules():
        if isinstance(m, torch.nn.BatchNorm1d):
            with torch.no_grad():
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 2.0)


@pytest.fixture(scope="module")
def ref_files(tmp_path_factory):
    """{model_type: (mirror module, path)} in the reference's formats: the
    AE ``{step, model_state, optimizer_state}``, the SE ``{step,
    model_state, speakers}``, the WaveRNN a bare ``state_dict`` (.pyt)."""
    torch.manual_seed(11)
    d = tmp_path_factory.mktemp("ref")
    ae = MirrorAutoVC()
    _randomize_bn(ae)
    opt = torch.optim.Adam(ae.parameters(), lr=1e-3)
    torch.save({"step": 200_000, "model_state": ae.state_dict(),
                "optimizer_state": opt.state_dict()}, d / "AutoVC.pt")
    se = MirrorSpeakerEncoder()
    hilde = torch.nn.functional.normalize(torch.randn(256), dim=0)
    torch.save({"step": 3_000, "model_state": se.state_dict(),
                "speakers": {"hilde": hilde}}, d / "SpeakerEncoder.pt")
    wr = MirrorWaveRNN(**VOC)
    _randomize_bn(wr)
    torch.save(wr.state_dict(), d / "WaveRNN.pyt")
    return {"auto_encoder": (ae.eval(), str(d / "AutoVC.pt")),
            "speaker_encoder": (se.eval(), str(d / "SpeakerEncoder.pt")),
            "vocoder": (wr.eval(), str(d / "WaveRNN.pyt"))}


def _configs():
    return {"auto_encoder": AutoEncoderConfig(),
            "speaker_encoder": SpeakerEncoderConfig(),
            "vocoder": WaveRNNConfig().with_overrides(**VOC)}


@pytest.mark.parametrize("model_type",
                         ["auto_encoder", "speaker_encoder", "vocoder"])
def test_reference_file_loads_as_the_bridged_jax_conversion(ref_files,
                                                            model_type):
    """Every leaf bitwise the JAX conversion through ``from_jax_params``;
    ``step``, ``speakers`` and the other extras equal."""
    _, path = ref_files[model_type]
    got = TM.load_model(model_type, path, config=_configs()[model_type],
                        verbose=False, device="cpu")
    want = JM.load_model(model_type, path, verbose=False)
    a = tree_leaves(got.params)
    b = tree_leaves(from_jax_params(want.params))
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == torch.float32
        assert torch.equal(x, y)
    assert got.step == want.step == {"auto_encoder": 200_000,
                                     "speaker_encoder": 3_000,
                                     "vocoder": 0}[model_type]
    assert sorted(got.extras) == sorted(want.extras)
    assert sorted(got.speakers) == sorted(want.speakers)
    for k in got.speakers:
        assert np.array_equal(got.speakers[k], want.speakers[k])
    if model_type == "speaker_encoder":
        assert sorted(got.speakers) == ["hilde"]


@pytest.mark.parametrize("model_type",
                         ["auto_encoder", "speaker_encoder", "vocoder"])
def test_reference_file_forward_matches_the_mirror(ref_files, model_type):
    """The port's f32 forward on the CPU against the mirror module that
    wrote the file, same inputs.  Bar: 1e-5 of max |mirror output| plus
    1e-6 (f32, sums taken in another order over at most a few thousand
    terms): the AE's post-net mel and content codes, the SE's embeddings,
    the WaveRNN's logits."""
    m, path = ref_files[model_type]
    cfg = _configs()[model_type]
    params = TM.load_model(model_type, path, config=cfg, verbose=False,
                           device="cpu").params
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        if model_type == "auto_encoder":
            x = torch.rand(2, 80, 96, generator=g)
            c = torch.nn.functional.normalize(
                torch.randn(2, 256, generator=g), dim=1)
            _, post_ref, codes_ref = m(x, c, c)
            _, post, codes = TAE.forward(params, x, c, c, cfg)[:3]
            pairs = [(post, post_ref), (codes, codes_ref)]
        elif model_type == "speaker_encoder":
            x = torch.randn(4, 160, 40, generator=g)
            pairs = [(TSE.forward(params, x), m(x))]
        else:
            F_frames = 8
            mel = torch.rand(1, 80, F_frames, generator=g)
            T = (F_frames - 2 * cfg.pad) * cfg.total_scale
            x = torch.rand(1, T, generator=g) * 2 - 1
            pairs = [(TWR.forward(params, x, mel, cfg), m(x, mel))]
    for got, want in pairs:
        assert got.shape == want.shape
        bar = 1e-5 * float(want.abs().max()) + 1e-6
        assert float((got - want).abs().max()) <= bar


def test_load_models_resolves_each_name(ref_files, tmp_path, monkeypatch):
    """``load_models`` on three names of three kinds (a reference ``.pt``
    by path, a v2 ``.ckpt`` by name in its ``model_dir``, a ``.pyt`` by
    name in the artifact cache): the models of ``load_model`` on each,
    bitwise those of the JAX ``load_models``."""
    import shutil
    se = JM.load_model("speaker_encoder", ref_files["speaker_encoder"][1],
                       verbose=False)
    JM.save_model(se, "se.ckpt", str(tmp_path / "se"))
    cache = tmp_path / "cache"
    cache.mkdir()
    shutil.copy(ref_files["vocoder"][1], cache / "WaveRNN.pyt")
    monkeypatch.setenv("AUTOVC_MODEL_CACHE", str(cache))
    types_ = ["auto_encoder", "speaker_encoder", "vocoder"]
    names = [ref_files["auto_encoder"][1], "se.ckpt", "WaveRNN.pyt"]
    dirs = [None, str(tmp_path / "se"), str(tmp_path / "nowhere")]
    cfgs = _configs()
    got = TM.load_models(types_, names, dirs, [cfgs[t] for t in types_],
                         verbose=False, device="cpu")
    want = JM.load_models(types_, names, dirs,
                          [None, None, JWRConfig().with_overrides(**VOC)],
                          verbose=False)
    assert [m.model_type for m in got] == types_
    for g, w in zip(got, want):
        assert g.step == w.step
        for x, y in zip(tree_leaves(g.params),
                        tree_leaves(from_jax_params(w.params))):
            assert torch.equal(x, y)
    assert np.array_equal(got[1].speakers["hilde"],
                          want[1].speakers["hilde"])


def test_load_checkpoint_refuses_a_torch_file(ref_files):
    path = ref_files["vocoder"][1]
    assert tckpt._is_torch_checkpoint(path) and jckpt._is_torch_checkpoint(
        path)
    for load in (tckpt.load_checkpoint, jckpt.load_checkpoint):
        with pytest.raises(ValueError, match="is a PyTorch checkpoint"):
            load(path)
