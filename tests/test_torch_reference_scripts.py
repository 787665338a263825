"""The port's reference-checkpoint scripts against the JAX package's:
``scripts/convert_reference_checkpoints_torch.py`` against
``scripts/convert_reference_checkpoints.py`` (the ``.ckpt`` files equal
leaf for leaf, read by both packages' ``load_checkpoint``), and
``scripts/eval_reference_parity_torch.py`` against
``scripts/eval_reference_parity.py`` on the CPU (the verdict, and each
file's ``mel_mse`` where it measures a real difference), on reference-format
files written from ``tests/torch_mirrors.py`` (as ``test_torch_loader.py``
writes them: no reference weights ship) and a synthetic wav."""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from autovc_tpu.utils import checkpoint as jckpt
from autovc_tpu_torch import models as TM
from autovc_tpu_torch.audio import io as tio
from autovc_tpu_torch.config import WaveRNNConfig
from autovc_tpu_torch.utils import checkpoint as tckpt
from autovc_tpu_torch.utils import tree_leaves

from torch_mirrors import MirrorAutoVC, MirrorSpeakerEncoder, MirrorWaveRNN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a narrow vocoder (the converters fix res_blocks = 10 and 3 upsample convs)
VOC = {"rnn_dims": 64, "fc_dims": 64}
SR = 22050
# the weight the failing harness run moves: every post-net mel frame
# moves by about it, ~100x the harness's atol
PERTURBED = ("decoder.linear_projection.linear_layer.bias", 1e-2)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomize_bn(module):
    for m in module.modules():
        if isinstance(m, torch.nn.BatchNorm1d):
            with torch.no_grad():
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 2.0)


@pytest.fixture(scope="module")
def ref_files(tmp_path_factory):
    """{model_type: path} in the reference's three formats, and the
    samples directory holding one 1 s synthetic wav."""
    torch.manual_seed(17)
    d = tmp_path_factory.mktemp("ref")
    ae = MirrorAutoVC()
    _randomize_bn(ae)
    torch.save({"step": 200_000, "model_state": ae.state_dict(),
                "optimizer_state": torch.optim.Adam(
                    ae.parameters()).state_dict()}, d / "AutoVC.pt")
    se = MirrorSpeakerEncoder()
    hilde = torch.nn.functional.normalize(torch.randn(256), dim=0)
    torch.save({"step": 3_000, "model_state": se.state_dict(),
                "speakers": {"hilde": hilde}}, d / "SpeakerEncoder.pt")
    wr = MirrorWaveRNN(**VOC)
    _randomize_bn(wr)
    torch.save(wr.state_dict(), d / "WaveRNN.pyt")
    blob = torch.load(d / "AutoVC.pt", weights_only=False)
    name, delta = PERTURBED
    blob["model_state"][name] = blob["model_state"][name] + delta
    torch.save(blob, d / "AutoVC_perturbed.pt")
    samples = d / "samples"
    samples.mkdir()
    rng = np.random.default_rng(3)
    t = np.arange(SR) / SR
    wav = (0.3 * np.sin(2 * np.pi * 160 * t) * (0.6 + 0.4 * np.sin(
        2 * np.pi * 3 * t)) + 0.01 * rng.standard_normal(SR))
    tio.save_wav(str(samples / "syn_1s.wav"), wav.astype(np.float32), SR)
    return {"auto_encoder": str(d / "AutoVC.pt"),
            "speaker_encoder": str(d / "SpeakerEncoder.pt"),
            "vocoder": str(d / "WaveRNN.pyt"),
            "perturbed": str(d / "AutoVC_perturbed.pt"),
            "samples": str(samples)}


@pytest.fixture(scope="module")
def converted(ref_files, tmp_path_factory):
    """The port's and the JAX script's ``.ckpt`` files of the three
    reference files: {model_type: (port path, JAX path)}."""
    d = tmp_path_factory.mktemp("native")
    flags = [f"--{k}={ref_files[k]}"
             for k in ("auto_encoder", "speaker_encoder", "vocoder")]
    written = _script("convert_reference_checkpoints_torch").main(
        flags + [f"--out_dir={d / 'torch'}"])
    argv = sys.argv
    sys.argv = ["convert_reference_checkpoints.py"] + flags + [
        f"--out_dir={d / 'jax'}"]
    try:
        _script("convert_reference_checkpoints").main()
    finally:
        sys.argv = argv
    names = ("AutoVC.ckpt", "SpeakerEncoder.ckpt", "WaveRNN.ckpt")
    assert written == [str(d / "torch" / n) for n in names]
    return {k: (str(d / "torch" / n), str(d / "jax" / n)) for k, n in zip(
        ("auto_encoder", "speaker_encoder", "vocoder"), names)}


def _flat(tree, path=""):
    """{path: leaf} of a checkpoint payload."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{path}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{path}/{i}").items()}
    return {path: tree}


def _same_payload(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb) and fa
    for k in fa:
        x, y = fa[k], fb[k]
        if isinstance(x, np.ndarray) or hasattr(y, "shape"):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert np.array_equal(x, y), k
        else:
            assert x == y, k


@pytest.mark.parametrize("model_type",
                         ["auto_encoder", "speaker_encoder", "vocoder"])
def test_converted_ckpt_equals_the_jax_scripts(converted, model_type):
    """Leaf for leaf (dtype, shape, values) and in every scalar
    (``step``), the port's file against the JAX script's, each read by
    the port's reader and by the JAX package's."""
    mine, theirs = converted[model_type]
    _same_payload(tckpt.load_checkpoint(mine), tckpt.load_checkpoint(theirs))
    _same_payload(jckpt.load_checkpoint(mine), jckpt.load_checkpoint(theirs))
    _same_payload(jckpt.load_checkpoint(mine), tckpt.load_checkpoint(mine))


@pytest.mark.parametrize("model_type",
                         ["auto_encoder", "speaker_encoder", "vocoder"])
def test_converted_ckpt_loads_as_the_reference_file(ref_files, converted,
                                                    model_type):
    """``load_model`` of the port's ``.ckpt`` equals ``load_model`` of the
    reference file it came from: every parameter bitwise, ``step`` and the
    speaker registry."""
    cfg = {"vocoder": WaveRNNConfig().with_overrides(**VOC)}.get(model_type)
    a = TM.load_model(model_type, converted[model_type][0], config=cfg,
                      verbose=False, device="cpu")
    b = TM.load_model(model_type, ref_files[model_type], config=cfg,
                      verbose=False, device="cpu")
    la, lb = tree_leaves(a.params), tree_leaves(b.params)
    assert len(la) == len(lb) > 0
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert a.step == b.step
    assert sorted(a.speakers) == sorted(b.speakers)
    for k in a.speakers:
        assert np.array_equal(a.speakers[k], b.speakers[k])


@pytest.fixture(scope="module")
def reports(ref_files, converted):
    """The two harnesses' reports on the 1 s wav: the converted ``.ckpt``
    against its mirror, then against the perturbed mirror."""
    mine = _script("eval_reference_parity_torch")
    theirs = _script("eval_reference_parity")
    out = {}
    for case, mirror in (("clean", ref_files["auto_encoder"]),
                         ("perturbed", ref_files["perturbed"])):
        out[case] = (
            mine.evaluate(converted["auto_encoder"][0], ref_files["samples"],
                          mirror_pt=mirror, device="cpu"),
            theirs.evaluate(converted["auto_encoder"][1],
                            ref_files["samples"], mirror_pt=mirror))
    return out


def test_harness_reports_parity_on_the_cpu(reports):
    """The port's f32 generator against the mirror on the CPU: allclose
    at rtol 1e-3 / atol 1e-4, as the JAX harness finds; both MSEs at the
    level of f32 rounding (below 1e-10 where the mel is ~1)."""
    mine, theirs = reports["clean"]
    assert set(mine) == {"allclose_rtol1e3", "mel_mse", "files", "device"}
    assert mine["device"] == "cpu"
    assert mine["allclose_rtol1e3"] is theirs["allclose_rtol1e3"] is True
    assert sorted(mine["files"]) == sorted(theirs["files"]) == ["syn_1s.wav"]
    for f in mine["files"]:
        assert mine["files"][f]["allclose"] is True
        assert mine["files"][f]["mel_mse"] < 1e-10
        assert theirs["files"][f]["mel_mse"] < 1e-10


def test_harness_mse_matches_jax_and_fails_a_perturbed_mirror(
        reports, ref_files, converted, capsys):
    """With the mirror's ``PERTURBED`` weight moved the MSE measures that
    move (~1e-4, against ~1e-15 of rounding), and the port's per-file
    ``mel_mse`` equals the JAX harness's to 1e-6 relative; both report
    false, and the port's command line exits 1."""
    mine, theirs = reports["perturbed"]
    assert mine["allclose_rtol1e3"] is theirs["allclose_rtol1e3"] is False
    for f in mine["files"]:
        m, t = mine["files"][f]["mel_mse"], theirs["files"][f]["mel_mse"]
        assert m > 1e-5
        assert m == pytest.approx(t, rel=1e-6, abs=0)
        assert mine["files"][f]["allclose"] is False
    assert mine["mel_mse"] == pytest.approx(theirs["mel_mse"], rel=1e-6)
    with pytest.raises(SystemExit) as done:
        _script("eval_reference_parity_torch").main(
            ["--auto_encoder", converted["auto_encoder"][0], "--samples",
             ref_files["samples"], "--mirror_pt", ref_files["perturbed"]],
            device="cpu")
    assert done.value.code == 1
    assert '"allclose_rtol1e3": false' in capsys.readouterr().out
