"""Import hygiene of the port: ``autovc_tpu_torch`` and ``chip_smoke.py``
import nothing of JAX or of the JAX package (checked in a subprocess where
both are made unimportable), the port runs a CPU conversion there (through
``convert``, ``convert_batch`` and the command line), the ranks the
port's launcher starts run without them too, and the entry points refuse
to fall back to the CPU when no GPU is present."""
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCK_IMPORTS = textwrap.dedent("""
    import importlib.abc, sys
    BLOCKED = ("jax", "jaxlib", "autovc_tpu")

    class Blocker(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"{name} is blocked in this process")
            return None

    sys.meta_path.insert(0, Blocker())
""")
_BLOCKER = _BLOCK_IMPORTS + f"sys.path.insert(0, {REPO!r})\n"


def _run(code: str, cwd: str = REPO, timeout: int = 240):
    return subprocess.run([sys.executable, "-c", _BLOCKER + code], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES="",
                                   OMP_NUM_THREADS="1"))


def test_port_imports_and_converts_without_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil
        import numpy as np
        import autovc_tpu_torch
        names = {m.name for m in pkgutil.walk_packages(
            autovc_tpu_torch.__path__, "autovc_tpu_torch.")}
        for name in sorted(names):
            importlib.import_module(name)
        assert {"autovc_tpu_torch.ops.gru_train_kernels",
                "autovc_tpu_torch.ops.mol",
                "autovc_tpu_torch.train.loop", "autovc_tpu_torch.cli",
                "autovc_tpu_torch.__main__",
                "autovc_tpu_torch.utils.torch_compat",
                "autovc_tpu_torch.utils.profiling",
                "autovc_tpu_torch.utils.roofline",
                "autovc_tpu_torch.utils.visual",
                "autovc_tpu_torch.utils.launcher",
                "autovc_tpu_torch.parallel.collectives",
                "autovc_tpu_torch.parallel.sharding",
                "autovc_tpu_torch.parallel.streams",
                "autovc_tpu_torch.parallel.steps",
                "autovc_tpu_torch.parallel.ring",
                "autovc_tpu_torch.parallel.pipeline",
                "autovc_tpu_torch.parallel.multihost_smoke"} <= names, names
        from autovc_tpu_torch import Audio, ConverterConfig, VoiceConverter
        cfg = ConverterConfig().with_overrides(vocoder={
            "rnn_dims": 32, "fc_dims": 32,
            "generate": {"target": 1375, "overlap": 550}},
            auto_encoder={"spectrogram": {"partial_utterance_n_frames": 64}})
        vc = VoiceConverter(config=cfg, device="cpu", verbose=False)
        t = np.arange(11025) / 22050
        wav = (0.3 * np.sin(2 * np.pi * 180 * t)).astype(np.float32)
        out = vc.convert(Audio(wav, sr_org=22050),
                         Audio(wav.copy(), sr_org=22050), save_name=False,
                         partial_frames=64)
        assert out.wav.shape == (63 * 275,), out.wav.shape
        assert np.all(np.isfinite(out.wav))
        import os, tempfile
        from autovc_tpu_torch.audio import io
        with tempfile.TemporaryDirectory() as d:
            os.mkdir(os.path.join(d, "src"))
            for k in range(2):
                io.save_wav(os.path.join(d, "src", f"s{k}.wav"), wav, 22050)
            io.save_wav(os.path.join(d, "trg.wav"), wav, 22050)
            outs = vc.convert_batch(os.path.join(d, "src"),
                                    os.path.join(d, "trg.wav"),
                                    save_dir=os.path.join(d, "out"))
            assert sorted(os.listdir(os.path.join(d, "out"))) == [
                "s0_to_trg.wav", "s1_to_trg.wav"]
        assert [o.wav.shape for o in outs] == [(63 * 275,)] * 2
        assert all(np.all(np.isfinite(o.wav)) for o in outs)
        from autovc_tpu_torch.__main__ import main
        with tempfile.TemporaryDirectory() as d:
            io.save_wav(os.path.join(d, "s.wav"), wav, 22050)
            main(["-mode", "convert", "-quiet", "-auto_encoder_params",
                  "spectrogram={'partial_utterance_n_frames': 64}",
                  "-vocoder_params", "rnn_dims=32", "fc_dims=32",
                  "generate={'target': 1375, 'overlap': 550}",
                  "-sources", os.path.join(d, "s.wav"), "-targets",
                  os.path.join(d, "s.wav"), "-save_dir",
                  os.path.join(d, "results"), "-convert_params",
                  "preprocess=('normalize_volume', 'trim_long_silences')"],
                 device="cpu")
            assert os.listdir(os.path.join(d, "results")) == ["s_to_s.wav"]
        bad = [m for m in sys.modules
               if m in ("jax", "jaxlib", "autovc_tpu")
               or m.startswith(("jax.", "jaxlib.", "autovc_tpu."))]
        assert not bad, bad
        print("PORT_OK")
    """)
    res = _run(code)
    assert res.returncode == 0 and "PORT_OK" in res.stdout, res.stderr[-3000:]


def test_launched_ranks_run_without_jax(tmp_path):
    """From a process that cannot import JAX or the JAX package, the
    launcher starts two gloo ranks of ``python -m autovc_tpu_torch.
    parallel.multihost_smoke``, which cannot import them either (the
    blocker runs as their ``sitecustomize``): rank 0 prints
    ``MULTIHOST_OK`` with procs=2."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_BLOCK_IMPORTS)
    code = textwrap.dedent(f"""
        import os
        from autovc_tpu_torch.utils import launcher
        os.environ["PYTHONPATH"] = {str(site)!r}
        res = launcher.launch_local_multiprocess(
            "autovc_tpu_torch.parallel.multihost_smoke", 2, device="cpu",
            module=True, timeout=200)
        out = "".join(o for _, o in res)
        assert [rc for rc, _ in res] == [0, 0], out[-3000:]
        assert "MULTIHOST_OK" in out and "procs=2 devices=2" in out, out
        print("LAUNCH_OK")
    """)
    res = _run(code, timeout=240)
    assert res.returncode == 0 and "LAUNCH_OK" in res.stdout, \
        res.stdout[-3000:] + res.stderr[-3000:]


def test_chip_smoke_imports_without_jax():
    res = _run("import chip_smoke\nprint('SMOKE_IMPORT_OK')")
    assert res.returncode == 0 and "SMOKE_IMPORT_OK" in res.stdout, \
        res.stderr[-3000:]


def test_chip_smoke_refuses_without_gpu_or_repo(tmp_path):
    """No CUDA device: exit non-zero with no result line.  A directory
    holding chip_smoke.py and nothing else of the repo: the same."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for cwd in (REPO, str(alone)):
        res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=240,
                             env=env)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout


def test_entry_points_raise_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from autovc_tpu_torch import VoiceConverter, load_model
    from autovc_tpu_torch.models import wavernn as TW
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VoiceConverter(verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model("vocoder", verbose=False)
    params = load_model("vocoder", verbose=False, device="cpu").params
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TW.generate(params, np.zeros((80, 5), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TW.generate_many(params, [np.zeros((80, 5), np.float32)])
    with pytest.raises(RuntimeError):
        load_model("vocoder", verbose=False, device="cuda")
    from autovc_tpu_torch.models import speaker_encoder as TSE
    from autovc_tpu_torch.ops import melspec as TMEL
    wav = np.zeros(16000, np.float32)
    se = load_model("speaker_encoder", verbose=False, device="cpu").params
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSE.embed_utterance(se, wav)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSE.embed_utterances(se, [wav])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TMEL.mel_spec_auto_encoder_sliced(wav)
    assert TSE.embed_utterance(se, wav, device="cpu").shape == (256,)
