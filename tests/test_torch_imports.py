"""Import hygiene of the port: ``autovc_tpu_torch`` and ``chip_smoke.py``
import nothing of JAX or of the JAX package (checked in a subprocess where
both are made unimportable), the port runs a CPU conversion there, and the
entry points refuse to fall back to the CPU when no GPU is present."""
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKER = textwrap.dedent("""
    import importlib.abc, sys
    BLOCKED = ("jax", "jaxlib", "autovc_tpu")

    class Blocker(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"{name} is blocked in this process")
            return None

    sys.meta_path.insert(0, Blocker())
    sys.path.insert(0, REPO_DIR)
""").replace("REPO_DIR", repr(REPO))


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
        for m in pkgutil.walk_packages(autovc_tpu_torch.__path__,
                                       "autovc_tpu_torch."):
            importlib.import_module(m.name)
        from autovc_tpu_torch import Audio, ConverterConfig, VoiceConverter
        cfg = ConverterConfig().with_overrides(vocoder={
            "rnn_dims": 32, "fc_dims": 32,
            "generate": {"target": 1375, "overlap": 550}})
        vc = VoiceConverter(config=cfg, device="cpu", verbose=False)
        t = np.arange(11025) / 22050
        wav = (0.3 * np.sin(2 * np.pi * 180 * t)).astype(np.float32)
        out = vc.convert(Audio(wav, sr_org=22050),
                         Audio(wav.copy(), sr_org=22050), save_name=False,
                         partial_frames=64)
        assert out.wav.shape == (63 * 275,), out.wav.shape
        assert np.all(np.isfinite(out.wav))
        bad = [m for m in sys.modules
               if m in ("jax", "jaxlib", "autovc_tpu")
               or m.startswith(("jax.", "jaxlib.", "autovc_tpu."))]
        assert not bad, bad
        print("PORT_OK")
    """)
    res = _run(code)
    assert res.returncode == 0 and "PORT_OK" in res.stdout, res.stderr[-3000:]


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
    with pytest.raises(RuntimeError):
        load_model("vocoder", verbose=False, device="cuda")
