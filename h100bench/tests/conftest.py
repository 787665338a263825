"""A tiny copy of the benchmark's folder for the CPU tests: the folder as
it is, plus new files only (a tiny configuration of each vocoder mode,
tiny mixes, their cells' limits, a ``BENCHMARK.json`` of tiny cells), so
that the tests also show a new configuration, mix and cell found by name
with no edit to an existing file."""
import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_CELLS = {"t.serve": ("tiny", "tiny-serve"),
              "t.rawserve": ("tiny-raw", "tiny-serve"),
              "t.convert": ("tiny", "tiny-convert"),
              "t.rawconvert": ("tiny-raw", "tiny-convert"),
              "t.train": ("tiny", "tiny-train")}
# the CPU runs the program in float32 (its "auto" precision there), so the
# tiny configurations state f32, and these limits are float32's
CONVERSION_LIMITS = {"mel_err": 1e-4, "served_gap": 1e-4, "finish_err": 1e-4}
# float32 against float32 on the CPU: the first gradients agree to ~2e-4,
# and Adam's unit steps of lr = 1e-3 carry the round-off of near-zero
# gradient elements into the third step's loss (~1e-2 there; ~1e-5 at
# lr = 1e-5) and the leaves' changes (~3e-2)
TRAIN_LIMITS = {"grad_cos_gap": 1e-3, "grad_gap": 1e-2, "change_gap": 0.25,
                "ema_gap": 0.25}


def build_tiny(dst: Path) -> Path:
    """The tiny tree under ``dst``; returns its ``BENCHMARK.json``."""
    bench = dst / "h100bench"
    shutil.copytree(REPO / "h100bench", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((bench / "configs/autovc-mol.json").read_text())
    cfg["precision"] = "f32"
    cfg["auto_encoder"].update({"dim_neck": 4, "dim_emb": 16, "dim_pre": 16})
    cfg["auto_encoder"]["learn"]["precision"] = "f32"
    cfg["auto_encoder"]["spectrogram"]["partial_utterance_n_frames"] = 64
    cfg["speaker_encoder"].update({"hidden_size": 16, "embedding_size": 16,
                                   "num_layers": 2})
    cfg["vocoder"].update({"rnn_dims": 16, "fc_dims": 16, "compute_dims": 8,
                           "res_out_dims": 16, "res_blocks": 1})
    (bench / "configs/tiny.json").write_text(json.dumps(cfg))
    raw = json.loads(json.dumps(cfg))
    raw["vocoder"].update({"mode": "RAW", "bits": 5})
    raw["vocoder"]["generate"]["mu_law"] = True
    (bench / "configs/tiny-raw.json").write_text(json.dumps(raw))
    mixes = {
        "tiny-serve": {"kind": "serve_batch", "file_sr": 16000,
                       "lengths_s": [0.6, 1.1], "target_s": 0.8,
                       "pool_calls": 3, "judged_calls": 1},
        "tiny-convert": {"kind": "convert", "file_sr": 16000,
                         "lengths_s": [1.0, 1.2], "target_s": 0.8,
                         "pool_requests": 6, "judged_requests": 2},
        "tiny-train": {"kind": "train_ae", "batch": 2, "frames": 64,
                       "pool_rows": 8, "reference_steps": 3}}
    for name, mix in mixes.items():
        (bench / f"traffic/{name}.json").write_text(json.dumps(mix))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1,
                          "why": "tiny"} for n, (c, t) in TINY_CELLS.items()]
    moves = {"serve_audio_s_per_s": ["t.serve", "t.rawserve"],
             "convert_p95_s": ["t.convert", "t.rawconvert"],
             "train_step_s": ["t.train"]}
    for m in spec["end_to_end"]:
        if m["name"] in moves:
            m["workloads"] = moves[m["name"]]
    for m in spec["per_layer"]:
        m["workloads"] = moves[m["moves"]]
    for n, (_, t) in TINY_CELLS.items():
        lim = TRAIN_LIMITS if t == "tiny-train" else CONVERSION_LIMITS
        (bench / f"limits/{n}.json").write_text(json.dumps(lim))
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    return dst / "BENCHMARK.json"


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """(folder, BENCHMARK.json) of the tiny tree."""
    dst = tmp_path_factory.mktemp("tiny")
    spec = build_tiny(dst)
    return dst / "h100bench", spec


@pytest.fixture(scope="session")
def tiny_run(tiny):
    """harness.run of a tiny cell on the CPU (results cached by call)."""
    import torch
    from h100bench import harness
    torch.set_num_threads(4)
    cache = {}

    def run(name, seed=2 ** 31 + 17, fault=None, mix=None, tracing=False,
            control=False):
        key = (name, seed, getattr(fault, "__name__", None),
               json.dumps(mix, sort_keys=True), tracing, control)
        if key not in cache:
            cache[key] = harness.run(
                name, seed, 0.05, tracing, device="cpu", root=tiny[0],
                spec_path=tiny[1], fault=fault, mix=mix,
                device_name="NVIDIA H100 80GB HBM3", control=control)
        return cache[key]
    return run
