"""The training extras of the port against the JAX package: asynchronous
checkpoint writes (a snapshot later in-place updates cannot change, errors
of a background write, the legacy v1 pickle), the AutoVC loop's parameter
and gradient histograms (the JAX loop's names and counts on the same data
and bridged weights) and reconstruction figure, the speaker encoder's
histograms and TSNE figure, the vocoder loop's asynchronous save, and the
per-epoch conversion examples, which must run with the epoch's weights,
lstm2's packed kernel weights included.  CPU only, small shapes, seeded
with numpy."""
import glob
import json
import os
import pickle
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from autovc_tpu.config import AutoEncoderConfig as JCfg
from autovc_tpu.train import loop as JL
from autovc_tpu.utils import checkpoint as JCK
from autovc_tpu.utils.logging import MetricsLogger as JLogger
from autovc_tpu_torch.audio import io as TIO
from autovc_tpu_torch.config import AutoEncoderConfig as TCfg
from autovc_tpu_torch.config import ConverterConfig
from autovc_tpu_torch.config import SpeakerEncoderConfig as TSECfg
from autovc_tpu_torch.config import WaveRNNConfig as TWCfg
from autovc_tpu_torch.models import autoencoder as TAE
from autovc_tpu_torch.models import speaker_encoder as TSE
from autovc_tpu_torch.models import wavernn as TWR
from autovc_tpu_torch.train import loop as TL
from autovc_tpu_torch.train import schedules as TS
from autovc_tpu_torch.utils import checkpoint as TCK
from autovc_tpu_torch.utils import tree_clone, tree_leaves
from autovc_tpu_torch.utils.bridge import from_jax_params
from autovc_tpu_torch.utils.logging import MetricsLogger as TLogger

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TESTS)
from torch_dp_worker import ArrayDataset  # noqa: E402
from torch_tp_worker import BlockDataset, VocoderDataset  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# a narrow generator (the decoder's lstm2 keeps its 2 x 1024)
SMALL = dict(dim_pre=64, dim_neck=8)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.numpy()


@pytest.fixture(scope="module")
def ae_tree():
    """Seeded generator weights as a numpy tree, which the JAX loop takes
    as it is and the port through ``from_jax_params``."""
    return _numpy_tree(TAE.init(torch.Generator().manual_seed(0),
                                TCfg().with_overrides(**SMALL)))


def _records(logger):
    with open(logger.jsonl_path) as f:
        return [json.loads(line) for line in f]


def _hists(records):
    """(name, record) of every histogram record, in the order logged."""
    return [(k, v) for r in records for k, v in r.items()
            if k.startswith("hist/")]


# ---------------------------------------------------------------------------
# Asynchronous checkpoints
# ---------------------------------------------------------------------------


def test_async_snapshot_is_not_torn_by_in_place_updates(tmp_path,
                                                        monkeypatch):
    """The writer is held until the tensors (and a numpy leaf) have been
    changed in place, as the optimizer changes them: the file still holds
    the values from before the change."""
    go = threading.Event()
    write = TCK._write

    def held_write(*args):
        assert go.wait(30)
        write(*args)

    monkeypatch.setattr(TCK, "_write", held_write)
    w = torch.arange(1000, dtype=torch.float32)
    payload = {"step": 3, "params": {"w": w, "h": w.to(torch.bfloat16)},
               "opt_state": {"mu": [torch.ones(5)]},
               "speakers": {"a": np.full(4, 0.5, np.float32)}}
    path = str(tmp_path / "m.ckpt")
    TCK.save_checkpoint(path, payload, block=False)
    w.add_(1.0)
    payload["params"]["h"].mul_(2)
    payload["opt_state"]["mu"][0].zero_()
    payload["speakers"]["a"][:] = 7.0
    go.set()
    TCK.wait_for_saves()
    blob = TCK.load_checkpoint(path)
    np.testing.assert_array_equal(blob["params"]["w"], np.arange(1000))
    torch.testing.assert_close(blob["params"]["h"],
                               torch.arange(1000.0).to(torch.bfloat16),
                               rtol=0, atol=0)
    np.testing.assert_array_equal(blob["opt_state"]["mu"][0], np.ones(5))
    np.testing.assert_array_equal(blob["speakers"]["a"], np.full(4, 0.5))
    assert blob["step"] == 3


def test_failed_background_write_raises_at_the_wait_and_next_save(tmp_path):
    payload = {"step": 1, "params": {"w": torch.ones(3)}}
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    bad = str(blocker / "x.ckpt")        # a directory that is a file
    TCK.save_checkpoint(bad, payload, block=False)
    with pytest.raises(OSError):
        TCK.wait_for_saves()
    TCK.wait_for_saves()                 # the failure was reported once
    TCK.save_checkpoint(bad, payload, block=False)
    assert isinstance(TCK._PENDING[-1].exception(timeout=30), OSError)
    with pytest.raises(OSError):
        TCK.save_checkpoint(str(tmp_path / "ok.ckpt"), payload, block=False)
    TCK.save_checkpoint(str(tmp_path / "ok.ckpt"), payload, block=False)
    TCK.wait_for_saves()
    assert TCK.load_checkpoint(str(tmp_path / "ok.ckpt"))["step"] == 1


def test_blocking_save_waits_for_the_background_ones(tmp_path):
    """A blocking save to the path of a pending background save lands
    last: saves stay in the order they were made."""
    path = str(tmp_path / "m.ckpt")
    big = {"step": 1, "params": {"w": torch.zeros(1 << 20)}}
    TCK.save_checkpoint(path, big, block=False)
    TCK.save_checkpoint(path, {"step": 2, "params": {}})
    assert not TCK._PENDING
    assert TCK.load_checkpoint(path)["step"] == 2


def test_v1_pickle_loads_only_when_allowed_in_both_packages(tmp_path):
    path = str(tmp_path / "legacy.ckpt")
    legacy = {"format_version": 1, "step": 3,
              "params": {"w": np.ones((2, 2), np.float32),
                         "layers": [{"b": np.arange(3.0)}]}}
    with open(path, "wb") as f:
        pickle.dump(legacy, f, protocol=4)
    for load in (JCK.load_checkpoint, TCK.load_checkpoint):
        with pytest.raises(ValueError, match="allow_v1=True"):
            load(path)
    jblob = JCK.load_checkpoint(path, allow_v1=True)
    tblob = TCK.load_checkpoint(path, allow_v1=True)
    assert tblob.keys() == jblob.keys() == {"step", "params"}
    assert tblob["step"] == jblob["step"] == 3
    for a, b in zip(jax.tree_util.tree_leaves(tblob["params"]),
                    jax.tree_util.tree_leaves(jblob["params"])):
        np.testing.assert_array_equal(a, b)
    garbage = tmp_path / "garbage.ckpt"
    garbage.write_bytes(b"not a checkpoint")
    with pytest.raises(ValueError, match="not a v2 checkpoint"):
        TCK.load_checkpoint(str(garbage), allow_v1=True)


# ---------------------------------------------------------------------------
# The AutoVC loop's histograms and figure
# ---------------------------------------------------------------------------


class _ArrayDataset:
    """Fixed synthetic batches (B, 80, T) and embeddings (B, 256)."""

    def __init__(self, n=2, T=32, seed=0):
        rng = np.random.default_rng(seed)
        self.x = rng.random((n, 80, T), dtype=np.float32)
        c = rng.standard_normal((n, 256)).astype(np.float32)
        self.c = c / np.linalg.norm(c, axis=1, keepdims=True)

    def batches(self, batch_size, shuffle=True, seed=0):
        order = np.random.default_rng(seed).permutation(len(self.x))
        for s in range(0, len(self.x), batch_size):
            idx = order[s:s + batch_size]
            yield self.x[idx], self.c[idx]

    def epoch_steps(self, batch_size):
        return len(self.x) // batch_size


def test_ae_loop_histograms_match_the_jax_loop(tmp_path, ae_tree):
    """2 epochs of one f32 step, a logger on each side: the same
    ``hist/params/*`` and ``hist/grads/*`` records, in the same order and
    with the same counts, at the same step; the reconstruction figure of
    the save epoch; the asynchronous checkpoint on disk when the loop
    returns, holding the returned parameters."""
    ds = _ArrayDataset()
    kw = dict(n_epochs=2, batch_size=2, log_freq=1, save_freq=2,
              verbose=False, precision="f32")
    jlog = JLogger(log_dir=str(tmp_path / "jax"))
    JL.train_autoencoder(ae_tree, ds, JCfg().with_overrides(**SMALL),
                         logger=jlog, model_name="", **kw)
    tlog = TLogger(log_dir=str(tmp_path / "torch"))
    params, ema, info = TL.train_autoencoder(
        from_jax_params(ae_tree), ds, TCfg().with_overrides(**SMALL),
        logger=tlog, model_name="ae.ckpt", save_dir=str(tmp_path / "ckpt"),
        **kw)
    jh, th = _hists(_records(jlog)), _hists(_records(tlog))
    assert [k for k, _ in th] == [k for k, _ in jh]
    assert [v["count"] for _, v in th] == [v["count"] for _, v in jh]
    jsteps = [r["_step"] for r in _records(jlog) if any(
        k.startswith("hist/") for k in r)]
    assert [r["_step"] for r in _records(tlog) if any(
        k.startswith("hist/") for k in r)] == jsteps
    names = [k for k, _ in th]
    n_leaves = len(tree_leaves(params))
    assert len(names) == 2 * n_leaves and jsteps == [2] * len(names)
    assert sum(k.startswith("hist/params/") for k in names) == n_leaves
    assert sum(k.startswith("hist/grads/") for k in names) == n_leaves
    assert all(sum(v["bins"]) == v["count"] and np.isfinite(v["mean"])
               for _, v in th)
    figs = sorted(os.path.basename(p) for p in glob.glob(os.path.join(
        os.path.dirname(tlog.jsonl_path), "*.png")))
    assert figs == ["mel_reconstruction_2.png"]
    blob = TCK.load_checkpoint(str(tmp_path / "ckpt" / "ae.ckpt"))
    assert blob["step"] == info["step"] == 2
    for a, b in zip(tree_leaves(from_jax_params(blob["params"])),
                    tree_leaves(params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_ae_step_carries_the_raw_gradients(ae_tree):
    """``make_ae_step(with_grads=True)``: aux's ``grads`` is a tree of the
    parameters' structure holding the gradients before clipping (their
    global norm is ``grad_norm``, far above the clip)."""
    cfg = TCfg().with_overrides(optimizer={"grad_clip_norm": 1e-3},
                                **SMALL)
    tx = TS.make_optimizer(cfg.optimizer, 1)
    params = from_jax_params(ae_tree)
    x, c = next(_ArrayDataset().batches(2, seed=1))
    _, want = TL.loss_and_grads(from_jax_params(ae_tree), x, c, cfg, "f32")
    step = TL.make_ae_step(cfg, tx, 0.99, "f32", with_grads=True)
    _, _, _, aux = step(params, tx.init(tree_leaves(params)),
                        from_jax_params(ae_tree), x, c)
    got = tree_leaves(aux["grads"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    norm = float(torch.sqrt(sum(torch.sum(g * g) for g in got)))
    assert norm == pytest.approx(float(aux["grad_norm"]), rel=1e-6)
    assert norm > 1.0
    plain = TL.make_ae_step(cfg, tx, 0.99, "f32")
    _, _, _, aux = plain(params, tx.init(tree_leaves(params)),
                         from_jax_params(ae_tree), x, c)
    assert "grads" not in aux


# ---------------------------------------------------------------------------
# The speaker encoder's and the vocoder's save epochs
# ---------------------------------------------------------------------------


class _Speakers:
    def batches(self, U, n_batches, seed=0):
        rng = np.random.default_rng(seed)
        protos = 2.0 * np.random.default_rng(5).random((3, 1, 1, 40))
        for _ in range(n_batches):
            yield (protos + rng.random((3, U, 40, 40))).astype(np.float32)


def test_se_loop_logs_histograms_and_tsne_and_saves(tmp_path):
    cfg = TSECfg()
    params = TSE.init(torch.Generator().manual_seed(3), cfg)
    log = TLogger(log_dir=str(tmp_path))
    params, info = TL.train_speaker_encoder(
        params, _Speakers(), cfg, n_epochs=2, utterances_per_speaker=4,
        steps_per_epoch=1, log_freq=1, save_freq=1, model_name="se.ckpt",
        save_dir=str(tmp_path / "ckpt"), logger=log, verbose=False,
        speakers={"a": np.zeros(256, np.float32)})
    records = _records(log)
    names = [k for k, _ in _hists(records)]
    n = len(tree_leaves(params))
    assert len(names) == 2 * n and len(set(names)) == n
    assert all(k.startswith("hist/params/") for k in names)
    assert sum("eer" in r for r in records) == 2
    figs = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(os.path.dirname(log.jsonl_path), "*.png")))
    assert figs == ["embedding_tsne_1.png", "embedding_tsne_2.png"]
    blob = TCK.load_checkpoint(str(tmp_path / "ckpt" / "se.ckpt"))
    assert blob["step"] == info["step"] == 2 and "a" in blob["speakers"]
    for a, b in zip(tree_leaves(from_jax_params(blob["params"])),
                    tree_leaves(params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


class _VocoderData:
    def __init__(self, cfg):
        self.cfg = cfg

    def batches(self, batch_size, seq_frames, n_batches, seed=0):
        rng = np.random.default_rng(seed)
        T = seq_frames * self.cfg.hop_length
        for _ in range(n_batches):
            x = rng.uniform(-1, 1, (batch_size, T)).astype(np.float32)
            mels = rng.random((batch_size, 80, seq_frames + 2 * self.cfg.pad),
                              dtype=np.float32)
            yield x, np.roll(x, -1, 1), mels


def test_vocoder_loop_saves_asynchronously(tmp_path):
    cfg = TWCfg().with_overrides(res_blocks=2, rnn_dims=16, fc_dims=16,
                                 compute_dims=8, res_out_dims=16)
    params = TWR.init(torch.Generator().manual_seed(4), cfg)
    params, info = TL.train_vocoder(
        params, _VocoderData(cfg), cfg, n_epochs=2, batch_size=2,
        steps_per_epoch=1, seq_frames=2, model_name="voc.ckpt",
        save_dir=str(tmp_path), verbose=False)
    assert not TCK._PENDING
    blob = TCK.load_checkpoint(str(tmp_path / "voc.ckpt"))
    assert blob["step"] == info["step"] == 2
    for a, b in zip(tree_leaves(from_jax_params(blob["params"])),
                    tree_leaves(params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Per-epoch conversion examples
# ---------------------------------------------------------------------------


def _wav(seconds, f0, sr=22050):
    t = np.arange(int(seconds * sr)) / sr
    return (0.2 * sum(np.sin(2 * np.pi * k * f0 * t) / k
                      for k in (1, 2, 3))).astype(np.float32)


def test_epoch_examples_convert_with_the_epochs_weights(tmp_path,
                                                        monkeypatch):
    """``train(source_examples=..., target_examples=...)`` converts each
    example after each epoch.  The last epoch's file equals ``convert``
    (same seed, same target) by the trained converter, whose lstm2 kernel
    weights ``train`` packs afresh; an example converted with the packed
    weights of construction time would differ from it.  The first
    epoch's example differs from the last's."""
    from autovc_tpu_torch import VoiceConverter
    monkeypatch.chdir(tmp_path)
    os.mkdir("data")
    for i in range(2):
        TIO.save_wav(f"data/spk{i}_{i}.wav", _wav(0.45, 110 + 40 * i), 22050)
    TIO.save_wav("src.wav", _wav(0.4, 150), 22050)
    TIO.save_wav("trg.wav", _wav(0.4, 220), 22050)
    cfg = ConverterConfig().with_overrides(
        auto_encoder={"spectrogram": {"partial_utterance_n_frames": 32},
                      **SMALL},
        vocoder={"rnn_dims": 32, "fc_dims": 32,
                 "generate": {"target": 1375, "overlap": 550}})
    vc = VoiceConverter(config=cfg, device="cpu", verbose=False)
    per_epoch = []
    convert_multiple = vc.convert_multiple

    def tap(*args, **kwargs):
        out = convert_multiple(*args, **kwargs)
        per_epoch.append((kwargs["audio_log_dict"]["epoch"],
                          [o.wav.copy() for o in out]))
        return out

    monkeypatch.setattr(vc, "convert_multiple", tap)
    vc.train("data", model_type="auto_encoder", n_epochs=2, batch_size=2,
             model_name="", precision="f32",
             opt_overrides={"lr": 1e-3, "lr_scheduler": "constant"},
             source_examples=["src.wav"], target_examples=["trg.wav"])
    assert [e for e, _ in per_epoch] == [1, 2]
    example = os.path.join("results", "training_examples",
                           "src_to_trg.wav")
    assert os.path.isfile(example)
    after = vc.convert("src.wav", "trg.wav", save_dir="after")
    np.testing.assert_array_equal(per_epoch[-1][1][0], after.wav)
    np.testing.assert_array_equal(
        TIO.load_wav(example)[0],
        TIO.load_wav(os.path.join("results", "after", "src_to_trg.wav"))[0])
    assert not np.array_equal(per_epoch[0][1][0], per_epoch[1][1][0])


def test_examples_are_ignored_by_the_other_models(tmp_path, monkeypatch):
    """As in the JAX dispatcher, the examples belong to the auto-encoder:
    the vocoder's training takes and ignores them."""
    from autovc_tpu_torch import VoiceConverter
    monkeypatch.chdir(tmp_path)
    os.mkdir("data")
    TIO.save_wav("data/v.wav", _wav(1.2, 130), 22050)
    tiny = dict(res_blocks=2, rnn_dims=16, fc_dims=16, compute_dims=8,
                res_out_dims=16)
    vc = VoiceConverter(config=ConverterConfig().with_overrides(
        vocoder=tiny), device="cpu", verbose=False)
    info = vc.train("data", model_type="vocoder", n_epochs=1,
                    steps_per_epoch=1, batch_size=2, seq_frames=3,
                    model_name="", source_examples=["data/v.wav"],
                    target_examples=["data/v.wav"])
    assert info["step"] == 1 and not os.path.exists("results")



_MESH_LOOPS = """
import os, sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, {tests!r})
from torch_dp_worker import ArrayDataset
from torch_tp_worker import BlockDataset, VocoderDataset
from autovc_tpu_torch.parallel import sharding as shd
from autovc_tpu_torch.parallel import steps as psteps
from autovc_tpu_torch.train import loop as L
from autovc_tpu_torch.utils import tree_leaves

torch.set_num_threads(1)
psteps.initialize_distributed()
inp = torch.load(os.path.join({d!r}, "inputs.pt"), weights_only=False)
mesh = shd.make_mesh((1, 2), ("data", "model"))
kw = dict(n_epochs=1, model_name="", verbose=False, mesh=mesh)
ae = inp["train_autoencoder"]
p, _, info = L.train_autoencoder(ae["params"], ArrayDataset(ae["x"], ae["c"]),
                                 ae["cfg"], batch_size=2, precision="f32",
                                 opt_overrides={{"lr": 1e-4}}, **kw)
out = {{"train_autoencoder": (info["step"], tree_leaves(p))}}
se = inp["train_speaker_encoder"]
p, info = L.train_speaker_encoder(se["params"], BlockDataset(se["block"]),
                                  se["cfg"], steps_per_epoch=1, **kw)
out["train_speaker_encoder"] = (info["step"], tree_leaves(p))
voc = inp["train_vocoder"]
p, info = L.train_vocoder(voc["params"], VocoderDataset(voc["batch"]),
                          voc["cfg"], steps_per_epoch=1, batch_size=2,
                          lr=1e-4, **kw)
out["train_vocoder"] = (info["step"], tree_leaves(p))
torch.save(out, os.path.join({d!r}, f"rank{{mesh.rank}}.pt"))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def mesh_loops(tmp_path_factory):
    """Two gloo ranks as a (1, 2) ("data", "model") mesh, each running one
    step of the three loops (started by the port's launcher); the inputs
    and both ranks' (step, returned parameters)."""
    from autovc_tpu_torch.utils import launcher
    d = tmp_path_factory.mktemp("mesh_loops")
    rng = np.random.default_rng(7)
    gen = torch.Generator().manual_seed(7)
    wcfg = TWCfg().with_overrides(res_blocks=2, rnn_dims=16, fc_dims=16,
                                  compute_dims=8, res_out_dims=16)
    F = 2 + 2 * wcfg.pad
    x_in = rng.uniform(-1, 1, (2, 2 * wcfg.total_scale)).astype(np.float32)
    inputs = {
        "train_autoencoder": {
            "cfg": TCfg().with_overrides(**SMALL),
            "params": TAE.init(gen, TCfg().with_overrides(**SMALL)),
            "x": rng.random((2, 80, 32), dtype=np.float32),
            "c": rng.random((2, 256), dtype=np.float32)},
        "train_speaker_encoder": {
            "cfg": TSECfg(), "params": TSE.init(gen, TSECfg()),
            "block": rng.random((2, 2, 24, 40), dtype=np.float32)},
        "train_vocoder": {
            "cfg": wcfg, "params": TWR.init(gen, wcfg),
            "batch": (x_in, np.roll(x_in, -1, 1),
                      rng.random((2, 80, F), dtype=np.float32))},
    }
    torch.save(inputs, str(d / "inputs.pt"))
    script = d / "mesh_loops.py"
    script.write_text(_MESH_LOOPS.format(tests=TESTS, d=str(d)))
    res = launcher.launch_local_multiprocess(str(script), 2, device="cpu",
                                             timeout=240)
    assert all(rc == 0 for rc, _ in res), [out[-3000:] for _, out in res]
    return inputs, [torch.load(str(d / f"rank{r}.pt"), weights_only=False)
                    for r in range(2)]


@pytest.mark.parametrize("loop", ["train_autoencoder",
                                  "train_speaker_encoder", "train_vocoder"])
def test_mesh_loops_name_their_roadmap_item(mesh_loops, loop):
    """Each loop runs a step on a (1, 2) ("data", "model") mesh (tensor
    parallelism, ROADMAP Queue 1 item 9b) and returns the full tree: the
    shapes of the tree it was given, the same on both ranks, within 3 lr
    of the one-process step (Adam moves a weight by about lr a step)."""
    inputs, ranks = mesh_loops
    inp = inputs[loop]
    kw = dict(n_epochs=1, model_name="", verbose=False)
    params = tree_clone(inp["params"])
    if loop == "train_autoencoder":
        ref, _, info = TL.train_autoencoder(
            params, ArrayDataset(inp["x"], inp["c"]), inp["cfg"],
            batch_size=2, precision="f32", opt_overrides={"lr": 1e-4}, **kw)
        lr = 1e-4
    elif loop == "train_speaker_encoder":
        ref, info = TL.train_speaker_encoder(
            params, BlockDataset(inp["block"]), inp["cfg"],
            steps_per_epoch=1, **kw)
        lr = inp["cfg"].optimizer.lr
    else:
        ref, info = TL.train_vocoder(
            params, VocoderDataset(inp["batch"]), inp["cfg"],
            steps_per_epoch=1, batch_size=2, lr=1e-4, **kw)
        lr = 1e-4
    ref = tree_leaves(ref)
    for out in ranks:
        step, got = out[loop]
        assert step == info["step"] == 1
        assert [g.shape for g in got] == [r.shape for r in ref]
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), r.numpy(), atol=3 * lr,
                                       rtol=0)
    assert all(torch.equal(a, b) for a, b in zip(ranks[0][loop][1],
                                                  ranks[1][loop][1]))
