"""The port's ``MetricsLogger`` histograms and figures against the JAX
logger's, and its figure helpers against ``autovc_tpu/utils/visual.py``.
Equal values give equal JSONL records: names and order, counts and bins
exactly, the summary stats to 1e-12."""
import glob
import json
import os

import jax
import matplotlib
import numpy as np
import pytest
import torch

from autovc_tpu.config import SpeakerEncoderConfig as JSECfg
from autovc_tpu.models import speaker_encoder as JSE
from autovc_tpu.utils import visual as JV
from autovc_tpu.utils.logging import MetricsLogger as JLogger
from autovc_tpu_torch.models import autoencoder as TAE
from autovc_tpu_torch.utils import visual as TV
from autovc_tpu_torch.utils.bridge import from_jax_params
from autovc_tpu_torch.utils.logging import MetricsLogger as TLogger

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

STATS = ("mean", "std", "min", "max", "lo", "hi")


def _hist_records(logger):
    with open(logger.jsonl_path) as f:
        records = [json.loads(line) for line in f]
    return [(k, v, r.get("_step")) for r in records for k, v in r.items()
            if k.startswith("hist/")]


def _assert_same(got, want):
    assert [k for k, _, _ in got] == [k for k, _, _ in want]
    for (name, g, gs), (_, w, ws) in zip(got, want):
        assert gs == ws, name
        assert g["count"] == w["count"] and g["bins"] == w["bins"], name
        for key in STATS:
            assert g[key] == pytest.approx(w[key], rel=1e-12, abs=1e-12), \
                (name, key)


def _loggers(tmp_path):
    return (JLogger(log_dir=str(tmp_path / "jax")),
            TLogger(log_dir=str(tmp_path / "torch")))


def test_tree_histograms_of_a_numpy_tree_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"enc": {"w": rng.standard_normal((4, 5)), "b": np.zeros(4)},
            "blocks": [{"k": np.full(3, 2.0)},
                       {"k": rng.random(7, dtype=np.float32)}],
            "scale": np.float32(1.5), "lr": 0.1, "none": None,
            "a": rng.integers(-3, 3, size=9)}
    jlog, tlog = _loggers(tmp_path)
    jlog.log_tree_histograms("params", tree, step=3)
    tlog.log_tree_histograms("params", tree, step=3)
    got, want = _hist_records(tlog), _hist_records(jlog)
    _assert_same(got, want)
    assert [k for k, _, _ in got] == [
        "hist/params/a", "hist/params/blocks/0/k", "hist/params/blocks/1/k",
        "hist/params/enc/b", "hist/params/enc/w", "hist/params/scale"]


@pytest.mark.parametrize("bins", [24, 7])
def test_histogram_of_a_tensor_equals_jax_of_its_values(tmp_path, bins):
    """A bf16 and an f32 tensor against the JAX logger on the same values
    (numpy float32), at the default and another bin count; an empty one
    writes nothing in either."""
    t = torch.linspace(-2, 3, 301).to(torch.bfloat16)
    f = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (6, 11)).astype(np.float32))
    jlog, tlog = _loggers(tmp_path)
    for name, tensor in (("bf16", t), ("f32", f), ("empty", torch.ones(0))):
        tlog.log_histogram(name, tensor, step=1, bins=bins)
        jlog.log_histogram(name, tensor.float().numpy(), step=1, bins=bins)
    got, want = _hist_records(tlog), _hist_records(jlog)
    _assert_same(got, want)
    assert [k for k, _, _ in got] == ["hist/bf16", "hist/f32"]
    assert all(len(v["bins"]) == bins for _, v, _ in got)


def test_tree_histograms_of_bridged_params_equal_jax(tmp_path):
    """The speaker encoder's JAX parameters against the port's bridged
    tensors, and the generator's seeded tensors against their numpy copy
    in the JAX logger."""
    jse = JSE.init(jax.random.PRNGKey(0), JSECfg())
    tae = TAE.init(torch.Generator().manual_seed(0))
    jlog, tlog = _loggers(tmp_path)
    jlog.log_tree_histograms("se", jse, step=1)
    tlog.log_tree_histograms("se", from_jax_params(jse), step=1)
    jlog.log_tree_histograms("ae", jax.tree_util.tree_map(
        lambda x: x.numpy(), tae), step=2)
    tlog.log_tree_histograms("ae", tae, step=2)
    got, want = _hist_records(tlog), _hist_records(jlog)
    _assert_same(got, want)
    assert len(got) == (len(jax.tree_util.tree_leaves(jse))
                        + len(jax.tree_util.tree_leaves(tae)))


def test_log_figure_writes_the_png_and_closes_the_figure(tmp_path):
    tlog = TLogger(log_dir=str(tmp_path))
    fig = plt.figure()
    tlog.log_figure("fig", fig, step=4)
    assert not plt.fignum_exists(fig.number)
    assert os.path.getsize(os.path.join(os.path.dirname(tlog.jsonl_path),
                                        "fig_4.png")) > 0
    fig = plt.figure()
    tlog.log_figure("nostep", fig, save_dir=str(tmp_path / "figs"))
    assert os.listdir(tmp_path / "figs") == ["nostep.png"]
    # a failed save still closes the figure
    (tmp_path / "file").write_text("")
    fig = plt.figure()
    with pytest.raises(OSError):
        tlog.log_figure("bad", fig, save_dir=str(tmp_path / "file"))
    assert not plt.fignum_exists(fig.number)


def test_plot_conversion_holds_the_jax_figures_matrices():
    rng = np.random.default_rng(2)
    a, b = rng.random((80, 40)), rng.random((80, 40))
    tfig, jfig = TV.plot_conversion(a, b), JV.plot_conversion(a, b)
    try:
        for tax, jax_ax, want in zip(tfig.axes, jfig.axes, (a, b)):
            np.testing.assert_array_equal(tax.images[0].get_array(),
                                          jax_ax.images[0].get_array())
            np.testing.assert_array_equal(tax.images[0].get_array(), want)
            assert tax.get_title() == jax_ax.get_title()
        assert [ax.get_title() for ax in tfig.axes] == ["Original",
                                                        "Reconstructed"]
        assert tuple(tfig.get_size_inches()) == tuple(
            jfig.get_size_inches())
    finally:
        plt.close(tfig)
        plt.close(jfig)


def test_visualise_embedding_three_speakers_four_utterances(tmp_path):
    emb = np.random.default_rng(3).standard_normal((3, 4, 16)).astype(
        np.float32)
    fig = TV.visualise_embedding(emb)
    try:
        ax = fig.axes[0]
        assert [c.get_offsets().shape for c in ax.collections] == [(4, 2)] * 3
        assert [t.get_text() for t in ax.get_legend().get_texts()] == [
            "speaker 0", "speaker 1", "speaker 2"]
    finally:
        TLogger(log_dir=str(tmp_path)).log_figure("tsne", fig)
    assert glob.glob(str(tmp_path / "*" / "tsne.png"))
