"""The per-layer readers of the program's spans and counters
(``h100bench/program_spans.py``): each reads its value from a made-up
record, a program without the recorder reads nothing, and a traced tiny
run reports them over the stretch its profiler covers."""
import pytest

from h100bench import harness
from conftest import REPO

SPAN_READERS = {
    "audio_ms.serve": ("convert_batch/preprocess", "convert_batch/outprocess"),
    "mel_ms.serve": ("convert_batch/mel",),
    "embed_ms.serve": ("convert_batch/target", "convert_batch/embed"),
    "ae_ms.serve": ("convert_batch/autoencoder",),
    "vocoder_ms.serve": ("convert_batch/vocoder",),
    "fwd_bwd_ms.train": ("train/forward", "train/backward"),
    "optim_ms.train": ("train/optimizer", "train/ema")}
NEW_READERS = sorted(SPAN_READERS) + ["k1_useful.convert", "k1_useful.serve"]


def _record(spans_ms=(), counters=None):
    """A record of two calls: span name -> (ms in call 0, ms in call 1)."""
    from autovc_tpu_torch.utils import profiling as P
    rec = P.Record(profiled=True)
    for name, per_call in spans_ms:
        for call, ms in enumerate(per_call):
            rec.spans.append(P.Span(name, None, call, 0, int(ms * 1e6)))
    rec.counters.update(counters or {})
    return rec


def _with_record(monkeypatch, rec):
    from autovc_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "profiled", lambda: rec)


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_span_readers_average_their_spans_over_the_calls(name, monkeypatch):
    names = SPAN_READERS[name]
    spans = [(n, (1.0 + i, 3.0 + i)) for i, n in enumerate(names)]
    spans.append(("vocoder/sample", (100.0, 100.0)))
    reader = harness.metric_reader(REPO / "h100bench", name)
    _with_record(monkeypatch, _record(spans))
    want = sum(2.0 + i for i in range(len(names)))
    assert reader.read(None) == pytest.approx(want)
    # a stretch in which a span did not run, or no stretch, reads nothing
    _with_record(monkeypatch, _record(spans[1:]))
    assert reader.read(None) is None
    _with_record(monkeypatch, None)
    assert reader.read(None) is None


@pytest.mark.parametrize("name", ["k1_useful.serve", "k1_useful.convert"])
def test_k1_useful_is_samples_over_row_steps(name, monkeypatch):
    reader = harness.metric_reader(REPO / "h100bench", name)
    _with_record(monkeypatch, _record(
        counters={"k1.samples": 300, "k1.row_steps": 1200}))
    assert reader.read(None) == pytest.approx(25.0)
    _with_record(monkeypatch, _record())
    assert reader.read(None) is None


@pytest.mark.parametrize("name", NEW_READERS)
def test_a_program_without_the_recorder_reads_nothing(name, monkeypatch):
    from autovc_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "profiled")
    reader = harness.metric_reader(REPO / "h100bench", name)
    assert reader.read(None) is None


CELL_READERS = {
    "t.serve": ["audio_ms.serve", "mel_ms.serve", "embed_ms.serve",
                "ae_ms.serve", "vocoder_ms.serve", "k1_useful.serve"],
    "t.convert": ["k1_useful.convert"],
    "t.train": ["fwd_bwd_ms.train", "optim_ms.train"]}


@pytest.mark.parametrize("cell", sorted(CELL_READERS))
def test_a_traced_run_reports_the_span_metrics(tiny_run, cell):
    from autovc_tpu_torch.utils import profiling
    mix = {"trace_seconds": 0.0} if cell == "t.train" else None
    out = tiny_run(cell, seed=2 ** 31 + 99, tracing=True, mix=mix)
    for name in CELL_READERS[cell]:
        assert out["metrics"][name]["value"] > 0, name
    if cell != "t.train":
        useful = CELL_READERS[cell][-1]
        assert out["metrics"][useful]["value"] < 100
    if cell == "t.serve":
        # the record is the profiler's stretch: the window's calls alone
        rec = profiling.profiled()
        assert len(rec.by_call()) == out["attempted"]


def test_an_untraced_run_reads_no_span_metric(tiny_run):
    out = tiny_run("t.serve")
    assert not set(out["metrics"]) & set(NEW_READERS)
