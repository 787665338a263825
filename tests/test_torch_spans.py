"""The port's span and counter recorder (``autovc_tpu_torch.utils.
profiling``): nesting, call identifiers, pool-worker parents, counters,
critical-path and self-time arithmetic on hand-made stamps, the cost with
recording off, a profiler's stretch; then the spans and counters where the program puts them:
``convert`` (``stage_times`` with no synchronise), ``convert_batch``, the
vocoder's kernel-1 counters and the training step.  The last test runs on
the card only: the span's host clock against the profiler's, and its
device stamps against the kernels' (run it there with ``python -m pytest
--noconftest -p no:cacheprovider -m cuda tests/test_torch_spans.py``)."""
import json
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from autovc_tpu_torch import Audio, ConverterConfig, VoiceConverter
from autovc_tpu_torch.audio import io as TIO
from autovc_tpu_torch.config import AutoEncoderConfig
from autovc_tpu_torch.models import autoencoder as TAE
from autovc_tpu_torch.models import wavernn as TWR
from autovc_tpu_torch.ops import wavernn_kernels as TWK
from autovc_tpu_torch.train import loop as TL
from autovc_tpu_torch.train import schedules as TS
from autovc_tpu_torch.utils import profiling as P
from autovc_tpu_torch.utils import tree_clone, tree_leaves

SR = 22050
VOC = dict(rnn_dims=32, fc_dims=32, compute_dims=16, res_out_dims=16,
           res_blocks=1, upsample_factors=(2, 2), hop_length=4,
           generate={"target": 16, "overlap": 8, "auto_target": False})
CFG = ConverterConfig().with_overrides(
    vocoder=VOC, auto_encoder={
        "dim_neck": 4, "dim_emb": 16, "dim_pre": 16,
        "spectrogram": {"partial_utterance_n_frames": 32}},
    speaker_encoder={"hidden_size": 16, "embedding_size": 16,
                     "num_layers": 1})


def _wav(seconds, f0):
    t = np.arange(int(seconds * SR)) / SR
    return (0.3 * np.sin(2 * np.pi * f0 * t)).astype(np.float32)


@pytest.fixture(scope="module")
def vc():
    return VoiceConverter(config=CFG, device="cpu", verbose=False)


# -- the recorder -------------------------------------------------------------

def test_nesting_calls_and_pool_parents():
    with P.recording() as rec:
        with P.call() as c0:
            with P.span("a") as a:
                with P.span("a/b") as b:
                    pass

                def worker(i):
                    with P.span("a/w", parent=a) as w:
                        with P.span("a/w/x"):
                            pass
                    return w

                with ThreadPoolExecutor(3) as ex:
                    ws = list(ex.map(worker, range(3)))
        with P.call() as c1:
            with P.span("a") as a1, P.call() as inner:
                pass
        with P.span("outside") as out:
            pass
    assert c0 != c1 and inner == c1
    assert b.parent is a and a.parent is None and a1.parent is None
    assert all(w.parent is a and w.call == c0 for w in ws)
    xs = [s for s in rec.spans if s.name == "a/w/x"]
    assert len(xs) == 3 and {x.parent for x in xs} == set(ws)
    assert all(x.call == c0 for x in xs)
    assert a1.call == c1 and out.call is None
    assert list(rec.by_call()) == [c0, c1]
    assert [s.name for s in rec.by_call()[c1]] == ["a"]
    assert rec.per_call_ms()["a/w"][1] == 0.0
    # a span on a thread of its own with no parent is a root
    def lone():
        with P.span("lone") as s:
            return s
    t = ThreadPoolExecutor(1)
    with P.recording():
        s = t.submit(lone).result()
    t.shutdown()
    assert s.parent is None and s.call is None


def test_counters_sum_and_recording_nests():
    with P.recording() as rec:
        P.count("k", 3)
        P.count("k", 4)
        with P.recording() as inner:
            P.count("j", 2.5)
        assert inner is rec and P._active() is rec
    P.count("k", 100)
    assert rec.counters == {"k": 7, "j": 2.5}
    assert P._active() is None


def test_counters_and_spans_from_many_threads():
    """More workers than cores, a short switch interval: no count or span
    is lost."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with P.recording() as rec:
            def work(i):
                for _ in range(200):
                    P.count("n", 1)
                    with P.span("s"):
                        pass
            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(4 * (os.cpu_count() or 1))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert rec.counters["n"] == 200 * len(threads)
    assert len(rec.spans) == 200 * len(threads)
    assert all(s.t1 is not None for s in rec.spans)


def _made(name, host, device=None, parent=None, call=0):
    s = P.Span(name, parent, call, host[0], host[1])
    if device is not None:
        s.d0, s.d1 = device
    return s


@pytest.mark.parametrize("host,device,interval", [
    ((0, 100), None, (0, 100)),                   # CPU: the host wall
    ((0, 100), (40, 250), (40, 250)),             # the device runs later
    ((30, 100), (10, 60), (30, 100)),             # the host is later
    ((0, 100), (20, 80), (20, 100)),              # device inside the host
])
def test_critical_path_interval(host, device, interval):
    rec = P.Record()
    s = _made("a", host, device)
    rec.spans.append(s)
    assert rec.interval(s) == interval
    assert rec.critical_s(s) == pytest.approx(
        (interval[1] - interval[0]) / 1e9)


def test_self_time_takes_out_the_childrens_union():
    rec = P.Record()
    a = _made("a", (0, 1000), (100, 1200))         # critical [100, 1200]
    kids = [_made("b", (50, 300), parent=a),        # [50, 300] -> [100, 300]
            _made("c", (200, 500), parent=a),       # overlaps b
            _made("d", (900, 1000), (950, 1500), parent=a)]   # [950, 1500]
    rec.spans += [a] + kids
    # covered: [100, 500] and [950, 1200] = 400 + 250
    assert rec.self_s(a) == pytest.approx((1100 - 650) / 1e9)
    assert rec.self_s(kids[1]) == rec.critical_s(kids[1])


def test_consecutive_spans_tile_the_chain():
    """Stages of one chain with device events: each one's interval starts
    where the previous one's ends, so they sum to the chain's wall."""
    rec = P.Record()
    stages = [_made("s0", (0, 10), (5, 300)),      # the device lags
              _made("s1", (11, 20), (300, 400)),   # waits behind s0's work
              _made("s2", (21, 600), (400, 410))]  # host work after it
    rec.spans += stages
    ivs = [rec.interval(s) for s in stages]
    assert [iv[0] for iv in ivs[1:]] == [iv[1] for iv in ivs[:-1]]
    assert sum(rec.critical_s(s) for s in stages) == pytest.approx(
        (600 - 5) / 1e9)
    assert rec.seconds(0) == pytest.approx(
        {"s0": 295e-9, "s1": 100e-9, "s2": 200e-9})


def test_recording_off_records_nothing_and_opens_no_range(monkeypatch):
    opened = []

    class Counted:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counted)
    assert P._active() is None
    before = P.profiled()
    with P.call() as c, P.span("x") as s:
        P.count("k", 1)
    assert c is None and s is None and opened == []
    assert P.profiled() is before and P._RECORD is None


def test_a_profiler_records_its_stretch(monkeypatch):
    """Under a profiler a span opens its range and lands in the
    stretch's record, ``profiled()``; the stretch ends with the profiler,
    and the next profiler's stretch has a record of its own."""
    opened = []
    rf = torch.profiler.record_function

    def counted(name):
        opened.append(name)
        return rf(name)
    monkeypatch.setattr(torch.profiler, "record_function", counted)
    acts = [torch.profiler.ProfilerActivity.CPU]
    records = []
    for k in range(2):
        with torch.profiler.profile(activities=acts):
            with P.call() as c, P.span(f"y{k}") as y:
                P.count("k", k + 1)
                with P.recording() as inner:
                    pass
            records.append(P.profiled())
            assert inner is records[-1] and y.call == c
        with P.span("after") as s:          # the profiler stopped
            P.count("k", 100)
        assert s is None and P._active() is None
    a, b = records
    assert a is not b and a.profiled and P.profiled() is b
    assert [s.name for s in a.spans] == ["y0"] and a.counters == {"k": 1}
    assert [s.name for s in b.spans] == ["y1"] and b.counters == {"k": 2}
    assert opened == ["y0", "y1"]
    assert list(b.per_call_ms()) == ["y1"]


def test_trace_records_and_writes_the_spans(tmp_path):
    with P.trace(str(tmp_path)):
        with P.call(), P.span("convert/mel"):
            torch.ones(8).sum()
        rec = P.profiled()
    assert P._active() is None
    assert [s.name for s in rec.spans] == ["convert/mel"]
    (f,) = os.listdir(tmp_path)
    with open(tmp_path / f) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert "convert/mel" in names


# -- where the program records ------------------------------------------------

STAGES = {"preprocess", "embed_source", "embed_target", "mel", "autoencoder",
          "vocoder", "download", "outprocess"}


def test_convert_stage_times_without_a_synchronise(vc, monkeypatch):
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: syncs.append(a))
    vc.stage_times = {}
    try:
        t0 = time.perf_counter()
        vc.convert(Audio(_wav(0.5, 150.0), sr_org=SR),
                   Audio(_wav(0.4, 220.0), sr_org=SR), save_name=False)
        wall = time.perf_counter() - t0
        times = vc.stage_times
    finally:
        vc.stage_times = None
    assert set(times) == STAGES
    assert all(t >= 0.0 for t in times.values())
    assert sum(times.values()) <= wall
    assert syncs == []
    assert P._active() is None


def test_convert_batch_records_its_spans(vc, tmp_path):
    sources = []
    for k, sec in enumerate((0.5, 0.35, 0.6)):
        p = str(tmp_path / f"src{k}.wav")
        TIO.save_wav(p, _wav(sec, 120.0 + 30 * k), SR)
        sources.append(p)
    target = str(tmp_path / "trg.wav")
    TIO.save_wav(target, _wav(0.4, 210.0), SR)
    with P.recording() as rec:
        outs = vc.convert_batch(sources, target, outprocess=())
    (spans,) = rec.by_call().values()
    top = [s.name for s in spans if s.parent is None]
    assert top == ["convert_batch/" + n for n in (
        "target", "preprocess", "mel", "embed", "autoencoder", "vocoder",
        "outprocess")]
    by = {s.name: s for s in spans if s.parent is None}
    loads = [s for s in spans if s.name == "convert_batch/load"]
    assert len(loads) == 3
    assert all(s.parent is by["convert_batch/preprocess"] for s in loads)
    voc = [s for s in spans if s.name.startswith("vocoder/")]
    assert [s.name for s in voc] == ["vocoder/condition", "vocoder/sample",
                                     "vocoder/finish"]
    assert all(s.parent is by["convert_batch/vocoder"] for s in voc)
    assert rec.counters["k1.samples"] == sum(len(a.wav) for a in outs)


class _RowsTap:
    def __init__(self, monkeypatch):
        self.shapes = []
        rows = TWK.generate_rows

        def tapped(*a, **k):
            out = rows(*a, **k)
            self.shapes.append(tuple(out.shape))
            return out
        monkeypatch.setattr(TWK, "generate_rows", tapped)


@pytest.mark.parametrize("many", [False, True])
def test_kernel1_counters_match_the_launches(vc, monkeypatch, many):
    tap = _RowsTap(monkeypatch)
    cfg = vc.vocoder.config
    gen = torch.Generator().manual_seed(3)
    mels = [torch.rand(1, cfg.feat_dims, f) for f in (23, 41)]
    with P.recording() as rec:
        if many:
            outs = TWR.generate_many(vc.vocoder.params, mels, cfg, gen,
                                     fast_math=False, slab_rows=8,
                                     device="cpu")
        else:
            outs = [TWR.generate(vc.vocoder.params, mels[1], cfg, gen,
                                 fast_math=False, device="cpu")]
    assert rec.counters["k1.samples"] == sum(len(w) for w in outs)
    assert rec.counters["k1.row_steps"] == sum(r * s for r, s in tap.shapes)
    assert len(tap.shapes) == (2 if many else 1)
    assert 0 < rec.counters["k1.samples"] < rec.counters["k1.row_steps"]
    names = [s.name for s in rec.spans]
    assert names.count("vocoder/sample") == len(tap.shapes)
    assert names.count("vocoder/condition") == 1


def _k1_split_reader():
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "h100bench", "metrics", "k1_split.py")
    spec = importlib.util.spec_from_file_location("k1_split_reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("counters,want", [
    ({"k1.row_steps": 1200, TWK.SPLIT_ROW_STEPS: 1200}, 100.0),
    ({"k1.row_steps": 1200, TWK.SPLIT_ROW_STEPS: 300}, 25.0),
    ({"k1.row_steps": 1200}, 0.0),
    ({}, None)])
def test_k1_split_reads_the_split_share(monkeypatch, counters, want):
    """The benchmark's ``k1_split`` reader: 100 x the split pick's row
    steps over all of kernel 1's, nothing without a sampling pass, and
    nothing from a program that has no split pick."""
    from h100bench import program_spans
    reader = _k1_split_reader()
    monkeypatch.setattr(program_spans, "counters", lambda: dict(counters))
    got = reader.read(None)
    assert got == (None if want is None else pytest.approx(want))
    monkeypatch.delattr(TWK, "SPLIT_ROW_STEPS")
    assert reader.read(None) is None


def _ae_state():
    cfg = AutoEncoderConfig().with_overrides(dim_neck=4, dim_emb=16,
                                             dim_pre=16)
    params = TAE.init(torch.Generator().manual_seed(0), cfg)
    tx = TS.make_optimizer(cfg.optimizer, 10)
    return cfg, tx, params, tx.init(tree_leaves(params)), tree_clone(params)


def test_training_step_spans_and_identical_state():
    g = torch.Generator().manual_seed(1)
    x = torch.rand(2, 80, 64, generator=g)
    c = torch.rand(2, 16, generator=g)
    trees = []
    for on in (False, True):
        cfg, tx, params, opt, ema = _ae_state()
        step = TL.make_ae_step(cfg, tx, 0.99, "f32")
        with (P.recording() if on else P._NULL) as rec:
            params, opt, ema, _ = step(params, opt, ema, x, c)
        trees.append(tree_leaves(params) + opt["mu"] + opt["nu"]
                     + tree_leaves(ema))
    (spans,) = rec.by_call().values()
    assert sorted(s.name for s in spans) == [
        "train/backward", "train/ema", "train/forward", "train/optimizer"]
    assert all(s.parent is None for s in spans)
    for a, b in zip(*trees):
        assert torch.equal(a, b)


# -- on the card ---------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("mode,split", [("RAW", True), ("MOL", False)])
def test_split_row_steps_counted_on_the_card(mode, split):
    """A launch on the split pick (RAW with 9 bits, rnn_dims = fc_dims =
    512) counts its rows x steps under ``k1.split_row_steps``, as many as
    ``k1.row_steps``; MOL's launch counts none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    from autovc_tpu_torch.config import WaveRNNConfig
    from autovc_tpu_torch.utils.bridge import from_jax_params
    dev = torch.device("cuda")
    cfg = WaveRNNConfig().with_overrides(mode=mode, bits=9)
    gen = torch.Generator().manual_seed(0)
    params = from_jax_params(TWR.init(gen, cfg), dev)
    J = TWR._upsample_margin(params["upsample"]["up_convs"],
                             cfg.upsample_factors)
    mel = torch.rand(32, 2 + 2 * J, cfg.feat_dims, generator=gen).to(dev)
    aux = torch.randn(32, 2, cfg.res_out_dims, generator=gen).to(dev)
    with P.recording() as rec:
        out = TWR._sample(params, mel, aux, cfg, True, None, None)
    torch.cuda.synchronize()
    assert rec.counters["k1.row_steps"] == out.numel() == 32 * 2 * 275
    assert rec.counters.get(TWK.SPLIT_ROW_STEPS, 0) == (
        out.numel() if split else 0)


@pytest.mark.cuda
def test_one_clock_on_the_card():
    """Over 100 spans: a span's host entry against its profiler range's
    start, and its device exit against the host's clock (the stamps before
    the last poll of its event that found it pending and after the one
    that found it done), each within 5 us / 20 us at the 95th percentile
    (a stamp or a poll that the scheduler delays reads later).  The device
    exit against the profiler's end of the one kernel it launched is only
    printed: on an H100 (torch 2.11) the profiler's own device timestamps
    sit from -9 us to hundreds of us off, drifting within one profile."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x = torch.randn(8192, 8192, device="cuda")     # ~0.2 ms a pass
    torch.sin(x)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    seen = []
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(10):             # the first ranges' own set-up
            with torch.profiler.record_function("warm"):
                torch.sin(x)
        with P.recording() as rec:
            for i in range(100):
                with P.span(f"probe/{i}") as s:
                    torch.sin(x)
                pending = time.time_ns()
                while True:
                    now = time.time_ns()
                    if s.events[1].query():
                        break
                    pending = now
                seen.append((pending, time.time_ns()))
        torch.cuda.synchronize()
    start = prof.profiler.kineto_results.trace_start_ns()
    ranges, kernels = {}, []
    for e in prof.events():
        lo = start + 1e3 * e.time_range.start
        hi = start + 1e3 * e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                kernels.append((lo, hi))
        elif e.name.startswith("probe/"):
            ranges[e.name] = lo
    kernels = sorted(kernels)[-100:]            # the probes' kernels
    assert len(rec.spans) == len(kernels) == 100
    host, dev, mid, prof_dev = [], [], [], []
    for s, (_, end), (lo, hi) in zip(rec.spans, kernels, seen):
        rec.interval(s)
        host.append(ranges[s.name] - s.t0)
        dev.append(max(lo - s.d1, s.d1 - hi, 0.0))
        mid.append(s.d1 - 0.5 * (lo + hi))
        prof_dev.append(s.d1 - end)
    q = [0, 5, 50, 95, 100]
    print("one clock, us at percentiles", q, "; range start - host entry",
          np.percentile(host, q) / 1e3, "; device exit - the polls' middle",
          np.percentile(mid, q) / 1e3, "; outside the polls",
          np.percentile(dev, q) / 1e3, "; device exit - profiler's kernel "
          "end", np.percentile(prof_dev, q) / 1e3, "; torch",
          torch.__version__)
    assert np.percentile(np.abs(host), 95) <= 5e3
    assert np.percentile(dev, 95) <= 20e3
