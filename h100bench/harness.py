"""One run of one cell: set-up, the measured window, the traced reading,
the output check and the result line.

Everything that belongs to a configuration, a traffic mix, a per-layer
metric or a cell is found by its name under the benchmark's folder:
``configs/<config>.json`` (and the plain reference module it names),
``traffic/<mix>.json``, ``metrics/<metric>.py`` (or its family's reader,
``metrics/<family>.py``) and ``limits/<cell>.json``;
``BENCHMARK.json`` beside the folder lists the cells and metrics.  The
program under test is ``autovc_tpu_torch``; this module imports it only
inside the functions that drive it.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from h100bench import costs, trace, traffic, weights

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "autovc_tpu")
MODELS = ("speaker_encoder", "generator", "vocoder")


def forbidden_modules(modules=None) -> list:
    """Top-level names of ``modules`` (default: ``sys.modules``) that the
    benchmark's process may not hold, compared whole (``autovc_tpu_torch``
    is not ``autovc_tpu``)."""
    modules = list(sys.modules) if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def load_module(path: Path):
    """A module of the benchmark's folder, by its file path."""
    name = "h100bench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(root: Path, name: str):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, or
    where there is none, the reader of its family, ``metrics/<the name
    before its first dot>.py`` (``mfu.serve`` -> ``mfu.py``)."""
    path = root / "metrics" / f"{name}.py"
    if not path.exists():
        path = root / "metrics" / f"{name.split('.')[0]}.py"
    return load_module(path)


@dataclass
class Cell:
    name: str
    root: Path
    spec: dict
    workload: dict
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def kind(self) -> str:
        return self.mix["kind"]

    def reference(self):
        return load_module(self.root / "configs" /
                           f"{self.config['reference']}.py")


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def load_cell(name: str, root: Path = ROOT,
              spec_path: Path | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with everything its names
    point to."""
    spec_path = spec_path or root.parent / "BENCHMARK.json"
    with open(spec_path) as f:
        spec = json.load(f)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {spec_path}")
    w = cells[name]
    with open(root / "configs" / f"{w['config']}.json") as f:
        config = json.load(f)
    limits_path = root / "limits" / f"{name}.json"
    with open(limits_path) as f:
        limits = json.load(f)
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if _applies(m, name, reported)]
    return Cell(name, root, spec, w, config,
                traffic.load_mix(root, w["traffic"]), limits, e2e,
                per_layer)


def process_age() -> float:
    """Seconds since this process started (from /proc; the interpreter's
    start counts as set-up)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


STAMPS: list = []


def stamp(name: str) -> None:
    """Marks the end of a set-up phase: the process's age, its user and
    system CPU seconds, its major page faults and the machine's stolen
    seconds (``/proc/stat``), so that a slow set-up shows whether the host
    stalled, read from a cold disk or ran slower."""
    import resource
    r = resource.getrusage(resource.RUSAGE_SELF)
    try:
        with open("/proc/stat") as f:
            steal = int(f.readline().split()[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        steal = float("nan")
    STAMPS.append((name, process_age(), r.ru_utime, r.ru_stime, r.ru_majflt,
                   steal))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# Weights, both sides
# ---------------------------------------------------------------------------


def meta_models(ref, cfg: dict) -> dict:
    with torch.device("meta"):
        return {"speaker_encoder": ref.SpeakerEncoder(cfg["speaker_encoder"]),
                "generator": ref.Generator(cfg["auto_encoder"]),
                "vocoder": ref.WaveRNN(cfg["vocoder"])}


def make_states(ref, cfg: dict, seed: int, device, kinds=MODELS) -> dict:
    """Each model's weights from the seed, on ``device``."""
    metas = meta_models(ref, cfg)
    return {k: weights.make_state(metas[k], weights.stream_seed(seed, k),
                                  device) for k in kinds}


def program_tree(kind: str, state: dict, cfg: dict, names=None):
    """The program's parameter tree of ``kind`` from a reference state; a
    copy of its own.  ``names``: filled with state name -> program leaf."""
    state = {k: v.detach().clone().contiguous() for k, v in state.items()}
    if kind == "speaker_encoder":
        return weights.speaker_encoder_tree(
            state, cfg["speaker_encoder"]["num_layers"], names)
    if kind == "generator":
        return weights.generator_tree(state, names)
    v = cfg["vocoder"]
    return weights.vocoder_tree(state, v["res_blocks"],
                                len(v["upsample_factors"]), names)


def converter_config(cfg: dict):
    from autovc_tpu_torch import ConverterConfig
    groups = ("auto_encoder", "speaker_encoder", "vocoder", "convert")
    return ConverterConfig().with_overrides(
        **{g: cfg[g] for g in groups})


def make_converter(cell: Cell, seed: int, device):
    """The program's converter at the cell's configuration, its weights
    replaced by the seed's."""
    from autovc_tpu_torch import VoiceConverter
    ref = cell.reference()
    vc = VoiceConverter(config=converter_config(cell.config), verbose=False,
                        device=device)
    states = make_states(ref, cell.config, seed, device)
    vc.SE.params = program_tree("speaker_encoder",
                                states["speaker_encoder"], cell.config)
    vc.AE.params = program_tree("generator", states["generator"],
                                cell.config)
    vc.vocoder.params = program_tree("vocoder", states["vocoder"],
                                     cell.config)
    vc._pack_weights("auto_encoder")
    vc._pack_weights("vocoder")
    del states
    return vc


# ---------------------------------------------------------------------------
# What the window drives
# ---------------------------------------------------------------------------


class RowsTap:
    """Keeps what the vocoder is handed and what it serves: each
    utterance's converted mel as it reaches the vocoder
    (``wavernn._prepare_frame_conditioning``) and each block of fold rows
    the sampling loop returns (``wavernn_kernels.generate_rows``), which
    the output check judges."""

    def __init__(self):
        self.launches = []
        self.mels = []

    def mark(self) -> tuple:
        return len(self.launches), len(self.mels)

    def since(self, mark: tuple) -> tuple:
        return self.launches[mark[0]:], self.mels[mark[1]:]

    @contextlib.contextmanager
    def installed(self):
        from autovc_tpu_torch.models import wavernn as WRm
        from autovc_tpu_torch.ops import wavernn_kernels as WK
        rows, cond = WK.generate_rows, WRm._prepare_frame_conditioning

        def tapped_rows(*args, **kwargs):
            out = rows(*args, **kwargs)
            self.launches.append(out)
            return out

        def tapped_cond(params, mel, *args, **kwargs):
            self.mels.append(mel)
            return cond(params, mel, *args, **kwargs)

        WK.generate_rows = tapped_rows
        WRm._prepare_frame_conditioning = tapped_cond
        try:
            yield self
        finally:
            WK.generate_rows = rows
            WRm._prepare_frame_conditioning = cond


@contextlib.contextmanager
def host_ranges(on: bool, ranges):
    """In a traced run, a ``bench/<label>`` profiler range around each
    (module, attribute, label) of the program, for the idle-gap labels."""
    if not on:
        yield
        return
    saved = []
    for mod, attr, label in ranges:
        fn = getattr(mod, attr)

        def wrapped(*a, _fn=fn, _label=label, **k):
            with torch.profiler.record_function(f"bench/{_label}"):
                return _fn(*a, **k)

        saved.append((mod, attr, fn))
        setattr(mod, attr, wrapped)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def serving_ranges():
    from autovc_tpu_torch.audio import Audio
    from autovc_tpu_torch.models import autoencoder as AEm
    from autovc_tpu_torch.models import speaker_encoder as SEm
    from autovc_tpu_torch.models import wavernn as WRm
    from autovc_tpu_torch.ops import melspec as MEL
    from autovc_tpu_torch.ops import wavernn_kernels as WK
    return [(Audio, "preprocess", "audio"),
            (MEL, "mel_spec_auto_encoder_sliced", "mel"),
            (SEm, "embed_utterances", "embed"),
            (AEm, "batch_forward_packed", "generator"),
            (WRm, "_generate_many_program", "vocoder"),
            (WK, "draw_noise", "noise")]


@dataclass
class Window:
    """What a window did: request walls and the audio or steps they
    completed, and everything the output check needs."""
    start: float = 0.0
    end: float = 0.0
    walls: list = field(default_factory=list)
    audio_s: float = 0.0
    steps: int = 0
    items: list = field(default_factory=list)
    useful_flops: float = 0.0
    k1: list = field(default_factory=list)       # (rows, steps) real rows
    stage_s: dict = field(default_factory=dict)
    # (seconds, requests or steps, useful operations) of a traced part of
    # the window, and of the untraced part before it; the first of ``k1``
    # in the traced part
    traced: tuple | None = None
    untraced: tuple | None = None
    k1_traced_from: int = 0

    @property
    def seconds(self) -> float:
        return self.end - self.start


class TraceTail:
    """The profiler over the last ``trace_s`` seconds of a window of
    ``seconds``: reading a whole window's trace of thousands of small
    kernels a second would outlast the run, and the profiler slows the
    host's launches while it records and after it stops, so the part of
    the window before it starts is the one the rates are read over.  Its
    start can take seconds; the window stays open until it has recorded
    ``trace_s`` seconds (its end metrics are not reported in a traced
    run)."""

    def __init__(self, on: bool, seconds: float, trace_s: float):
        self.on, self.seconds = on, seconds
        self.trace_s = min(trace_s, seconds)
        self.prof = None
        self.mark = None

    def before(self, now: float, win: "Window", count: int) -> None:
        """Before each request or step: start the profiler once the
        untraced part is over (``count``: requests or steps so far)."""
        if self.on and self.prof is None and (
                now >= self.seconds - self.trace_s):
            win.untraced = (now, count, win.useful_flops)
            win.k1_traced_from = len(win.k1)
            self.prof = trace.profiler()
            self.mark = (time.perf_counter(), count, win.useful_flops)

    def done(self, now: float) -> bool:
        if now < self.seconds:
            return False
        return not self.on or (self.prof is not None and (
            time.perf_counter() - self.mark[0] >= self.trace_s))

    def stop(self, win: "Window", count: int) -> None:
        """After the window: stop the profiler, note the traced part."""
        if self.prof is not None:
            self.prof.stop()
            win.traced = (win.end - self.mark[0], count - self.mark[1],
                          win.useful_flops - self.mark[2])


def utterance_geometry(cfg: dict, ref, seconds: float) -> dict:
    """The counts an utterance of ``seconds`` needs (from the plain
    reference's slice rules): AE chunks and mel frames, the converted
    samples, the speaker encoder's frames and partials."""
    sp = cfg["auto_encoder"]["spectrogram"]
    ssp = cfg["speaker_encoder"]["spectrogram"]
    n22 = int(round(seconds * sp["sr"]))
    N = sp["partial_utterance_n_frames"]
    starts, stop = ref.partial_slices(n22, sp["sr"], N, sp["mel_window_step"])
    frames = N + (len(starts) - 1) * int(N * 0.5)
    n16 = int(round(seconds * ssp["sr"]))
    M = ssp["partial_utterance_n_frames"]
    s_starts, s_stop = ref.partial_slices(n16, ssp["sr"], M,
                                          ssp["mel_window_step"])
    return {"chunks": len(starts), "mel_frames": stop // sp["hop_length"] + 1,
            "samples": (frames - 1) * cfg["vocoder"]["hop_length"],
            "se_frames": s_stop // int(ssp["sr"] * ssp["mel_window_step"]
                                       / 1000) + 1,
            "se_partials": len(s_starts)}


def conversion_flops(cfg: dict, ref, seconds: float) -> float:
    g = utterance_geometry(cfg, ref, seconds)
    return costs.conversion_flops(cfg, g["mel_frames"], g["chunks"],
                                  g["samples"], g["se_frames"],
                                  g["se_partials"])


def kernel1_rows(tap_launches, real_rows: int) -> list:
    """(real rows, steps) of each sampling launch: padding rows of the
    last launches not counted."""
    out, left = [], real_rows
    for rows in tap_launches:
        n = min(int(rows.shape[0]), max(left, 0))
        out.append((n, int(rows.shape[1])))
        left -= n
    return out


def folds_of(cfg: dict, samples: int, steps: int) -> int:
    """Fold rows of an utterance of ``samples`` output samples at fold rows
    of ``steps`` samples (the fold length and overlap of the published
    batched generation)."""
    hop = cfg["vocoder"]["hop_length"]
    overlap = cfg["vocoder"]["generate"]["overlap"]
    target = steps - 2 * overlap
    T = (samples // hop + 1) * hop
    n = max(0, (T - overlap) // (target + overlap))
    if T - (n * (overlap + target) + overlap) != 0:
        n += 1
    return max(n, 1)


def run_serve(cell: Cell, seed: int, seconds: float, tracing: bool,
              device, tmp_root: str, out: dict, fault=None):
    """``serve_batch``: one ``convert_batch`` call after another."""
    ref = cell.reference()
    cfg = cell.config
    vc = make_converter(cell, seed, device)
    stamp("converter")
    plan = traffic.plan(cell.mix, seed, device, tmp_root)
    out["plan"] = plan
    stamp("inputs")
    tap = RowsTap()
    win = Window()
    geo = {s: utterance_geometry(cfg, ref, s) for s in cell.mix["lengths_s"]}
    call_flops = (sum(conversion_flops(cfg, ref, s)
                      for s in cell.mix["lengths_s"])
                  + costs.embed_flops(cfg, *_target_counts(cfg, ref,
                                                           plan.target_s)))
    real_rows_of = None

    def call(i):
        files = plan.group(i)
        with torch.profiler.record_function("bench/call"):
            res = vc.convert_batch([p for p, _ in files], plan.target,
                                   seed=plan.seed(i))
        return files, res

    with tap.installed(), (fault or contextlib.nullcontext)():
        call(0)                                   # warm-up: the cell's shapes
        sync(device)
        del tap.launches[:], tap.mels[:]
        stamp("warm-up")
        out["setup_s"] = process_age()
        with trace.traced(tracing) as tr, host_ranges(tracing,
                                                      serving_ranges()):
            win.start = time.perf_counter()
            i = 1
            while True:
                t0 = time.perf_counter()
                mark = tap.mark()
                files, res = call(i)
                t1 = time.perf_counter()
                launches, mels = tap.since(mark)
                steps = int(launches[0].shape[1])
                if real_rows_of is None:
                    real_rows_of = sum(folds_of(cfg, geo[s]["samples"], steps)
                                       for _, s in files)
                win.walls.append(t1 - t0)
                win.audio_s += sum(len(a.wav) / a.sr for a in res)
                win.useful_flops += call_flops
                win.k1 += kernel1_rows(launches, real_rows_of)
                win.items.append({"sources": files, "target": plan.target,
                                  "seed": plan.seed(i), "launches": launches,
                                  "mels": mels,
                                  "outputs": [a.wav for a in res],
                                  "batch": True})
                i += 1
                if t1 - win.start >= seconds:
                    break
            win.end = time.perf_counter()
        out["trace"] = tr.prof
    out["attempted"] = len(win.walls)
    out["e2e"] = {"serve_audio_s_per_s": win.audio_s / win.seconds}
    return win


def _target_counts(cfg, ref, seconds):
    g = utterance_geometry(cfg, ref, seconds)
    return g["se_frames"], g["se_partials"]


def run_convert(cell: Cell, seed: int, seconds: float, tracing: bool,
                device, tmp_root: str, out: dict, fault=None):
    """``convert``: one client, one request after another."""
    ref = cell.reference()
    cfg = cell.config
    vc = make_converter(cell, seed, device)
    stamp("converter")
    plan = traffic.plan(cell.mix, seed, device, tmp_root)
    out["plan"] = plan
    stamp("inputs")
    tap = RowsTap()
    win = Window()
    t_frames, t_parts = _target_counts(cfg, ref, plan.target_s)
    flops = {s: conversion_flops(cfg, ref, s) + costs.embed_flops(
        cfg, t_frames, t_parts) for s in cell.mix["lengths_s"]}
    geo = {s: utterance_geometry(cfg, ref, s) for s in cell.mix["lengths_s"]}
    warm = len(cell.mix["lengths_s"])

    def request(i):
        (path, s), = plan.group(i)
        with torch.profiler.record_function("bench/request"):
            a = vc.convert(path, plan.target, cut=True, save_name=False,
                           seed=plan.seed(i))
        return path, s, a

    with tap.installed(), (fault or contextlib.nullcontext)():
        for i in range(warm):                     # one request of each length
            request(i)
        sync(device)
        del tap.launches[:], tap.mels[:]
        stamp("warm-up")
        out["setup_s"] = process_age()
        tail = TraceTail(tracing, seconds,
                         cell.mix.get("trace_seconds", seconds))
        win.start = time.perf_counter()
        i, now = warm, 0.0
        while True:
            tail.before(now, win, len(win.walls))
            if tracing:
                vc.stage_times = {}
            t0 = time.perf_counter()
            mark = tap.mark()
            path, s, a = request(i)
            t1 = time.perf_counter()
            launches, mels = tap.since(mark)
            steps = int(launches[0].shape[1])
            win.walls.append(t1 - t0)
            win.audio_s += len(a.wav) / a.sr
            win.useful_flops += flops[s]
            win.k1 += kernel1_rows(
                launches, folds_of(cfg, geo[s]["samples"], steps))
            if tracing:
                for k, v in vc.stage_times.items():
                    win.stage_s[k] = win.stage_s.get(k, 0.0) + v
            win.items.append({"sources": [(path, s)],
                              "target": plan.target,
                              "seed": plan.seed(i), "launches": launches,
                              "mels": mels,
                              "outputs": [a.wav], "batch": False})
            i += 1
            now = t1 - win.start
            if tail.done(now):
                break
        win.end = time.perf_counter()
        tail.stop(win, len(win.walls))
        vc.stage_times = None
        out["trace"] = tail.prof
    out["attempted"] = len(win.walls)
    walls = sorted(win.walls)
    out["e2e"] = {"convert_p95_s": float(np.percentile(walls, 95))}
    return win


def run_train(cell: Cell, seed: int, seconds: float, tracing: bool,
              device, tmp_root: str, out: dict, fault=None):
    """``train_ae``: the generator's training step, one after another."""
    from autovc_tpu_torch.config import AutoEncoderConfig
    from autovc_tpu_torch.train import loop, schedules
    from autovc_tpu_torch.utils import tree_leaves
    ref = cell.reference()
    cfg, mix = cell.config, cell.mix
    ae_cfg: AutoEncoderConfig = converter_config(cfg).auto_encoder
    state = make_states(ref, cfg, seed, device, ("generator",))["generator"]
    names = {}
    params = program_tree("generator", state, cfg, names)
    del state
    oc = ae_cfg.optimizer
    # one epoch is the whole run: the learning rate stays at its first value
    tx = schedules.make_optimizer(oc, steps_per_epoch=10 ** 9, dim_model=80)
    leaves = tree_leaves(params)
    opt_state = tx.init(leaves)
    from autovc_tpu_torch.utils import tree_clone
    ema = tree_clone(params)
    step = loop.make_ae_step(ae_cfg, tx, ae_cfg.learn.ema_decay,
                             cfg["auto_encoder"]["learn"]["precision"])
    stamp("converter")
    mels, embs = traffic.train_pool(mix, seed, cfg["auto_encoder"]["n_mels"],
                                    cfg["auto_encoder"]["dim_emb"], device)
    stamp("inputs")
    batches = traffic.train_batches(mix, seed, 100000)
    name_of = {id(t): n for n, t in names.items()}
    p0 = {n: t.detach().clone() for n, t in names.items()}
    win = Window()
    record = {"loss": [], "grad_norm": {}, "grad": {}, "change": {},
              "ema_change": {}}
    e0 = {n: t.detach().clone() for n, t in _named(ema, params, names).items()}
    step_flops = costs.train_step_flops(cfg["auto_encoder"], mix["batch"],
                                        mix["frames"])

    def one(k):
        idx = torch.as_tensor(batches[k], device=device)
        nonlocal params, opt_state, ema
        params, opt_state, ema, aux = step(params, opt_state, ema,
                                           mels[idx], embs[idx])
        return aux

    with (fault or contextlib.nullcontext)():
        for k in range(mix["reference_steps"]):
            aux = one(k)
            record["loss"].append(float(aux["loss"]))
            if k == 0:
                b1 = oc.betas[0]
                for i, t in enumerate(tree_leaves(params)):
                    n = name_of.get(id(t))
                    if n is not None:
                        g = opt_state["mu"][i] / (1.0 - b1)
                        record["grad_norm"][n] = float(torch.linalg.norm(g))
                        record["grad"][n] = g.cpu()
        for n, t in names.items():
            record["change"][n] = float(torch.linalg.norm(t - p0[n]))
        for n, t in _named(ema, params, names).items():
            record["ema_change"][n] = float(torch.linalg.norm(t - e0[n]))
        del p0, e0
        sync(device)
        stamp("warm-up")
        out["setup_s"] = process_age()
        k = mix["reference_steps"]
        tail = TraceTail(tracing, seconds, mix.get("trace_seconds", seconds))
        win.start = time.perf_counter()
        now = 0.0
        while True:
            tail.before(now, win, win.steps)
            with torch.profiler.record_function("bench/step"):
                aux = one(k)
                float(aux["loss"])
            k += 1
            win.steps += 1
            win.useful_flops += step_flops
            now = time.perf_counter() - win.start
            if tail.done(now):
                break
        win.end = time.perf_counter()
        tail.stop(win, win.steps)
        out["trace"] = tail.prof
    out["attempted"] = win.steps
    out["e2e"] = {"train_step_s": win.seconds / win.steps}
    win.items = [record]
    return win


def _named(ema, params, names) -> dict:
    """The EMA tree's leaves by state name (the EMA has the parameters'
    structure)."""
    from autovc_tpu_torch.utils import tree_leaves
    pos = {id(t): i for i, t in enumerate(tree_leaves(params))}
    e = tree_leaves(ema)
    return {n: e[pos[id(t)]] for n, t in names.items() if id(t) in pos}


RUNNERS = {"serve_batch": run_serve, "convert": run_convert,
           "train_ae": run_train}


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------


@dataclass
class Reading:
    """What a per-layer reader reads: ``window_s`` and ``useful_flops``
    are the stretch of the window that MFU reads (the whole window, or the
    part before the profiler starts), ``trace.window_s`` the traced stretch
    that the device's busy time and ``k1`` (its sampling launches) are
    read against."""
    kind: str
    config: dict
    mix: dict
    window_s: float
    useful_flops: float
    peaks: costs.Peaks
    trace: trace.Trace
    k1: list
    stage_ms: dict
    train_steps: int


def run(name: str, seed: int, seconds: float, tracing: bool, device="cuda",
        root: Path = ROOT, spec_path: Path | None = None, fault=None,
        device_name: str | None = None, control: bool = False,
        mix: dict | None = None) -> dict:
    """One run of cell ``name``; returns the result line's object.

    For the control and fault readings (``control.py``, the tests):
    ``fault`` is a context manager factory entered around the warm-up and
    the window; ``control`` adds each fp8 control's readings under
    ``"control"`` and its verdict by the rule of ``correct`` under
    ``"control_correct"``; ``mix`` overrides entries of the traffic
    mix."""
    cell = load_cell(name, root, spec_path)
    if mix:
        cell.mix = dict(cell.mix, **mix)
    dev = torch.device(device)
    if dev.type == "cuda":
        device_name = torch.cuda.get_device_name(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    out = {}
    tmp_root = os.environ.get("TMPDIR") or None
    win = RUNNERS[cell.kind](cell, seed, seconds, tracing, dev, tmp_root,
                             out, fault)
    plan = out.pop("plan", None)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    result = {"correct": False, "attempted": out["attempted"], "failed": 0}
    metrics = {}
    for m in cell.end_to_end:
        value = (out["setup_s"] if m["name"] == "setup_s"
                 else out["e2e"].get(m["name"]))
        if value is not None and not tracing:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": device_name or str(dev), "count": 1,
                   "memory_peak_bytes": int(peak)}
    prof = out.pop("trace", None)
    if tracing and prof is not None:
        whole = (win.seconds, win.steps, win.useful_flops)
        t_s, t_steps, _ = win.traced or whole
        u_s, _, u_flops = (win.untraced if win.untraced and win.untraced[1]
                           else win.traced or whole)
        tr = trace.reduce(prof, t_s)
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = t_s
        result["breakdown"] = tr.breakdown()
        reading = Reading(cell.kind, cell.config, cell.mix, u_s, u_flops,
                          costs.peaks(device_name), tr,
                          win.k1[win.k1_traced_from:],
                          {k: 1e3 * v / max(len(win.walls), 1)
                           for k, v in win.stage_s.items()}, t_steps)
        for m in cell.per_layer:
            value = metric_reader(root, m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    del prof
    result["metrics"] = metrics
    result["device"] = device_info
    # the reference runs once the window is closed and the program's state
    # is gone; its time is not set-up and not in the window
    from h100bench import check
    items = win.items
    del win
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    try:
        readings, ctrl, detail = check.judge(cell, seed, items, dev,
                                             control)
    finally:
        if plan is not None:
            plan.close()
    result["correct"] = check.passes(
        {k: v["value"] for k, v in readings.items()}, cell.limits)
    if control:
        # each control judged by the same rule: it has to come out false
        result["control"] = ctrl
        result["control_correct"] = {n: check.passes(c, cell.limits)
                                     for n, c in ctrl.items()}
    result["detail"] = detail
    result["checks"] = readings
    return result
