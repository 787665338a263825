"""The harness on the CPU at tiny sizes: the traffic generator, the metric
arithmetic, discovery by name, the plain reference against the program's
CPU path, and each fault seen by the output check."""
import json
import os
import sys

import numpy as np
import pytest
import torch

from h100bench import costs, faults, harness, trace, traffic
from conftest import REPO


# -- traffic ---------------------------------------------------------------

def serve_mix():
    return json.loads((REPO / "h100bench/traffic/serve-mixed16.json")
                      .read_text())


def test_serve_lengths_are_the_stratified_set():
    mix = serve_mix()
    assert mix["lengths_s"] == [round(2.0 + 1.2 * k, 1) for k in range(16)]
    assert sum(mix["lengths_s"]) == pytest.approx(176.0)


def small(mix, **kw):
    return dict(mix, **kw)


def test_each_call_is_the_whole_set_in_its_own_order(tmp_path):
    mix = small(serve_mix(), lengths_s=[0.2, 0.3, 0.4], target_s=0.2,
                pool_calls=4)
    plan = traffic.plan(mix, 5, "cpu", str(tmp_path))
    try:
        orders = [[s for _, s in g] for g in plan.groups]
        assert all(sorted(o) == [0.2, 0.3, 0.4] for o in orders)
        assert len({tuple(o) for o in orders}) > 1
        paths = [p for g in plan.groups for p, _ in g] + [plan.target]
        assert len(set(paths)) == len(paths)          # a fresh file each
        assert len(set(plan.seeds)) == len(plan.seeds)
    finally:
        plan.close()
    assert not os.path.exists(plan.tmp)


def test_convert_pool_takes_every_length_equally_often(tmp_path):
    mix = {"kind": "convert", "file_sr": 16000, "lengths_s": [0.2, 0.3],
           "target_s": 0.2, "pool_requests": 6}
    plan = traffic.plan(mix, 9, "cpu", str(tmp_path))
    try:
        lengths = [g[0][1] for g in plan.groups]
        assert lengths[:2] == [0.2, 0.3]              # the warm-up's
        assert sorted(lengths[2:]) == [0.2] * 3 + [0.3] * 3
    finally:
        plan.close()


def test_content_is_the_seeds(tmp_path):
    def content(seed):
        return [np.asarray(w) for w in traffic.synth_speech(
            [0.1, 0.2], 16000, seed, "cpu")]
    a, b, c = content(3), content(3), content(4)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert [len(x) for x in a] == [1600, 3200]


def test_train_batches_hold_distinct_rows():
    mix = {"pool_rows": 12, "batch": 4, "reference_steps": 3}
    batches = traffic.train_batches(mix, 1, 3)
    rows = np.concatenate(batches)
    assert len(set(rows.tolist())) == 12


# -- metric arithmetic ------------------------------------------------------

def test_idle_share_is_one_minus_the_union():
    spans = [(0, 10), (5, 15), (20, 30), (29, 31)]
    busy = trace.union(spans)
    assert busy == [[0, 15], [20, 31]]
    gaps = trace.idle_gaps(busy, 0, 40)
    assert gaps == [(15, 20), (31, 40)]
    labels = trace.label_gaps(gaps, [("bench/call", 0, 40),
                                     ("convert/vocoder", 30, 40)])
    assert labels == {"(gaps under 20 us)": pytest.approx(14e-6)}
    tr = trace.Trace(window_s=40e-6, busy_s=26e-6)
    idle = harness.metric_reader(REPO / "h100bench", "idle.serve")
    r = harness.Reading("serve_batch", {}, {}, 40e-6, 1.0,
                        costs.peaks("H100 SXM"), tr, [], {}, 0)
    assert idle.read(r) == pytest.approx(35.0)


def test_long_gaps_take_the_innermost_range():
    labels = trace.label_gaps([(100, 200), (300, 400)],
                              [("bench/call", 0, 1000),
                               ("convert/vocoder", 50, 250)])
    assert labels == pytest.approx({"convert/vocoder": 1e-4, "bench/call": 1e-4})


def test_mfu_and_roofline_readers():
    p = costs.peaks("H100 SXM")
    voc = json.loads((REPO / "h100bench/configs/autovc-mol.json")
                     .read_text())["vocoder"]
    k1 = [(64, 6600), (10, 6600)]
    tr = trace.Trace(window_s=2.0, busy_s=1.5,
                     ops={"void avc::wr_kernel<bf16>": 1.0, "other": 0.5})
    r = harness.Reading("serve_batch", {"vocoder": voc}, {}, 2.0, 989e12,
                        p, tr, k1, {}, 0)
    mfu = harness.metric_reader(REPO / "h100bench", "mfu.serve")
    assert mfu.read(r) == pytest.approx(50.0)
    k1r = harness.metric_reader(REPO / "h100bench", "k1_roofline.serve")
    flops = 74 * 6600 * costs.wavernn_sample_flops(voc)
    assert k1r.read(r) == pytest.approx(100.0 * flops / 989e12, rel=1e-6)
    assert 0 < k1r.read(r) < 100
    r.k1 = []
    assert k1r.read(r) is None


def test_p95_counts_every_request(tiny_run):
    out = tiny_run("t.convert")
    assert out["attempted"] >= 1
    assert set(out["metrics"]) == {"convert_p95_s", "setup_s"}


def test_serve_window_closes_at_the_first_call_past_the_seconds(tiny_run):
    out = tiny_run("t.serve")
    # a 0.05 s window closes at the end of its first call
    assert out["attempted"] == 1
    assert out["metrics"]["serve_audio_s_per_s"]["value"] > 0


# -- discovery ----------------------------------------------------------------

def test_new_files_are_found_by_name(tiny):
    root, spec_path = tiny
    (root / "metrics" / "calls.serve.py").write_text(
        "def read(r):\n    return r.window_s\n")
    spec = json.loads(spec_path.read_text())
    spec["per_layer"].append({"name": "calls.serve", "unit": "s",
                              "better": "lower", "source": "host_clock",
                              "layer": "orchestration",
                              "moves": "serve_audio_s_per_s",
                              "workloads": ["t.serve"]})
    new_spec = spec_path.with_name("BENCHMARK.discovery.json")
    new_spec.write_text(json.dumps(spec))
    cell = harness.load_cell("t.serve", root, new_spec)
    assert cell.config["vocoder"]["rnn_dims"] == 16          # tiny.json
    assert cell.mix["lengths_s"] == [0.6, 1.1]                # tiny-serve
    assert "calls.serve" in {m["name"] for m in cell.per_layer}
    out = harness.run("t.serve", 23, 0.05, True, device="cpu", root=root,
                      spec_path=new_spec,
                      device_name="NVIDIA H100 80GB HBM3")
    assert out["metrics"]["calls.serve"]["value"] > 0
    assert list(out)[-1] == "checks"


# -- the reference against the program, and the faults ------------------------

@pytest.mark.parametrize("cell", ["t.serve", "t.convert", "t.rawconvert",
                                  "t.train"])
def test_reference_agrees_with_the_program_on_the_cpu(tiny_run, cell):
    out = tiny_run(cell)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["t.serve", "t.convert", "t.rawconvert",
                                  "t.train"])
def test_each_control_makes_correct_false(tiny_run, cell):
    """The reference one precision below, in the program's place and judged
    by the rule of ``correct``, comes out not correct: for a conversion the
    whole chain and the vocoder alone, each with the noise as served."""
    out = tiny_run(cell, control=True)
    assert out["correct"], out["checks"]
    want = {"fp8"} if cell == "t.train" else {"fp8", "fp8_vocoder"}
    assert set(out["control_correct"]) == want
    assert not any(out["control_correct"].values()), out["control"]


def test_a_metric_family_shares_one_reader(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "calls.py").write_text(
        "def read(r):\n    return 1.0\n")
    (tmp_path / "metrics" / "calls.serve.py").write_text(
        "def read(r):\n    return 2.0\n")
    assert harness.metric_reader(tmp_path, "calls.train").read(None) == 1.0
    assert harness.metric_reader(tmp_path, "calls.serve").read(None) == 2.0


@pytest.mark.parametrize("cell,fault", [
    ("t.serve", "token_altered"), ("t.serve", "half_batch"),
    ("t.convert", "token_altered"), ("t.convert", "half_batch"),
    ("t.serve", "answer_altered"), ("t.convert", "answer_altered"),
    ("t.train", "token_altered"), ("t.train", "half_batch"),
    ("t.train", "state_unchanged")])
def test_each_fault_makes_correct_false(tiny_run, cell, fault):
    kind = "train_ae" if cell == "t.train" else "serve_batch"
    out = tiny_run(cell, fault=faults.for_kind(kind)[fault])
    assert not out["correct"], out["checks"]


def test_run_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    sys.path.insert(0, str(REPO / "h100bench"))
    import run
    assert run.main(["--workload", "mol.serve-mixed16", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_tiny_serve_on_the_card(tiny):
    """On the card: the tiny cell at f32 runs kernel 1 and agrees."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = harness.run("t.serve", 29, 0.05, False, device="cuda",
                      root=tiny[0], spec_path=tiny[1])
    assert out["correct"], out["checks"]


def test_traced_training_profiles_the_last_part_of_the_window(tiny_run):
    out = tiny_run("t.train", mix={"trace_seconds": 0.0}, tracing=True)
    # the profiler starts once the window's seconds are up and takes one
    # step; MFU reads the untraced steps before it
    assert 0 < out["device"]["window_s"]
    assert out["attempted"] >= 2
    assert out["metrics"]["mfu.train"]["value"] > 0
    assert list(out)[-1] == "checks"
