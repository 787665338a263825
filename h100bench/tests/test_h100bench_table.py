"""The seam between the harness and a configuration's models: what is
particular to them is asked of the configuration's reference module
(``harness.REFERENCE_TABLE``).  The table of ``configs/autovc_ref.py``
gives the counts, trees and program configuration of the code it
replaced; a configuration whose vocoder is not WaveRNN is found by name
and reached through its own module, with WaveRNN's tree and counts never
called; a module that lacks a name of the table fails at ``load_cell``;
and the harness, the check and the faults name no part of WaveRNN."""
import ast
import json
import sys
import types

import pytest
import torch

from h100bench import check, costs, faults, harness, trace, weights
from conftest import REPO, build_tiny

BENCH = REPO / "h100bench"
CONFIGS = ["autovc-mol", "autovc-raw9", "tiny", "tiny-raw"]


def config(tiny, name):
    root = BENCH if name.startswith("autovc") else tiny[0]
    return json.loads((root / f"configs/{name}.json").read_text())


def mix_lengths():
    lengths = set()
    for mix in ("serve-mixed16", "convert-3to11s"):
        lengths |= set(json.loads((BENCH / f"traffic/{mix}.json")
                                  .read_text())["lengths_s"])
    return sorted(lengths)


def reference():
    return harness.load_reference(BENCH, {"reference": "autovc_ref"})


# -- the formulas the table replaced -----------------------------------------

def parent_conversion_flops(cfg, mel_frames, chunks, samples_out, se_frames,
                            se_partials):
    """``costs.conversion_flops`` as it was, WaveRNN's counts built in."""
    ae, voc = cfg["auto_encoder"], cfg["vocoder"]
    sp = ae["spectrogram"]
    frames_out = samples_out // voc["hop_length"] + 1
    return (costs.mel_flops(mel_frames, sp["n_fft"], sp["n_mels"])
            + costs.embed_flops(cfg, se_frames, se_partials)
            + costs.generator_flops(ae, chunks,
                                    sp["partial_utterance_n_frames"])
            + samples_out * costs.wavernn_sample_flops(voc)
            + frames_out * costs.wavernn_frame_flops(voc))


def parent_k1_roofline(r):
    """The ``k1_roofline`` reader as it was."""
    seconds = r.trace.kernel_s("wr_kernel")
    voc = r.config["vocoder"]
    flops = sum(rows * steps for rows, steps in r.k1) * \
        costs.wavernn_sample_flops(voc)
    nbytes = sum(costs.kernel1_bytes(voc, rows, steps) for rows, steps in r.k1
                 if rows)
    return 100.0 * costs.roofline_seconds(flops, nbytes, r.peaks) / seconds


def parent_converter_config(cfg):
    """``harness.converter_config`` as it was."""
    from autovc_tpu_torch import ConverterConfig
    groups = ("auto_encoder", "speaker_encoder", "vocoder", "convert")
    return ConverterConfig().with_overrides(**{g: cfg[g] for g in groups})


def parent_tree(kind, state, cfg, names):
    """``harness.program_tree`` as it was."""
    state = {k: v.detach().clone().contiguous() for k, v in state.items()}
    if kind == "speaker_encoder":
        return weights.speaker_encoder_tree(
            state, cfg["speaker_encoder"]["num_layers"], names)
    if kind == "generator":
        return weights.generator_tree(state, names)
    v = cfg["vocoder"]
    return weights.vocoder_tree(state, v["res_blocks"],
                                len(v["upsample_factors"]), names)


def leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in leaves(t, f"{path}/{i}")]
    return [(path, tree)]


@pytest.mark.parametrize("part", ["conversion_flops", "k1_roofline",
                                  "converter_config", "program_tree"])
@pytest.mark.parametrize("name", CONFIGS)
def test_the_table_gives_the_parent_counts_and_trees(tiny, name, part):
    cfg, ref = config(tiny, name), reference()
    if part == "conversion_flops":
        for s in mix_lengths():
            g = harness.utterance_geometry(cfg, ref, s)
            want = parent_conversion_flops(
                cfg, g["mel_frames"], g["chunks"], g["samples"],
                g["se_frames"], g["se_partials"])
            assert harness.conversion_flops(cfg, ref, s) == want, s
    elif part == "k1_roofline":
        reader = harness.metric_reader(BENCH, "k1_roofline.convert")
        tr = trace.Trace(window_s=2.0, busy_s=1.5,
                         ops={"void avc::wr_kernel<bf16>": 0.37})
        for k1 in ([(64, 2475)], [(64, 12100), (64, 12100), (13, 12100)],
                   [(32, 2475), (7, 2475), (0, 2475)], [(1, 1375)]):
            r = harness.Reading("convert", cfg, {}, 2.0, 1.0,
                                costs.peaks("NVIDIA H100 80GB HBM3"), tr, k1,
                                {}, 0)
            assert reader.read(r) == parent_k1_roofline(r), k1
    elif part == "converter_config":
        assert harness.converter_config(cfg) == parent_converter_config(cfg)
    else:
        states = harness.make_states(ref, cfg, 11, "cpu")
        for kind, state in states.items():
            got_names, want_names = {}, {}
            got = leaves(harness.program_tree(ref, kind, state, cfg,
                                              got_names))
            want = leaves(parent_tree(kind, state, cfg, want_names))
            assert [p for p, _ in got] == [p for p, _ in want], kind
            for (p, a), (_, b) in zip(got, want):
                assert a.shape == b.shape and torch.equal(a, b), (kind, p)
            assert list(got_names) == list(want_names), kind
            for n in got_names:
                assert torch.equal(got_names[n], want_names[n]), (kind, n)


# -- a configuration with another vocoder -------------------------------------

STUB_REF = '''"""A stand-in configuration whose vocoder is not WaveRNN: a
causal convolution stack over a once-upsampled mel, with counts, a tree and
program points of its own; the rest is the AutoVC reference's."""
import importlib.util
from pathlib import Path

import torch
import torch.nn as nn

_spec = importlib.util.spec_from_file_location(
    "stub_base", Path(__file__).with_name("autovc_ref.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
for _n in ("exact_f32", "round_to", "load_wav", "normalize_volume",
           "partial_slices", "embed", "generator_mel", "fold", "finish",
           "draw_noise"):
    globals()[_n] = getattr(_base, _n)


class ConvVocoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.hop = c["hop_length"]
        self.inp = nn.Conv1d(1 + c["n_mels"], c["channels"], 2)
        self.out = nn.Conv1d(c["channels"], c["classes"], 1)

    def forward(self, x_prev, mels):
        x = torch.cat([x_prev[:, None], mels.transpose(1, 2)], 1)
        h = torch.relu(self.inp(nn.functional.pad(x, (1, 0))))
        return self.out(h).transpose(1, 2)


MODELS = dict(_base.MODELS, vocoder=(ConvVocoder, "vocoder"))
POINTS = {"rows": ("stub_program", "rows"), "mel": ("stub_program", "mel"),
          "pick": ("stub_program", "pick"), "pcm": ("stub_program", "pcm"),
          "vocoder": ("stub_program", "vocoder"),
          "noise": ("stub_program", "noise")}


def build(kind, c, precision="f32", device=None, state=None):
    model = MODELS[kind][0](c)
    if state is not None:
        model.load_state_dict(state)
    model = model.to(device).eval()
    return _base.to_fp8(model) if precision == "fp8" else model


def program_tree(kind, state, cfg, names=None):
    if kind != "vocoder":
        return _base.program_tree(kind, state, cfg, names)
    return {"convs": [{"w": state[f"{k}.weight"], "b": state[f"{k}.bias"]}
                      for k in ("inp", "out")]}


def vocoder_flops(cfg):
    return 1009, 13


def conditioning(voc, mel, c):
    return (torch.repeat_interleave(mel, c["hop_length"], dim=-1).T,)


def pick(cfg):
    n = cfg["vocoder"]["classes"]
    return {"lanes": n, "mu_law": None,
            "costs": lambda l, g, lg, s: _base.pick_costs(l, g, lg, s,
                                                          "RAW", n),
            "samples": lambda l, g, lg: _base.control_samples(l, g, lg,
                                                              "RAW", n)}


def teacher_forced(model, x_prev, cond):
    return model(x_prev, *cond)
'''


def tiny_copy(tmp_path):
    """(folder, BENCHMARK.json) of a tiny tree of the test's own."""
    spec_path = build_tiny(tmp_path)
    return tmp_path / "h100bench", spec_path


@pytest.fixture
def stub(tmp_path, monkeypatch):
    """The stand-in configuration's cell in a tiny tree of its own, the
    program points it names as a module of their own, and WaveRNN's tree
    and counts replaced by spies that raise."""
    root, spec_path = tiny = tiny_copy(tmp_path)
    cfg = config(tiny, "tiny")
    cfg["reference"] = "stub_ref"
    cfg["vocoder"] = {"hop_length": 275, "n_mels": 80, "channels": 8,
                      "classes": 16, "generate": {"overlap": 550}}
    (root / "configs/stub.json").write_text(json.dumps(cfg))
    (root / "configs/stub_ref.py").write_text(STUB_REF)
    (root / "limits/s.convert.json").write_text(
        json.dumps({"mel_err": 1e-4, "served_gap": 1e-4,
                    "finish_err": 1e-4}))
    spec = json.loads(spec_path.read_text())
    spec["workloads"].append({"name": "s.convert", "config": "stub",
                              "traffic": "tiny-convert", "chips": 1,
                              "why": "a vocoder that is not WaveRNN"})
    new_spec = spec_path.with_name("BENCHMARK.stub.json")
    new_spec.write_text(json.dumps(spec))

    def spy(name):
        def raises(*a, **k):
            raise AssertionError(f"{name} was called")
        return raises

    monkeypatch.setattr(weights, "vocoder_tree", spy("vocoder_tree"))
    for name in ("wavernn_sample_flops", "wavernn_frame_flops",
                 "kernel1_bytes"):
        monkeypatch.setattr(costs, name, spy(name))
    program = types.ModuleType("stub_program")
    program.rows = lambda n: torch.zeros(n, 8)
    program.mel = lambda params, mel: mel
    program.pick = lambda n: torch.full((n, 8), 0.5)
    program.pcm = lambda x: x.clone()
    monkeypatch.setitem(sys.modules, "stub_program", program)
    return harness.load_cell("s.convert", root, new_spec), program


def test_another_vocoder_is_found_and_reached_through_its_reference(stub):
    cell, program = stub
    ref, cfg = cell.ref, cell.config
    assert ref.MODELS["vocoder"][0].__name__ == "ConvVocoder"
    # its weights, its tree and the program's groups
    states = harness.make_states(ref, cfg, 7, "cpu")
    assert set(states["vocoder"]) == {"inp.weight", "inp.bias",
                                      "out.weight", "out.bias"}
    tree = harness.program_tree(ref, "vocoder", states["vocoder"], cfg)
    assert torch.equal(tree["convs"][1]["w"], states["vocoder"]["out.weight"])
    # the program's groups as the configuration holds them: its vocoder
    # group is no WaveRNNConfig, and nothing falls back to one
    with pytest.raises(ValueError, match="valid option for WaveRNNConfig"):
        harness.converter_config(cfg)
    conv = harness.converter_config(
        {k: v for k, v in cfg.items() if k != "vocoder"})
    assert conv.auto_encoder.dim_neck == cfg["auto_encoder"]["dim_neck"]
    # its counts, in the useful operations
    g = harness.utterance_geometry(cfg, ref, 3.0)
    ae, sp = cfg["auto_encoder"], cfg["auto_encoder"]["spectrogram"]
    want = (costs.mel_flops(g["mel_frames"], sp["n_fft"], sp["n_mels"])
            + costs.embed_flops(cfg, g["se_frames"], g["se_partials"])
            + costs.generator_flops(ae, g["chunks"],
                                    sp["partial_utterance_n_frames"])
            + g["samples"] * 1009 + (g["samples"] // 275 + 1) * 13)
    assert harness.conversion_flops(cfg, ref, 3.0) == want
    # the output check's models, conditioning, pass and pick
    models = check.reference_models(cell, 7, "cpu", "f32")
    mel = torch.rand(80, 3)
    parts = check._folded(ref, models["vocoder"], mel, cfg["vocoder"], 1200)
    assert len(parts) == 1 and parts[0].shape[1:] == (1200, 80)
    logits = ref.teacher_forced(models["vocoder"], torch.zeros(1, 1200),
                                parts)
    assert logits.shape == (1, 1200, 16)
    assert ref.pick(cfg)["lanes"] == 16
    # its program points: the tap and the faults
    tap = harness.RowsTap(ref)
    with tap.installed():
        program.rows(3)
        program.mel(None, mel)
    assert [t.shape for t in tap.launches] == [(3, 8)]
    assert tap.mels[0] is mel
    assert program.rows(2).shape == (2, 8)
    assert tap.launches[1:] == []
    with faults.token_altered(ref):
        assert float(program.pick(2)[0, 4]) == pytest.approx(-0.9)
    assert float(program.pick(2)[0, 4]) == 0.5
    with faults.answer_altered(ref):
        assert program.pcm(torch.tensor([0.1, -0.5, 0.2])).tolist() == \
            pytest.approx([0.1, 0.5, 0.2])


@pytest.mark.parametrize("name", harness.REFERENCE_TABLE)
def test_a_reference_without_a_name_fails_at_load_cell(tmp_path, name):
    root, spec_path = tiny = tiny_copy(tmp_path)
    module = f"lacks_{name.lower()}"
    (root / f"configs/{module}.py").write_text(
        "import importlib.util\nfrom pathlib import Path\n"
        "_s = importlib.util.spec_from_file_location(\n"
        "    'base', Path(__file__).with_name('autovc_ref.py'))\n"
        "_m = importlib.util.module_from_spec(_s)\n"
        "_s.loader.exec_module(_m)\n"
        "globals().update({k: v for k, v in vars(_m).items()\n"
        f"                 if not k.startswith('__') and k != {name!r}}})\n")
    cfg = config(tiny, "tiny")
    cfg["reference"] = module
    (root / f"configs/{module}.json").write_text(json.dumps(cfg))
    (root / f"limits/l.{module}.json").write_text(json.dumps({"mel_err": 1}))
    spec = json.loads(spec_path.read_text())
    spec["workloads"].append({"name": f"l.{module}", "config": module,
                              "traffic": "tiny-convert", "chips": 1,
                              "why": "lacks a name"})
    new_spec = spec_path.with_name(f"BENCHMARK.{module}.json")
    new_spec.write_text(json.dumps(spec))
    with pytest.raises(AttributeError) as err:
        harness.load_cell(f"l.{module}", root, new_spec)
    assert str(err.value).endswith(f"lacks {name}")


@pytest.mark.parametrize("cell", ["mol.serve-mixed16", "mol.convert-3to11s",
                                  "raw9.convert-3to11s", "mol.train-ae16"])
def test_each_cell_loads_its_reference_with_the_whole_table(cell):
    ref = harness.load_cell(cell).ref
    assert all(hasattr(ref, n) for n in harness.REFERENCE_TABLE)


# -- the harness names no part of WaveRNN -------------------------------------

WAVERNN_PARTS = ("wavernn", "rnn_dims", "res_blocks", "upsample_factors")


def names_in(path):
    """Every identifier, attribute, imported name, argument and string
    (docstrings included) of a module's source, lower-cased."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        for attr in ("id", "attr", "name", "arg", "module", "asname"):
            v = getattr(node, attr, None)
            if isinstance(v, str):
                out.add(v.lower())
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            out.add(node.value.lower())
    return out


@pytest.mark.parametrize("name", ["harness.py", "check.py", "faults.py"])
def test_the_harness_names_no_part_of_wavernn(name):
    found = sorted(n for n in names_in(BENCH / name)
                   if any(p in n for p in WAVERNN_PARTS))
    assert not found, found
