"""``autovc_tpu_torch.utils.roofline`` and ``.profiling`` against the JAX
package's modules: every cost model gives the JAX integers on the default
configurations and two small ones, ``account`` / ``format_table`` give
the JAX entries for the same peaks, ``chip_spec`` maps the three H100
parts and refuses any other card, and ``trace`` writes a Chrome trace on
the CPU."""
import json
import os

import numpy as np
import pytest
import torch

from autovc_tpu import config as JC
from autovc_tpu.utils import roofline as JR
from autovc_tpu_torch import config as TC
from autovc_tpu_torch.utils import profiling as TP
from autovc_tpu_torch.utils import roofline as TR

AE = {"default": {}, "narrow": dict(dim_neck=8, dim_pre=64, dim_emb=32),
      "forty_mels": dict(dim_neck=16, dim_pre=128, n_mels=40)}
SE = {"default": {}, "narrow": dict(hidden_size=64, embedding_size=32),
      "two_layers": dict(hidden_size=128, input_size=20, embedding_size=64,
                         num_layers=2)}
WR = {"default": {},
      "narrow": dict(res_blocks=2, rnn_dims=16, fc_dims=16, compute_dims=8,
                     res_out_dims=16, upsample_factors=(5, 5, 11)),
      "raw": dict(mode="RAW", bits=9, rnn_dims=64, fc_dims=48, pad=1,
                  upsample_factors=(4, 5, 5), hop_length=100,
                  generate={"target": 2000, "overlap": 200})}


def _cfgs(table, name, jcls, tcls):
    return (jcls().with_overrides(**table[name]),
            tcls().with_overrides(**table[name]))


@pytest.mark.parametrize("which", sorted(AE))
def test_ae_and_melspec_costs_equal_jax(which):
    jc, tc = _cfgs(AE, which, JC.AutoEncoderConfig, TC.AutoEncoderConfig)
    for batch, t in ((1, 400), (9, 400), (16, 128)):
        assert TR.ae_forward_cost(tc, batch, t) == JR.ae_forward_cost(
            jc, batch, t)
        assert TR.ae_train_cost(tc, batch, t) == JR.ae_train_cost(
            jc, batch, t)
    for args in ((400,), (1925, 1024, 40, 800)):
        assert TR.melspec_cost(*args) == JR.melspec_cost(*args)


@pytest.mark.parametrize("which", sorted(SE))
def test_se_cost_equals_jax(which):
    jc, tc = _cfgs(SE, which, JC.SpeakerEncoderConfig,
                   TC.SpeakerEncoderConfig)
    for s, u, t in ((64, 8, 160), (4, 3, 40)):
        assert TR.se_train_cost(tc, s, u, t) == JR.se_train_cost(
            jc, s, u, t)


@pytest.mark.parametrize("which", sorted(WR))
def test_wavernn_costs_equal_jax(which):
    jc, tc = _cfgs(WR, which, JC.WaveRNNConfig, TC.WaveRNNConfig)
    assert TR._band_reach(tc) == JR._band_reach(jc)
    for rows in (1, 16, 64):
        assert TR.wavernn_step_cost(tc, rows) == JR.wavernn_step_cost(
            jc, rows)
        assert TR.wavernn_xla_step_cost(tc, rows) == \
            JR.wavernn_xla_step_cost(jc, rows)
        assert TR.wavernn_conditioning_cost(tc, rows, 12100 * 4) == \
            JR.wavernn_conditioning_cost(jc, rows, 12100 * 4)
        assert TR.wavernn_prologue_cost(tc, rows, 12100) == \
            JR.wavernn_prologue_cost(jc, rows, 12100)
        assert TR.vocoder_train_cost(tc, rows, 2475) == \
            JR.vocoder_train_cost(jc, rows, 2475)


@pytest.mark.parametrize("args", [(3, 5, 7), (1, 1024, 4096)])
def test_layer_costs_equal_jax(args):
    assert TR.matmul_flops(*args) == JR.matmul_flops(*args)
    assert TR.lstm_flops(2, *args) == JR.lstm_flops(2, *args)
    assert TR.gru_flops(2, *args) == JR.gru_flops(2, *args)
    assert TR.conv1d_flops(2, *args, 5) == JR.conv1d_flops(2, *args, 5)


ACCOUNTS = [
    dict(name="ae_train_step", flops=3.1e12, hbm_bytes=2.4e9,
         seconds=0.09),
    dict(name="wavernn", flops=1.43e12, hbm_bytes=6.2e7, seconds=0.19,
         compute_dtype="bf16", sequential_steps=12100, step_floor_us=15.7),
    dict(name="ae_convert", flops=2e11, hbm_bytes=1.2e8, seconds=0.002,
         compute_dtype="bf16", sequential_steps=400, step_floor_us=3.8),
    dict(name="too_fast", flops=1e15, hbm_bytes=1e6, seconds=1e-3),
    dict(name="floor_below", flops=5e12, hbm_bytes=1e9, seconds=0.05,
         compute_dtype="bf16", sequential_steps=10, step_floor_us=1.0),
]


@pytest.mark.parametrize("kw", ACCOUNTS, ids=[a["name"] for a in ACCOUNTS])
def test_account_and_table_equal_jax(kw):
    peaks = (989.0, 67.0, 3350.0)
    tspec, jspec = TR.ChipSpec("card", *peaks), JR.ChipSpec("card", *peaks)
    got = TR.account(spec=tspec, **kw)
    want = JR.account(spec=jspec, **kw)
    assert got == want
    assert got["measurement_valid"] == (kw["name"] != "too_fast")
    assert TR.format_table([got]) == JR.format_table([want])


@pytest.mark.parametrize("name,peaks", [
    ("NVIDIA H100 80GB HBM3", (989.0, 67.0, 3350.0)),
    ("NVIDIA H100 SXM5 80GB", (989.0, 67.0, 3350.0)),
    ("NVIDIA H100 PCIe", (756.0, 51.0, 2000.0)),
    ("NVIDIA H100 NVL", (835.0, 60.0, 3900.0)),
])
def test_chip_spec_maps_the_h100_parts(name, peaks):
    spec = TR.chip_spec(name)
    assert (spec.peak_bf16_tflops, spec.peak_f32_tflops,
            spec.hbm_gbs) == peaks


@pytest.mark.parametrize("name", ["NVIDIA A100-SXM4-80GB", "TPU v5 lite",
                                  "NVIDIA GeForce RTX 4090", ""])
def test_chip_spec_refuses_another_card(name):
    with pytest.raises(ValueError, match="no peak table"):
        TR.chip_spec(name)


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    out = tmp_path / "profile"
    with TP.trace(str(out)) as d:
        assert d == str(out)
        y = torch.ones(64, 64) @ torch.ones(64, 64)
    assert float(y[0, 0]) == 64.0
    files = os.listdir(out)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(out / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_trace_is_written_when_the_block_raises(tmp_path):
    with pytest.raises(RuntimeError, match="boom"):
        with TP.trace(str(tmp_path)):
            torch.zeros(3).sum()
            raise RuntimeError("boom")
    assert len(os.listdir(tmp_path)) == 1


def test_sync_returns_the_tree():
    tree = {"a": [torch.ones(2), np.zeros(3)], "b": torch.zeros(1)}
    assert TP.sync(tree) is tree
    x = torch.ones(3)
    assert TP.sync(x) is x
