"""The benchmark's cost arithmetic, pinned."""
import json

import pytest

from h100bench import costs
from conftest import REPO


def config(name):
    return json.loads((REPO / f"h100bench/configs/{name}.json").read_text())


def test_raw9_sample_exceeds_mol_by_the_wider_fc3():
    mol, raw = config("autovc-mol")["vocoder"], config("autovc-raw9")["vocoder"]
    assert (costs.wavernn_sample_flops(raw) - costs.wavernn_sample_flops(mol)
            == 2 * 512 * (512 - 30))


def test_mol_sample_count():
    voc = config("autovc-mol")["vocoder"]
    # 4 GRU products of 512 x 1536, fc1, fc2, fc3 at 30 classes, 5 taps
    assert costs.wavernn_sample_flops(voc) == (
        2 * (4 * 512 * 1536 + 512 * 512 + 512 * 512 + 512 * 30) + 2 * 5 * 512)
    assert costs.band_taps(voc) == 5
    assert costs.n_classes(voc) == 30 and costs.pick_lanes(voc) == 10


def test_pick_lanes_and_kernel1_bytes_follow_the_mode():
    raw = config("autovc-raw9")["vocoder"]
    assert costs.pick_lanes(raw) == 512
    mol = config("autovc-mol")["vocoder"]
    # the noise and samples stream: (lanes + 1) + 1 f32 a row and step
    d = costs.kernel1_bytes(raw, 64, 2750) - costs.kernel1_bytes(mol, 64, 2750)
    weights = 2 * 512 * (512 - 30)
    assert d == weights + 4 * 64 * 2750 * (512 - 10)


def test_train_step_and_kernel_6_7_counts():
    ae = config("autovc-mol")["auto_encoder"]
    step = costs.train_step_flops(ae, 16, 400)
    assert 1.2e12 < step < 1.3e12
    # kernels 6/7: lstm1 (1 x 512) and lstm2 (2 x 1024), 3 x the forward's
    # recurrent and upper-layer input products
    rows = 16 * 400
    want = 3 * (2 * rows * 512 * 2048 + 3 * 2 * rows * 1024 * 4096)
    assert costs.decoder_lstm_kernel_flops(ae, 16, 400) == want


def test_peaks_are_published_and_unknown_cards_raise():
    p = costs.peaks("NVIDIA H100 80GB HBM3")
    assert (p.bf16_flops, p.f32_flops, p.hbm_bytes) == (989e12, 67e12,
                                                         3.35e12)
    with pytest.raises(ValueError):
        costs.peaks("NVIDIA A100-SXM4-80GB")


def test_roofline_takes_the_longer_bound():
    p = costs.peaks("H100 SXM")
    assert costs.roofline_seconds(989e12, 0, p) == pytest.approx(1.0)
    assert costs.roofline_seconds(0, 3.35e12, p) == pytest.approx(1.0)
    assert costs.roofline_seconds(989e12, 6.7e12, p) == pytest.approx(2.0)
