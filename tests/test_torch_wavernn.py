"""Kernel 1 and the vocoder chain (autovc_tpu_torch.ops.wavernn_kernels,
autovc_tpu_torch.models.wavernn) against the JAX package on CPU, f32.

The port's plain sampling loop is held against ``generate_rows_pallas(...,
fast_math=False, interpret=True)`` at the SMALL config of
tests/test_wavernn_pallas.py, in MOL and RAW modes (atol 1e-4), with the
noise drawn by ``jax.random`` exactly as ``wavernn_pallas.py:237-242`` does
and handed to the port through its ``draw_noise`` hook."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autovc_tpu.config import WaveRNNConfig as JCfg
from autovc_tpu.models import wavernn as JW
from autovc_tpu.ops import wavernn_pallas as JWP
from autovc_tpu_torch.config import WaveRNNConfig as TCfg
from autovc_tpu_torch.models import wavernn as TW
from autovc_tpu_torch.ops import wavernn_kernels as WK
from autovc_tpu_torch.utils.bridge import from_jax_params

SMALL = dict(rnn_dims=64, fc_dims=64, compute_dims=16, res_out_dims=16,
             res_blocks=2, upsample_factors=(2, 2), hop_length=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path is thousands of small ops; one intra-op thread
    runs them fastest and keeps parallel test workers from contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_noise(key, steps, rows, pick_dim):
    """The JAX kernel's noise draw (wavernn_pallas.py:237-242)."""
    k1, k2 = jax.random.split(key)
    u1 = jax.random.uniform(k1, (steps, rows, pick_dim), minval=1e-5,
                            maxval=1.0 - 1e-5)
    u2 = jax.random.uniform(k2, (steps, rows), minval=1e-5,
                            maxval=1.0 - 1e-5)
    return (torch.from_numpy(np.array(-jnp.log(-jnp.log(u1)))),
            torch.from_numpy(np.array(jnp.log(u2) - jnp.log(1.0 - u2))))


def patch_noise(monkeypatch, key):
    def draw(steps, rows, pick_dim, generator, device):
        return jax_noise(key, steps, rows, pick_dim)
    monkeypatch.setattr(WK, "draw_noise", draw)


def _setup(mode="MOL", **over):
    kw = dict(SMALL, mode=mode, **over)
    jcfg, tcfg = JCfg().with_overrides(**kw), TCfg().with_overrides(**kw)
    params = JW.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, params, from_jax_params(params)


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(1)
    B, fpf, J = 3, 10, 2
    return (rng.random((B, fpf + 2 * J, 80), dtype=np.float32),
            rng.random((B, fpf, 16), dtype=np.float32))


@pytest.mark.parametrize("mode,extra,seed", [("MOL", {}, 42),
                                             ("RAW", {"bits": 4}, 7)])
def test_plain_loop_matches_pallas(rows, monkeypatch, mode, extra, seed):
    jcfg, tcfg, jp, tp = _setup(mode, **extra)
    mel_rows, aux_rows = rows
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(JWP.generate_rows_pallas(
        jp, jnp.asarray(mel_rows), jnp.asarray(aux_rows), key, jcfg,
        fast_math=False, interpret=True))
    patch_noise(monkeypatch, key)
    out = WK.generate_rows(tp, torch.from_numpy(mel_rows),
                           torch.from_numpy(aux_rows), tcfg, fast_math=False)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


def test_bf16_statistics(rows):
    """fast_math: bf16 weights, frame features and noise; the samples agree
    in distribution with f32 (as tests/test_wavernn_pallas.py bounds the
    JAX kernel)."""
    _, tcfg, _, tp = _setup()
    mel_rows, aux_rows = (torch.from_numpy(r) for r in rows)
    f32 = WK.generate_rows(tp, mel_rows, aux_rows, tcfg, False,
                           torch.Generator().manual_seed(3)).numpy()
    bf16 = WK.generate_rows(tp, mel_rows, aux_rows, tcfg, True,
                            torch.Generator().manual_seed(3)).numpy()
    assert np.all(np.isfinite(bf16)) and np.all(np.abs(bf16) <= 1.0)
    assert abs(f32.mean() - bf16.mean()) < 0.1
    assert abs(f32.std() - bf16.std()) < 0.15
    inp = WK.prepare_rows(tp, mel_rows, aux_rows, tcfg, True)
    assert inp.w_ih1.dtype == torch.bfloat16
    assert torch.equal(inp.base, inp.base.bfloat16().float())


def test_generate_matches_jax_pallas_chain(monkeypatch):
    """Public generate(): frame-rate fold with margins, row bucket, sampling
    loop, crossfade-unfold, trim and fade — the JAX pallas branch."""
    jcfg, tcfg, jp, tp = _setup()
    mel = np.random.default_rng(5).random((1, 80, 23), dtype=np.float32)
    key = jax.random.PRNGKey(0)
    ref = JW.generate(jp, mel, jcfg, key=key, batched=True, target=16,
                      overlap=8, fast_math=False, backend="pallas",
                      interpret=True)
    patch_noise(monkeypatch, key)
    out = TW.generate(tp, mel, tcfg, batched=True, target=16, overlap=8,
                      fast_math=False, device="cpu")
    assert out.shape == ref.shape == (22 * 4,)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_generate_unbatched_matches_jax(monkeypatch):
    jcfg, tcfg, jp, tp = _setup()
    mel = np.random.default_rng(6).random((1, 80, 9), dtype=np.float32)
    key = jax.random.PRNGKey(2)
    ref = JW.generate(jp, mel, jcfg, key=key, batched=False, fast_math=False,
                      backend="pallas", interpret=True)
    patch_noise(monkeypatch, key)
    out = TW.generate(tp, mel, tcfg, batched=False, fast_math=False,
                      device="cpu")
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_conditioning_parity():
    jcfg, tcfg, jp, tp = _setup()
    mel = np.random.default_rng(7).random((1, 80, 31), dtype=np.float32)
    K, J = JW._composite_upsample_kernel(jp["upsample"]["up_convs"],
                                         jcfg.upsample_factors)
    tK, tJ = TW._composite_upsample_kernel(tp["upsample"]["up_convs"],
                                           tcfg.upsample_factors)
    assert tJ == J
    np.testing.assert_allclose(tK.numpy(), np.asarray(K), atol=1e-7)
    for target, overlap in ((16, 8), (8, 4)):
        ref = JW._prepare_frame_conditioning(jp, jnp.asarray(mel), jcfg,
                                             target, overlap, True)
        out = TW._prepare_frame_conditioning(tp, torch.from_numpy(mel), tcfg,
                                             target, overlap, True)
        for o, r in zip(out, ref):
            assert o.shape == r.shape
            np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5)


def test_finish_parity():
    rng = np.random.default_rng(8)
    y = rng.uniform(-1, 1, (5, 40)).astype(np.float32)
    np.testing.assert_allclose(
        TW.xfade_and_unfold_device(torch.from_numpy(y), 8).numpy(),
        np.asarray(JW.xfade_and_unfold_device(jnp.asarray(y), 8)), atol=1e-6)
    for mu_law, batched in ((False, True), (True, True), (False, False)):
        ref = JW._finish(jnp.asarray(y), 8, 150, 4, batched, mu_law, 16)
        out = TW._finish(torch.from_numpy(y), 8, 150, 4, batched, mu_law, 16)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_row_bucket_and_fold_count_equal():
    for n in range(1, 200):
        assert TW._row_bucket(n) == JW._row_bucket(n)
    for total, target, overlap in ((100, 16, 8), (5, 16, 8), (2475, 1375, 550),
                                   (549725, 11000, 550)):
        assert (TW._fold_count(total, target, overlap)
                == JW._fold_count(total, target, overlap))


def test_unaligned_geometry_raises():
    _, tcfg, _, tp = _setup()
    mel = np.zeros((1, 80, 12), np.float32)
    with pytest.raises(ValueError, match="multiple of total_scale"):
        TW.generate(tp, mel, tcfg, batched=True, target=15, overlap=7,
                    device="cpu")


def test_auto_target_is_reference_geometry():
    assert TW.auto_fold_target(10 ** 6, 550, TCfg()) == 11_000


def test_packed_weights_match_per_call_packing(rows):
    """The loop's weights packed once (as VoiceConverter does) give the
    same inputs and samples as packing them inside each call; the margin J
    from the conv widths equals the impulse response's."""
    _, tcfg, _, tp = _setup()
    mel_rows, aux_rows = (torch.from_numpy(r) for r in rows)
    up = tp["upsample"]["up_convs"]
    assert TW._upsample_margin(up, tcfg.upsample_factors) == \
        TW._composite_upsample_kernel(up, tcfg.upsample_factors)[1]
    packed = WK.pack_weights(tp, tcfg, False)
    a = WK.prepare_rows(tp, mel_rows, aux_rows, tcfg, False, packed)
    b = WK.prepare_rows(tp, mel_rows, aux_rows, tcfg, False)
    for k, v in vars(a).items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, getattr(b, k)), k
        else:
            assert v == getattr(b, k), k
    out = [WK.generate_rows(tp, mel_rows, aux_rows, tcfg, False,
                            torch.Generator().manual_seed(4), p)
           for p in (packed, None)]
    assert torch.equal(out[0], out[1])
