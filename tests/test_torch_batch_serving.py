"""Batch serving and the rest of ``convert``'s paths in the port, on the
CPU, against the JAX package: the slab planner, the packed merge,
``batch_forward_packed`` / ``batch_forward_many``, the batched MelResNet
pass, ``_finish_many``, ``generate_many``, ``VoiceConverter.convert_batch``,
``convert(cut=False)``, ``convert(pad_to_seconds=...)`` and
``convert_multiple``.

The auto-encoder runs at full width on chunks of N = 32 frames; the
vocoder at the SMALL config of tests/test_torch_wavernn.py (hop 4, folds
of 16 + 2 x 8 samples).  Both sides load the same .ckpt files written by
the JAX package (or take bridged parameters), and the port's sampling
noise is the JAX draw, handed over through ``wavernn_kernels.draw_noise``.
The JAX ``VoiceConverter.convert_batch`` takes its XLA scan on the CPU,
so the converter's reference is the chain of JAX functions it mirrors
(the device speaker encoder, the PCM16 device mel, ``batch_forward_packed``
in f32, ``generate_many(backend="pallas", interpret=True)``).  Bars are
stated in each test."""
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autovc_tpu import models as JM
from autovc_tpu.audio import Audio as JAudio
from autovc_tpu.audio import io as jio
from autovc_tpu.config import ConverterConfig as JConv
from autovc_tpu.models import autoencoder as JAE
from autovc_tpu.models import speaker_encoder as JSE
from autovc_tpu.models import wavernn as JW
from autovc_tpu.ops import melspec as JMEL
from autovc_tpu.voice_converter import VoiceConverter as JVC
from autovc_tpu_torch import Audio, VoiceConverter
from autovc_tpu_torch.audio import dsp
from autovc_tpu_torch.config import ConverterConfig as TConv
from autovc_tpu_torch.models import autoencoder as TAE
from autovc_tpu_torch.models import wavernn as TW
from autovc_tpu_torch.ops import wavernn_kernels as WK
from autovc_tpu_torch.utils.bridge import from_jax_params

SR = 22050
N = 32
SMALL = dict(rnn_dims=64, fc_dims=64, compute_dims=16, res_out_dims=16,
             res_blocks=2, upsample_factors=(2, 2), hop_length=4)
VOC = dict(SMALL, generate={"target": 16, "overlap": 8})
AE_OVR = {"spectrogram": {"partial_utterance_n_frames": N}}
SEED = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path is thousands of small ops; one intra-op thread
    runs them fastest and keeps parallel test workers from contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wav(seconds, f0, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    tone = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in (1, 2, 3))
    env = 0.6 + 0.4 * np.sin(2 * np.pi * 2.5 * t)
    return (0.2 * tone * env + 0.01 * rng.standard_normal(len(t))).astype(
        np.float32)


def jax_noise(key, steps, rows, pick_dim):
    """The JAX kernel's noise draw from ``key`` (wavernn_pallas.py:237-242)."""
    k1, k2 = jax.random.split(key)
    u1 = jax.random.uniform(k1, (steps, rows, pick_dim), minval=1e-5,
                            maxval=1.0 - 1e-5)
    u2 = jax.random.uniform(k2, (steps, rows), minval=1e-5,
                            maxval=1.0 - 1e-5)
    return (torch.from_numpy(np.array(-jnp.log(-jnp.log(u1)))),
            torch.from_numpy(np.array(jnp.log(u2) - jnp.log(1.0 - u2))))


class SlabKeys:
    """``draw_noise`` as the JAX batch pass draws it: a fresh
    ``key, sk = split(key)`` for every slab, in slab order."""

    def __init__(self, key):
        self.key = key

    def __call__(self, steps, rows, pick_dim, generator, device):
        self.key, sk = jax.random.split(self.key)
        return jax_noise(sk, steps, rows, pick_dim)


def row_invariant_pinned(steps, rows, pick_dim, generator, device):
    """The same noise on every row and in every call, with one Gumbel lane
    a step raised by 1e3: a fold's samples then depend on its conditioning
    alone, and no pick hangs on the logits' last bits."""
    g = torch.Generator().manual_seed(11)
    u1 = torch.rand((steps, 1, pick_dim), generator=g) * (1 - 2e-5) + 1e-5
    gumbel = -torch.log(-torch.log(u1))
    lane = torch.randint(0, pick_dim, (steps, 1, 1), generator=g)
    gumbel = gumbel.scatter(-1, lane, 1e3)
    u2 = torch.rand((steps, 1), generator=g) * (1 - 2e-5) + 1e-5
    logistic = torch.log(u2) - torch.log(1.0 - u2)
    return (gumbel.expand(steps, rows, pick_dim).contiguous(),
            logistic.expand(steps, rows).contiguous())


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    """The JAX package's models at the test config, saved as .ckpt; the
    port's CPU converter on them; three source wavs and a target on
    disk."""
    d = tmp_path_factory.mktemp("serving")
    jcfg = JConv().with_overrides(vocoder=VOC, auto_encoder=AE_OVR)
    paths, models = {}, {}
    for i, (name, sub) in enumerate((("auto_encoder", jcfg.auto_encoder),
                                     ("speaker_encoder", jcfg.speaker_encoder),
                                     ("vocoder", jcfg.vocoder))):
        models[name] = JM.load_model(name, config=sub, seed=i, verbose=False)
        paths[name] = JM.save_model(models[name], f"{name}.ckpt", str(d))
    wav_dir = d / "wavs"
    wav_dir.mkdir()
    sources = []
    for k, (sec, f0) in enumerate(((0.7, 140.0), (0.45, 180.0),
                                   (0.9, 120.0))):
        p = str(wav_dir / f"src{k}.wav")
        jio.save_wav(p, _wav(sec, f0, k), SR)
        sources.append(p)
    target = str(d / "trg.wav")
    jio.save_wav(target, _wav(0.8, 210.0, 9), SR)
    vc = VoiceConverter(paths["auto_encoder"], paths["speaker_encoder"],
                        paths["vocoder"], config=TConv().with_overrides(
                            vocoder=VOC, auto_encoder=AE_OVR),
                        device="cpu", verbose=False)
    return dict(jcfg=jcfg, models=models, paths=paths, sources=sources,
                target=target, vc=vc, dir=d)


# ---------------------------------------------------------------------------
# (a) the slab planner
# ---------------------------------------------------------------------------

_V5E_TABLE = dict(JAE._SLAB_MS)


@pytest.mark.parametrize("table", ["jax", "port"])
def test_slab_plan_equals_jax_under_one_table(monkeypatch, table):
    """``_slab_plan`` and ``_pick_slab`` equal the JAX functions for rows
    1-600 with both modules reading one cost table (the JAX package's and
    the port's own); every plan covers the rows with ladder sizes only."""
    costs = dict(_V5E_TABLE if table == "jax" else TAE._SLAB_MS)
    assert TAE._SLAB_LADDER == JAE._SLAB_LADDER
    monkeypatch.setattr(JAE, "_SLAB_MS", costs)
    monkeypatch.setattr(TAE, "_SLAB_MS", costs)
    JAE._slab_plan.cache_clear()
    TAE._slab_plan.cache_clear()
    try:
        for rows in range(1, 601):
            plan = TAE._slab_plan(rows)
            assert plan == JAE._slab_plan(rows), rows
            assert sum(plan) >= rows
            assert set(plan) <= set(TAE._SLAB_LADDER)
            assert list(plan) == sorted(plan, reverse=True)
            assert TAE._pick_slab(rows) == JAE._pick_slab(rows), rows
    finally:
        JAE._slab_plan.cache_clear()
        TAE._slab_plan.cache_clear()


def test_slab_table_is_the_ladder():
    """The port's cost table has one positive entry per ladder size, and
    its plan for 0 rows is the smallest slab, as the JAX one."""
    assert set(TAE._SLAB_MS) == set(TAE._SLAB_LADDER)
    assert all(v > 0 for v in TAE._SLAB_MS.values())
    assert TAE._slab_plan(0) == JAE._slab_plan(0) == (8,)
    assert TAE._round_up(257, 256) == JAE._round_up(257, 256) == 512


# ---------------------------------------------------------------------------
# (b)-(d) the auto-encoder's batch functions
# ---------------------------------------------------------------------------


def test_merge_rows_matches_jax():
    """Mean overlap-add at data offsets, padding rows aimed at the trash
    window: equal to JAX within 1e-6, frames no row covers exactly 0."""
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((7, 5, 8)).astype(np.float32)
    out_frames = 40
    offsets = np.array([0, 4, 8, 20, 24, out_frames, out_frames], np.int32)
    ref = np.asarray(JAE.merge_rows(jnp.asarray(rows), jnp.asarray(offsets),
                                    out_frames))
    got = TAE.merge_rows(torch.from_numpy(rows), torch.from_numpy(offsets),
                         out_frames).numpy()
    assert got.shape == ref.shape == (5, out_frames)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    assert np.all(got[:, 16:20] == 0) and np.all(got[:, 32:] == 0)


@pytest.fixture(scope="module")
def ae_pair(serving):
    ae = serving["models"]["auto_encoder"]
    return ae.config, serving["vc"].AE.config, ae.params, \
        from_jax_params(ae.params)


@pytest.fixture(scope="module")
def chunk_sets():
    rng = np.random.default_rng(6)
    counts = (3, 1, 2)
    sets = [rng.random((m, 80, N), dtype=np.float32) for m in counts]
    cs = [rng.standard_normal(256).astype(np.float32) for _ in counts]
    c_trg = rng.standard_normal((1, 256)).astype(np.float32)
    return sets, cs, c_trg


@pytest.mark.parametrize("gap,slab_rows", [(0, 8), (2, 8), (0, None),
                                           (2, None)])
def test_batch_forward_packed_matches_jax_and_per_utterance(
        ae_pair, chunk_sets, gap, slab_rows):
    """f32, counts (3, 1, 2): the packed timeline equals JAX's
    ``batch_forward_packed`` (same starts and lengths, atol 1e-5), each
    utterance's span equals the port's own ``batch_forward`` of its chunks
    (atol 1e-5), the gap frames stay 0; c_orgs as numpy vectors or as one
    tensor give the same timeline."""
    cfg, tcfg, jp, tp = ae_pair
    sets, cs, c_trg = chunk_sets
    ref, r_starts, r_lengths = JAE.batch_forward_packed(
        jp, [jnp.asarray(s) for s in sets], cs, c_trg, cfg, 0.5, "f32",
        slab_rows=slab_rows, gap=gap)
    ref = np.asarray(ref)
    t_sets = [torch.from_numpy(s) for s in sets]
    with torch.no_grad():
        got, starts, lengths = TAE.batch_forward_packed(
            tp, t_sets, cs, c_trg, tcfg, 0.5, "f32", slab_rows=slab_rows,
            gap=gap)
        got_t, _, _ = TAE.batch_forward_packed(
            tp, t_sets, torch.from_numpy(np.stack(cs)),
            torch.from_numpy(c_trg), tcfg, 0.5, "f32", slab_rows=slab_rows,
            gap=gap)
    assert (starts, lengths) == (r_starts, r_lengths)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_t.numpy(), got.numpy(), atol=1e-6, rtol=0)
    for u, (s, c) in enumerate(zip(t_sets, cs)):
        with torch.no_grad():
            one = TAE.batch_forward(tp, s, torch.from_numpy(c)[None],
                                    torch.from_numpy(c_trg), tcfg, 0.5,
                                    "f32")
        span = got[:, starts[u]:starts[u] + lengths[u]]
        np.testing.assert_allclose(span.numpy(), one.numpy(), atol=1e-5,
                                   rtol=0)
        if gap:
            assert torch.all(got[:, starts[u] - gap:starts[u]] == 0)
            assert torch.all(got[:, starts[u] + lengths[u]:
                                 starts[u] + lengths[u] + gap] == 0)


def test_batch_forward_many_matches_jax(ae_pair, chunk_sets):
    """All utterances' chunks in one forward (rows padded to 8), merged
    per utterance: equal to JAX's ``batch_forward_many``, atol 1e-5."""
    cfg, tcfg, jp, tp = ae_pair
    sets, cs, c_trg = chunk_sets
    counts = tuple(s.shape[0] for s in sets)
    chunks = np.concatenate(sets + [np.zeros((2, 80, N), np.float32)])
    c_orgs = np.concatenate([np.repeat(c[None], m, 0)
                             for c, m in zip(cs, counts)]
                            + [np.zeros((2, 256), np.float32)])
    ref = JAE.batch_forward_many(jp, jnp.asarray(chunks), jnp.asarray(c_orgs),
                                 jnp.asarray(c_trg), counts, cfg, 0.5, "f32")
    with torch.no_grad():
        got = TAE.batch_forward_many(tp, torch.from_numpy(chunks),
                                     torch.from_numpy(c_orgs),
                                     torch.from_numpy(c_trg), counts, tcfg,
                                     0.5, "f32")
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=0)


# ---------------------------------------------------------------------------
# (e)-(g) the vocoder's batch functions
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def voc_pair(serving):
    voc = serving["models"]["vocoder"]
    return voc.config, serving["vc"].vocoder.config, voc.params, \
        from_jax_params(voc.params)


def _mels(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.random((80, F), dtype=np.float32) for F in lengths]


def test_batched_mel_resnet_equals_per_utterance(voc_pair):
    """One MelResNet pass over utterances padded to the longest, sliced
    per utterance and handed in as ``aux_pre``, gives the per-utterance
    conditioning (atol 1e-5), and equals JAX's ``aux_pre`` path."""
    jcfg, tcfg, jp, tp = voc_pair
    mels = [torch.from_numpy(m)[None] for m in _mels((14, 23, 9), 1)]
    Fmax = max(m.shape[-1] for m in mels)
    stacked = torch.cat([torch.nn.functional.pad(m, (0, Fmax - m.shape[-1]))
                         for m in mels])
    with torch.no_grad():
        aux_all = TW._mel_resnet(tp["upsample"]["resnet"],
                                 TW.pad_mel(stacked, tcfg.pad))
        for u, mel in enumerate(mels):
            aux_pre = aux_all[u:u + 1, :, :mel.shape[-1]]
            got = TW._prepare_frame_conditioning(tp, mel, tcfg, 16, 8, True,
                                                 aux_pre)
            one = TW._prepare_frame_conditioning(tp, mel, tcfg, 16, 8, True)
            ref = JW._prepare_frame_conditioning(
                jp, jnp.asarray(mel.numpy()), jcfg, 16, 8, True,
                jnp.asarray(aux_pre.numpy()))
            for g, o, r in zip(got, one, ref):
                assert g.shape == o.shape == r.shape
                np.testing.assert_allclose(g.numpy(), o.numpy(), atol=1e-5,
                                           rtol=0)
                np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                           atol=1e-5, rtol=0)


def test_finish_many_matches_jax():
    """Per-utterance unfold, trim, fade and the flat int16 pack: equal to
    JAX's ``_finish_many`` within 1 LSB."""
    rng = np.random.default_rng(8)
    y = rng.uniform(-1, 1, (9, 40)).astype(np.float32)
    counts, wave_lens, overlap, hop = (4, 2, 3), (110, 50, 64), 8, 4
    ref = np.asarray(JW._finish_many(jnp.asarray(y), counts, wave_lens,
                                     overlap, hop))
    got = TW._finish_many(torch.from_numpy(y), counts, wave_lens, overlap,
                          hop)
    assert got.dtype == torch.int16 and ref.dtype == np.int16
    assert got.shape == ref.shape == (sum(wave_lens),)
    assert np.max(np.abs(got.numpy().astype(np.int32) - ref)) <= 1


def test_generate_many_matches_jax_pallas(voc_pair, monkeypatch):
    """Three mels, 8-row slabs (three of them): equal to JAX's
    ``generate_many(backend="pallas", interpret=True, fast_math=False,
    slab_rows=8)`` with the noise of JAX's per-slab key split, atol 1e-4;
    ``block=False``'s collector returns the same waveforms."""
    jcfg, tcfg, jp, tp = voc_pair
    lengths = (34, 47, 23)
    mels = _mels(lengths, 2)
    key = jax.random.PRNGKey(4)
    kw = dict(target=16, overlap=8, fast_math=False, slab_rows=8)
    ref = JW.generate_many(jp, mels, jcfg, key=key, backend="pallas",
                           interpret=True, **kw)
    folds = sum(TW._fold_count(F, 4, 2) for F in lengths)
    assert folds > 16                       # more than two 8-row slabs
    monkeypatch.setattr(WK, "draw_noise", SlabKeys(key))
    got = TW.generate_many(tp, mels, tcfg, device="cpu", **kw)
    monkeypatch.setattr(WK, "draw_noise", SlabKeys(key))
    later = TW.generate_many(tp, mels, tcfg, device="cpu", block=False, **kw)
    assert callable(later)
    got_later = later()
    assert [len(g) for g in got] == [len(r) for r in ref] == \
        [(F - 1) * 4 for F in lengths]
    for g, gl, r in zip(got, got_later, ref):
        np.testing.assert_allclose(g, r, atol=1e-4, rtol=0)
        np.testing.assert_array_equal(g, gl)


# ---------------------------------------------------------------------------
# (h)-(l) the converter
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jvc(serving):
    """The JAX converter on the same checkpoints, for the tests that run
    its own ``convert`` / ``convert_batch`` with the model stages stubbed."""
    return JVC(serving["paths"]["auto_encoder"],
               serving["paths"]["speaker_encoder"],
               serving["paths"]["vocoder"], config=serving["jcfg"],
               verbose=False, ae_precision="f32", vocoder_backend="xla")


def _jax_audio(path, jcfg):
    a = JAudio(path, SR)
    a.preprocess(*jcfg.convert.preprocess, **jcfg.convert.preprocess_args)
    return a


def _jax_embed(models, wavs):
    se = models["speaker_encoder"]
    return JSE.embed_utterances(se.params, [jio.resample(w, SR, 16000)
                                            for w in wavs], se.config,
                                device=True)


def test_convert_batch_matches_jax_chain(serving, monkeypatch):
    """``convert_batch`` on the CPU against the JAX chain it mirrors:
    embedding MSE < 1e-8, post-mel MSE < 1e-6 (the packed timeline),
    waveform atol 1e-3 (the JAX waveform through int16 PCM)."""
    jcfg, models, vc = serving["jcfg"], serving["models"], serving["vc"]
    ae = models["auto_encoder"]
    audios = [_jax_audio(p, jcfg) for p in serving["sources"]]
    c_srcs = _jax_embed(models, [a.wav for a in audios])
    c_trg = _jax_embed(models, [_jax_audio(serving["target"], jcfg).wav])[0]
    chunks = [JMEL.mel_spec_auto_encoder_sliced(
        a.wav, ae.config.spectrogram, overlap=0.5, pcm16=True)[0]
        for a in audios]
    packed, starts, lengths = JAE.batch_forward_packed(
        ae.params, chunks, c_srcs, c_trg[None], ae.config, 0.5, "f32")
    post = [packed[:, s:s + L] for s, L in zip(starts, lengths)]
    key = jax.random.PRNGKey(SEED)
    ref = JW.generate_many(models["vocoder"].params, post,
                           models["vocoder"].config, key=key, target=16,
                           overlap=8, fast_math=False, backend="pallas",
                           interpret=True)

    emb = vc._embed_many([Audio(a.wav, sr_org=SR) for a in audios])
    assert isinstance(emb, torch.Tensor) and emb.shape == (3, 256)
    assert np.mean((emb.numpy() - np.stack(c_srcs)) ** 2) < 1e-8
    seen = {}
    real = TAE.batch_forward_packed

    def spy(*a, **k):
        out = real(*a, **k)
        seen["packed"] = out
        return out

    monkeypatch.setattr(TAE, "batch_forward_packed", spy)
    monkeypatch.setattr(WK, "draw_noise", SlabKeys(key))
    outs = vc.convert_batch(serving["sources"], serving["target"],
                            outprocess=(), seed=SEED)
    t_packed, t_starts, t_lengths = seen["packed"]
    assert (t_starts, t_lengths) == (starts, lengths)
    assert np.mean((t_packed.numpy() - np.asarray(packed)) ** 2) < 1e-6
    assert len(outs) == 3
    for out, r in zip(outs, ref):
        assert out.sr == SR and out.wav.shape == r.shape
        assert np.all(np.isfinite(out.wav))
        np.testing.assert_allclose(out.wav, r, atol=1e-3, rtol=0)


def test_convert_batch_equals_convert_and_saves_as_jax(serving, jvc,
                                                       tmp_path,
                                                       monkeypatch):
    """Under row-invariant pinned noise each utterance of
    ``convert_batch`` equals ``convert`` of the same wav (atol 1e-3: both
    through int16 PCM); the files are ``{name}_to_{trg}.wav`` directly in
    ``save_dir``, the relative paths the JAX ``convert_batch`` writes (its
    model stages stubbed: they do not decide the names); ``parallel=
    "pipeline"`` with no ``devices`` on a CPU converter refuses to fall
    back to the CPU (``RuntimeError``: the positions default to the local
    CUDA devices), another value raises ``ValueError``."""
    vc, sources, target = serving["vc"], serving["sources"], serving["target"]
    monkeypatch.setattr(WK, "draw_noise", row_invariant_pinned)
    monkeypatch.chdir(tmp_path)
    outs = vc.convert_batch(sources, target, outprocess=(), save_dir="out")
    for src, out in zip(sources, outs):
        one = vc.convert(src, target, outprocess=(), save_name=False)
        assert out.wav.shape == one.wav.shape
        np.testing.assert_allclose(out.wav, one.wav, atol=1e-3, rtol=0)

    emb = np.zeros(256, np.float32)
    monkeypatch.setattr(jvc, "_speaker_embedding", lambda *a: emb)
    monkeypatch.setattr(jvc, "_embed_many", lambda audios: [emb] * len(
        audios))
    monkeypatch.setattr(JMEL, "mel_spec_auto_encoder_sliced",
                        lambda *a, **k: (jnp.zeros((1, 80, N)), None))
    monkeypatch.setattr(JAE, "batch_forward_packed", lambda *a, **k: (
        jnp.zeros((80, 256)), [0] * len(sources), [10] * len(sources)))
    monkeypatch.setattr(JW, "generate_many", lambda *a, **k: [
        np.zeros(2750, np.float32)] * len(sources))
    jvc.convert_batch(sources, target, outprocess=(), save_dir="jax_out")
    names = {d: sorted(str(p.relative_to(tmp_path / d))
                       for p in (tmp_path / d).rglob("*.wav"))
             for d in ("out", "jax_out")}
    assert names["out"] == names["jax_out"] == [
        f"src{k}_to_trg.wav" for k in range(3)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vc.convert_batch(sources, target, parallel="pipeline")
    with pytest.raises(ValueError, match="parallel"):
        vc.convert_batch(sources, target, parallel="x")


def _jax_unchunked(models, wav, c_src, c_trg, key):
    ae, voc = models["auto_encoder"], models["vocoder"]
    mel = dsp.mel_spec_auto_encoder(wav, ae.config.spectrogram)
    post = JAE.infer(ae.params, jnp.asarray(mel[None]), jnp.asarray(c_src),
                     jnp.asarray(c_trg), ae.config, precision="f32")
    return np.asarray(post[0]), JW.generate(
        voc.params, np.asarray(post), voc.config, key=key, backend="pallas",
        interpret=True, fast_math=False, target=16, overlap=8)


def test_convert_unchunked_matches_jax(serving, monkeypatch):
    """``convert(cut=False)``: the host mel of the whole wav, the
    generator's one pass (JAX ``autoencoder.infer``, post-mel MSE < 1e-6)
    and ``generate`` (pallas, interpret; waveform atol 1e-3)."""
    jcfg, models, vc = serving["jcfg"], serving["models"], serving["vc"]
    src = _jax_audio(serving["sources"][1], jcfg).wav
    trg = _jax_audio(serving["target"], jcfg).wav
    c_src, c_trg = _jax_embed(models, [src, trg])
    key = jax.random.PRNGKey(SEED)
    ref_post, ref = _jax_unchunked(models, src, c_src[None], c_trg[None],
                                   key)
    with torch.no_grad():
        post = TAE.infer(vc.AE.params,
                         torch.from_numpy(dsp.mel_spec_auto_encoder(
                             src, vc.AE.config.spectrogram))[None],
                         torch.from_numpy(c_src[None]),
                         torch.from_numpy(c_trg[None]), vc.AE.config, "f32")
    assert post.shape[1:] == ref_post.shape
    assert np.mean((post[0].numpy() - ref_post) ** 2) < 1e-6
    monkeypatch.setattr(WK, "draw_noise",
                        lambda steps, rows, pick_dim, g, d:
                        jax_noise(key, steps, rows, pick_dim))
    out = vc.convert(serving["sources"][1], serving["target"], cut=False,
                     outprocess=(), save_name=False, seed=SEED)
    assert out.wav.shape == ref.shape
    np.testing.assert_allclose(out.wav, ref, atol=1e-3, rtol=0)


def test_pad_to_seconds_matches_jax(serving, monkeypatch):
    """``pad_to_seconds``: the source padded to the bucket before it is
    embedded and converted, then trimmed as ``voice_converter.py:411-419``
    trims: JAX's length and samples (its chain on the padded wav, atol
    1e-3).  The trim keeps (last unpadded slice's stop - 1) x the MEL hop,
    which cuts nothing at the SMALL vocoder's hop of 4: the next test
    holds the trim itself."""
    jcfg, models, vc = serving["jcfg"], serving["models"], serving["vc"]
    ae, voc = models["auto_encoder"], models["vocoder"]
    src = _jax_audio(serving["sources"][1], jcfg).wav
    trg = _jax_audio(serving["target"], jcfg).wav
    bucket = int(round(0.4 * SR))
    padded = np.pad(src, (0, (-len(src)) % bucket))
    assert len(padded) > len(src)
    c_src, c_trg = _jax_embed(models, [padded, trg])
    mel_cfg = ae.config.spectrogram
    chunks, _ = JMEL.mel_spec_auto_encoder_sliced(padded, mel_cfg,
                                                  overlap=0.5, pcm16=True)
    packed, starts, lengths = JAE.batch_forward_packed(
        ae.params, [chunks], [c_src], c_trg[None], ae.config, 0.5, "f32")
    key = jax.random.PRNGKey(SEED)
    wav = JW.generate(voc.params, np.asarray(
        packed[:, starts[0]:starts[0] + lengths[0]])[None], voc.config,
        key=key, backend="pallas", interpret=True, fast_math=False,
        target=16, overlap=8)
    _, true_slices = dsp.compute_partial_slices(
        len(src), SR, partial_utterance_n_frames=N, overlap=0.5,
        mel_window_step=mel_cfg.mel_window_step)
    keep = (true_slices[-1].stop - 1) * mel_cfg.hop_length
    ref = (np.clip(np.round(wav * 32767.0), -32767, 32767) / 32767.0)[:keep]
    monkeypatch.setattr(WK, "draw_noise",
                        lambda steps, rows, pick_dim, g, d:
                        jax_noise(key, steps, rows, pick_dim))
    out = vc.convert(serving["sources"][1], serving["target"],
                     pad_to_seconds=0.4, outprocess=(), save_name=False,
                     seed=SEED)
    assert out.wav.shape == ref.shape
    np.testing.assert_allclose(out.wav, ref, atol=1e-3, rtol=0)


@pytest.mark.parametrize("seconds,pad_to", [(0.45, 0.4), (0.55, 0.9),
                                            (0.7, 0.5)])
def test_pad_to_seconds_trims_as_jax(serving, jvc, monkeypatch, seconds,
                                     pad_to):
    """The trim of ``pad_to_seconds`` at the default hops (vocoder hop =
    mel hop = 275): both packages' ``convert`` with the model stages
    stubbed by a ramp as long as the padded conversion keep the same
    samples, as many as the unpadded conversion gives."""
    vc = serving["vc"]
    mel_cfg = vc.AE.config.spectrogram
    hop, step = mel_cfg.hop_length, N // 2
    emb = np.zeros(256, np.float32)

    def ramp(frames):
        return np.arange((frames - 1) * hop, dtype=np.float32) / 1e6

    def frames_of(n_samples):
        _, sl = dsp.compute_partial_slices(
            n_samples, SR, partial_utterance_n_frames=N, overlap=0.5,
            mel_window_step=mel_cfg.mel_window_step)
        return N + (len(sl) - 1) * step

    for conv in (jvc, vc):
        monkeypatch.setattr(conv, "_embed", lambda audio: emb)
        monkeypatch.setattr(conv, "_speaker_embedding", lambda *a: emb)
    monkeypatch.setattr(JAE, "batch_forward_jit", lambda p, chunks, *a, **k:
                        jnp.zeros((80, N + (chunks.shape[0] - 1) * step)))
    monkeypatch.setattr(JW, "generate", lambda p, mel, *a, **k:
                        ramp(mel.shape[-1]))
    monkeypatch.setattr(vc, "_fused_convert", lambda wav, *a, **k:
                        ramp(frames_of(len(wav))))
    wav = _wav(seconds, 150.0, 4)
    outs = [conv.convert(cls(wav.copy(), sr_org=SR), "target",
                         pad_to_seconds=pad_to, preprocess=(), outprocess=(),
                         save_name=False).wav
            for conv, cls in ((jvc, JAudio), (vc, Audio))]
    assert frames_of(len(np.pad(wav, (0, (-len(wav)) % int(round(
        pad_to * SR)))))) > frames_of(len(wav))
    assert len(outs[0]) == len(outs[1]) == (frames_of(len(wav)) - 1) * hop
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("method,bidirectional,targets", [
    ("all_combinations", False, "dir"), ("align", False, "dir"),
    ("all_combinations", True, "dir"), ("align", True, "dir"),
    ("all_combinations", False, "mean")])
def test_convert_multiple_order_and_count(tmp_path, method, bidirectional,
                                          targets):
    """``convert_multiple`` makes the JAX package's ``convert`` calls, in
    its order, for every match method, with ``bidirectional`` and with a
    mean-speaker target (``convert`` stubbed on both sides)."""
    src_dir, trg_dir = tmp_path / "src", tmp_path / "trg"
    for d, n in ((src_dir, 2), (trg_dir, 2)):
        d.mkdir()
        for k in range(n):
            jio.save_wav(str(d / f"{d.name}{k}.wav"),
                         np.zeros(100, np.float32), SR)
    trg = "spk" if targets == "mean" else str(trg_dir)
    calls = {}
    for name, cls in (("jax", JVC), ("torch", VoiceConverter)):
        log = calls[name] = []
        fake = types.SimpleNamespace(speakers={"spk": np.zeros(256)})
        fake.convert = lambda s, t, log=log, **kw: log.append(
            (os.path.basename(s), os.path.basename(t), kw)) or (s, t)
        fake.convert_multiple = types.MethodType(cls.convert_multiple, fake)
        outs = fake.convert_multiple(str(src_dir), trg, method,
                                     bidirectional, seed=3)
        assert len(outs) == len(log)
    assert calls["torch"] == calls["jax"]
    n_targets = 1 if targets == "mean" else 2
    pairs = 2 * n_targets if method == "all_combinations" else 2
    assert len(calls["torch"]) == pairs * (2 if bidirectional else 1)


def test_convert_multiple_refuses_what_jax_refuses(tmp_path):
    """A bidirectional mean-speaker target, an uneven 'align' and an
    unknown method raise in both packages."""
    d = tmp_path / "src"
    d.mkdir()
    for k in range(2):
        jio.save_wav(str(d / f"s{k}.wav"), np.zeros(100, np.float32), SR)
    for cls in (JVC, VoiceConverter):
        fake = types.SimpleNamespace(speakers={"spk": np.zeros(256)},
                                     convert=lambda s, t, **kw: None)
        cm = types.MethodType(cls.convert_multiple, fake)
        with pytest.raises((AssertionError, ValueError)):
            cm(str(d), "spk", bidirectional=True)
        with pytest.raises((AssertionError, ValueError)):
            cm(str(d), str(d / "s0.wav"), "align")
        with pytest.raises(ValueError):
            cm(str(d), "spk", "nearest")
