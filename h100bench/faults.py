"""Faults planted under the timed path, for the control readings
(``control.py``) and the tests that see ``correct`` come out false: each
is a context manager factory for ``harness.run(..., fault=...)``.

* ``token_altered``: one served sample of every sampling launch (row 0,
  mid-row) moved to the other side of zero where the loop produces it;
* ``answer_altered``: the served waveform's loudest sample negated where
  the vocoder produces it;
* ``half_batch``: the generator's merge over the first half of the chunk
  rows only (half of the batch left out, the mean taken over the rest);
* ``train_half_batch``: the training loss taken over the first half of
  each batch only;
* ``train_state_unchanged``: the optimizer step leaves the parameters
  as they were;
* ``train_grad_altered``: the largest leaf's gradient altered (four
  times too large) where it is produced.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(mod, attr, make):
    original = getattr(mod, attr)
    setattr(mod, attr, make(original))
    try:
        yield
    finally:
        setattr(mod, attr, original)


def token_altered():
    from autovc_tpu_torch.ops import wavernn_kernels as WK

    def make(orig):
        def sample_rows(inp, gumbel, logistic):
            out = orig(inp, gumbel, logistic)
            t = out.shape[1] // 2
            out[0, t] = -0.9 if float(out[0, t]) >= 0 else 0.9
            return out
        return sample_rows
    return _patched(WK, "sample_rows", make)


def answer_altered():
    """The served waveform's loudest PCM sample negated where the vocoder
    produces it."""
    from autovc_tpu_torch.models import wavernn as WRm

    def make(orig):
        def pcm16(x):
            out = orig(x)
            i = int(out.abs().argmax())
            out[i] = -out[i]
            return out
        return pcm16
    return _patched(WRm, "_pcm16", make)


def half_batch():
    """The generator's merge takes the mean over the first half of each
    utterance's chunk rows and leaves the rest out (frames only they
    cover stay 0)."""
    from autovc_tpu_torch.models import autoencoder as AEm

    def make_rows(orig):
        def merge_rows(mel_rows, offsets, out_frames):
            real = (offsets < out_frames).nonzero().flatten()
            offsets = offsets.clone()
            offsets[real[len(real) - len(real) // 2:]] = out_frames  # trash
            return orig(mel_rows, offsets, out_frames)
        return merge_rows

    def make_chunks(orig):
        def merge_chunks(mel_post, step):
            M, n_mels, N = mel_post.shape
            acc = mel_post.new_zeros(n_mels, N + (M - 1) * step)
            cnt = mel_post.new_zeros(1, acc.shape[-1])
            for i in range(M - M // 2):
                acc[:, i * step:i * step + N] += mel_post[i]
                cnt[:, i * step:i * step + N] += 1.0
            return torch.where(cnt > 0, acc / torch.clamp(cnt, min=1.0),
                               torch.zeros_like(acc))
        return merge_chunks

    stack = contextlib.ExitStack()
    stack.enter_context(_patched(AEm, "merge_rows", make_rows))
    stack.enter_context(_patched(AEm, "_merge_chunks", make_chunks))
    return stack


def train_half_batch():
    from autovc_tpu_torch.models import autoencoder as AEm

    def make(orig):
        def loss(params, x, c_org, *a, **k):
            h = max(1, x.shape[0] // 2)
            return orig(params, x[:h], c_org[:h], *a, **k)
        return loss
    return _patched(AEm, "loss", make)


def train_state_unchanged():
    from autovc_tpu_torch.train import schedules

    def make(orig):
        def step(self, params, grads, state, model=None):
            saved = [p.detach().clone() for p in params]
            norm = orig(self, params, grads, state, model)
            for p, s in zip(params, saved):
                p.copy_(s)
            return norm
        return step
    return _patched(schedules.Optimizer, "step", make)


def train_grad_altered():
    from autovc_tpu_torch.train import loop

    def make(orig):
        def loss_and_grads(*a, **k):
            aux, grads = orig(*a, **k)
            big = max(range(len(grads)), key=lambda i: grads[i].numel())
            grads[big] = grads[big] * 4.0
            return aux, grads
        return loss_and_grads
    return _patched(loop, "loss_and_grads", make)


CONVERSION = {"token_altered": token_altered, "answer_altered": answer_altered,
              "half_batch": half_batch}
TRAINING = {"half_batch": train_half_batch,
            "state_unchanged": train_state_unchanged,
            "token_altered": train_grad_altered}


def for_kind(kind: str) -> dict:
    return TRAINING if kind == "train_ae" else CONVERSION
