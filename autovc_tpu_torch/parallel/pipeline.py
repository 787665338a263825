"""Stage-level pipeline parallelism for batch conversion (counterpart of
``autovc_tpu/parallel/pipeline.py``).

The conversion chain is cut into stages, each pinned to a group of mesh
positions; utterances stream through, so stage i of utterance j may run
while stage i - 1 of utterance j + 1 does.  The host loop only queues
work: each stage computes on the first device of its group, on that
card's CUDA stream, and a handoff between stages is an event the next
stage's stream waits for, then a ``tensor.to(device, non_blocking=True)``.
``run`` keeps at most ``max_inflight`` items queued and returns the
results in order, as numpy arrays.

Positions may repeat a device (``[cuda:0, cuda:0]``): the stages then share
one card and its stream, and run in order (``streams.lanes``: the port's
inference kernels 1-3 are persistent grids of up to one block per SM, so
two of them must not be resident at once).

:func:`conversion_pipeline` is the AutoVC server: stage 0 converts an
utterance's mel chunks and merges them (``autoencoder.batch_forward``:
decoder lstm2 on kernel 2 at <= 8 chunks, kernel 3 above); stage 1 runs
the single-utterance vocoder program (``wavernn._generate_program``, the
sampling loop on kernel 1) and the finish to int16 PCM.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable, List, Sequence

import numpy as np
import torch

from autovc_tpu_torch.parallel import sharding as shd
from autovc_tpu_torch.parallel import streams as ST


def _move(x, device, src, dst):
    """Every tensor of ``x`` (a tensor, tuple or list) on ``device`` for
    lane ``dst``; other values pass."""
    if torch.is_tensor(x):
        return ST.hop(x, device, src, dst)
    if isinstance(x, (tuple, list)):
        return type(x)(_move(v, device, src, dst) for v in x)
    return x


def _tensors(x) -> list:
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


class Stage:
    """One pipeline stage: ``fn(params, *args)`` with its parameters
    resident on the first device of ``devices``, computing there on
    ``lane`` (None: a new lane of that device)."""

    def __init__(self, fn: Callable, params: Any, devices: Sequence,
                 lane=None):
        self.devices = [torch.device(d) for d in devices]
        self.device = self.devices[0]
        self.params = shd.tree_to(params, self.device)
        self.fn = fn
        self.lane = lane if lane is not None else ST.lanes([self.device])[0]

    def __call__(self, *args, src=None):
        """Run on this stage's lane; ``src``: the lane the tensor
        arguments were made on (None: their devices' current streams).
        Returns the result, made on this stage's lane."""
        args = _move(args, self.device, src, self.lane)
        with ST.on(self.lane):
            return self.fn(self.params, *args)


class StagePipeline:
    """Stages over groups of mesh positions, items streamed through.

    >>> pipe = StagePipeline([(ae_fn, ae_params), (voc_fn, voc_params)],
    ...                      device_groups=split_devices(devs, 2))
    >>> outs = pipe.run(items)        # list of numpy arrays
    """

    def __init__(self, stages: Sequence[tuple], device_groups: Sequence):
        assert len(stages) == len(device_groups)
        assert all(len(g) for g in device_groups), "empty device group"
        lanes = ST.lanes([torch.device(g[0]) for g in device_groups])
        self.stages = [Stage(fn, params, group, lane)
                       for (fn, params), group, lane
                       in zip(stages, device_groups, lanes)]

    def _queue(self, *args):
        """Queue one item through every stage; returns (result, the last
        stage's lane)."""
        x = self.stages[0](*args)
        src = self.stages[0].lane
        for stage in self.stages[1:]:
            x = stage(x, src=src)
            src = stage.lane
        return x, src

    def run(self, items: Sequence, max_inflight: int = 4) -> List[np.ndarray]:
        """Stream ``items`` (each an argument tuple, or one argument)
        through the stages, queueing at most ``max_inflight`` ahead of the
        oldest unfinished one.  Returns the results in order as numpy
        arrays."""
        assert max_inflight >= 2, "pipelining needs >= 2 in-flight items"
        results: List[np.ndarray] = []
        inflight: deque = deque()

        def collect():
            x, event = inflight.popleft()
            if event is not None:
                event.synchronize()
            results.append(x.cpu().numpy())

        for it in items:
            if len(inflight) >= max_inflight:
                collect()
            x, lane = self._queue(*(it if isinstance(it, tuple) else (it,)))
            event = None
            if lane is not None:
                event = torch.cuda.Event()
                event.record(lane)
            inflight.append((x, event))
        while inflight:
            collect()
        return results


def split_devices(devices: Sequence | None = None,
                  n_stages: int = 2) -> List[List]:
    """Cut the positions ``devices`` (None: every local CUDA device) into
    ``n_stages`` contiguous groups, disjoint as positions (a device may
    repeat)."""
    devices = list(devices if devices is not None
                   else shd.make_mesh().devices)
    n = len(devices)
    assert n >= n_stages, f"need >= {n_stages} devices, have {n}"
    base, rem = divmod(n, n_stages)
    groups, i = [], 0
    for s in range(n_stages):
        size = base + (1 if s < rem else 0)
        groups.append(devices[i:i + size])
        i += size
    return groups


def conversion_pipeline(ae_params, wr_params, ae_cfg, wr_cfg,
                        devices: Sequence | None = None,
                        overlap: float = 0.5,
                        ae_precision: str = "auto",
                        fast_math: bool = True,
                        lstm2_packed=None,
                        vocoder_packed=None) -> StagePipeline:
    """The AutoVC inference pipeline as two stages:

      stage 0: chunked auto-encoder conversion and the mean overlap-add
               merge (``autoencoder.batch_forward``);
      stage 1: the single-utterance vocoder program (conditioning, fold,
               the sampling loop, the crossfade, trim and fade) to an
               int16 PCM waveform, as ``convert`` downloads it (the JAX
               stage returns the float waveform before that rounding and
               clipping).

    ``run`` takes ``(chunks, c_org, c_trg, seed)`` per utterance: chunks
    (M, n_mels, N), embeddings (1, emb), the sampling generator seeded
    with ``seed`` on the vocoder's device.  ``lstm2_packed`` /
    ``vocoder_packed``: the kernels' packed weights (``VoiceConverter``'s;
    None: built per call), copied to their stage's device."""
    from autovc_tpu_torch.models import autoencoder as AE
    from autovc_tpu_torch.models import wavernn as WR

    g = wr_cfg.generate
    groups = split_devices(devices, 2)
    ae_dev, voc_dev = groups[0][0], groups[1][0]

    ae_packed = shd.tree_to(lstm2_packed, ae_dev)
    voc_packed = shd.tree_to(vocoder_packed, voc_dev)
    mu_law = g.mu_law and wr_cfg.mode == "RAW"

    def ae_stage(params, chunks, c_org, c_trg, seed):
        mel = AE.batch_forward(params, chunks, c_org, c_trg, ae_cfg,
                               overlap, ae_precision, ae_packed)
        return mel, seed

    def voc_stage(params, mel_and_seed):
        mel, seed = mel_and_seed
        t_total = (int(mel.shape[-1]) - 1) * wr_cfg.hop_length
        target = (WR.auto_fold_target(t_total, g.overlap, wr_cfg)
                  if g.auto_target else g.target)
        gen = torch.Generator(device=mel.device).manual_seed(int(seed))
        return WR._pcm16(WR._generate_program(
            params, mel[None], gen, wr_cfg, target, g.overlap, g.batched,
            mu_law, fast_math, voc_packed))

    return StagePipeline([(ae_stage, ae_params), (voc_stage, wr_params)],
                         groups)
