"""Command-line entry: ``python -m autovc_tpu_torch -mode {train,convert} ...``

The JAX package's ``autovc_tpu/__main__.py`` on the port: phase-1 init
args build the :class:`VoiceConverter`, phase-2 mode args drive ``train``
or ``convert_multiple``; a ``-mean_speaker_path`` pre-step learns mean
speakers first; the run ends with ``close``.  The converter runs on the
GPU (and raises without one); ``main``'s keyword ``device`` is for
callers such as tests (``device="cpu"``) and has no flag.
"""
from __future__ import annotations

import inspect
import sys

from autovc_tpu_torch.cli import parse_mode_args, parse_vc_args


def main(argv=None, *, device=None):
    argv = argv if argv is not None else sys.argv[1:]
    vc_args, rest = parse_vc_args(argv)
    mode_args = parse_mode_args(vc_args.mode, rest)

    from autovc_tpu_torch.voice_converter import VoiceConverter
    vc = VoiceConverter(
        auto_encoder=vc_args.auto_encoder,
        speaker_encoder=vc_args.speaker_encoder,
        vocoder=vc_args.vocoder,
        auto_encoder_params=vc_args.auto_encoder_params,
        speaker_encoder_params=vc_args.speaker_encoder_params,
        vocoder_params=vc_args.vocoder_params,
        wandb_params=vc_args.wandb_params,
        verbose=not vc_args.quiet, device=device)

    if mode_args.mean_speaker_path:
        vc.learn_speakers(mode_args.mean_speaker_path)

    if vc_args.mode == "convert":
        # an unknown -convert_params key dies here, before any model work
        allowed = set(inspect.signature(
            VoiceConverter.convert).parameters) - {"self", "source",
                                                   "target"}
        bad = sorted(set(mode_args.convert_params) - allowed)
        if bad:
            raise SystemExit(
                f"unsupported -convert_params key(s) {bad}; "
                f"convert() accepts: {sorted(allowed)}")
        vc.convert_multiple(
            sources=mode_args.sources,
            targets=(mode_args.targets[0] if len(mode_args.targets) == 1
                     else mode_args.targets),
            match_method=mode_args.match_method,
            bidirectional=mode_args.bidirectional,
            save_dir=mode_args.save_dir,
            save_name=mode_args.save_name,
            **({"sr": mode_args.sr} if mode_args.sr else {}),
            **mode_args.convert_params)
    else:
        kwargs = dict(mode_args.train_params)
        for k in ("n_epochs", "batch_size", "model_name", "save_dir"):
            v = getattr(mode_args, k)
            if v is not None:
                kwargs[k] = v
        data_path = mode_args.data_path
        if mode_args.model_type == "speaker_encoder":
            # speaker-encoder data is 'name=path' pairs -> dict
            data_path = {k.strip(): v.strip() for k, v in
                         (a.split("=") for a in data_path)}
        elif len(data_path) == 1:
            data_path = data_path[0]
        vc.train(data_path=data_path, model_type=mode_args.model_type,
                 **kwargs)
    vc.close()


if __name__ == "__main__":
    main()
