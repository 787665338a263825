"""Command-line argument parsing (a copy of ``autovc_tpu/cli.py``, which
mirrors ``autovc/utils/argparser.py:5-216``).

Two phases, as the reference: converter-init args first
(``parse_vc_args``), then the mode's own (``parse_mode_args``), with
``key=value`` dict actions for config overrides.  The flags, defaults and
choices are the JAX package's; only the program's name and description
differ.
"""
from __future__ import annotations

import argparse
import ast


class ParseKwargs(argparse.Action):
    """Collect ``key=value`` pairs into a dict, literal-evaluating values
    where possible (argparser.py:10-19, with ``ast.literal_eval`` instead of
    bare ``eval``)."""

    def __call__(self, parser, namespace, values, option_string=None):
        d = getattr(namespace, self.dest) or {}
        for item in values:
            key, _, value = item.partition("=")
            if not _:
                raise argparse.ArgumentError(
                    self, f"expected key=value, got {item!r}")
            try:
                d[key] = ast.literal_eval(value)
            except (ValueError, SyntaxError):
                d[key] = value
        setattr(namespace, self.dest, d)


class StringToNone(argparse.Action):
    """Map the literal strings 'None'/'none' to None (argparser.py:21-28)."""

    def __call__(self, parser, namespace, values, option_string=None):
        if isinstance(values, str) and values.lower() == "none":
            values = None
        setattr(namespace, self.dest, values)


def vc_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="autovc_tpu_torch",
        description="AutoVC voice conversion on an NVIDIA GPU",
        add_help=False)
    p.add_argument("-mode", choices=["train", "convert"], required=True)
    p.add_argument("-auto_encoder", default=None)
    p.add_argument("-speaker_encoder", default=None)
    p.add_argument("-vocoder", default=None)
    p.add_argument("-auto_encoder_params", nargs="*", action=ParseKwargs,
                   default={})
    p.add_argument("-speaker_encoder_params", nargs="*", action=ParseKwargs,
                   default={})
    p.add_argument("-vocoder_params", nargs="*", action=ParseKwargs,
                   default={})
    p.add_argument("-wandb_params", nargs="*", action=ParseKwargs,
                   default={})
    p.add_argument("-quiet", action="store_true")
    return p


def convert_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="autovc_tpu_torch convert")
    p.add_argument("-sources", nargs="+", required=True)
    p.add_argument("-targets", nargs="+", required=True)
    p.add_argument("-match_method", default="all_combinations",
                   choices=["all_combinations", "align"])
    p.add_argument("-bidirectional", action="store_true")
    p.add_argument("-save_dir", default=None, action=StringToNone)
    p.add_argument("-save_name", default=None, action=StringToNone)
    p.add_argument("-sr", type=int, default=None)
    p.add_argument("-mean_speaker_path", nargs="*", default=None,
                   help="name=path pairs to learn mean speakers first")
    p.add_argument("-convert_params", nargs="*", action=ParseKwargs,
                   default={})
    return p


def train_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="autovc_tpu_torch train")
    p.add_argument("-data_path", nargs="+", required=True)
    p.add_argument("-model_type", default="auto_encoder",
                   choices=["auto_encoder", "speaker_encoder", "vocoder"])
    p.add_argument("-n_epochs", type=int, default=None)
    p.add_argument("-batch_size", type=int, default=None)
    p.add_argument("-model_name", default=None, action=StringToNone)
    p.add_argument("-save_dir", default=None, action=StringToNone)
    p.add_argument("-mean_speaker_path", nargs="*", default=None)
    p.add_argument("-train_params", nargs="*", action=ParseKwargs,
                   default={})
    return p


def parse_vc_args(argv):
    """Phase 1: known init args; returns (vc_args, remaining argv)."""
    return vc_parser().parse_known_args(argv)


def parse_mode_args(mode: str, argv):
    parser = convert_parser() if mode == "convert" else train_parser()
    return parser.parse_args(argv)
