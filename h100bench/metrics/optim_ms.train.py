"""optim_ms.train: the training loop's optimizer (global norm, clip, Adam:
``schedules.Optimizer.step``) and EMA update, ms a step: the critical-
path ms of the program's spans ``train/optimizer`` + ``train/ema``
(``h100bench/program_spans.py``) in each step of the traced
stretch, averaged over the steps."""
from h100bench import program_spans

SPANS = ('train/optimizer', 'train/ema')


def read(r):
    return program_spans.ms_per_call(*SPANS)
