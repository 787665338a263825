"""fwd_bwd_ms.train: the training loop's forward and backward
(``loop._value_and_grads``), ms a step: the critical-path ms of the
program's spans ``train/forward`` + ``train/backward``
(``h100bench/program_spans.py``) in each step of the traced
stretch, averaged over the steps."""
from h100bench import program_spans

SPANS = ('train/forward', 'train/backward')


def read(r):
    return program_spans.ms_per_call(*SPANS)
