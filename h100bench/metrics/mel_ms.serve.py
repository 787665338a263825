"""mel_ms.serve: the mel front-end: every source's PCM16 mel chunks, ms a
call: the critical-path ms of the program's spans ``convert_batch/mel``
(``h100bench/program_spans.py``) in each call of the traced
stretch, averaged over the calls."""
from h100bench import program_spans

SPANS = ('convert_batch/mel',)


def read(r):
    return program_spans.ms_per_call(*SPANS)
