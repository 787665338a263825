"""vocoder_ms.serve: the vocoder: ``generate_many``, its read-back of the
PCM included, ms a call: the critical-path ms of the program's spans
``convert_batch/vocoder`` (``h100bench/program_spans.py``) in each
call of the traced stretch, averaged over the calls."""
from h100bench import program_spans

SPANS = ('convert_batch/vocoder',)


def read(r):
    return program_spans.ms_per_call(*SPANS)
