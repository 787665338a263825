"""audio_ms.serve: host audio: the sources' load-and-preprocess pool and
the finish pool, ms a call: the critical-path ms of the program's spans
``convert_batch/preprocess`` + ``convert_batch/outprocess``
(``h100bench/program_spans.py``) in each call of the traced
stretch, averaged over the calls."""
from h100bench import program_spans

SPANS = ('convert_batch/preprocess', 'convert_batch/outprocess')


def read(r):
    return program_spans.ms_per_call(*SPANS)
