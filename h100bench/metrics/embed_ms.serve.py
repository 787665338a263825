"""embed_ms.serve: the speaker encoder: the target's embedding (made again
every call) and the sources' one forward, ms a call: the critical-path
ms of the program's spans ``convert_batch/target`` +
``convert_batch/embed`` (``h100bench/program_spans.py``) in each
call of the traced stretch, averaged over the calls."""
from h100bench import program_spans

SPANS = ('convert_batch/target', 'convert_batch/embed')


def read(r):
    return program_spans.ms_per_call(*SPANS)
