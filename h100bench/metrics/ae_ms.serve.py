"""ae_ms.serve: the generator: the slab plan and every chunk's pass, ms a
call: the critical-path ms of the program's spans
``convert_batch/autoencoder`` (``h100bench/program_spans.py``) in
each call of the traced stretch, averaged over the calls."""
from h100bench import program_spans

SPANS = ('convert_batch/autoencoder',)


def read(r):
    return program_spans.ms_per_call(*SPANS)
