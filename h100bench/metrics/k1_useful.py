"""k1_useful.<part>: kernel 1's useful work over what it ran, in %: the
output samples the vocoder returned over the rows x steps its sampling
passes ran, padding rows included (the program's counters ``k1.samples``
and ``k1.row_steps`` over the traced stretch,
``h100bench/program_spans.py``).  Padding rows, fold overlap and the fold
tail lower it.  One reader for every ``k1_useful.*`` metric."""
from h100bench import program_spans


def read(r):
    c = program_spans.counters()
    steps = c.get("k1.row_steps", 0)
    if steps <= 0:
        return None
    return 100.0 * c.get("k1.samples", 0) / steps
