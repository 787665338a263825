"""k1_split.<part>: the share of kernel 1's rows x steps that ran on its
split pick (fc3 and the Gumbel-max pick split across the R1 blocks by
class), in %: the program's counter ``k1.split_row_steps`` over
``k1.row_steps`` over the traced stretch (``h100bench/program_spans.py``).
A program without the split pick, or a stretch with no sampling pass,
reads nothing.  One reader for every ``k1_split.*`` metric."""
from h100bench import program_spans


def read(r):
    from autovc_tpu_torch.ops import wavernn_kernels
    name = getattr(wavernn_kernels, "SPLIT_ROW_STEPS", None)
    c = program_spans.counters()
    steps = c.get("k1.row_steps", 0)
    if name is None or steps <= 0:
        return None
    return 100.0 * c.get(name, 0) / steps
