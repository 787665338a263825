"""mfu.<part>: the useful operations of the window's completed work (the
benchmark's cost arithmetic, from the inputs' shapes) over the window's
wall times the card's published bf16 peak, in %.  A run that profiles
only its window's last seconds reads the part before the profiler
starts.  One reader for every ``mfu.*`` metric."""


def read(r):
    if r.window_s <= 0 or r.useful_flops <= 0:
        return None
    return 100.0 * r.useful_flops / (r.window_s * r.peaks.bf16_flops)
