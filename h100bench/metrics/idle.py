"""idle.<part>: the share of the traced window in which no kernel, copy
or set ran on the device, in %.  One reader for every ``idle.*`` metric
(the part after the dot names the cells' end-to-end metric)."""


def read(r):
    w = r.trace.window_s if r.trace is not None else 0.0
    if w <= 0 or r.trace.busy_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - r.trace.busy_s / w)
