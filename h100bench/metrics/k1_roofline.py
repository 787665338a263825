"""k1_roofline.<part>: kernel 1 (the WaveRNN sampling loop, ``wr_kernel``)
against its roofline: the least time the card could take for the real
fold rows x steps it sampled in the window (operations at the bf16 peak
or bytes once at the HBM rate, whichever is longer; padded rows not
counted) over the kernel's device time in the trace, in %.  One reader
for every ``k1_roofline.*`` metric."""
from h100bench import costs


def read(r):
    if r.trace is None or not r.k1:
        return None
    seconds = r.trace.kernel_s("wr_kernel")
    if seconds <= 0:
        return None
    voc = r.config["vocoder"]
    flops = sum(rows * steps for rows, steps in r.k1) * \
        costs.wavernn_sample_flops(voc)
    nbytes = sum(costs.kernel1_bytes(voc, rows, steps) for rows, steps in r.k1
                 if rows)
    return 100.0 * costs.roofline_seconds(flops, nbytes, r.peaks) / seconds
