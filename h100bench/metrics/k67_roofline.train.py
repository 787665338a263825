"""k67_roofline.train: kernels 6 and 7 (the decoder LSTM stacks' training
forward and backward, ``lstm_fwd_kernel`` / ``lstm_train_bwd_kernel``,
with their ``dw_*_kernel`` tiles) against their roofline over the
window's steps: operations at the bf16 peak or bytes once at the HBM
rate, whichever is longer, over their device time in the trace, in %."""
from h100bench import costs


def read(r):
    if r.trace is None or r.train_steps <= 0:
        return None
    seconds = r.trace.kernel_s("lstm_fwd_kernel", "lstm_train_bwd_kernel",
                               "dw_f32_kernel", "dw_bf16_kernel")
    if seconds <= 0:
        return None
    ae = r.config["auto_encoder"]
    B, T = r.mix["batch"], r.mix["frames"]
    flops = r.train_steps * costs.decoder_lstm_kernel_flops(ae, B, T)
    nbytes = r.train_steps * costs.decoder_lstm_kernel_bytes(ae, B, T)
    return 100.0 * costs.roofline_seconds(flops, nbytes, r.peaks) / seconds
