"""The MSS loss forward's least time (``counts.mss_forward_bound_s``: the
real FFTs of the prediction's and the target's spectrograms, 2.5 n log2 n
FLOP a frame, at the float32 peak, or the bytes of the prediction and the
target at the memory bandwidth, whichever is longer) over the device time
a step launched inside ``loss``."""


def read(w):
    ms = w.per_unit_ms("loss") if "loss" in w.device_s else 0.0
    if ms <= 0.0:
        return None
    return 100.0 * 1e3 * w.context["loss_bound_s"] / ms
