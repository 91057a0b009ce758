"""A step's counted model FLOP (``counts.train_step_flops``: the forward,
the backward as twice it, the encoder when finetuning) over the traced
time a step took, against the H100's float32 peak."""

from benchmark import counts


def read(w):
    flops = w.context["unit_flops"] * w.units
    return 100.0 * flops / (w.window_s * counts.PEAK_FP32_FLOPS)
