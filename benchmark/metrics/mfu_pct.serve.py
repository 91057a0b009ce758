"""A hop's counted FLOP (CREPE windows, the loudness rDFT, the controller,
the oscillator's points, the noise FIR, the partitioned reverb;
``counts.serve_hop_flops``) over the traced time a hop took, against the
H100's float32 peak: the configuration computes in float32, TF32 off."""

from benchmark import counts


def read(w):
    flops = w.context["unit_flops"] * w.units
    return 100.0 * flops / (w.window_s * counts.PEAK_FP32_FLOPS)
