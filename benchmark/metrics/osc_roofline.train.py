"""The forward oscillator's least time (7.5 FLOP a (sample, harmonic)
point at the float32 peak, or its bytes; ``counts.osc_forward_bound_s``)
over the device time a step launched inside ``oscillator_bank``."""


def read(w):
    ms = w.per_unit_ms("oscillator_bank") if "oscillator_bank" in w.device_s else 0.0
    if ms <= 0.0:
        return None
    return 100.0 * 1e3 * w.context["osc_bound_s"] / ms
