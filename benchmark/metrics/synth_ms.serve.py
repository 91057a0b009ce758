"""Device ms a hop launched inside the program's ``oscillator``, ``noise``
and ``reverb`` ranges (K5, the FIR noise, the partitioned reverb)."""

STAGES = ("oscillator", "noise", "reverb")


def read(w):
    if not any(s in w.device_s for s in STAGES):
        return None
    return w.per_unit_ms(*STAGES)
