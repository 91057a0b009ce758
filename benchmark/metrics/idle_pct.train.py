"""Share of the traced training window in which no operation ran on the
card (the union of the device's intervals, not their sum)."""


def read(w):
    return 100.0 * (1.0 - w.busy_s / w.window_s)
