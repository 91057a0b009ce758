"""Host ms a step spent inside the program's ``optimizer`` range (the
per-tensor Adam loop)."""


def read(w):
    if "optimizer" not in w.host_s:
        return None
    return 1e3 * w.host_s["optimizer"] / w.units
