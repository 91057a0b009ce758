"""Device ms a step launched inside the program's ``controller`` range
(the MLPs, the GRU's time loop, the heads)."""


def read(w):
    return w.per_unit_ms("controller") if "controller" in w.device_s else None
