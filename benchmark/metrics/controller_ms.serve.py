"""Device ms a hop launched inside the program's ``controller`` range
(the MLPs, one GRU step, the heads)."""


def read(w):
    return w.per_unit_ms("controller") if "controller" in w.device_s else None
