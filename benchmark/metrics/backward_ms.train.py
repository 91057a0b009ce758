"""Device ms a step launched while the program's ``backward`` range was
open (autograd's thread: K2, S1, the STFTs' and the GRU's backward)."""


def read(w):
    return w.per_unit_ms("backward") if "backward" in w.device_s else None
