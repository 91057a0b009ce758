"""Host ms a step inside the forward's ``controller`` span (the MLPs and the
GRU's Python time loop), waits for a full launch queue included."""

from benchmark import spans


def read(w):
    return spans.host_ms(w, "controller")
