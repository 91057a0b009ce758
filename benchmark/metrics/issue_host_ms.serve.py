"""Host ms a hop issuing the step (the program's span ``hop`` in
``MultiStreamServer.process``): the launches, and any wait for a full queue."""

from benchmark import spans


def read(w):
    return spans.host_ms(w, "hop")
