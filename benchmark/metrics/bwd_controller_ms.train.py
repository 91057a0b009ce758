"""Device ms a step of the controller's backward (the program's span
``backward.controller``, the GRU loop's backward), event-timed on the stream."""

from benchmark import spans


def read(w):
    return spans.device_ms(w, "backward.controller")
