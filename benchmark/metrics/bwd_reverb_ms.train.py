"""Device ms a step of the reverb's backward (the program's span
``backward.reverb``, S1's d/dsignal), event-timed on the stream."""

from benchmark import spans


def read(w):
    return spans.device_ms(w, "backward.reverb")
