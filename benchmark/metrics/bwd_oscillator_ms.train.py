"""Device ms a step of the oscillator's backward (the program's span
``backward.oscillator_bank``, K2), event-timed on the stream."""

from benchmark import spans


def read(w):
    return spans.device_ms(w, "backward.oscillator_bank")
