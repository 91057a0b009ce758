"""Device ms a step of the filtered noise's backward (the program's span
``backward.filtered_noise``), event-timed on the stream."""

from benchmark import spans


def read(w):
    return spans.device_ms(w, "backward.filtered_noise")
