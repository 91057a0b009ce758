"""Device ms a step of the MSS loss's backward (the program's span
``backward.loss``, the STFTs' backward), event-timed on the stream."""

from benchmark import spans


def read(w):
    return spans.device_ms(w, "backward.loss")
