"""Device ms a step of the z encoder's backward (the program's span
``backward.z_encoder``: the upsampling, the dense layer, the encoder's GRU
and the norm), event-timed on the stream."""

from benchmark import spans


def read(w):
    return spans.device_ms(w, "backward.z_encoder")
