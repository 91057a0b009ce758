"""Device ms a hop of CREPE with the window's normalisation and the argmax (the
program's span ``features.crepe``), event-timed on the stream."""

from benchmark import spans


def read(w):
    return spans.device_ms(w, "features.crepe")
