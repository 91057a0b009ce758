"""Device ms a hop of the features' loudness and the input buffer's roll (the
program's span ``features.loudness``), event-timed on the stream."""

from benchmark import spans


def read(w):
    return spans.device_ms(w, "features.loudness")
