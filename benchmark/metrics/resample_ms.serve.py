"""Device ms a hop of the features' resampling to CREPE's rate (the program's
span ``features.resample``), event-timed on the stream."""

from benchmark import spans


def read(w):
    return spans.device_ms(w, "features.resample")
