"""Device ms a hop launched inside the program's ``features`` range
(loudness, resampling, CREPE)."""


def read(w):
    return w.per_unit_ms("features") if "features" in w.device_s else None
