"""The least time of a hop's features (``counts.features_bound_s``: CREPE
and the loudness rDFT for every slot at the float32 peak, or their bytes)
over the device time launched inside ``features``."""


def read(w):
    ms = w.per_unit_ms("features") if "features" in w.device_s else 0.0
    if ms <= 0.0:
        return None
    return 100.0 * 1e3 * w.context["features_bound_s"] / ms
