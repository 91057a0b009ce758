"""Device ms a hop of the step's state row selects (the program's span
``state`` in ``make_multistream_step``), event-timed on the stream."""

from benchmark import spans


def read(w):
    return spans.device_ms(w, "state")
