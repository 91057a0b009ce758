"""Host ms a step inside ``make_train_step``'s step (the program's span
``train_step``), waits for a full launch queue included."""

from benchmark import spans


def read(w):
    return spans.host_ms(w, "train_step")
