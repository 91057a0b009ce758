"""Host ms a hop in ``MultiStreamServer.process``'s copy of the output to the
host (the program's span ``copy_out``), the wait for the hop's device work
included."""

from benchmark import spans


def read(w):
    return spans.host_ms(w, "copy_out")
