"""Host ms a hop in ``MultiStreamServer.process``'s copy of the blocks to the card
(the program's span ``copy_in``: ``torch.from_numpy(...).to(device)``)."""

from benchmark import spans


def read(w):
    return spans.host_ms(w, "copy_in")
