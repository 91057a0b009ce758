"""Operations on the card (kernels, copies, fills) per training step."""


def read(w):
    return w.n_ops / w.units
