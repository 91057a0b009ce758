"""Operations on the card (kernels, copies, fills) per serving hop."""


def read(w):
    return w.n_ops / w.units
