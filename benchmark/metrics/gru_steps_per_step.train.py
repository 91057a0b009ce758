"""GRU gate-kernel launches (``gru_gates_fwd``) a training step, every
recurrence of the model together: the program's counter
(``ops/cuda/gru.FWD_LAUNCHES``) over the steps it took, as the model's
counts hand it to the window; one launch a time step of a sequence."""


def read(w):
    return w.context.get("gru_fwd_launches_per_step")
