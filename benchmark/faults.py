"""Faults planted under a run, to show that ``correct`` catches them: each
takes what a driver hands to ``ctx.tamper`` (the server, or the step
function) and returns it broken.  Used by the benchmark's tests on the
CPU and by ``benchmark/controls/readings.py`` on the card."""

from __future__ import annotations

import torch


def serve_frozen_state(server):
    """Every hop's output computed, its new state thrown away."""
    step = server._step

    def frozen(state, blocks):
        out, _ = step(state, blocks)
        return out, state

    server._step = frozen
    return server


def serve_frozen_phase(server):
    """Every hop advances the state but the oscillator's phase, which it
    returns as it was."""
    step = server._step

    def frozen(state, blocks):
        out, new = step(state, blocks)
        return out, new._replace(phase=state.phase)

    server._step = frozen
    return server


def serve_half_slots(server):
    """The second half of the slots left out: their output rows zero."""
    step = server._step

    def half(state, blocks):
        out, new = step(state, blocks)
        out = out.clone()
        out[out.shape[0] // 2:] = 0.0
        return out, new

    server._step = half
    return server


def serve_altered_answer(server, at_call: int = 5):
    """One sample of every slot's output negated at one call."""
    process = server.process

    def altered(blocks):
        out = process(blocks)
        if server.blocks == at_call:
            out = out.copy()
            out[:, out.shape[1] // 3] *= -1.0
        return out

    server.process = altered
    return server


def train_frozen_state(step_fn):
    """The step runs, and the parameters are put back as they were."""
    def frozen(state, batch):
        saved = [p.detach().clone() for p in state.params.parameters()]
        new, metrics = step_fn(state, batch)
        with torch.no_grad():
            for p, s in zip(state.params.parameters(), saved):
                p.copy_(s)
        return new, metrics

    return frozen


def train_half_batch(step_fn):
    """Half of each batch left out: the loss is the mean over the rest."""
    def half(state, batch):
        return step_fn(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})

    return half


SERVE = {"frozen_state": serve_frozen_state, "frozen_phase": serve_frozen_phase,
         "half_slots": serve_half_slots,
         "altered_answer": serve_altered_answer}
TRAIN = {"frozen_state": train_frozen_state, "half_batch": train_half_batch}
