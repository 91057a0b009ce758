"""A cell at narrow widths on the CPU, for the benchmark's own tests: the
drivers run as on the card, past the card check, with CPU stand-ins for
the card's synchronise, memory peak and trace."""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from types import SimpleNamespace

from benchmark.registry import DEFAULT_MODEL, Registry

REG = Registry(Path(__file__).resolve().parents[2])

TINY_FIELDS = dict(
    n_harmonics=20, n_noise_filters=65, decoder_mlp_units=32, decoder_gru_units=32,
    reverb_length=4096, example_duration=0.5, mss_ffts=[512, 256, 128, 64],
)

TONE = {"f0_hz": [55.0, 1000.0], "vibrato_hz": [4.0, 7.0], "vibrato_cents": [10.0, 60.0],
        "level": [0.05, 0.5], "partials": 12, "noise_level": [0.005, 0.05]}
SERVE_MIX = dict(TONE, kind="serve", slots=3, loop_hops=6, warm_hops=2, check_slots=2)
TRAIN_MIX = dict(TONE, kind="train", batch=4, batches=4, stft_impl="auto", check_steps=3,
                 reference_rows=2)


def cpu_context(mix: dict, seed: int = 5, seconds: float = 0.3, tamper=None, model=None,
                **fields) -> SimpleNamespace:
    """``model``: a model module (``ddsp_decoder`` if None); ``fields``
    override the narrow widths."""
    model = model or REG.model(DEFAULT_MODEL)
    conf = model.config({**TINY_FIELDS, **fields})
    return SimpleNamespace(
        model=model, conf=conf, cd=model.as_dict(conf), mix=mix, seed=seed, seconds=seconds,
        trace=False, device=model.device("cpu"), t_start=time.perf_counter(),
        tamper=tamper or (lambda x: x), marks=[], sync=lambda: None,
        profiler=contextlib.nullcontext, memory_peak=lambda: 0, free=lambda: None,
        summarise=None,
    )


def drive(ctx):
    from benchmark import run

    return run.drive(ctx)
