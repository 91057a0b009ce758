"""Griffin-Lim inversion quality against its iteration count, on the card.

The port's counterpart of ``scripts/gl_quality_curve.py``: the reference
inverts style-transfer spectrograms with 5000 momentum-0.99 iterations
(reference style_transfer.py:149-154) and ``StyleTransferConfig``
defaults to ``gl_iters=512``.  For each budget this prints the spectral
convergence SC = || |STFT(x_rec)| - M ||_F / ||M||_F of
``ops/griffin_lim.griffin_lim`` on a harmonic-rich fixture (waveform SNR
says nothing for phase retrieval: the phase is not unique), the dB
magnitude error 20 log10 SC, and the device ms a run took.

    python -m ddsp_tpu_torch.utils.gl_quality_curve [--device=cpu] [--out=FILE.json]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import numpy as np
import torch

from ddsp_tpu_torch.device import resolve_device
from ddsp_tpu_torch.ops.griffin_lim import griffin_lim, stft_pair

ITERS = (64, 128, 256, 512, 1024, 5000)
SAMPLE_RATE, N_FFT, HOP = 44100, 2048, 512


def fixture_audio(sr: int, seconds: float = 3.0) -> np.ndarray:
    """Harmonic-rich deterministic test signal (``scripts/
    gl_quality_curve.py:fixture_audio``): three gliding voices of 11
    harmonics each plus a noise floor, peak 0.2."""
    t = np.arange(int(sr * seconds)) / sr
    x = np.zeros_like(t)
    rng = np.random.default_rng(0)
    for f0, vib in ((110.0, 3.0), (164.8, 2.0), (220.0, 5.0)):
        phase = np.cumsum(f0 * (1 + 0.01 * np.sin(2 * np.pi * vib * t)) / sr)
        for h in range(1, 12):
            x += np.sin(2 * np.pi * h * phase) / h
    x += 0.01 * rng.standard_normal(t.size)
    return (0.2 * x / np.max(np.abs(x))).astype(np.float32)


def magnitude(audio: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    re, im = stft_pair(audio, n_fft, hop)
    return torch.sqrt(re**2 + im**2)


def spectral_convergence(audio: torch.Tensor, target: torch.Tensor, n_fft: int,
                         hop: int) -> float:
    """|| |STFT(audio)| - target ||_F / || target ||_F."""
    return float(torch.linalg.vector_norm(magnitude(audio, n_fft, hop) - target)
                 / torch.linalg.vector_norm(target))


def quality_curve(device) -> Dict:
    """Spectral convergence and time of one Griffin-Lim run per budget in
    ``ITERS`` on 3 s of the fixture (each from the same initial angles).  ``ms`` is a run's time
    between CUDA events on a card, the host clock on the CPU."""
    dev = resolve_device(device)
    audio = torch.from_numpy(fixture_audio(SAMPLE_RATE)).to(dev)
    mag = magnitude(audio, N_FFT, HOP)
    griffin_lim(mag, N_FFT, HOP, n_iter=2, length=audio.numel())  # warm-up
    rows = []
    for n_iter in ITERS:
        if dev.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            start.record()
        t0 = time.perf_counter()
        rec = griffin_lim(mag, N_FFT, HOP, n_iter=n_iter, length=audio.numel())
        if dev.type == "cuda":
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
        else:
            ms = (time.perf_counter() - t0) * 1e3
        sc = spectral_convergence(rec, mag, N_FFT, HOP)
        rows.append({"n_iter": n_iter, "spectral_convergence": sc,
                     "mag_err_db": 20 * np.log10(sc), "ms": ms, "ms_per_iter": ms / n_iter})
    return {"device": str(dev), "shape": list(mag.shape), "n_fft": N_FFT, "hop": HOP,
            "sample_rate": SAMPLE_RATE, "rows": rows}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="gl_quality_curve")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    result = quality_curve(args.device)
    if result["device"].startswith("cuda"):
        result["card"] = torch.cuda.get_device_name(0)
    for row in result["rows"]:
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
