"""The one generator of the benchmark's inputs, read from a traffic mix's
parameters (``benchmark/workloads/<name>.json``) and made on the device
from the seed.

Every signal is a tone: a glide of the fundamental between two
frequencies drawn log-uniform from ``f0_hz``, with vibrato (rate from
``vibrato_hz``, depth from ``vibrato_cents``), ``partials`` harmonics at
1/k below Nyquist, a level drawn from ``level`` under a slow swell, and
white noise at a level drawn from ``noise_level`` relative to it.  Every
seed draws the same sizes; only the content moves.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference import dsp


def _draw(gen, n, bounds, device, log=False):
    lo, hi = (math.log(b) for b in bounds) if log else bounds
    v = lo + (hi - lo) * torch.rand(n, 1, generator=gen, device=device, dtype=torch.float64)
    return torch.exp(v) if log else v


def tones(mix: dict, n: int, length: int, sample_rate: int, gen, device,
          loop: bool = False):
    """(audio (n, length) float32, f0 (n, length) float64 in Hz).  With
    ``loop`` the glide returns to its start at ``length``, so the signal
    repeats without a jump in pitch."""
    t = torch.arange(length, device=device, dtype=torch.float64)[None, :] / sample_rate
    dur = length / sample_rate
    fa = _draw(gen, n, mix["f0_hz"], device, log=True)
    fb = _draw(gen, n, mix["f0_hz"], device, log=True)
    u = t / dur
    shape = (1.0 - torch.cos(2.0 * math.pi * u)) / 2.0 if loop else (1.0 - torch.cos(math.pi * u)) / 2.0
    log_f = torch.log(fa) + (torch.log(fb) - torch.log(fa)) * shape
    rate = _draw(gen, n, mix["vibrato_hz"], device)
    if loop:  # a whole number of vibrato cycles a loop
        rate = torch.clamp(torch.round(rate * dur), min=1.0) / dur
    depth = _draw(gen, n, mix["vibrato_cents"], device)
    vib_phase = 2.0 * math.pi * torch.rand(n, 1, generator=gen, device=device, dtype=torch.float64)
    f0 = torch.exp(log_f) * 2.0 ** (depth / 1200.0 * torch.sin(2.0 * math.pi * rate * t + vib_phase))
    phase = torch.cumsum(f0 / sample_rate, dim=1)
    audio = torch.zeros(n, length, device=device, dtype=torch.float64)
    norm = 0.0
    for k in range(1, int(mix["partials"]) + 1):
        audio += torch.where(k * f0 < sample_rate / 2, torch.sin(2.0 * math.pi * k * phase) / k, 0.0)
        norm += 1.0 / k
    level = _draw(gen, n, mix["level"], device)
    swell_rate = 1.0 / dur if loop else 0.5
    swell = 0.75 + 0.25 * torch.sin(2.0 * math.pi * swell_rate * t + vib_phase)
    audio = audio * (level * swell / norm)
    noise = _draw(gen, n, mix["noise_level"], device) * level
    audio = audio + noise * torch.randn(n, length, generator=gen, device=device, dtype=torch.float64)
    return audio.float(), f0


def training_batches(mix: dict, conf: dict, seed: int, device) -> list:
    """``mix['batches']`` distinct batches of ``mix['batch']`` examples:
    the audio and, for decoder training, its features at the frame rate
    (f0 at each frame's centre, its position on CREPE's grid, and the
    A-weighted loudness of the audio padded as the encoder pads it)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + 3) % (1 << 63))
    hop, n_fft, sr = conf["hop_length"], conf["n_fft"], conf["sample_rate"]
    length, frames = conf["frames"] * hop, conf["frames"]
    out = []
    for _ in range(int(mix["batches"])):
        audio, f0 = tones(mix, int(mix["batch"]), length, sr, gen, device)
        batch: Dict[str, torch.Tensor] = {"audio": audio}
        if mix["kind"] == "train":
            centres = torch.arange(frames, device=device) * hop + hop // 2
            f0f = f0[:, centres].float()[..., None]
            p = n_fft - hop
            padded = F.pad(audio, (p // 2, p - p // 2))
            batch.update(f0=f0f, normalized_cents=dsp.hz_cents_normalised(f0f),
                         loudness=dsp.loudness(padded.unfold(-1, n_fft, hop), sr)[..., None])
        out.append(batch)
    return out


def serving_loop(mix: dict, conf: dict, seed: int, device) -> torch.Tensor:
    """(loop_hops, slots, hop) float32: each slot's looped input, a call's
    blocks contiguous."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + 4) % (1 << 63))
    hop, n = conf["hop_length"], int(mix["slots"])
    length = int(mix["loop_hops"]) * hop
    audio, _ = tones(mix, n, length, conf["sample_rate"], gen, device, loop=True)
    return audio.reshape(n, -1, hop).transpose(0, 1).contiguous()
