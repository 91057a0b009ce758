"""Polyphase windowed-sinc resampling (torchaudio ``Resample`` defaults).

Counterpart of ``ddsp_tpu/ops/resample.py``: reduce the rate ratio by the
gcd, build one Hann^2-windowed sinc kernel per output phase, and evaluate
all phases as a single strided 1-D convolution.  Used to bring 44.1 kHz
audio to CREPE's 16 kHz.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _sinc_kernel(
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
) -> tuple:
    """(kernels (new_freq, filt_len) float32, width): phase ``p``'s kernel
    is the lowpass sinc centred at output time ``p/new_freq`` on the input
    grid, Hann^2-windowed, scaled by ``base_freq/orig_freq``."""
    if math.gcd(orig_freq, new_freq) != 1:
        raise ValueError("rates must be reduced by their gcd")
    base_freq = min(orig_freq, new_freq) * rolloff
    width = int(math.ceil(lowpass_filter_width * orig_freq / base_freq))
    idx = np.arange(-width, width + orig_freq, dtype=np.float64) / orig_freq
    t = (
        -np.arange(new_freq, dtype=np.float64)[:, None] / new_freq + idx
    ) * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t = t * np.pi
    kernels = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernels = kernels * window * (base_freq / orig_freq)
    return kernels.astype(np.float32), width


def resample_length(length: int, orig_freq: int, new_freq: int) -> int:
    gcd = math.gcd(orig_freq, new_freq)
    return int(math.ceil(new_freq // gcd * length / (orig_freq // gcd)))


def resample(
    x: torch.Tensor,
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
) -> torch.Tensor:
    """Resample (..., L) audio from ``orig_freq`` to ``new_freq``."""
    if orig_freq == new_freq:
        return x
    gcd = math.gcd(orig_freq, new_freq)
    of, nf = orig_freq // gcd, new_freq // gcd
    kernels, width = _sinc_kernel(of, nf, lowpass_filter_width, rolloff)

    length = x.shape[-1]
    lead_shape = x.shape[:-1]
    xf = F.pad(x.reshape(-1, 1, length), (width, width + of))
    filt = torch.as_tensor(kernels, device=x.device)[:, None, :]
    out = F.conv1d(xf, filt, stride=of)  # (B, nf, n_blocks)
    out = out.transpose(1, 2).reshape(xf.shape[0], -1)
    target = resample_length(length, orig_freq, new_freq)
    return out[..., :target].reshape(*lead_shape, target)
