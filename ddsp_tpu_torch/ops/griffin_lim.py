"""STFT inversion: complex STFT, overlap-add iSTFT, Griffin-Lim.

Counterpart of ``ddsp_tpu/ops/griffin_lim.py``, which the style-transfer
experiment inverts its spectrogram with (the reference calls torchaudio's
``griffinlim`` with momentum, reference: style_transfer.py:145-156).  The
transforms run on ``torch.fft`` through ``ops/fft.rfft_pair`` /
``irfft_pair``; the overlap-add is one ``F.fold`` over all frames, divided
by the squared-window sum (COLA) formed on the host in float64.  The
functions run where their tensors are.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ddsp_tpu_torch.ops.fft import irfft_pair, rfft_pair
from ddsp_tpu_torch.ops.fir import PRNGKey, uniform
from ddsp_tpu_torch.ops.spectral import _window, frame_signal, reflect_pad


@functools.lru_cache(maxsize=8)
def _cola_divisor(n_fft: int, hop: int, t: int, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """max(sum of the frames' squared periodic Hann windows, 1e-11) over the
    (n_fft + hop (t - 1))-sample output, summed in float64 on the host."""
    out_len = n_fft + hop * (t - 1)
    w2 = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)) ** 2
    wsq = np.zeros(out_len, np.float64)
    for i in range(t):
        wsq[i * hop : i * hop + n_fft] += w2
    return torch.as_tensor(np.maximum(wsq, 1e-11), dtype=dtype, device=device)


def stft_pair(
    x: torch.Tensor, n_fft: int, hop: int, center: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Complex STFT as (re, im), shape (..., frames, n_fft//2+1)."""
    if center:
        x = reflect_pad(x, n_fft // 2)
    frames = frame_signal(x, n_fft, hop) * _window(n_fft, x.dtype, x.device)
    return rfft_pair(frames)


def istft(
    re: torch.Tensor,
    im: torch.Tensor,
    n_fft: int,
    hop: int,
    length: Optional[int] = None,
    center: bool = True,
) -> torch.Tensor:
    """Inverse STFT by windowed overlap-add with COLA normalization."""
    frames = irfft_pair(re, im, n_fft) * _window(n_fft, re.dtype, re.device)
    lead, t = frames.shape[:-2], frames.shape[-2]
    out_len = n_fft + hop * (t - 1)
    cols = frames.reshape(-1, t, n_fft).transpose(1, 2)  # (N, n_fft, t)
    sig = F.fold(cols, (1, out_len), (1, n_fft), stride=(1, hop))
    sig = sig.reshape(*lead, out_len) / _cola_divisor(n_fft, hop, t, frames.dtype,
                                                      frames.device)
    if center:
        sig = sig[..., n_fft // 2 : out_len - n_fft // 2]
    if length is not None:
        sig = sig[..., :length]
    return sig


def griffin_lim(
    magnitude: torch.Tensor,
    n_fft: int,
    hop: int,
    n_iter: int = 32,
    momentum: float = 0.99,
    length: Optional[int] = None,
    key: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Phase retrieval from a magnitude spectrogram (torchaudio-style
    momentum), ``ddsp_tpu/ops/griffin_lim.py:64-106`` step for step.

    Args:
      magnitude: (..., frames, n_fft//2+1) linear magnitudes.
      key: a threefry key (``ops/fir.PRNGKey``; default ``PRNGKey(0)``):
        the initial angles are ``jax.random.uniform(key, shape, 0, 2 pi)``
        bit for bit.
    """
    key = PRNGKey(0) if key is None else key
    ang = uniform(key.to(magnitude.device), magnitude.shape, 0.0, 2 * np.pi,
                  magnitude.dtype)
    re, im = magnitude * torch.cos(ang), magnitude * torch.sin(ang)
    pre, pim = torch.zeros_like(re), torch.zeros_like(im)
    for _ in range(n_iter):
        nre, nim = stft_pair(istft(re, im, n_fft, hop, length), n_fft, hop)
        # momentum acceleration on the unnormalized rebuilt spectrum
        are = nre - (momentum / (1 + momentum)) * pre
        aim = nim - (momentum / (1 + momentum)) * pim
        mag = torch.sqrt(are**2 + aim**2) + 1e-16
        re, im = magnitude * are / mag, magnitude * aim / mag
        pre, pim = nre, nim
    return istft(re, im, n_fft, hop, length)
