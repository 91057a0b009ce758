"""Framing, the loss spectrogram and A-weighted loudness.

Counterpart of ``ddsp_tpu/ops/spectral.py``:

* ``spectrogram``: torchaudio ``Spectrogram(n_fft, hop)`` conventions, as
  the reference MSS loss uses them (loss/mss_loss.py:23) -- centre reflect
  padding, periodic Hann window, ``|X|^2``, output (..., bins, T).  By
  default a float32 ``torch.stft``; after ``set_stft_impl('pallas')`` the
  bf16 loss spectrograms go through the hand-written CUDA power-STFT
  kernels (``ops/cuda/stft.py``), routed exactly as the JAX package routes
  its Pallas kernels.  The JAX package's XLA hop-blocked and
  phase-decimated matmul forms are TPU layouts of the transform and are
  not ported;
* loudness: ``torch.stft(center=False)`` with no window and the librosa
  A-weighting curve, as in the reference loudness encoder
  (encoder.py:135-156);
* ``mfcc``: the z encoder's MFCCs, as magenta/ddsp's
  ``spectral_ops.compute_mfcc`` computes them (the port's own: the JAX
  package has no z encoder).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

import torch.nn.functional as F

from ddsp_tpu_torch.ops.cuda.stft import StftPower
from ddsp_tpu_torch.ops.fft import DIRECT_MAX, rfft_pair
from ddsp_tpu_torch.ops.fir import hann_window


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """(..., L) -> (..., n_frames, frame_length) overlapping frames."""
    return x.unfold(-1, frame_length, hop)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last axis (torch 'reflect': no edge repeat)."""
    lead = x.shape[:-1]
    out = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
    return out.reshape(*lead, out.shape[-1])


@functools.lru_cache(maxsize=None)
def _window(n_fft: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return hann_window(n_fft, dtype, device)


# STFT implementation switch, named as in the JAX package.  'auto' ==
# 'xla': the float32 torch.stft.  'pallas' selects the hand-written CUDA
# power-STFT kernels (K3 forward, K4 backward; their plain versions on a
# CPU tensor) wherever the JAX package would take its Pallas kernels.
_STFT_IMPL = "auto"


def set_stft_impl(impl: str) -> None:
    """Select the loss spectrogram's route: 'auto' | 'xla' | 'pallas'."""
    global _STFT_IMPL
    if impl not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown STFT impl {impl!r}: expected 'auto', 'xla' or 'pallas'")
    _STFT_IMPL = impl


def hop_blocks(x: torch.Tensor, n_fft: int, hop: int) -> Tuple[torch.Tensor, int]:
    """(..., L) -> (hop blocks (N, Lp/hop, hop), n_frames): reflect-pad by
    ``n_fft // 2``, zero-pad to a hop multiple and view; N is the product
    of the leading axes.  Ordinary autograd, as the JAX package keeps it
    outside its ``custom_vjp``."""
    xp = reflect_pad(x, n_fft // 2).reshape(-1, x.shape[-1] + n_fft)
    lp = xp.shape[-1]
    lb = -(-lp // hop) * hop
    if lb > lp:
        xp = F.pad(xp, (0, lb - lp))
    return xp.reshape(xp.shape[0], lb // hop, hop), 1 + (lp - n_fft) // hop


def spectrogram_power_blocked(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Power spectrogram through the power-STFT kernel pair: (..., L) ->
    (..., bins, T), :func:`hop_blocks` then
    :class:`~ddsp_tpu_torch.ops.cuda.stft.StftPower`
    (``ddsp_tpu/ops/pallas/stft.py:spectrogram_power_pallas``)."""
    xb, n_frames = hop_blocks(x, n_fft, hop)
    mag = StftPower.apply(xb, n_fft, hop, n_frames)
    return mag.reshape(*x.shape[:-1], n_frames, n_fft // 2 + 1).transpose(-1, -2)


def spectrogram(
    x: torch.Tensor, n_fft: int, hop: int, matmul_dtype=None
) -> torch.Tensor:
    """torchaudio-convention power spectrogram: (..., L) -> (..., n_fft//2+1, T).

    Centre reflect padding by ``n_fft // 2``, periodic Hann window,
    ``|rfft|^2``.  With ``set_stft_impl('pallas')``, ``matmul_dtype=
    torch.bfloat16``, ``hop`` dividing ``n_fft`` and ``n_fft <= 4096`` (the
    conditions of ``ddsp_tpu/ops/spectral.py:189-200``) it runs the
    power-STFT kernels on bf16 inputs with float32 sums; otherwise a
    float32 ``torch.stft`` (cuFFT has no bf16 transform, so there
    ``matmul_dtype`` changes nothing).
    """
    if (
        _STFT_IMPL == "pallas"
        and matmul_dtype == torch.bfloat16
        and n_fft % hop == 0
        and n_fft <= DIRECT_MAX
    ):
        return spectrogram_power_blocked(x, n_fft, hop)
    lead = x.shape[:-1]
    spec = torch.stft(
        x.reshape(-1, x.shape[-1]), n_fft, hop_length=hop,
        window=_window(n_fft, x.dtype, x.device), center=True,
        pad_mode="reflect", return_complex=True,
    )
    mag = spec.real * spec.real + spec.imag * spec.imag
    return mag.reshape(*lead, *mag.shape[-2:])


def stft_magnitude_nocenter(
    x: torch.Tensor, n_fft: int, hop: int
) -> torch.Tensor:
    """|STFT| with center=False and a rectangular window,
    (..., T, n_fft//2+1)."""
    re, im = rfft_pair(frame_signal(x, n_fft, hop))
    return torch.sqrt(re * re + im * im)


@functools.lru_cache(maxsize=None)
def a_weighting(n_fft: int, sample_rate: int, min_db: float = -80.0) -> np.ndarray:
    """A-weighting in dB for the rfft bin frequencies (librosa formula)."""
    freqs = np.linspace(0, sample_rate / 2, 1 + n_fft // 2, dtype=np.float64)
    f_sq = freqs**2
    const = np.array([12194.217, 20.598997, 107.65265, 737.86223]) ** 2
    with np.errstate(divide="ignore"):
        weights = 2.0 + 20.0 * (
            np.log10(const[0])
            + 2 * np.log10(np.where(f_sq > 0, f_sq, 1.0))
            - np.log10(f_sq + const[0])
            - np.log10(f_sq + const[1])
            - 0.5 * np.log10(f_sq + const[2])
            - 0.5 * np.log10(f_sq + const[3])
        )
        weights = np.where(f_sq > 0, weights, -np.inf)
    return np.maximum(min_db, weights).astype(np.float32)


def a_weighted_loudness(
    x: torch.Tensor, n_fft: int, hop: int, sample_rate: int
) -> torch.Tensor:
    """Per-frame A-weighted loudness, (..., T, 1): dB of the rectangular
    STFT magnitudes plus A-weighting, mapped by ``db/90 + 1`` and averaged
    over bins."""
    mag = stft_magnitude_nocenter(x, n_fft, hop)
    db = 20.0 * torch.log10(mag + 1e-20)
    db = db + torch.as_tensor(a_weighting(n_fft, sample_rate), device=x.device)
    return (db / 90.0 + 1.0).mean(dim=-1, keepdim=True)


MEL_FLOOR = 1e-5  # magenta's safe_log: log(max(x, 1e-5))


def hz_to_mel(f):
    """HTK mel: 1127 ln(1 + f / 700)."""
    return 1127.0 * np.log1p(np.asarray(f, dtype=np.float64) / 700.0)


@functools.lru_cache(maxsize=None)
def mel_matrix(n_mels: int, n_bins: int, sample_rate: int, lo_hz: float,
               hi_hz: float) -> np.ndarray:
    """(n_bins, n_mels) float64 weights of ``tf.signal.linear_to_mel_weight_matrix``:
    n_mels + 2 edges evenly spaced in mel from ``lo_hz`` to ``hi_hz``,
    triangles max(0, min(rising, falling)) over the bins' mel, the DC row
    zero."""
    mel = hz_to_mel(np.linspace(0.0, sample_rate / 2.0, n_bins)[1:])[:, None]
    edges = np.linspace(hz_to_mel(lo_hz), hz_to_mel(hi_hz), n_mels + 2)
    lower, centre, upper = edges[None, :-2], edges[None, 1:-1], edges[None, 2:]
    w = np.maximum(0.0, np.minimum((mel - lower) / (centre - lower),
                                   (upper - mel) / (upper - centre)))
    return np.concatenate([np.zeros((1, n_mels)), w])


@functools.lru_cache(maxsize=None)
def dct_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float64: the first ``n_out`` coefficients of the DCT-II,
    2 sum_n x_n cos(pi k (2n + 1) / 2N), times 1 / sqrt(2N)
    (``tf.signal.mfccs_from_log_mel_spectrograms``)."""
    n = np.arange(n_in, dtype=np.float64)[:, None]
    k = np.arange(n_out, dtype=np.float64)[None, :]
    return 2.0 * np.cos(np.pi * k * (2.0 * n + 1.0) / (2.0 * n_in)) / np.sqrt(2.0 * n_in)


@functools.lru_cache(maxsize=None)
def _mfcc_mats(n_fft: int, sample_rate: int, n_mels: int, n_mfcc: int, lo_hz: float,
               hi_hz: float, device: torch.device):
    mel = mel_matrix(n_mels, n_fft // 2 + 1, sample_rate, lo_hz, hi_hz)
    return (torch.as_tensor(mel, dtype=torch.float32, device=device),
            torch.as_tensor(dct_matrix(n_mels, n_mfcc), dtype=torch.float32, device=device))


def mfcc(x: torch.Tensor, sample_rate: int, n_fft: int, hop: int, n_mels: int, n_mfcc: int,
         lo_hz: float, hi_hz: float) -> torch.Tensor:
    """(B, L) audio -> (B, ceil(L / hop), n_mfcc) MFCCs: |STFT| (periodic
    Hann, no centring, zeros padded at the end, ``pad_end``), the mel
    weights of :func:`mel_matrix` from ``lo_hz`` to ``hi_hz``,
    log(max(x, 1e-5)), and the DCT-II of :func:`dct_matrix`."""
    length = x.shape[-1]
    frames = -(-length // hop)
    xp = F.pad(x, (0, max(0, (frames - 1) * hop + n_fft - length)))
    spec = torch.stft(xp, n_fft, hop_length=hop, window=_window(n_fft, x.dtype, x.device),
                      center=False, return_complex=True)
    mel, dct = _mfcc_mats(n_fft, sample_rate, n_mels, n_mfcc, lo_hz, hi_hz, x.device)
    logmel = torch.log(torch.clamp(spec.abs().transpose(-1, -2) @ mel, min=MEL_FLOOR))
    return logmel @ dct
