"""Multi-scale spectral (MSS) reconstruction loss.

Counterpart of ``ddsp_tpu/losses.py`` (reference loss/mss_loss.py:11-68):
per-scale loss = L1(|S|^2) + alpha * L1(log2(|S|^2 + eps)) with
torchaudio-Spectrogram conventions (power-2 magnitudes, hop = n_fft * (1 -
overlap), centred reflect padding, periodic Hann), summed over FFT sizes.

``matmul_dtype`` is the JAX package's: ``torch.bfloat16`` (the training
default, ``Config.loss_matmul_dtype``) sends each spectrogram through the
bf16 power-STFT kernels when ``ops/spectral.set_stft_impl('pallas')`` is
set; otherwise, and for ``None``, the spectrograms are float32
``torch.stft`` (ops/spectral.py).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from ddsp_tpu_torch.ops.spectral import spectrogram

DEFAULT_FFTS: Tuple[int, ...] = (2048, 1024, 512, 256, 128, 64)


def _as_audio(x, signal_key: str) -> torch.Tensor:
    """Reference MSSLoss dict-input convention (loss/mss_loss.py:57-62):
    prediction dicts are read at ``signal_key`` ('audio_reverb' when
    use_reverb else 'audio_synth'), target dicts at 'audio'."""
    return x[signal_key] if isinstance(x, dict) else x


def _scale_loss(s_pred, s_true, alpha: float, eps: float) -> torch.Tensor:
    linear_term = torch.mean(torch.abs(s_pred - s_true))
    log_term = torch.mean(torch.abs(torch.log2(s_true + eps) - torch.log2(s_pred + eps)))
    return linear_term + alpha * log_term


def sss_loss(
    pred: torch.Tensor,
    true: torch.Tensor,
    n_fft: int,
    alpha: float = 1.0,
    overlap: float = 0.75,
    eps: float = 1e-7,
    matmul_dtype=None,
) -> torch.Tensor:
    """Single-scale spectral loss (reference loss/mss_loss.py:11-33)."""
    hop = int(n_fft * (1 - overlap))
    return _scale_loss(
        spectrogram(pred, n_fft, hop, matmul_dtype),
        spectrogram(true, n_fft, hop, matmul_dtype),
        alpha, eps,
    )


def mss_loss(
    pred,
    true,
    ffts: Sequence[int] = DEFAULT_FFTS,
    alpha: float = 1.0,
    overlap: float = 0.75,
    eps: float = 1e-7,
    matmul_dtype=None,
    use_reverb: bool = True,
) -> torch.Tensor:
    """Multi-scale spectral loss (reference loss/mss_loss.py:36-68); dict
    inputs follow the reference's MSSLoss convention (``_as_audio``)."""
    pred = _as_audio(pred, "audio_reverb" if use_reverb else "audio_synth")
    true = _as_audio(true, "audio")
    return sum(sss_loss(pred, true, n, alpha, overlap, eps, matmul_dtype) for n in ffts)


def mss_loss_per_scale(
    pred: torch.Tensor,
    true: torch.Tensor,
    ffts: Sequence[int] = DEFAULT_FFTS,
    alpha: float = 1.0,
    overlap: float = 0.75,
    eps: float = 1e-7,
    matmul_dtype=None,
) -> Dict[str, torch.Tensor]:
    """Per-scale loss terms, for structured training metrics."""
    return {
        f"mss_{n}": sss_loss(pred, true, n, alpha, overlap, eps, matmul_dtype)
        for n in ffts
    }


# --- cached-target variant ---------------------------------------------------
# A training set's target audio is fixed, so its spectrograms are dataset
# constants: computed once (target_spectrograms), gathered per batch, and
# the loss reads them instead of transforming the target every step.

def target_mag_key(n_fft: int) -> str:
    return f"mss_target_mag_{n_fft}"


def target_spectrograms(
    true: torch.Tensor,
    ffts: Sequence[int] = DEFAULT_FFTS,
    overlap: float = 0.75,
    matmul_dtype=None,
) -> Dict[str, torch.Tensor]:
    """Per-scale power spectrograms of the (fixed) target audio."""
    return {
        target_mag_key(n): spectrogram(true, n, int(n * (1 - overlap)), matmul_dtype)
        for n in ffts
    }


def mss_loss_per_scale_cached(
    pred: torch.Tensor,
    target_mags: Dict[str, torch.Tensor],
    ffts: Sequence[int] = DEFAULT_FFTS,
    alpha: float = 1.0,
    overlap: float = 0.75,
    eps: float = 1e-7,
    matmul_dtype=None,
) -> Dict[str, torch.Tensor]:
    """Per-scale loss terms against precomputed target spectrograms: the
    same math as :func:`mss_loss_per_scale` when ``target_mags`` came from
    :func:`target_spectrograms` with the same FFT sizes, overlap and
    ``matmul_dtype``."""
    out = {}
    for n in ffts:
        s_pred = spectrogram(pred, n, int(n * (1 - overlap)), matmul_dtype)
        out[f"mss_{n}"] = _scale_loss(s_pred, target_mags[target_mag_key(n)], alpha, eps)
    return out
