"""Feature encoders: CREPE f0 + A-weighted loudness.

Counterpart of ``ddsp_tpu/models/encoder.py`` (reference
model/autoencoder/encoder.py:13-177):

* f0: resample to 16 kHz, per-example mean/std normalisation (unbiased
  std, as torch), the aligned CREPE hop ``int(hop * (resampled_len -
  1024) / (orig_len - n_fft))`` so that CREPE frames equal STFT frames
  (the 172-frame contract; on long inputs, where that integer hop
  drifts, the windows are placed at the exact hop so the counts still
  agree), frozen CREPE over unfolded 1024-sample
  windows (operands rounded to ``conf.crepe_compute_dtype`` when it is
  not 'float32', as in the JAX package), pitch decode by
  ``conf.pitch_decode`` ('argmax', 'weighted' or 'centered_ref');
* loudness: rectangular-window STFT dB + A-weighting, -90 dB floor
  mapping, mean over bins.

CREPE is frozen by default (the reference freezes it, encoder.py:35-37);
``freeze_crepe=False`` lets the gradient flow through the resampling, the
normalisation, the framing, CREPE and the decode into the CREPE weights
(analysis-by-synthesis finetuning, ``training/trainer.py``).
"""

from __future__ import annotations

from typing import Dict

import torch

from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.models.nn import compute_dtype_of
from ddsp_tpu_torch.models.crepe import (
    Crepe,
    crepe_forward,
    pitch_argmax,
    pitch_centered_ref,
    pitch_weighted,
)
from ddsp_tpu_torch.ops.resample import resample
from ddsp_tpu_torch.ops.spectral import a_weighted_loudness, frame_signal


def crepe_frame_hop(orig_len: int, resampled_len: int, conf: Config) -> int:
    """Aligned hop at 16 kHz so CREPE frames == STFT frames
    (encoder.py:66-68), guarding the lengths the reference divides by
    unchecked."""
    if orig_len <= conf.n_fft:
        raise ValueError(
            f"audio too short for the f0 encoder: {orig_len} samples <= "
            f"n_fft={conf.n_fft} (the 172-frame contract needs > n_fft; "
            "pad inputs with models.autoencoder.feature_pad)"
        )
    if resampled_len < conf.crepe_window:
        raise ValueError(
            f"resampled audio ({resampled_len} samples) shorter than the "
            f"CREPE window ({conf.crepe_window})"
        )
    hop = int(
        conf.hop_length * (resampled_len - conf.crepe_window) / (orig_len - conf.n_fft)
    )
    if hop < 1:
        raise ValueError(
            f"audio too short for the f0 encoder: the aligned CREPE hop "
            f"is {hop} (< 1) at {orig_len} samples; pad inputs with "
            "models.autoencoder.feature_pad"
        )
    return hop


_DECODERS = {
    "argmax": pitch_argmax,
    "weighted": pitch_weighted,
    "centered_ref": pitch_centered_ref,  # bug-compatible A/B variant
}


def _pitch_decoder(conf: Config):
    if conf.pitch_decode not in _DECODERS:
        raise ValueError(
            f"unknown pitch_decode {conf.pitch_decode!r}: expected one of "
            f"{sorted(_DECODERS)}"
        )
    return _DECODERS[conf.pitch_decode]


def aligned_crepe_frames(x: torch.Tensor, orig_len: int, n_frames: int,
                         conf: Config) -> torch.Tensor:
    """(B, T, window) CREPE windows of the 16 kHz signal ``x`` whose frame
    k starts at floor(k * h) for the aligned hop's exact value h =
    hop_length * (len(x) - window) / (orig_len - n_fft): ``n_frames``
    frames, the STFT's, over the whole signal.  The integer hop of
    :func:`crepe_frame_hop` drifts by its fraction every frame, so past a
    few seconds at 44.1 kHz it gives more CREPE frames than STFT frames
    (the JAX package then fails to join f0 and loudness)."""
    exact = conf.hop_length * (x.shape[-1] - conf.crepe_window) / (orig_len - conf.n_fft)
    starts = torch.floor(torch.arange(n_frames, dtype=torch.float64) * exact).long()
    idx = (starts[:, None] + torch.arange(conf.crepe_window)).to(x.device)
    return x[..., idx]


def f0_encoder_apply(
    crepe: Crepe, audio: torch.Tensor, conf: Config, freeze_crepe: bool = True
) -> Dict[str, torch.Tensor]:
    """(B, L) audio -> f0 features at the STFT frame rate:
    {'f0', 'harmonicity', 'probabilities', 'normalized_cents'}.

    Where the integer CREPE hop gives another frame count than the STFT's
    (long inputs), the windows are placed at the exact aligned hop instead
    (:func:`aligned_crepe_frames`); elsewhere the integer hop, as the JAX
    package, which on long inputs returns the extra frames.

    The frozen encoder runs under ``torch.no_grad``; with
    ``freeze_crepe=False`` the whole encoder is differentiable (the unbiased
    std's ``+1e-8`` included), so a differentiable decode passes gradient
    into every CREPE weight.
    """
    decode = _pitch_decoder(conf)
    with torch.set_grad_enabled(not freeze_crepe and torch.is_grad_enabled()):
        orig_len = audio.shape[-1]
        x = resample(audio, conf.sample_rate, conf.crepe_sample_rate)
        mean = x.mean(dim=-1, keepdim=True)
        std = x.std(dim=-1, keepdim=True)  # unbiased, as the reference's torch
        # the epsilon keeps a digitally silent example finite
        x = (x - mean) / (std + 1e-8)
        hop = crepe_frame_hop(orig_len, x.shape[-1], conf)
        frames = frame_signal(x, conf.crepe_window, hop)  # (B, T, 1024)
        n_frames = (orig_len - conf.n_fft) // conf.hop_length + 1  # the STFT's
        if frames.shape[-2] != n_frames:
            frames = aligned_crepe_frames(x, orig_len, n_frames, conf)
        b, t, w = frames.shape
        probs = crepe_forward(
            crepe, frames.reshape(b * t, w),
            compute_dtype=compute_dtype_of(conf.crepe_compute_dtype),
        ).reshape(b, t, -1)
        freq, harmonicity, normalized_cents = decode(probs)
    return {
        "f0": freq,
        "harmonicity": harmonicity,
        "probabilities": probs,
        "normalized_cents": normalized_cents,
    }


def loudness_encoder_apply(audio: torch.Tensor, conf: Config) -> torch.Tensor:
    """(B, L) audio -> (B, T, 1) A-weighted loudness (encoder.py:131-156)."""
    return a_weighted_loudness(audio, conf.n_fft, conf.hop_length, conf.sample_rate)


def encoder_apply(
    crepe: Crepe, audio: torch.Tensor, conf: Config, freeze_crepe: bool = True
) -> Dict[str, torch.Tensor]:
    """Joint feature dict (reference Encoder.forward, encoder.py:159-177)."""
    result = f0_encoder_apply(crepe, audio, conf, freeze_crepe)
    result["loudness"] = loudness_encoder_apply(audio, conf)
    return result
