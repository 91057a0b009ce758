"""Autoencoder facade: analysis (encoder) -> synthesis (decoder).

Counterpart of ``feature_pad`` and ``encode`` in
``ddsp_tpu/models/autoencoder.py`` (reference
model/autoencoder/autoencoder.py:9-32): pad the input by ``n_fft - hop``
split half and half, so that encoder frames x hop equals the example length
(the 172-frame / 88,064-sample contract), then encode.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.models.encoder import encoder_apply


def feature_pad(audio: torch.Tensor, conf: Config) -> torch.Tensor:
    """Zero-pad (B, L) audio by (n_fft - hop)/2 on each side
    (autoencoder.py:17-18)."""
    padding = conf.n_fft - conf.hop_length
    return F.pad(audio, (padding // 2, padding - padding // 2))


def encode(
    params: Dict, audio: torch.Tensor, conf: Config, freeze_crepe: bool = True
) -> Dict[str, torch.Tensor]:
    """(B, L) audio -> feature dict at frame rate, with the contract
    padding.  ``params`` holds the CREPE module under 'crepe'."""
    return encoder_apply(params["crepe"], feature_pad(audio, conf), conf, freeze_crepe)
