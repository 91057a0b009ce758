"""Autoencoder facade: analysis (encoder) -> synthesis (decoder).

Counterpart of ``ddsp_tpu/models/autoencoder.py`` (reference
model/autoencoder/autoencoder.py:9-32): pad the input by ``n_fft - hop``
split half and half, so that encoder frames x hop equals the example length
(the 172-frame / 88,064-sample contract), encode, decode.  The JAX
package's parameter pytree ``{'decoder', 'crepe'}`` is an ``nn.ModuleDict``
with those two keys here.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.models.controller import decoder_apply, decoder_init
from ddsp_tpu_torch.models.crepe import crepe_init, load_torch_checkpoint
from ddsp_tpu_torch.models.encoder import encoder_apply
from ddsp_tpu_torch.ops.fir import split
from ddsp_tpu_torch.utils.profiling import named_scope


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


def autoencoder_init(
    key: torch.Tensor, conf: Config, crepe_checkpoint: Optional[str] = None
) -> nn.ModuleDict:
    """``{'decoder', 'crepe'}`` from a (2,) threefry key: ``kd, kc =
    split(key)`` as the JAX package splits it; the decoder's torch init is
    seeded from ``kd``, CREPE's from ``kc`` unless ``crepe_checkpoint``
    names a reference ``.pth``.  On the CPU; ``.to(device)`` moves both."""
    kd, kc = split(key.cpu())
    crepe = (
        load_torch_checkpoint(crepe_checkpoint, conf.crepe_capacity)
        if crepe_checkpoint
        else crepe_init(conf.crepe_capacity, seed=int(kc[1]))
    )
    return nn.ModuleDict({"decoder": decoder_init(conf, seed=int(kd[1])), "crepe": crepe})


def autoencoder_apply(
    params,
    audio: torch.Tensor,
    conf: Config,
    noise_key: torch.Tensor,
    freeze_crepe: bool = True,
) -> torch.Tensor:
    """Reconstruct audio: encode (in the ``encoder`` span) -> decode
    (autoencoder.py:17-22).  ``freeze_crepe=False`` lets the gradient flow
    into CREPE (analysis-by-synthesis finetuning).  A decoder with z takes
    it from ``audio``."""
    with named_scope("encoder"):
        features = encode(params, audio, conf, freeze_crepe)
    return decoder_apply(params["decoder"], dict(features, audio=audio), conf, noise_key)
