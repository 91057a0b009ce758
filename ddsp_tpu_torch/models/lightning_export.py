"""Export a decoder to the reference's torch layout (a Lightning ``.ckpt``).

Counterpart of ``ddsp_tpu/models/torch_export.py``: the port's
:class:`Decoder` already keeps the reference's parameter names and layouts,
so the export adds only the keys the reference ``Decoder`` registers but
does not learn (reference model/autoencoder/decoder.py:119-135), so that a
``strict=True`` load succeeds, and the training module's wrapping.
``models/convert.load_lightning_decoder`` reads the file back bit-equal.
"""

from __future__ import annotations

import warnings
from typing import Dict

import torch

from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.models.controller import Decoder


def state_dict_from_decoder(decoder: Decoder, conf: Config) -> Dict[str, torch.Tensor]:
    """:class:`Decoder` -> the reference Decoder's ``state_dict``: the
    learned tensors (float32, on the CPU) plus the oscillator's harmonic
    numbers and streaming-phase state (reference harmonic_oscillator.py:15-21,
    int64) and the reverb's time ramp and live buffer (reference
    reverb.py:19-22).  Warns when the reverb's length is not one second,
    which the reference hardwires."""
    sd = {k: v.detach().to("cpu", torch.float32).clone()
          for k, v in decoder.state_dict().items()}
    n_h = int(conf.n_harmonics)
    sd["harmonics.harmonics"] = torch.arange(1, n_h + 1, step=1)
    sd["harmonics.last_phases"] = torch.zeros(n_h, dtype=torch.int64)
    length = int(sd["reverb.noise"].shape[-1])
    if length != int(conf.sample_rate):
        warnings.warn(
            f"reverb IR length {length} != sample_rate {conf.sample_rate}: "
            "the reference Reverb hardwires a 1 s (sample_rate-tap) IR "
            "(reference model/ddsp/reverb.py:10-22), so its Decoder will "
            "fail a strict=True load of this checkpoint",
            stacklevel=2,
        )
    sd["reverb.t"] = (torch.arange(length) / conf.sample_rate).reshape(1, -1)
    sd["reverb.buffer"] = torch.zeros(1, length)
    return sd


def save_torch_decoder(decoder: Decoder, conf: Config, path: str,
                       lightning: bool = True, step: int = 0) -> None:
    """Write the decoder as a torch checkpoint file: with
    ``lightning=True`` the way the reference's training module saves it
    (``{'state_dict': {'model.' + k: v}, 'epoch', 'global_step'}``), which
    the reference's ``rt/utils.load_checkpoint`` reads; else the bare
    Decoder state dict."""
    sd = state_dict_from_decoder(decoder, conf)
    if lightning:
        blob = {
            "state_dict": {"model." + k: v for k, v in sd.items()},
            "epoch": int(step),
            "global_step": int(step),
        }
    else:
        blob = sd
    torch.save(blob, path)
