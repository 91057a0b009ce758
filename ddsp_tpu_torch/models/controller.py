"""Control network: (f0, loudness) features -> synthesis controls.

Counterpart of ``ddsp_tpu/models/controller.py`` (reference
model/autoencoder/decoder.py:41-147): two input MLPs -> GRU -> MLP -> three
dense heads through ``modified_sigmoid``.  The streaming path returns the
advanced GRU state (the reference returns the stale one).
``decoder_apply`` wires the controls into oscillator + noise + reverb,
each stage inside a ``torch.profiler.record_function`` range (controller,
oscillator_bank, filtered_noise, reverb), the counterparts of the JAX
package's ``named_scope``s.

``Config.compute_dtype`` other than 'float32' runs the three MLPs with
the JAX package's roundings to that dtype (``models/nn.MLP``), in
``decoder_apply`` and ``decoder_synth_only`` only, where the JAX package
reads it; the GRU and the dense heads stay float32, and so do the stream
steps, which call ``controller_apply`` without it, as the JAX ones do.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.models.nn import GRU, MLP, compute_dtype_of
from ddsp_tpu_torch.models.synths import (
    Reverb,
    noise_apply,
    oscillator_apply,
    reverb_apply,
)


def modified_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """2 * sigmoid(x)^2.3026 + 1e-7: the reference's literal exponent
    (decoder.py:110-116), not log(10)."""
    return 2.0 * torch.sigmoid(x) ** 2.3026 + 1e-7


class Controller(nn.Module):
    def __init__(self, conf: Config):
        super().__init__()
        units, layers = conf.decoder_mlp_units, conf.decoder_mlp_layers
        gru_units = conf.decoder_gru_units
        self.mlp_f0 = MLP(1, units, layers)
        self.mlp_loudness = MLP(1, units, layers)
        self.gru = GRU(2 * units, gru_units, conf.decoder_gru_layers)
        self.mlp_gru = MLP(gru_units + 2 * units, units, layers)
        self.dense_harmonic = nn.Linear(units, conf.n_harmonics)
        self.dense_loudness = nn.Linear(units, 1)
        self.dense_filter = nn.Linear(units, conf.n_noise_filters)

    def forward(
        self,
        batch: Dict[str, torch.Tensor],
        hidden: Optional[torch.Tensor] = None,
        compute_dtype: Optional[torch.dtype] = None,
    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        latent_f0 = self.mlp_f0(batch["normalized_cents"], compute_dtype)
        latent_loud = self.mlp_loudness(batch["loudness"], compute_dtype)
        latent, new_hidden = self.gru(
            torch.cat([latent_f0, latent_loud], dim=-1), hidden
        )
        latent = self.mlp_gru(torch.cat([latent, latent_f0, latent_loud], -1),
                              compute_dtype)
        controls = {
            "f0": batch["f0"],
            "c": modified_sigmoid(self.dense_harmonic(latent)),
            "a": modified_sigmoid(self.dense_loudness(latent)),
            "H": modified_sigmoid(self.dense_filter(latent)),
        }
        return controls, new_hidden


class Decoder(nn.Module):
    """Controller plus reverb parameters; ``state_dict`` keys are the
    learned keys of the reference Decoder (``controller.*``,
    ``reverb.{noise,decay,wet}``)."""

    def __init__(self, conf: Config):
        super().__init__()
        self.controller = Controller(conf)
        self.reverb = Reverb(conf)


def controller_init(conf: Config, seed: int = 0) -> Controller:
    """A :class:`Controller` with torch's default init drawn from ``seed``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return Controller(conf)


def decoder_init(conf: Config, seed: int = 0) -> Decoder:
    """A :class:`Decoder` with random weights drawn from ``seed``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return Decoder(conf)


def controller_apply(
    controller: Controller,
    batch: Dict[str, torch.Tensor],
    hidden: Optional[torch.Tensor] = None,
    compute_dtype: Optional[torch.dtype] = None,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Map features to synthesis controls.

    Args:
      batch: {'normalized_cents', 'loudness', 'f0'}, each (B, T, 1).
      hidden: optional (layers, B, H) GRU state.
      compute_dtype: the MLPs' low-precision dtype, or None for float32.

    Returns:
      (controls {f0, c, a, H}, advanced hidden state).
    """
    return controller(batch, hidden, compute_dtype)


def decoder_apply(
    params: Decoder,
    batch: Dict[str, torch.Tensor],
    conf: Config,
    noise_key: torch.Tensor,
    frame_chunk: Optional[int] = None,
    noise_row_offset: int = 0,
) -> torch.Tensor:
    """Full offline decode: controls -> harmonics + noise -> reverb.

    The reference Decoder.forward (decoder.py:127-135).  ``batch`` holds
    {'normalized_cents', 'loudness', 'f0'}, each (B, T, 1); ``noise_key``
    is a (2,) threefry key; ``noise_row_offset`` is the first row's index
    in the whole batch, whose row keys the noise takes (a data-parallel
    rank's rows, ``parallel/train.py``).  Returns (B, T*hop) audio.
    """
    with record_function("controller"):
        controls, _ = controller_apply(params.controller, batch,
                                       compute_dtype=compute_dtype_of(conf.compute_dtype))
    with record_function("oscillator_bank"):
        harm, _ = oscillator_apply(controls, conf, frame_chunk=frame_chunk)
    with record_function("filtered_noise"):
        noise = noise_apply(controls, conf, noise_key, noise_row_offset)
    with record_function("reverb"):
        return reverb_apply(params.reverb, harm + noise, conf)


def decoder_synth_only(
    params: Decoder,
    batch: Dict[str, torch.Tensor],
    conf: Config,
    noise_key: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """Decode returning the pre- and post-reverb signals and the controls."""
    controls, _ = controller_apply(params.controller, batch,
                                   compute_dtype=compute_dtype_of(conf.compute_dtype))
    harm, _ = oscillator_apply(controls, conf)
    noise = noise_apply(controls, conf, noise_key)
    dry = harm + noise
    return {
        "audio_harmonic": harm,
        "audio_noise": noise,
        "audio_synth": dry,
        "audio_reverb": reverb_apply(params.reverb, dry, conf),
        "controls": controls,
    }
