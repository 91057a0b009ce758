"""Model layer: the public names of ``ddsp_tpu/models/__init__.py``
(synthesizer modules, control networks, encoders, CREPE).  Importing them
builds no kernel."""

from ddsp_tpu_torch.models.autoencoder import (
    autoencoder_apply,
    autoencoder_init,
    encode,
    feature_pad,
)
from ddsp_tpu_torch.models.controller import (
    controller_apply,
    controller_init,
    decoder_apply,
    decoder_init,
    decoder_synth_only,
    modified_sigmoid,
)
from ddsp_tpu_torch.models.crepe import (
    crepe_forward,
    crepe_init,
    load_torch_checkpoint,
    pitch_argmax,
    pitch_weighted,
)
from ddsp_tpu_torch.models.encoder import (
    encoder_apply,
    f0_encoder_apply,
    loudness_encoder_apply,
)
from ddsp_tpu_torch.models.synths import (
    noise_apply,
    oscillator_apply,
    oscillator_live,
    reverb_apply,
    reverb_impulse,
    reverb_init,
    reverb_live,
)

__all__ = [
    "autoencoder_apply",
    "autoencoder_init",
    "encode",
    "feature_pad",
    "controller_apply",
    "controller_init",
    "decoder_apply",
    "decoder_init",
    "decoder_synth_only",
    "modified_sigmoid",
    "crepe_forward",
    "crepe_init",
    "load_torch_checkpoint",
    "pitch_argmax",
    "pitch_weighted",
    "encoder_apply",
    "f0_encoder_apply",
    "loudness_encoder_apply",
    "noise_apply",
    "oscillator_apply",
    "oscillator_live",
    "reverb_apply",
    "reverb_impulse",
    "reverb_init",
    "reverb_live",
]
