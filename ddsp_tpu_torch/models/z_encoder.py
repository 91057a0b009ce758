"""The DDSP autoencoder's latent z(t): MFCCs -> instance norm -> GRU ->
dense, upsampled to the decoder's frames.

The port's own module (the JAX package has no z encoder): magenta/ddsp's
``encoders.MfccTimeDistributedRnnEncoder`` as ``ae.gin`` configures it
(Engel et al. 2020, arXiv:2001.04643, App. B), for a decoder built with
``Config.z_dims`` above 0.  For (B, L) audio:

* the MFCCs of ``ops/spectral.mfcc`` (20 to 8,000 Hz, 128 mel bins, the
  first 30 coefficients: magenta's ``compute_z``) over frames of twice
  the step, step = L // ``z_time_steps`` (magenta's overlap 0.5), so
  ceil(L / step) frames: ``z_time_steps`` where it divides L;
* ``nn.Normalize('instance')``: each example's coefficient over time,
  (x - mean) / sqrt(var + 1e-5) with the population variance, times the
  learned ``norm_scale`` plus ``norm_shift``;
* a GRU of ``z_rnn_units`` (the port's ``GRU``, so the G1/G2 gate kernels
  on the card) and a dense layer to ``z_dims``;
* ``core.resample(method='linear', add_endpoint=True)`` to the decoder's
  frames: frame t reads (1 - a) z[i] + a z[i + 1] at i + a = t n_z / T,
  the last z frame held.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.models.nn import GRU
from ddsp_tpu_torch.ops.spectral import mfcc

# magenta's compute_z
MFCC_LO_HZ, MFCC_HI_HZ = 20.0, 8000.0
MEL_BINS, MFCC_BINS = 128, 30
NORM_EPS = 1e-5


class ZEncoder(nn.Module):
    def __init__(self, conf: Config):
        super().__init__()
        self.norm_scale = nn.Parameter(torch.ones(MFCC_BINS))
        self.norm_shift = nn.Parameter(torch.zeros(MFCC_BINS))
        self.gru = GRU(MFCC_BINS, conf.z_rnn_units)
        self.dense_z = nn.Linear(conf.z_rnn_units, conf.z_dims)


@functools.lru_cache(maxsize=None)
def _upsample_matrix(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """(n_out, n_in): row t holds 1 - a at i and a at min(i + 1, n_in - 1),
    i + a = t n_in / n_out."""
    w = np.zeros((n_out, n_in))
    num = np.arange(n_out) * n_in
    i, a = num // n_out, (num % n_out) / n_out
    np.add.at(w, (np.arange(n_out), i), 1.0 - a)
    np.add.at(w, (np.arange(n_out), np.minimum(i + 1, n_in - 1)), a)
    return torch.as_tensor(w, dtype=torch.float32, device=device)


def upsample_z(z: torch.Tensor, frames: int) -> torch.Tensor:
    """(B, n_z, D) -> (B, frames, D), linear with the endpoint held."""
    return _upsample_matrix(z.shape[1], frames, z.device) @ z


def z_encoder_apply(encoder: ZEncoder, audio: torch.Tensor, conf: Config,
                    frames: int) -> torch.Tensor:
    """(B, L) audio -> z (B, frames, z_dims)."""
    step = audio.shape[-1] // conf.z_time_steps
    x = mfcc(audio, conf.sample_rate, 2 * step, step, MEL_BINS, MFCC_BINS, MFCC_LO_HZ, MFCC_HI_HZ)
    mean = x.mean(1, keepdim=True)
    var = ((x - mean) ** 2).mean(1, keepdim=True)
    x = (x - mean) / torch.sqrt(var + NORM_EPS) * encoder.norm_scale + encoder.norm_shift
    seq, _ = encoder.gru(x)
    return upsample_z(encoder.dense_z(seq), frames)
