"""Pure DSP primitive ops: the public names of ``ddsp_tpu/ops/__init__.py``.
Importing them builds no kernel (the CUDA wrappers build at first call)."""

from ddsp_tpu_torch.ops.fir import (
    amp_to_impulse_response,
    convolve_designed_fir,
    fft_convolve,
    filtered_noise,
    frame_noise,
    hann_window,
)
from ddsp_tpu_torch.ops.interp import upsample_linear
from ddsp_tpu_torch.ops.oscillator import (
    nyquist_normalized_amps,
    oscillator_bank,
    render_padded,
)
from ddsp_tpu_torch.ops.resample import resample, resample_length
from ddsp_tpu_torch.ops.spectral import (
    a_weighted_loudness,
    a_weighting,
    frame_signal,
    spectrogram,
    stft_magnitude_nocenter,
)

__all__ = [
    "amp_to_impulse_response",
    "convolve_designed_fir",
    "fft_convolve",
    "filtered_noise",
    "frame_noise",
    "hann_window",
    "upsample_linear",
    "nyquist_normalized_amps",
    "oscillator_bank",
    "render_padded",
    "resample",
    "resample_length",
    "a_weighted_loudness",
    "a_weighting",
    "frame_signal",
    "spectrogram",
    "stft_magnitude_nocenter",
]
