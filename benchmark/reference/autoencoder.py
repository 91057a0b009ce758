"""The DDSP autoencoder with a learned z(t) in plain PyTorch, float32,
from its published description (Engel et al. 2020, arXiv:2001.04643,
App. B; magenta/ddsp ``ae.gin``: ``MfccTimeDistributedRnnEncoder`` and
``RnnFcDecoder``), on kureta/ddsp-pytorch's decoder and synthesis
(``benchmark/reference/dsp.py``).

For (B, L) audio:

* MFCCs (magenta's ``spectral_ops.compute_mfcc``): |rDFT| of periodic-Hann
  frames of 2 step samples every step = L // ``z_time_steps`` (overlap
  0.5), zeros padded at the end to ceil(L / step) frames; the HTK-mel triangles
  of ``tf.signal.linear_to_mel_weight_matrix`` (20 to 8,000 Hz, the DC
  bin zero) of 128 mel bins; log(max(x, 1e-5)); the DCT-II scaled by
  1 / sqrt(2 N), the first 30 kept;
* instance norm over time with the population variance (eps 1e-5), times
  ``z_encoder.norm_scale`` plus ``z_encoder.norm_shift``;
* a GRU (gates reset, update, new) and a dense layer to ``z_dims``;
* z linearly upsampled to the decoder's frames, the last z frame held;
* the controller's three input MLPs (normalised cents, loudness, z), its
  GRU over their concatenation, its MLP over the GRU's output and the
  three, and the three heads; then the oscillator, the filtered noise,
  the reverb and the multi-scale spectral loss of ``dsp.py``.

The filtered noise's FIR is written here: a frame shorter than the
designed 2 (F - 1) taps takes the windowed zero-phase taps wrapped onto
it (the tap of time tau at tau mod the frame, those that meet summed),
where ``dsp.fir_from_magnitudes`` pads to a frame at least as long.  The
weights are one dict named as the program's ``state_dict``.  Imports
neither JAX nor the program.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference import dsp, threefry

W = Dict[str, torch.Tensor]

MFCC_LO_HZ, MFCC_HI_HZ = 20.0, 8000.0
MEL_BINS, MFCC_BINS = 128, 30
LOG_FLOOR = 1e-5
NORM_EPS = 1e-5


# ----------------------------------------------------------------- encoder


def hz_to_mel(f: torch.Tensor) -> torch.Tensor:
    return 1127.0 * torch.log(1.0 + f / 700.0)


def mel_weights(n_mels: int, n_fft: int, sample_rate: int, device) -> torch.Tensor:
    """(n_fft // 2 + 1, n_mels): row b (bin b's frequency in mel) through
    triangle m (edges m, m + 1, m + 2 of n_mels + 2 evenly spaced in mel),
    max(0, min(rising, falling)); the DC row zero."""
    f64 = dict(dtype=torch.float64, device=device)
    bins = torch.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1, **f64)
    mel = hz_to_mel(bins)[:, None]
    lo, hi = hz_to_mel(torch.tensor(MFCC_LO_HZ, **f64)), hz_to_mel(torch.tensor(MFCC_HI_HZ, **f64))
    edges = lo + (hi - lo) * torch.arange(n_mels + 2, **f64) / (n_mels + 1)
    rise = (mel - edges[:-2]) / (edges[1:-1] - edges[:-2])
    fall = (edges[2:] - mel) / (edges[2:] - edges[1:-1])
    w = torch.clamp(torch.minimum(rise, fall), min=0.0)
    w[0] = 0.0
    return w.float()


def dct_ii(n: int, keep: int, device) -> torch.Tensor:
    """(n, keep): y_k = 2 sum_i x_i cos(pi k (2 i + 1) / (2 n)) / sqrt(2 n)."""
    i = torch.arange(n, dtype=torch.float64, device=device)[:, None]
    k = torch.arange(keep, dtype=torch.float64, device=device)[None, :]
    return (2.0 * torch.cos(math.pi * k * (2.0 * i + 1.0) / (2.0 * n)) / math.sqrt(2.0 * n)).float()


def mfcc(audio: torch.Tensor, conf: dict) -> torch.Tensor:
    """(B, L) -> (B, ceil(L / step), 30)."""
    length = audio.shape[-1]
    step = length // conf["z_time_steps"]
    n = 2 * step
    frames = -(-length // step)
    x = F.pad(audio, (0, (frames - 1) * step + n - length)).unfold(-1, n, step)
    k = torch.arange(n, dtype=torch.float64, device=audio.device)
    hann = (0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n)).float()
    mag = torch.fft.rfft(x * hann).abs()
    mel = mag @ mel_weights(MEL_BINS, n, conf["sample_rate"], audio.device)
    return torch.log(torch.clamp(mel, min=LOG_FLOOR)) @ dct_ii(MEL_BINS, MFCC_BINS, audio.device)


def gru(w: W, name: str, x: torch.Tensor) -> torch.Tensor:
    """The one-layer GRU ``name`` (leaves ``<name>.weight_ih_l0`` ...) over
    x (B, T, in) from a zero state -> (B, T, H)."""
    gi = x @ w[f"{name}.weight_ih_l0"].T + w[f"{name}.bias_ih_l0"]
    w_hh, b_hh = w[f"{name}.weight_hh_l0"], w[f"{name}.bias_hh_l0"]
    n_h = w_hh.shape[1]
    h = x.new_zeros(x.shape[0], n_h)
    outs = []
    for t in range(x.shape[1]):
        gh = h @ w_hh.T + b_hh
        g = gi[:, t]
        r = torch.sigmoid(g[:, :n_h] + gh[:, :n_h])
        u = torch.sigmoid(g[:, n_h:2 * n_h] + gh[:, n_h:2 * n_h])
        c = torch.tanh(g[:, 2 * n_h:] + r * gh[:, 2 * n_h:])
        h = (1.0 - u) * c + u * h
        outs.append(h)
    return torch.stack(outs, 1)


def upsample(z: torch.Tensor, frames: int) -> torch.Tensor:
    """(B, n, D) -> (B, frames, D): frame t at position t n / frames,
    between z[i] and z[min(i + 1, n - 1)]."""
    n = z.shape[1]
    pos = torch.arange(frames, device=z.device) * n
    i = pos // frames
    a = ((pos % frames).float() / frames)[None, :, None]
    return (1.0 - a) * z[:, i] + a * z[:, torch.clamp(i + 1, max=n - 1)]


def encode_z(w: W, conf: dict, audio: torch.Tensor, frames: int) -> torch.Tensor:
    """(B, L) audio -> z (B, frames, z_dims)."""
    x = mfcc(audio, conf)
    mean = x.mean(1, keepdim=True)
    var = ((x - mean) ** 2).mean(1, keepdim=True)
    x = (x - mean) / torch.sqrt(var + NORM_EPS) * w["z_encoder.norm_scale"] \
        + w["z_encoder.norm_shift"]
    z = gru(w, "z_encoder.gru", x) @ w["z_encoder.dense_z.weight"].T + w["z_encoder.dense_z.bias"]
    return upsample(z, frames)


# ----------------------------------------------------------------- decoder


def controls(w: W, conf: dict, cents: torch.Tensor, loud: torch.Tensor, z: torch.Tensor):
    """(B, T, 1) cents and loudness, (B, T, z_dims) z -> {c, a, H}."""
    layers = conf["decoder_mlp_layers"]
    stacks = [dsp.mlp(w, "controller.mlp_f0", cents, layers),
              dsp.mlp(w, "controller.mlp_loudness", loud, layers),
              dsp.mlp(w, "controller.mlp_z", z, layers)]
    seq = gru(w, "controller.gru", torch.cat(stacks, -1))
    out = dsp.mlp(w, "controller.mlp_gru", torch.cat([seq, *stacks], -1), layers)

    def head(name):
        return dsp.scaled_sigmoid(out @ w[f"controller.{name}.weight"].T
                                  + w[f"controller.{name}.bias"])

    return {"c": head("dense_harmonic"), "a": head("dense_loudness"), "H": head("dense_filter")}


def wrapped_fir(mags: torch.Tensor, size: int) -> torch.Tensor:
    """(..., F) zero-phase magnitudes -> (..., size) FIR: the irfft's
    2 (F - 1) taps under a Hann window centred on time 0, the tap of time
    tau at tau mod ``size``, those that meet summed."""
    ir = torch.fft.irfft(mags.to(torch.complex64))
    n = ir.shape[-1]
    k = torch.arange(n, device=mags.device, dtype=torch.float64)
    centred = torch.roll(ir, n // 2, -1) * (0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n)).float()
    at = (torch.arange(n, device=mags.device) - n // 2) % size  # tap j sounds at time j - n/2
    return centred.new_zeros(*centred.shape[:-1], size).index_add(-1, at, centred)


def filtered_noise(mags: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """(B, T, F) magnitudes, (B, T, hop) noise -> (B, T hop): each noise
    frame convolved with its frame's :func:`wrapped_fir`, cut to the frame."""
    hop = noise.shape[-1]
    ir = wrapped_fir(mags, hop)
    n = 2 * hop
    y = torch.fft.irfft(torch.fft.rfft(noise, n) * torch.fft.rfft(ir, n), n)[..., :hop]
    return y.reshape(noise.shape[0], -1)


def decode(w: W, conf: dict, batch: Dict[str, torch.Tensor], rows: slice, noise_key):
    """The rows ``rows`` of a batch -> (B, T hop) audio, z from their audio."""
    hop, sr = conf["hop_length"], conf["sample_rate"]
    audio, f0 = batch["audio"][rows], batch["f0"][rows]
    cents, loud = batch["normalized_cents"][rows], batch["loudness"][rows]
    b, t = f0.shape[:2]
    ctl = controls(w, conf, cents, loud, encode_z(w, conf, audio, t))

    def pad(v):  # the edges repeat the first and last frames
        return torch.cat([v[:, :1], v, v[:, -1:]], 1)

    harm, _ = dsp.harmonic(pad(f0), pad(ctl["c"]), pad(ctl["a"]), sr, hop)
    keys = threefry.derive(noise_key, torch.arange(rows.start, rows.stop, device=f0.device))
    samples = torch.arange(t * hop, device=f0.device).expand(b, t * hop)
    noise = threefry.uniform_pm1(keys, samples).reshape(b, t, hop)
    dry = harm + filtered_noise(ctl["H"], noise)
    return dsp.causal_convolve(dry, dsp.reverb_ir(w, conf["reverb_length"] or sr, sr))


def block_loss(w: W, conf: dict, batch: Dict[str, torch.Tensor], rows: slice,
               noise_key) -> torch.Tensor:
    """The loss of the rows ``rows`` (``reference/train.steps``' block loss)."""
    pred = decode(w, conf, batch, rows, noise_key)
    return dsp.mss_loss(pred, batch["audio"][rows], conf["mss_ffts"], conf["mss_overlap"],
                        conf["mss_alpha"])
