"""The DDSP autoencoder in plain PyTorch, float32, from its published
description (kureta/ddsp-pytorch; Engel et al. 2020; CREPE, Kim et al.
2018): features (A-weighted loudness, windowed-sinc resampling, CREPE),
controller (MLPs, GRU, heads), harmonic oscillator, filtered noise,
reverb and the multi-scale spectral loss.

Weights come as one dict of tensors named as the reference state dicts
name them (``benchmark/weights.py``).  Every function works on whole
tensors with autograd, so a training reference takes gradients through
it; the oscillator's phase is accumulated in float64, the one place
where float32 would not be a reference at all (88,064 samples of a
1 kHz phase).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

W = Dict[str, torch.Tensor]

# CREPE's pitch grid: bin b is 20 b + 1997.3794084376191 cents above 10 Hz
CENTS_0 = 1997.3794084376191
CENTS_STEP = 20.0
N_BINS = 360
BN_EPS = 0.0010000000474974513
CREPE_STRIDES = [4, 1, 1, 1, 1, 1]
CREPE_PADS = [(254, 254)] + 5 * [(31, 32)]


# ------------------------------------------------------------------ features


def a_weighting_db(n_fft: int, sample_rate: int, floor_db: float = -80.0) -> np.ndarray:
    """librosa's A-weighting in dB at the rfft bins, floored at -80 dB."""
    f = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    f2 = f * f
    c = np.array([12194.217, 20.598997, 107.65265, 737.86223]) ** 2
    out = np.full_like(f, floor_db)
    nz = f2 > 0
    g = f2[nz]
    db = 2.0 + 20.0 * (np.log10(c[0]) + 2.0 * np.log10(g) - np.log10(g + c[0])
                       - np.log10(g + c[1]) - 0.5 * np.log10(g + c[2])
                       - 0.5 * np.log10(g + c[3]))
    out[nz] = np.maximum(floor_db, db)
    return out.astype(np.float32)


def loudness(frames: torch.Tensor, sample_rate: int) -> torch.Tensor:
    """(..., n_fft) rectangular frames -> (...,) A-weighted loudness: the
    mean over bins of (dB + A-weighting) / 90 + 1."""
    n_fft = frames.shape[-1]
    mag = torch.fft.rfft(frames).abs()
    db = 20.0 * torch.log10(mag + 1e-20)
    db = db + torch.as_tensor(a_weighting_db(n_fft, sample_rate), device=frames.device)
    return (db / 90.0 + 1.0).mean(-1)


def sinc_resample_matrix(n_in: int, orig: int, new: int, rows: slice,
                         width_zeros: int = 6, rolloff: float = 0.99) -> np.ndarray:
    """(len(rows), n_in) float64 map of ``n_in`` samples at ``orig`` Hz to
    the output samples ``rows`` at ``new`` Hz, anchored at the first input
    sample (torchaudio's ``Resample`` defaults: a Hann-squared windowed sinc
    of ``width_zeros`` zero crossings at ``rolloff`` of the lower Nyquist;
    zeros outside the input)."""
    g = math.gcd(orig, new)
    orig, new = orig // g, new // g
    base = min(orig, new) * rolloff
    n = np.arange(rows.start, rows.stop, dtype=np.float64)[:, None]
    j = np.arange(n_in, dtype=np.float64)[None, :]
    t = np.clip((j / orig - n / new) * base, -width_zeros, width_zeros)
    win = np.cos(t * np.pi / width_zeros / 2.0) ** 2
    sinc = np.where(t == 0.0, 1.0, np.sin(np.pi * t) / np.where(t == 0.0, 1.0, np.pi * t))
    return sinc * win * (base / orig)


def resample(x: torch.Tensor, orig: int, new: int) -> torch.Tensor:
    """(..., L) at ``orig`` Hz -> (..., ceil(L new / orig)) at ``new`` Hz,
    the windowed sinc of :func:`sinc_resample_matrix` evaluated as one
    strided convolution per output phase."""
    g = math.gcd(orig, new)
    o, nw = orig // g, new // g
    base = min(o, nw) * 0.99
    half = int(math.ceil(6 * o / base))
    # output phase p of each block of o inputs, over the input offsets
    # -half .. half + o around the block's start
    idx = np.arange(-half, half + o, dtype=np.float64)
    p = np.arange(nw, dtype=np.float64)[:, None]
    t = np.clip((idx[None, :] / o - p / nw) * base, -6.0, 6.0)
    win = np.cos(t * np.pi / 12.0) ** 2
    k = np.where(t == 0.0, 1.0, np.sin(np.pi * t) / np.where(t == 0.0, 1.0, np.pi * t))
    k = torch.as_tensor(k * win * (base / o), dtype=torch.float32, device=x.device)
    length = x.shape[-1]
    lead = x.shape[:-1]
    xp = F.pad(x.reshape(-1, 1, length), (half, half + o))
    y = F.conv1d(xp, k[:, None, :], stride=o)  # (R, nw, blocks)
    y = y.transpose(1, 2).reshape(xp.shape[0], -1)
    out_len = int(math.ceil(nw * length / o))
    return y[:, :out_len].reshape(*lead, out_len)


def crepe_probs(w: W, windows: torch.Tensor) -> torch.Tensor:
    """(R, 1024) normalised windows -> (R, 360) sigmoid pitch activations:
    six [pad, conv, ReLU, BatchNorm (inference), max-pool 2] stages and the
    classifier over the h-major flattened map."""
    x = windows[:, None, :]
    for i in range(6):
        name = f"conv{i + 1}"
        x = F.conv1d(F.pad(x, CREPE_PADS[i]), w[f"{name}.weight"], w[f"{name}.bias"],
                     stride=CREPE_STRIDES[i])
        x = torch.relu(x)
        bn = f"{name}_BN"
        x = (x - w[f"{bn}.running_mean"][:, None]) * (
            w[f"{bn}.weight"] / torch.sqrt(w[f"{bn}.running_var"] + BN_EPS))[:, None] \
            + w[f"{bn}.bias"][:, None]
        x = F.max_pool1d(x, 2)
    x = x.transpose(1, 2).reshape(x.shape[0], -1)
    return torch.sigmoid(x @ w["classifier.weight"].T + w["classifier.bias"])


def normalise(windows: torch.Tensor) -> torch.Tensor:
    """Per-window zero mean and unit (unbiased) standard deviation, the
    deviation offset by 1e-8 so that silence stays finite."""
    mean = windows.mean(-1, keepdim=True)
    return (windows - mean) / (windows.std(-1, keepdim=True) + 1e-8)


def bin_hz(bins: torch.Tensor) -> torch.Tensor:
    return 10.0 * 2.0 ** ((bins * CENTS_STEP + CENTS_0) / 1200.0)


def hz_cents_normalised(f0: torch.Tensor) -> torch.Tensor:
    """f0 in Hz -> its position on CREPE's grid, 0 at bin 0 and 1 at bin 359."""
    cents = 1200.0 * torch.log2(f0 / 10.0)
    return (cents - CENTS_0) / (CENTS_STEP * (N_BINS - 1))


# --------------------------------------------------------------- controller


def mlp(w: W, name: str, x: torch.Tensor, layers: int) -> torch.Tensor:
    """[Linear, LayerNorm (eps 1e-5), LeakyReLU (0.01)] x ``layers``."""
    for i in range(1, layers + 1):
        p = f"{name}.mlp_layer{i}"
        x = x @ w[f"{p}.0.weight"].T + w[f"{p}.0.bias"]
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        x = (x - mu) / torch.sqrt(var + 1e-5) * w[f"{p}.1.weight"] + w[f"{p}.1.bias"]
        x = torch.where(x >= 0, x, 0.01 * x)
    return x


def gru(w: W, x: torch.Tensor, h: torch.Tensor):
    """One-layer GRU, gates (reset, update, new) as torch orders them:
    x (B, T, in), h (B, H) -> (outputs (B, T, H), last h)."""
    gi = x @ w["controller.gru.weight_ih_l0"].T + w["controller.gru.bias_ih_l0"]
    w_hh, b_hh = w["controller.gru.weight_hh_l0"], w["controller.gru.bias_hh_l0"]
    n_h = h.shape[-1]
    outs = []
    for t in range(x.shape[1]):
        gh = h @ w_hh.T + b_hh
        g = gi[:, t]
        r = torch.sigmoid(g[:, :n_h] + gh[:, :n_h])
        z = torch.sigmoid(g[:, n_h:2 * n_h] + gh[:, n_h:2 * n_h])
        n = torch.tanh(g[:, 2 * n_h:] + r * gh[:, 2 * n_h:])
        h = (1.0 - z) * n + z * h
        outs.append(h)
    return torch.stack(outs, 1), h


def scaled_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """The decoder's output nonlinearity: 2 sigmoid(x)^2.3026 + 1e-7."""
    return 2.0 * torch.sigmoid(x) ** 2.3026 + 1e-7


def controls(w: W, conf: dict, cents: torch.Tensor, loud: torch.Tensor, h0=None):
    """(B, T, 1) normalised cents and loudness -> ({c, a, H}, last GRU state)."""
    layers = conf["decoder_mlp_layers"]
    lf = mlp(w, "controller.mlp_f0", cents, layers)
    ll = mlp(w, "controller.mlp_loudness", loud, layers)
    if h0 is None:
        h0 = cents.new_zeros(cents.shape[0], conf["decoder_gru_units"])
    seq, h = gru(w, torch.cat([lf, ll], -1), h0)
    z = mlp(w, "controller.mlp_gru", torch.cat([seq, lf, ll], -1), layers)

    def head(name):
        return scaled_sigmoid(z @ w[f"controller.{name}.weight"].T + w[f"controller.{name}.bias"])

    return {"c": head("dense_harmonic"), "a": head("dense_loudness"),
            "H": head("dense_filter")}, h


# -------------------------------------------------------------- synthesis


def upsample(x_pad: torch.Tensor, hop: int) -> torch.Tensor:
    """(B, T + 2, C) frames with one frame of context each side -> (B,
    T hop, C): linear interpolation at half-sample centres (``F.interpolate``
    linear, align_corners False), the context frames giving the edges."""
    up = F.interpolate(x_pad.transpose(1, 2), scale_factor=hop, mode="linear",
                       align_corners=False)
    return up[..., hop:-hop].transpose(1, 2)


def harmonic(f0_pad: torch.Tensor, c_pad: torch.Tensor, a_pad: torch.Tensor,
             sample_rate: int, hop: int, phase0: torch.Tensor = None):
    """Additive synthesis of frames 1 .. T of (B, T + 2) padded controls:
    amplitudes above Nyquist zeroed and the rest renormalised at frame
    rate, then every control upsampled; the fundamental's phase is the
    running sum of f0 / sample_rate (float64), from 0 or, given ``phase0``
    (B, T), from each frame's own starting phase; each harmonic h sounds
    sin(2 pi h phase).  Returns (audio (B, T hop), each frame's phase
    advance (B, T) in cycles)."""
    b, t = f0_pad.shape[0], f0_pad.shape[1] - 2
    n_h = c_pad.shape[-1]
    h = torch.arange(1, n_h + 1, device=f0_pad.device, dtype=f0_pad.dtype)
    amps = torch.where(f0_pad * h > sample_rate // 2, torch.zeros_like(c_pad), c_pad)
    amps = amps / amps.sum(-1, keepdim=True)
    amp_up = upsample(amps, hop)  # (B, L, H)
    loud_up = upsample(a_pad, hop)[..., 0]
    step = upsample((f0_pad / sample_rate).double(), hop)[..., 0].reshape(b, t, hop)
    within = torch.cumsum(step, -1)
    if phase0 is None:
        start = torch.cumsum(within[..., -1], -1) - within[..., -1]
    else:
        start = phase0.double()
    phase = (start[..., None] + within).reshape(b, t * hop)
    phase = phase - torch.floor(phase)
    hp = phase[..., None] * h.double()
    sines = torch.sin(2.0 * math.pi * (hp - torch.floor(hp)).float())
    return loud_up * (amp_up * sines).sum(-1), within[..., -1]


def fir_from_magnitudes(mags: torch.Tensor, size: int) -> torch.Tensor:
    """(..., F) zero-phase magnitudes -> (..., size) causal FIR: irfft,
    centred, periodic-Hann windowed, zero-padded to ``size``, rotated back."""
    ir = torch.fft.irfft(mags.to(torch.complex64))
    n = ir.shape[-1]
    ir = torch.roll(ir, n // 2, -1)
    k = torch.arange(n, device=mags.device, dtype=torch.float64)
    ir = ir * (0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n)).float()
    ir = F.pad(ir, (0, size - n))
    return torch.roll(ir, -(n // 2), -1)


def filtered_noise(mags: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """(B, T, F) magnitudes, (B, T, hop) noise -> (B, T hop): each noise
    frame convolved with its frame's FIR, cut to the frame."""
    hop = noise.shape[-1]
    ir = fir_from_magnitudes(mags, hop)
    n = 2 * hop
    y = torch.fft.irfft(torch.fft.rfft(noise, n) * torch.fft.rfft(ir, n), n)[..., :hop]
    return y.reshape(noise.shape[0], -1)


def reverb_ir(w: W, length: int, sample_rate: int) -> torch.Tensor:
    """The learned impulse: noise under an exponential decay, scaled by
    sigmoid(wet), with a unit dry tap at 0."""
    t = torch.arange(length, device=w["reverb.noise"].device, dtype=torch.float32) / sample_rate
    env = torch.exp(-F.softplus(-w["reverb.decay"]) * t * 500.0)
    ir = w["reverb.noise"] * env * torch.sigmoid(w["reverb.wet"])
    return torch.cat([ir.new_ones(1), ir[1:]])


def causal_convolve(x: torch.Tensor, ir: torch.Tensor) -> torch.Tensor:
    """(B, L) signal, (K,) impulse -> (B, L) causal linear convolution."""
    n = 1 << (x.shape[-1] + ir.shape[-1] - 2).bit_length()
    return torch.fft.irfft(torch.fft.rfft(x, n) * torch.fft.rfft(ir, n), n)[..., :x.shape[-1]]


def mss_loss(pred: torch.Tensor, true: torch.Tensor, ffts, overlap: float,
             alpha: float = 1.0, eps: float = 1e-7) -> torch.Tensor:
    """Sum over scales of mean |S_p - S_t| + alpha mean |log2 S_t - log2 S_p|
    of power spectrograms (periodic Hann, centred with reflection)."""
    total = pred.new_zeros(())
    for n in ffts:
        hop = int(n * (1 - overlap))
        win = torch.hann_window(n, device=pred.device)

        def power(x):
            s = torch.stft(x, n, hop, window=win, center=True, pad_mode="reflect",
                           return_complex=True)
            return s.real ** 2 + s.imag ** 2

        sp, st = power(pred), power(true)
        total = total + (sp - st).abs().mean() + alpha * (
            torch.log2(st + eps) - torch.log2(sp + eps)).abs().mean()
    return total
