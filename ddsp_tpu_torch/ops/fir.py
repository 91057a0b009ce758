"""Counter-based noise, FIR design and FFT convolution.

Counterpart of ``ddsp_tpu/ops/fir.py``:

* ``threefry_2x32``, ``PRNGKey``, ``fold_in`` and ``split`` reproduce
  jax's default (threefry) keys bit for bit, so a noise stream keyed here
  equals the JAX package's for the same seed, and a trainer that splits
  its key every step draws the JAX trainer's noise;
* ``frame_noise`` is a pure function of (key, row, absolute sample), which
  is what makes block-by-block streaming equal to an offline render;
* ``convolve_designed_fir`` folds the FIR design of the reference
  (filtered_noise.py:7-22: irfft of zero-phase magnitudes, roll, Hann
  window, pad) and the convolution's forward transform into one
  precomputed (n_filters, n_bins) matrix pair;
* ``amp_to_impulse_response`` and ``fft_convolve`` are the reference's
  FIR design and causal convolution (filtered_noise.py:7-32), the latter
  on ``torch.fft``, with the JAX package's reduced-precision backward
  (``grad_matmul_dtype``: at bf16 its d/dsignal runs on the S1 kernel).

Torch has no 32-bit unsigned shifts on every device, so the 32-bit cipher
arithmetic runs in int64 with explicit masking: every value stays in
[0, 2^32).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ddsp_tpu_torch.ops.fft import (
    _split_factors,
    circular_convolve_spectrum,
    irfft_pair,
    next_fft_size,
    overlap_save_plan,
    rfft_convolve_same,
    rfft_pair,
)

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def _threefry_pair(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of counter words (x0, x1) under key
    (k0, k1); all int64 tensors holding uint32 values, broadcast together."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def threefry_2x32(key: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """jax's ``threefry_2x32(keypair, count)``: the flat count is split in
    halves that form the two cipher lanes (odd sizes padded with one 0),
    and the two output lanes are concatenated back.  uint32 values held in
    int64; returns the shape of ``count``."""
    flat = count.reshape(-1).to(torch.int64)
    odd = flat.shape[0] % 2
    if odd:
        flat = torch.cat([flat, flat.new_zeros(1)])
    x0, x1 = flat.chunk(2)
    y0, y1 = _threefry_pair(key[0], key[1], x0, x1)
    out = torch.cat([y0, y1])
    if odd:
        out = out[:-1]
    return out.reshape(count.shape)


def PRNGKey(seed: int, device=None) -> torch.Tensor:  # noqa: N802 -- jax name
    """jax's legacy ``PRNGKey(seed)``: [seed >> 32, seed & 0xFFFFFFFF]."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([seed >> 32, seed & _MASK], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """jax's ``fold_in``: ``threefry_2x32(key, [0, data])``.

    ``key``: (..., 2); ``data``: int or int tensor broadcasting against
    ``key[..., 0]``.  Returns (..., 2) keys."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    y0, y1 = _threefry_pair(key[..., 0], key[..., 1], torch.zeros_like(data),
                            data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax 0.9.0's ``random.split`` of a raw threefry key: (num, 2) keys.

    With ``jax_threefry_partitionable`` (the default since jax 0.5) key
    ``i`` is the threefry pair of the 64-bit counter ``i``, i.e. the words
    (0, i): the same words as ``fold_in(key, i)``."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = _threefry_pair(key[0], key[1], torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """jax 0.9.0's 32-bit ``random_bits(key, shape)`` (partitionable
    threefry): element i, in row-major order, is the xor of the two lanes
    of the threefry pair of the 64-bit counter i.  uint32 values in int64."""
    n = int(np.prod(shape))
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = _threefry_pair(key[0], key[1], i >> 32, i & _MASK)
    return (y0 ^ y1).reshape(shape)


def uniform(key: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0,
            dtype=torch.float32) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``, bit for
    bit: the top 23 bits as the mantissa of a float in [1, 2), minus 1,
    scaled to [minval, maxval) and kept >= minval (float32 arithmetic)."""
    bits = random_bits(key, shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    out = torch.clamp_min(floats * float(hi - lo) + float(lo), float(lo))
    return out.to(dtype)


# XLA's float32 erf_inv (Giles, "Approximating the erfinv function", the
# single-precision branch pair), evaluated as jax.lax.erf_inv evaluates it
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function on XLA's polynomial: w = -log1p(-x^2);
    a degree-8 polynomial in w - 2.5 (w < 5) or sqrt(w) - 3, times x."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, a, b) + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key: torch.Tensor, shape, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: sqrt(2) * erfinv(u) for
    u uniform on [nextafter(-1, 0), 1) (``jax/_src/random.py:867-872``)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, float(lo), 1.0)
    return (float(np.float32(np.sqrt(2))) * erfinv_f32(u)).to(dtype)


def noise_from_counts(row_keys: torch.Tensor, counts: torch.Tensor,
                      dtype=torch.float32) -> torch.Tensor:
    """Uniform [-1, 1) noise at absolute sample ``counts`` under per-row
    keys: row_keys (B, 2), counts (B, L) int64 -> (B, L).

    Each word is the first output lane of threefry on the pair
    (count mod 2^32, 0); its top 24 bits map exactly onto [-1, 1)."""
    bits, _ = _threefry_pair(
        row_keys[:, :1], row_keys[:, 1:], counts & _MASK,
        torch.zeros_like(counts),
    )
    return ((bits >> 8).to(torch.float32) * 2.0**-23 - 1.0).to(dtype)


def frame_noise(
    key: torch.Tensor,
    batch: int,
    n_frames: int,
    block_size: int,
    frame_offset=0,
    dtype=torch.float32,
    row_offset: int = 0,
) -> torch.Tensor:
    """(B, n_frames, block_size) uniform noise in [-1, 1).

    Row b uses the key ``fold_in(key, row_offset + b)`` over the absolute
    samples ``frame_offset * block_size + [0, n_frames * block_size)``, so
    a stream rendered block by block draws the same noise as an offline
    render, and rows ``row_offset + [0, B)`` of a larger batch (a
    data-parallel rank's) draw what those rows draw in the whole batch.
    Counters wrap at 2^32 samples (~27 hours at 44.1 kHz)."""
    row_keys = fold_in(key, row_offset + torch.arange(batch, device=key.device))
    n = n_frames * block_size
    start = torch.as_tensor(frame_offset, dtype=torch.int64,
                            device=key.device) * block_size
    counts = (start + torch.arange(n, device=key.device)).expand(batch, n)
    u = noise_from_counts(row_keys, counts, dtype)
    return u.reshape(batch, n_frames, block_size)


def hann_window(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window (``torch.hann_window(n)`` semantics), formed in
    float64 and cast, as the JAX package forms it."""
    i = np.arange(n)
    return torch.as_tensor(
        0.5 - 0.5 * np.cos(2.0 * np.pi * i / n), dtype=dtype, device=device
    )


def amp_to_impulse_response(amp: torch.Tensor, target_size: int) -> torch.Tensor:
    """Zero-phase magnitude response -> windowed causal FIR of target_size.

    ``amp``: (..., n_filters) magnitudes over [0, Nyquist]; irfft ->
    rotate to causal -> Hann window -> zero-pad -> rotate back
    (reference filtered_noise.py:7-22).  Returns (..., target_size).
    """
    ir = torch.fft.irfft(amp.to(torch.complex64))
    filter_size = ir.shape[-1]  # 2 * (n_filters - 1)
    ir = torch.roll(ir, filter_size // 2, dims=-1)
    ir = ir * hann_window(filter_size, ir.dtype, ir.device)
    ir = torch.nn.functional.pad(ir, (0, int(target_size) - int(filter_size)))
    return torch.roll(ir, -(filter_size // 2), dims=-1)


def fft_convolve(
    signal: torch.Tensor,
    kernel: torch.Tensor,
    kernel_len: int = None,
    grad_matmul_dtype: str = None,
) -> torch.Tensor:
    """Causal linear convolution via FFT, reference pad/crop alignment:
    ``out[n] = sum_{k<=n} kernel[k] * signal[n-k]``, (..., L).

    ``kernel_len`` declares the kernel's true support (the FFT size
    shrinks to it).  ``grad_matmul_dtype`` (e.g. 'bfloat16'), as in the
    JAX package (``ddsp_tpu/ops/fir.py:63-139``), runs the backward at
    reduced precision while the forward stays the float32 convolution,
    bit for bit.  It needs a 2-D signal and a 2-D kernel (one shared row
    or one per row); other shapes, None and 'float32' are plain autograd
    of the float32 ``torch.fft`` convolution.  See :class:`_FastGradConvolve`.
    """
    kernel_len = kernel_len or kernel.shape[-1]
    if (
        grad_matmul_dtype is not None
        and grad_matmul_dtype != "float32"
        and signal.ndim == 2
        and kernel.ndim == 2
    ):
        return _FastGradConvolve.apply(signal, kernel, kernel_len,
                                       getattr(torch, grad_matmul_dtype))
    return rfft_convolve_same(signal, kernel, kernel_len)


class _FastGradConvolve(torch.autograd.Function):
    """The causal convolution with a reduced-precision backward.

    The convolution is bilinear, so each gradient is a correlation with
    the other operand:

    * d/dsignal = flip(rfft_convolve_same(flip(g), kernel, kernel_len,
      matmul_dtype)), the JAX package's bf16 transpose computed as a
      convolution of the flipped cotangent.  With one shared kernel row at
      reverb scale at bf16, on an overlap-save plan whose rows take S1's
      one-launch cluster path, this is ``ops/cuda/ct_conv.ct_conv_dsignal``:
      one launch of the S1 kernel on the card that reads g and writes
      dsignal itself (the flips, the overlap-save blocks and the packing
      of two rows a complex row in its index math), its plain version of
      the same gather and scatter on the CPU; other shapes and dtypes take
      ``rfft_convolve_same`` as written above;
    * d/dkernel = the float32 ``torch.fft`` correlation of g with the
      signal, summed over the batch for a shared kernel, zero past
      ``kernel_len``, from the signal's spectrum that the forward kept
      (one rfft, of g, in the backward).  S1's shared-spectrum form does
      not fit it (the signal differs per row), so it stays a stock op,
      tighter than the JAX package's bf16 d/dkernel.
    """

    @staticmethod
    def forward(ctx, signal, kernel, kernel_len: int, matmul_dtype):
        length = signal.shape[-1]
        n = next_fft_size(length + kernel_len - 1)
        # rfft_convolve_same's float32 route, keeping the signal's spectrum
        sig_spec = torch.fft.rfft(signal, n=n)
        out = circular_convolve_spectrum(sig_spec, kernel, kernel_len, n)[..., :length]
        ctx.save_for_backward(sig_spec if ctx.needs_input_grad[1] else None, kernel)
        ctx.kernel_len, ctx.matmul_dtype, ctx.n = kernel_len, matmul_dtype, n
        ctx.signal_shape = signal.shape
        return out

    @staticmethod
    def backward(ctx, g):
        sig_spec, kernel = ctx.saved_tensors
        kernel_len, n = ctx.kernel_len, ctx.n
        dsignal = dkernel = None
        if ctx.needs_input_grad[0]:
            from ddsp_tpu_torch.ops.cuda.ct_conv import ct_conv_dsignal, on_chip

            plan = overlap_save_plan(*ctx.signal_shape, kernel_len)
            if (ctx.matmul_dtype == torch.bfloat16 and kernel.shape[0] == 1 and plan
                    and on_chip(*_split_factors(plan.n))):
                dsignal = ct_conv_dsignal(g.contiguous(), kernel, kernel_len, plan)
            else:
                dsignal = rfft_convolve_same(
                    g.flip(-1), kernel, kernel_len, matmul_dtype=ctx.matmul_dtype
                ).flip(-1)
        if ctx.needs_input_grad[1]:
            width = min(kernel_len, kernel.shape[-1])
            spec = torch.fft.rfft(g, n=n) * sig_spec.conj()
            if kernel.shape[0] == 1:
                spec = spec.sum(0, keepdim=True)
            corr = torch.fft.irfft(spec, n=n)[..., :width]
            dkernel = torch.nn.functional.pad(corr, (0, kernel.shape[-1] - width))
        return dsignal, dkernel, None, None


@functools.lru_cache(maxsize=None)
def _design_spectrum_mats(n_filters: int, block_size: int, n_fft: int):
    """(n_filters, n_fft//2+1) cos/sin pair: magnitudes -> kernel spectrum.

    The FIR design (irfft of a zero-phase magnitude response, roll to
    causal, Hann window, zero-pad to ``block_size``, roll back) followed by
    the convolution's forward rDFT at ``n_fft`` is one linear map of the
    ``n_filters`` magnitudes, composed here in float64 and cast to float32.
    The padding and the roll back put the windowed zero-phase tap of time
    tau at ``tau mod block_size``; a block shorter than the design's
    2 (n_filters - 1) taps takes the same rule, the taps that meet summed
    (the port's own: the JAX package refuses such a block), so the block's
    circular response is the windowed design's at every
    ``2 (n_filters - 1) / block_size``-th bin.
    """
    fs = 2 * (n_filters - 1)
    k = np.arange(n_filters, dtype=np.float64)[:, None]
    t = np.arange(fs, dtype=np.float64)[None, :]
    scale = np.full((n_filters, 1), 2.0 / fs)
    scale[0, 0] = 1.0 / fs
    scale[-1, 0] = 1.0 / fs  # n_filters-1 == fs//2 by construction
    design = np.cos(2.0 * np.pi * k * t / fs) * scale
    design = np.roll(design, fs // 2, axis=1)
    design = design * (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(fs) / fs))
    causal = design
    design = np.zeros((n_filters, block_size))  # tap j sounds at time j - fs/2
    np.add.at(design, (slice(None), (np.arange(fs) - fs // 2) % block_size), causal)
    tt = np.arange(block_size, dtype=np.float64)[:, None]
    kk = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * tt * kk / n_fft
    wre = design @ np.cos(ang)
    wri = design @ np.sin(ang)
    return wre.astype(np.float32), wri.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _design_spectrum_mats_on(n_filters: int, block_size: int, n_fft: int,
                             device: torch.device):
    """:func:`_design_spectrum_mats` as tensors on ``device``, made once."""
    return tuple(torch.as_tensor(m, device=device)
                 for m in _design_spectrum_mats(n_filters, block_size, n_fft))


def convolve_designed_fir(
    filter_mags: torch.Tensor, frames: torch.Tensor
) -> torch.Tensor:
    """Convolve per-frame signals with the FIR designed from ``filter_mags``.

    The same as a causal linear convolution of each frame with
    ``amp_to_impulse_response(filter_mags, block_size)``, truncated to the
    frame, evaluated spectrally.

    Args:
      filter_mags: (B, T, n_filters) per-frame magnitude responses.
      frames: (B, T, block_size) per-frame signals (noise blocks).

    Returns:
      (B, T*block_size) filtered signal, frames concatenated.
    """
    b, t, nf = filter_mags.shape
    block_size = frames.shape[-1]
    n = next_fft_size(2 * block_size - 1)
    wre, wri = _design_spectrum_mats_on(nf, block_size, n, filter_mags.device)
    kr = filter_mags @ wre
    ki = filter_mags @ wri
    sr, si = rfft_pair(frames, n)
    out = irfft_pair(sr * kr - si * ki, sr * ki + si * kr, n,
                     out_len=block_size)
    return out.reshape(b, t * block_size)


def filtered_noise(
    filter_mags: torch.Tensor,
    key: torch.Tensor,
    block_size: int,
    frame_offset=0,
    row_offset: int = 0,
) -> torch.Tensor:
    """Time-varying FIR-filtered uniform noise, (B, T*block_size).

    Args:
      filter_mags: (B, T, n_filters) per-frame magnitude responses.
      block_size: samples per frame (= hop length).
      frame_offset, row_offset: this block's first frame and row in the
        whole render (:func:`frame_noise`).
    """
    b, t, _ = filter_mags.shape
    noise = frame_noise(key, b, t, block_size, frame_offset,
                        filter_mags.dtype, row_offset)
    return convolve_designed_fir(filter_mags, noise)
