"""Real FFT pairs on ``torch.fft``.

The JAX package evaluates every transform as DFT matmuls or its own
Cooley-Tukey layer because its TPU backend has no FFT.  That layer was
never a Pallas kernel; on the GPU ``torch.fft`` (cuFFT) computes the same
transforms, so only the (re, im) pair interface and the truncated causal
convolution are kept here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# The largest DFT the JAX package evaluates as one matrix
# (``ddsp_tpu/ops/fft.py:35``); its power-STFT kernels take n_fft up to it.
DIRECT_MAX = 4096


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def next_fft_size(n: int) -> int:
    """Smallest FFT size >= n that is a power of two or 3 * 2^k."""
    p2 = next_pow2(n)
    p3 = 3 * next_pow2((n + 2) // 3)
    return min(x for x in (p2, p3) if x >= n)


def rfft_pair(
    x: torch.Tensor, n: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real-input FFT over the last axis -> (re, im), each (..., n//2+1).

    ``n`` larger than the input zero-pads it, as ``numpy.fft.rfft`` does.
    """
    spec = torch.fft.rfft(x, n=n or x.shape[-1], dim=-1)
    return spec.real.contiguous(), spec.imag.contiguous()


def irfft_pair(
    re: torch.Tensor,
    im: torch.Tensor,
    n: Optional[int] = None,
    out_len: Optional[int] = None,
) -> torch.Tensor:
    """Inverse of :func:`rfft_pair`: (..., n//2+1) spectra -> (..., n).

    ``out_len`` keeps only the first ``out_len`` output samples (the causal
    half of a linear convolution).
    """
    n = n or 2 * (re.shape[-1] - 1)
    out = torch.fft.irfft(torch.complex(re, im), n=n, dim=-1)
    if out_len is not None and out_len < n:
        out = out[..., :out_len]
    return out


def rfft_convolve_same(
    signal: torch.Tensor, kernel: torch.Tensor, kernel_len: int
) -> torch.Tensor:
    """Causal linear convolution truncated to the signal length.

    ``out[t] = sum_{k<=t, k<kernel_len} kernel[k] * signal[t-k]``: the
    reference's pad/crop ``fft_convolve`` (filtered_noise.py:25-32),
    computed as a circular convolution at ``next_fft_size(L + kernel_len
    - 1)`` points (no wraparound) on ``torch.fft``.  ``signal`` (..., L)
    and ``kernel`` (..., >= kernel_len) broadcast over leading axes.
    """
    length = signal.shape[-1]
    n = next_fft_size(length + kernel_len - 1)
    spec = torch.fft.rfft(signal, n=n) * torch.fft.rfft(kernel[..., :kernel_len], n=n)
    return torch.fft.irfft(spec, n=n)[..., :length]
