"""Real FFT pairs on ``torch.fft``, and the permuted Cooley-Tukey layer.

The JAX package evaluates every transform as DFT matmuls or its own
Cooley-Tukey layer because its TPU backend has no FFT.  On the GPU
``torch.fft`` (cuFFT) computes the same float32 transforms, so the (re, im)
pair interface and the truncated causal convolution run on it.

One part of that layer is kept: the permuted-spectrum Cooley-Tukey
convolution (``ddsp_tpu/ops/fft.py:294-524``) with bf16 matmul operands,
which is what the JAX package's bf16 reverb backward computes
(``rfft_convolve_same(matmul_dtype=bfloat16)``).  Its per-row core,
forward transform -> product with one shared spectrum -> inverse, was the
TPU kernel S1 (``scripts/ab_ct_conv_kernel.py:_kernel``); here it is the
CUDA kernel ``ops/cuda/ct_conv.py:ct_conv``, and ``_ct_fwd_permuted`` /
``_ct_inv_permuted`` below are the building blocks of its plain version.
Tables are formed in numpy float64, cast to float32, then to bf16 where
used, as the JAX package casts them.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

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


# --- tables (host numpy, cached; ddsp_tpu/ops/fft.py:110-144) ----------------
@functools.lru_cache(maxsize=None)
def _dft_mats(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Full complex DFT matrices (n, n), float32 from float64."""
    t = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    ang = -2.0 * np.pi * t * k / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _twiddle(n1: int, n2: int) -> Tuple[np.ndarray, np.ndarray]:
    """W_N^{k1 n2} twiddles, shape (n1, n2), N = n1*n2."""
    k1 = np.arange(n1)[:, None]
    n2i = np.arange(n2)[None, :]
    ang = -2.0 * np.pi * k1 * n2i / (n1 * n2)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _split_factors(n: int) -> Tuple[int, int]:
    """n = n1 * n2 with both factors <= DIRECT_MAX and n1 + n2 least
    (n1 >= n2): the JAX package's factorisation."""
    assert n > DIRECT_MAX
    best = None
    d = 1
    while d * d <= n:
        if n % d == 0:
            n1, n2 = n // d, d
            if n1 <= DIRECT_MAX and n2 <= DIRECT_MAX:
                if best is None or (n1 + n2) < sum(best):
                    best = (n1, n2)
        d += 1
    if best is None:
        raise ValueError(f"FFT size {n} has no two-stage factorization")
    return best


@functools.lru_cache(maxsize=None)
def ct_tables(n: int, device, matmul_dtype=None):
    """(d1r, d1i, d2r, d2i, tr, ti) for an n-point permuted transform on
    ``device``, made once per (n, device, dtype): the DFT matrices of
    (n1, n2) = ``_split_factors(n)`` in ``matmul_dtype`` (float32 for
    None) and the float32 twiddles."""
    n1, n2 = _split_factors(n)
    dtype = matmul_dtype or torch.float32
    mats = [torch.from_numpy(m).to(device=device, dtype=dtype)
            for m in (*_dft_mats(n1), *_dft_mats(n2))]
    return (*mats, *(torch.from_numpy(m).to(device) for m in _twiddle(n1, n2)))


def _mm(matmul_dtype):
    """A float32 matmul of operands rounded to ``matmul_dtype``: a bf16
    product is exact in float32, so this is the JAX package's
    ``preferred_element_type=float32`` product up to summation order (a
    bf16 ``torch.matmul`` would round its output to bf16)."""
    if matmul_dtype is None:
        return torch.matmul
    return lambda a, b: torch.matmul(a.to(matmul_dtype).float(), b.to(matmul_dtype).float())


# --- permuted-spectrum Cooley-Tukey (ddsp_tpu/ops/fft.py:294-373) ------------
#
# Convolution never needs natural spectral order: as long as forward,
# kernel spectrum and inverse share one (k1, k2) layout, the four-step
# transform's de-interleave cancels.  Both directions are (matmul,
# twiddle, matmul), with
#
#   P[k1, k2] = X[k1 + n1 k2],
#   y[a n2 + b] = (1/n) sum_k1 W_n1^{-a k1} [ W_n^{-b k1}
#                   sum_k2 P[k1, k2] W_n2^{-b k2} ].


def _ct_fwd_permuted(xr, xi, n: int, matmul_dtype=None):
    """Complex FFT of (..., n) rows -> permuted spectrum (..., n1, n2),
    P[..., k1, k2] = X[..., k1 + n1*k2].  With ``matmul_dtype`` the
    matmul operands (rows, D1, D2 and the twiddled stage-1 result) are
    rounded to it; sums and the twiddle stay float32."""
    n1, n2 = _split_factors(n)
    d1r, d1i, d2r, d2i, tr, ti = ct_tables(n, xr.device)
    mm = _mm(matmul_dtype)
    ar = xr.reshape(*xr.shape[:-1], n1, n2)
    ai = xi.reshape(*xi.shape[:-1], n1, n2)
    # B[k1, b] = sum_a D1[k1, a] A[a, b]  (D1 symmetric)
    br = mm(d1r, ar) - mm(d1i, ai)
    bi = mm(d1r, ai) + mm(d1i, ar)
    cr = br * tr - bi * ti
    ci = br * ti + bi * tr
    # P[k1, k2] = sum_b C[k1, b] D2[b, k2]
    return mm(cr, d2r) - mm(ci, d2i), mm(cr, d2i) + mm(ci, d2r)


def _ct_inv_permuted(pr, pi, n: int, matmul_dtype=None):
    """Inverse of :func:`_ct_fwd_permuted`: permuted spectrum
    (..., n1, n2) -> complex time rows (..., n) in natural order."""
    d1r, d1i, d2r, d2i, tr, ti = ct_tables(n, pr.device)
    mm = _mm(matmul_dtype)
    lead = pr.shape[:-2]
    # Q[k1, b] = sum_k2 P[k1, k2] conj(D2)[k2, b]
    qr = mm(pr, d2r) + mm(pi, d2i)
    qi = mm(pi, d2r) - mm(pr, d2i)
    rr = qr * tr + qi * ti
    ri = qi * tr - qr * ti
    # y[a, b] = sum_k1 conj(D1)[a, k1] R[k1, b]
    yr = mm(d1r, rr) + mm(d1i, ri)
    yi = mm(d1r, ri) - mm(d1i, rr)
    scale = 1.0 / n
    return (yr * scale).reshape(*lead, n), (yi * scale).reshape(*lead, n)


def ct_conv_permuted(zr, zi, kr, ki, n: int, matmul_dtype=None):
    """Circular convolution of complex rows (rows, n) with one shared
    spectrum given in the permuted layout ((n1, n2) or (1, n)):
    forward permuted transform -> complex product -> inverse.  With
    bf16 this is the plain version of S1 (``ops/cuda/ct_conv.py``)."""
    pr, pi = _ct_fwd_permuted(zr, zi, n, matmul_dtype)
    krm = kr.reshape(pr.shape[-2:])
    kim = ki.reshape(pr.shape[-2:])
    return _ct_inv_permuted(pr * krm - pi * kim, pr * kim + pi * krm, n, matmul_dtype)


@functools.lru_cache(maxsize=None)
def _rounded_tables(n: int, device, matmul_dtype):
    """``ct_tables(n, device)``'s DFT matrices rounded to ``matmul_dtype``
    and held in float32, as ``_mm`` rounds them, made once."""
    d1r, d1i, d2r, d2i, _, _ = ct_tables(n, device)
    return tuple(m.to(matmul_dtype).float() for m in (d1r, d1i, d2r, d2i))


def shared_kernel_spectrum(kernel: torch.Tensor, kernel_len: int, n: int, matmul_dtype=None):
    """(kr, ki): the permuted n-point spectrum (1, n1, n2) of one shared
    real kernel row (1, >= kernel_len), cut to ``kernel_len`` taps and
    zero-padded (a shorter kernel too): one plain transform, operands in
    ``matmul_dtype``.  The same values as ``_ct_fwd_permuted(k, 0, n,
    matmul_dtype)`` (its products with the zero imaginary part are zeros,
    and the tables are rounded once), in half its operations."""
    k = kernel[..., :kernel_len]
    k = F.pad(k, (0, n - k.shape[-1]))
    if matmul_dtype is None:
        return _ct_fwd_permuted(k, torch.zeros_like(k), n)
    n1, n2 = _split_factors(n)
    d1r, d1i, d2r, d2i = _rounded_tables(n, k.device, matmul_dtype)
    _, _, _, _, tr, ti = ct_tables(n, k.device)
    ar = k.reshape(*k.shape[:-1], n1, n2).to(matmul_dtype).float()
    br, bi = torch.matmul(d1r, ar), torch.matmul(d1i, ar)
    cr = (br * tr - bi * ti).to(matmul_dtype).float()
    ci = (br * ti + bi * tr).to(matmul_dtype).float()
    return (torch.matmul(cr, d2r) - torch.matmul(ci, d2i),
            torch.matmul(cr, d2i) + torch.matmul(ci, d2r))


def _rfft_convolve_large_shared(
    signal: torch.Tensor,
    kernel: torch.Tensor,
    kernel_len: int,
    n: int,
    matmul_dtype=None,
) -> torch.Tensor:
    """Large-n causal convolution of real rows (B, L) with ONE shared real
    kernel (1, >= kernel_len) on the permuted transform.

    Rows (2i, 2i+1) ride one complex row as re + j*im (the kernel is
    shared and real, so conv(x + j y) = conv(x) + j conv(y)); an odd batch
    pads one zero row.  At bf16 the rows go through S1
    (``ops/cuda/ct_conv.ct_conv``: the kernel on a CUDA tensor, its plain
    version on a CPU one); the kernel's spectrum is one plain transform.
    A kernel shorter than ``kernel_len`` is zero-padded.
    """
    b, length = signal.shape
    rows = (b + 1) // 2
    sig = F.pad(signal, (0, n - length, 0, 2 * rows - b))
    kr, ki = shared_kernel_spectrum(kernel, kernel_len, n, matmul_dtype)
    zr, zi = sig[0::2].contiguous(), sig[1::2].contiguous()
    if matmul_dtype == torch.bfloat16:
        from ddsp_tpu_torch.ops.cuda.ct_conv import ct_conv

        yr, yi = ct_conv(zr, zi, kr.contiguous(), ki.contiguous(), n)
    else:
        yr, yi = ct_conv_permuted(zr, zi, kr, ki, n, matmul_dtype)
    out = torch.stack([yr, yi], dim=1).reshape(2 * rows, n)
    return out[:b, :length]


def _fft_row_cost(m: int) -> int:
    """Relative per-row MAC count of an m-point matmul FFT."""
    if m <= DIRECT_MAX:
        return m * m
    n1, n2 = _split_factors(m)
    return m * (n1 + n2)


def _overlap_save_plan(length: int, kernel_len: int, max_chunks: int = None) -> int:
    """The chunk count k minimising k * _fft_row_cost(m), each chunk
    transformed at m = next_fft_size(ceil(L/k) + kernel_len - 1); the
    search bound scales with length / kernel_len, as in the JAX package
    (e.g. L = 88,064, kernel 44,100: two chunks of 98,304)."""
    if max_chunks is None:
        max_chunks = min(64, max(6, length // max(kernel_len, 1)))
    best_k, best_cost = 1, None
    for k in range(1, max_chunks + 1):
        c = -(-length // k)
        cost = k * _fft_row_cost(next_fft_size(c + kernel_len - 1))
        if best_cost is None or cost < best_cost:
            best_k, best_cost = k, cost
    return best_k


def _circular_convolve(signal, kernel, kernel_len: int, n: int) -> torch.Tensor:
    """Float32 ``torch.fft`` circular convolution at n points, (..., n)."""
    return circular_convolve_spectrum(torch.fft.rfft(signal, n=n), kernel, kernel_len, n)


def circular_convolve_spectrum(signal_spec, kernel, kernel_len: int, n: int) -> torch.Tensor:
    """:func:`_circular_convolve` from the signal's n-point ``rfft``, which
    a caller may keep (the reverb's forward keeps it for d/dkernel)."""
    spec = signal_spec * torch.fft.rfft(kernel[..., :kernel_len], n=n)
    return torch.fft.irfft(spec, n=n)


class OverlapSavePlan(NamedTuple):
    """Where the bf16 route of :func:`rfft_convolve_same` puts (B, L) real
    rows for a shared kernel of ``kernel_len`` taps: ``chunks`` blocks a
    row, block i reading input samples [i c - lead, i c - lead + n) (zero
    outside [0, L)) and keeping its outputs [lead, lead + c); block
    (row, i) is real row ``row * chunks + i``, and real rows (2j, 2j+1)
    ride complex row j (an odd count pads a zero row)."""

    batch: int
    length: int
    n: int  # the transform size of a block
    chunks: int
    c: int  # outputs kept per block
    lead: int  # the halo: kernel_len - 1 with chunks, else 0

    @property
    def rows(self) -> int:
        """Complex rows."""
        return (self.batch * self.chunks + 1) // 2


def overlap_save_plan(batch: int, length: int, kernel_len: int) -> Optional[OverlapSavePlan]:
    """The plan :func:`rfft_convolve_same` follows at a reduced matmul dtype
    when its blocks go to the permuted transform (n > DIRECT_MAX), else
    None (the blocks, or the whole rows, stay on float32 ``torch.fft``)."""
    n = next_fft_size(length + kernel_len - 1)
    if n <= DIRECT_MAX:
        return None
    k = _overlap_save_plan(length, kernel_len)
    if k == 1:
        return OverlapSavePlan(batch, length, n, 1, length, 0)
    c = -(-length // k)
    m = next_fft_size(c + kernel_len - 1)
    if m <= DIRECT_MAX:
        return None
    return OverlapSavePlan(batch, length, m, k, c, kernel_len - 1)


def _rfft_convolve_overlap_save(
    signal: torch.Tensor,
    kernel: torch.Tensor,
    kernel_len: int,
    k: int,
    matmul_dtype=None,
) -> torch.Tensor:
    """Overlap-save chunked causal convolution (shared kernel, 2-D
    batch): block i covers output samples [i c, i c + c), convolved
    circularly at m points over input samples [i c - halo, i c - halo + m),
    with no wraparound inside its valid window [halo, halo + c)."""
    b, length = signal.shape
    c = -(-length // k)
    m = next_fft_size(c + kernel_len - 1)
    halo = kernel_len - 1
    total = halo + (k - 1) * c + m
    padded = F.pad(signal, (halo, total - halo - length))
    blocks = torch.stack([padded[:, i * c : i * c + m] for i in range(k)], dim=1)
    blocks = blocks.reshape(b * k, m)
    if m > DIRECT_MAX:
        conv = _rfft_convolve_large_shared(blocks, kernel, kernel_len, m, matmul_dtype)
    else:
        conv = _circular_convolve(blocks, kernel, kernel_len, m)
    valid = conv[:, halo : halo + c].reshape(b, k * c)
    return valid[:, :length]


def rfft_convolve_same(
    signal: torch.Tensor,
    kernel: torch.Tensor,
    kernel_len: int,
    matmul_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Causal linear convolution truncated to the signal length.

    ``out[t] = sum_{k<=t, k<kernel_len} kernel[k] * signal[t-k]``: the
    reference's pad/crop ``fft_convolve`` (filtered_noise.py:25-32),
    computed as a circular convolution at ``next_fft_size(L + kernel_len
    - 1)`` points (no wraparound).  ``signal`` (..., L) and ``kernel``
    (..., >= kernel_len) broadcast over leading axes.

    ``matmul_dtype`` None: float32 ``torch.fft``.  Otherwise the JAX
    package's dispatch (``ddsp_tpu/ops/fft.py:547-568``): a 2-D signal
    and one shared kernel row at n > DIRECT_MAX take the overlap-save
    plan, then the permuted transform with operands in ``matmul_dtype``
    for chunks over DIRECT_MAX points (S1 at bf16).  Every other shape,
    and chunks of at most DIRECT_MAX points, stays on float32
    ``torch.fft``, which is tighter than the JAX package's direct DFT
    matmuls in ``matmul_dtype`` there.
    """
    length = signal.shape[-1]
    n = next_fft_size(length + kernel_len - 1)
    if (
        matmul_dtype is not None
        and n > DIRECT_MAX
        and signal.ndim == 2
        and kernel.ndim == 2
        and kernel.shape[0] == 1
    ):
        k = _overlap_save_plan(length, kernel_len)
        if k > 1:
            return _rfft_convolve_overlap_save(signal, kernel, kernel_len, k, matmul_dtype)
        return _rfft_convolve_large_shared(signal, kernel, kernel_len, n, matmul_dtype)
    return _circular_convolve(signal, kernel, kernel_len, n)[..., :length]
