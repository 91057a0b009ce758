"""The permuted-CT convolution of the bf16 reverb backward (S1): CUDA C++
for Hopper.

Counterpart of ``scripts/ab_ct_conv_kernel.py:ct_conv_pallas`` (kernel
``_kernel``): ``ct_conv(zr, zi, kr, ki, n) -> (yr, yi)`` convolves complex
rows zr + j zi, each (rows, n) float32, circularly with one shared
spectrum kr + j ki given in the permuted (n1, n2) layout of
``ops/fft._ct_fwd_permuted`` ((n1, n2), (1, n1, n2) or (1, n) float32):
forward permuted transform, spectrum product, inverse, with bf16 matmul
operands and float32 sums.  It is the per-row core of
``ops/fft._rfft_convolve_large_shared`` at bf16, which the reverb's bf16
backward reaches (``ops/fir.fft_convolve``).

A CUDA tensor launches ``csrc/ct_conv.cu`` (three launches: stage 1, the
fused middle stage, stage 3); a CPU tensor takes the plain version
:func:`ct_conv_plain`; anything else, and a dtype, layout or size the
kernel does not take, raises.  ``LAUNCHES`` counts calls that launched the
kernel and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ddsp_tpu_torch.ops.cuda import build as _build
from ddsp_tpu_torch.ops.fft import _split_factors, ct_conv_permuted, ct_tables

LAUNCHES = 0

MAX_ROWS = 65535  # the stages' grid.z
MAX_N2 = 512  # the middle stage keeps a row's n2 columns in 8 warps' accumulators
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"ct_conv": [_P] * 14 + [_I] * 3 + [_P]}


def _library() -> ctypes.CDLL:
    return _build.library("ct_conv", _SIGNATURES)


def ct_conv_plain(zr, zi, kr, ki, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of S1: ``_ct_fwd_permuted`` -> product with the
    spectrum -> ``_ct_inv_permuted`` at bf16 (``ct_conv_xla`` of the TPU
    script, ``scripts/ab_ct_conv_kernel.py:122-128``)."""
    return ct_conv_permuted(zr, zi, kr, ki, n, torch.bfloat16)


def _check(zr, zi, kr, ki, n: int) -> Tuple[int, int]:
    tensors = (zr, zi, kr, ki)
    if any(x.device.type != "cuda" for x in tensors):
        raise ValueError("ct_conv takes CUDA tensors only")
    if len({x.device for x in tensors}) != 1:
        raise ValueError("ct_conv inputs lie on different devices")
    if any(x.dtype != torch.float32 for x in tensors):
        raise ValueError("ct_conv takes float32 tensors only")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("ct_conv takes contiguous tensors only")
    if zr.dim() != 2 or zr.shape[-1] != n or zi.shape != zr.shape:
        raise ValueError(f"zr, zi must be (rows, {n}), got {tuple(zr.shape)}, {tuple(zi.shape)}")
    if kr.numel() != n or ki.numel() != n:
        raise ValueError(f"kr, ki must hold the {n}-point permuted spectrum")
    n1, n2 = _split_factors(n)
    if n1 % 32 or n2 % 32 or n2 > MAX_N2:
        raise ValueError(f"ct_conv tiles (n1, n2) in multiples of 32 with n2 <= {MAX_N2}, "
                         f"got {(n1, n2)} for n={n}")
    if zr.shape[0] > MAX_ROWS:
        raise ValueError(f"{zr.shape[0]} rows exceed {MAX_ROWS}")
    if any(x.data_ptr() % 16 for x in tensors):
        raise ValueError("ct_conv takes 16-byte aligned tensors only")
    return n1, n2


def _launch(zr, zi, kr, ki, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    global LAUNCHES
    n1, n2 = _check(zr, zi, kr, ki, n)
    rows = zr.shape[0]
    d1r, d1i, d2r, d2i, tr, ti = ct_tables(n, zr.device, torch.bfloat16)
    c = torch.empty((2, rows, n), dtype=torch.bfloat16, device=zr.device)  # C, then R
    y = torch.empty((2, rows, n), dtype=torch.float32, device=zr.device)
    lib = _library()
    with torch.cuda.device(zr.device):
        stream = torch.cuda.current_stream(zr.device).cuda_stream
        rc = lib.ct_conv(
            zr.data_ptr(), zi.data_ptr(), kr.data_ptr(), ki.data_ptr(),
            d1r.data_ptr(), d1i.data_ptr(), d2r.data_ptr(), d2i.data_ptr(),
            tr.data_ptr(), ti.data_ptr(), c[0].data_ptr(), c[1].data_ptr(),
            y[0].data_ptr(), y[1].data_ptr(), rows, n1, n2, stream,
        )
    if rc != 0:
        raise RuntimeError(f"ct_conv launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return y[0], y[1]


def ct_conv(zr, zi, kr, ki, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(yr, yi), each (rows, n) float32: the S1 kernel on CUDA tensors,
    its plain version on CPU tensors."""
    if zr.device.type == "cuda":
        return _launch(zr, zi, kr, ki, n)
    if zr.device.type != "cpu":
        raise ValueError(f"ct_conv: unsupported device {zr.device}")
    return ct_conv_plain(zr, zi, kr, ki, n)
