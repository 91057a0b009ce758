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

A CUDA tensor launches ``csrc/ct_conv.cu``: one thread-block cluster a
row for rows that fit on chip (n1 <= 512, n2 <= 256: the reverb's shapes),
three launches for larger ones; a CPU tensor takes the plain version
:func:`ct_conv_plain`; anything else, and a dtype, layout or size the
kernel does not take, raises.

``ct_conv_dsignal`` is the reverb's bf16 d/dsignal on the same kernel's
cluster path (rows of n1 <= 512, n2 <= 256): it reads the cotangent g and
writes dsignal itself, the flips, the overlap-save blocks and the packing
of two rows a complex row folded into the kernel's loads and stores
(``DsignalIO``); its plain version,
:func:`ct_conv_dsignal_plain`, does the same gather and scatter with index
tensors.  ``LAUNCHES`` counts calls that launched the kernel, through
either entry, and nothing else; ``DSIGNAL_LAUNCHES`` those of the fused
entry.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ddsp_tpu_torch.ops.cuda import build as _build
from ddsp_tpu_torch.ops.fft import (
    OverlapSavePlan,
    _split_factors,
    ct_conv_permuted,
    ct_tables,
    overlap_save_plan,
    shared_kernel_spectrum,
)
from ddsp_tpu_torch.utils.profiling import check_kernel_output

LAUNCHES = 0
DSIGNAL_LAUNCHES = 0

MAX_ROWS = 65535  # the grid's rows
MAX_N2 = 512  # the three-launch middle stage keeps a row's n2 columns in 8 warps
# The cluster path: one 64-row slice a CTA, at most 8 CTAs (the portable
# cluster size), a row's slices of A and C at n2 <= 256 in shared memory.
CLUSTER_MAX_N1, CLUSTER_MAX_N2 = 512, 256
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ct_conv": [_P] * 14 + [_I] * 3 + [_P],
    "ct_conv_dsignal": [_P] * 10 + [_I] * 8 + [_P],
}


def _library() -> ctypes.CDLL:
    return _build.library("ct_conv", _SIGNATURES)


def ct_conv_plain(zr, zi, kr, ki, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of S1: ``_ct_fwd_permuted`` -> product with the
    spectrum -> ``_ct_inv_permuted`` at bf16 (``ct_conv_xla`` of the TPU
    script, ``scripts/ab_ct_conv_kernel.py:122-128``)."""
    return ct_conv_permuted(zr, zi, kr, ki, n, torch.bfloat16)


def dsignal_index(plan: OverlapSavePlan, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused d/dsignal's data movement as index tensors into the flat
    (B L) cotangent: ``src`` (rows, 2, n), the sample of flip(g) that each
    packed complex-row element reads (B L for a zero: halo, tail or the
    padded row), and ``keep`` (rows, 2, n) / ``dst``, the elements kept
    and the flat sample of dsignal (flipped back) each one writes."""
    rows, n, k, c, lead = plan.rows, plan.n, plan.chunks, plan.c, plan.lead
    b, length = plan.batch, plan.length
    q = torch.arange(2 * rows, device=device).reshape(rows, 2, 1)  # real block row
    t = torch.arange(n, device=device)
    bi, ci = q // k, q % k
    pos = ci * c + t - lead  # sample of flip(g) / of the block's output
    real = q < b * k
    flat = bi * length + (length - 1 - pos)  # flip: sample pos of flip(g) is g[L-1-pos]
    src = torch.where(real & (pos >= 0) & (pos < length), flat, b * length)
    keep = real & (t >= lead) & (t < lead + c) & (pos < length)
    return src, keep, flat[keep]


def _dsignal_by_index(g, plan: OverlapSavePlan, conv) -> torch.Tensor:
    """Gather the packed complex rows of flip(g) by :func:`dsignal_index`,
    convolve them with ``conv(zr, zi)``, scatter the kept outputs flipped
    into dsignal (B, L)."""
    src, keep, dst = dsignal_index(plan, g.device)
    z = torch.cat([g.reshape(-1), g.new_zeros(1)])[src]
    yr, yi = conv(z[:, 0].contiguous(), z[:, 1].contiguous())
    out = g.new_empty(plan.batch * plan.length)
    out[dst] = torch.stack([yr, yi], dim=1)[keep]
    return out.reshape(plan.batch, plan.length)


def ct_conv_dsignal_plain(g, kr, ki, plan: OverlapSavePlan) -> torch.Tensor:
    """Plain version of the fused d/dsignal entry: the gather, S1's plain
    version and the scatter of :func:`_dsignal_by_index`.  The same values,
    moved alike, as ``flip(rfft_convolve_same(flip(g), kernel, kernel_len,
    bfloat16))``, bit for bit."""
    return _dsignal_by_index(g, plan, lambda zr, zi: ct_conv_plain(zr, zi, kr, ki, plan.n))


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


def on_chip(n1: int, n2: int) -> bool:
    """Whether rows of (n1, n2) take the one-launch cluster path."""
    return n1 <= CLUSTER_MAX_N1 and n2 <= CLUSTER_MAX_N2


def _launch(zr, zi, kr, ki, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    global LAUNCHES
    n1, n2 = _check(zr, zi, kr, ki, n)
    rows = zr.shape[0]
    d1r, d1i, d2r, d2i, tr, ti = ct_tables(n, zr.device, torch.bfloat16)
    # C, then R, of the three-launch path; the cluster path keeps them on chip
    c = torch.empty((2, rows, 0 if on_chip(n1, n2) else n), dtype=torch.bfloat16,
                    device=zr.device)
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
    check_kernel_output("ct_conv", y)
    return y[0], y[1]


def _launch_dsignal(g, kr, ki, plan: OverlapSavePlan) -> torch.Tensor:
    global LAUNCHES, DSIGNAL_LAUNCHES
    n = plan.n
    if g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError("ct_conv_dsignal takes a contiguous float32 cotangent")
    if len({g.device, kr.device, ki.device}) != 1:
        raise ValueError("ct_conv_dsignal inputs lie on different devices")
    n1, n2 = _split_factors(n)
    if n1 % 32 or n2 % 32 or not on_chip(n1, n2) or plan.rows > MAX_ROWS:
        raise ValueError(f"ct_conv_dsignal takes (n1, n2) in multiples of 32 with n1 <= "
                         f"{CLUSTER_MAX_N1}, n2 <= {CLUSTER_MAX_N2} and at most {MAX_ROWS} "
                         f"rows, got {(n1, n2)} and {plan.rows}")
    if any(x.dtype != torch.float32 or not x.is_contiguous() or x.numel() != n
           or x.data_ptr() % 16 for x in (kr, ki)) or g.data_ptr() % 16:
        raise ValueError("ct_conv_dsignal takes the contiguous, 16-byte aligned float32 "
                         f"{n}-point permuted spectrum and cotangent")
    d1r, d1i, d2r, d2i, tr, ti = ct_tables(n, g.device, torch.bfloat16)
    dsig = torch.empty_like(g)
    lib = _library()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = lib.ct_conv_dsignal(
            g.data_ptr(), dsig.data_ptr(), kr.data_ptr(), ki.data_ptr(),
            d1r.data_ptr(), d1i.data_ptr(), d2r.data_ptr(), d2i.data_ptr(),
            tr.data_ptr(), ti.data_ptr(), plan.rows, n1, n2, plan.batch * plan.chunks,
            plan.chunks, plan.c, plan.lead, plan.length, stream,
        )
    if rc != 0:
        raise RuntimeError(f"ct_conv_dsignal launch failed: CUDA error {rc}")
    LAUNCHES += 1
    DSIGNAL_LAUNCHES += 1
    check_kernel_output("ct_conv_dsignal", dsig)
    return dsig


def ct_conv_dsignal(g, kernel, kernel_len: int, plan: Optional[OverlapSavePlan] = None):
    """The reverb's bf16 d/dsignal, ``flip(rfft_convolve_same(flip(g),
    kernel, kernel_len, bfloat16))``, for a (B, L) float32 cotangent and
    one shared kernel row (1, >= kernel_len) on its overlap-save ``plan``
    (``ops/fft.overlap_save_plan``, made here if not given): the kernel's
    permuted spectrum is one plain transform, then one launch of S1 that
    gathers flip(g)'s blocks and writes dsignal itself on CUDA tensors
    (plans whose rows take the cluster path, :func:`on_chip`; others
    raise), or :func:`ct_conv_dsignal_plain` on CPU tensors.  Returns
    (B, L)."""
    if plan is None:
        plan = overlap_save_plan(*g.shape, kernel_len)
    if plan is None or g.dim() != 2 or tuple(g.shape) != (plan.batch, plan.length):
        raise ValueError(f"ct_conv_dsignal: no permuted-transform plan for g {tuple(g.shape)}"
                         f" and a {kernel_len}-tap kernel")
    kr, ki = (x.contiguous() for x in shared_kernel_spectrum(
        kernel, kernel_len, plan.n, torch.bfloat16))
    if g.device.type == "cuda":
        return _launch_dsignal(g, kr, ki, plan)
    if g.device.type != "cpu":
        raise ValueError(f"ct_conv_dsignal: unsupported device {g.device}")
    return ct_conv_dsignal_plain(g, kr, ki, plan)


def ct_conv(zr, zi, kr, ki, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(yr, yi), each (rows, n) float32: the S1 kernel on CUDA tensors,
    its plain version on CPU tensors."""
    if zr.device.type == "cuda":
        return _launch(zr, zi, kr, ki, n)
    if zr.device.type != "cpu":
        raise ValueError(f"ct_conv: unsupported device {zr.device}")
    return ct_conv_plain(zr, zi, kr, ki, n)
