"""Chebyshev-recurrence forward of the frame oscillator: CUDA C++ for Hopper.

Counterpart of ``_pallas_forward(impl='cheb')`` in
``ddsp_tpu/ops/pallas/oscillator.py`` (kernel ``_kernel_cheb``, K7), after
the caller's Nyquist normalisation and phase stage, without the TPU's
padding: phase (B, T, hop) in cycles, amps_pad (B, T+2, H), loud_pad
(B, T+2) -> audio (B, T*hop), each harmonic's sine from the three-term
recurrence ``sin((h+1)x) = 2 cos x sin hx - sin((h-1)x)`` re-seeded exactly
every ``resync`` harmonics.

* ``osc_cheb_fwd`` -- the entry.  CUDA tensors launch the kernel in
  ``csrc/osc_cheb.cu``; CPU tensors take :func:`osc_cheb_plain`; anything
  else raises.  There is no ``h_start`` (the TPU kernel has none).
* ``LAUNCHES`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from ddsp_tpu_torch.ops.cuda import build as _build
from ddsp_tpu_torch.ops.interp import hop_weights_on
from ddsp_tpu_torch.ops.osc_fill import exact_sincos, split_phase
from ddsp_tpu_torch.ops.oscillator import TWO_PI
from ddsp_tpu_torch.utils.profiling import check_kernel_output

LAUNCHES = 0

MAX_HARMONICS = 2048  # h * (1/4096-grid phase) stays exact in float32
MAX_BATCH = 65535  # the kernel's grid.y
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"osc_cheb_fwd": [_P] * 5 + [_I] * 5 + [_P]}


def _library() -> ctypes.CDLL:
    return _build.library("osc_cheb", _SIGNATURES)


def osc_cheb_plain(phase, amps_pad, loud_pad, resync: int = 32) -> torch.Tensor:
    """Plain version of the kernel, step for step as ``_kernel_cheb``
    (:347-419): one (B, T, hop) recurrence over harmonics, two window sums
    per half-hop when hop % 256 == 0, three otherwise.  Returns (B, T*hop)."""
    b, t, hop = phase.shape
    n_h = amps_pad.shape[-1]
    split = hop % 256 == 0
    half = hop // 2
    ang = TWO_PI * phase
    two_c = 2.0 * torch.cos(ang)
    hi, lo = split_phase(phase)
    a_l, a_m, a_r = amps_pad[:, :-2], amps_pad[:, 1:-1], amps_pad[:, 2:]  # (B, T, H)
    zeros = torch.zeros_like(phase[..., :half] if split else phase)
    acc = [zeros] * 4 if split else [zeros] * 3
    s_prev, s_cur = torch.zeros_like(phase), torch.sin(ang)
    for h in range(1, n_h + 1):
        if h > 1 and (h - 1) % resync == 0:
            s_cur = exact_sincos(hi, lo, float(h))[0]
            s_prev = exact_sincos(hi, lo, float(h - 1))[0]
        al, am, ar = (x[..., h - 1 : h] for x in (a_l, a_m, a_r))
        if split:
            s_lo, s_hi = s_cur[..., :half], s_cur[..., half:]
            acc = [acc[0] + al * s_lo, acc[1] + am * s_lo,
                   acc[2] + am * s_hi, acc[3] + ar * s_hi]
        else:
            acc = [acc[0] + al * s_cur, acc[1] + am * s_cur, acc[2] + ar * s_cur]
        s_prev, s_cur = s_cur, two_c * s_cur - s_prev
    w = hop_weights_on(hop, phase.device)
    if split:
        harm = torch.cat([acc[0] * w[:half, 0] + acc[1] * w[:half, 1],
                          acc[2] * w[half:, 1] + acc[3] * w[half:, 2]], dim=-1)
    else:
        harm = acc[0] * w[:, 0] + acc[1] * w[:, 1] + acc[2] * w[:, 2]
    lw = torch.stack([loud_pad[:, :-2], loud_pad[:, 1:-1], loud_pad[:, 2:]], dim=-1)
    loud = torch.einsum("btk,jk->btj", lw, w)
    return (harm * loud).reshape(b, t * hop)


def _check(phase, amps_pad, loud_pad, resync) -> None:
    if phase.dim() != 3:
        raise ValueError(f"phase must be (B, T, hop), got {tuple(phase.shape)}")
    b, t, hop = phase.shape
    h = amps_pad.shape[-1] if amps_pad.dim() == 3 else -1
    for name, x, want in (("amps_pad", amps_pad, (b, t + 2, h)),
                          ("loud_pad", loud_pad, (b, t + 2))):
        if tuple(x.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(x.shape)}")
    if not 1 <= h <= MAX_HARMONICS:
        raise ValueError(f"H={h} outside [1, {MAX_HARMONICS}]")
    if int(resync) < 1:
        raise ValueError(f"resync must be >= 1, got {resync}")
    if len({x.device for x in (phase, amps_pad, loud_pad)}) != 1:
        raise ValueError("osc_cheb_fwd inputs lie on different devices")


def osc_cheb_fwd(phase, amps_pad, loud_pad, resync: int = 32) -> torch.Tensor:
    """(B, T, hop), (B, T+2, H), (B, T+2) -> (B, T*hop) float32 audio.
    CUDA tensors launch the kernel; CPU tensors take :func:`osc_cheb_plain`;
    anything else raises."""
    global LAUNCHES
    _check(phase, amps_pad, loud_pad, resync)
    device = phase.device
    if device.type == "cpu":
        return osc_cheb_plain(phase, amps_pad, loud_pad, int(resync))
    if device.type != "cuda":
        raise ValueError(f"osc_cheb_fwd: unsupported device {device}")
    tensors = (phase, amps_pad, loud_pad)
    if any(x.dtype != torch.float32 for x in tensors):
        raise ValueError("osc_cheb_fwd takes float32 tensors only")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("osc_cheb_fwd takes contiguous tensors only")
    b, t, hop = phase.shape
    if b > MAX_BATCH or t * -(-hop // 128) >= 2**31:
        raise ValueError(f"(B, T, hop) = {(b, t, hop)} exceeds the grid")
    w = hop_weights_on(hop, device)
    out = torch.empty((b, t * hop), dtype=torch.float32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.osc_cheb_fwd(
            phase.data_ptr(), amps_pad.data_ptr(), loud_pad.data_ptr(),
            w.data_ptr(), out.data_ptr(), b, t, hop, amps_pad.shape[-1],
            int(resync), stream,
        )
    if rc != 0:
        raise RuntimeError(f"osc_cheb_fwd launch failed: CUDA error {rc}")
    LAUNCHES += 1
    check_kernel_output("osc_cheb_fwd", out)
    return out
