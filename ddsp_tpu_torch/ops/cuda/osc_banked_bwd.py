"""Round-2 oscillator backward on tensor cores (K6) and its bank fill alone
(S2): CUDA C++ for Hopper.

Counterparts of ``_pallas_backward(impl='banked')`` in
``ddsp_tpu/ops/pallas/oscillator.py`` (kernel ``_kernel_cheb_bwd``) and of
``scripts/bwd_ablation.py:run_variant(_kernel_fill_only, ...)``, without
the TPU's padding:

* ``osc_banked_bwd(g, phase, amps_pad, loud_pad, h_start, bank_dtype)``
  -> (dphase (B, T, hop), d amps_pad (B, T+2, H), d loud_pad (B, T+2)):
  rotation-filled sine and cosine banks and the three contractions as one
  bf16 pass with float32 sums, as the TPU runs them at DEFAULT precision;
* ``osc_fill_only(phase, amps_pad)`` -> (dphase, da_l, da_m, da_r, dloud):
  the same fill with the contractions compiled out, writing what
  ``_kernel_fill_only`` writes (sine of harmonic 1 + cosine of harmonic hb
  as dphase, the amplitude windows as da, zeros as dloud);
* ``osc_banked_bwd_windows`` launches K6 alone (each frame's window
  gradients), and
  ``sincos_seed_mismatches`` counts the arguments where the kernels'
  branch-free seed sincos differs from ``sincosf`` (0 expected).

CUDA tensors launch the kernels in ``csrc/osc_banked_bwd.cu`` (K6 then
``osc_frames.osc_overlap_add``, one launch, bit-equal to the plain
overlap-add); CPU tensors take the plain versions :func:`banked_bwd_plain` /
:func:`fill_only_plain`; anything else raises.  ``BWD_LAUNCHES`` and
``FILL_LAUNCHES`` count kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ddsp_tpu_torch.ops.cuda import build as _build
from ddsp_tpu_torch.ops.cuda.osc_frames import (
    osc_overlap_add,
    render_from_phase_bwd_variant_plain,
)
from ddsp_tpu_torch.ops.interp import hop_weights_on
from ddsp_tpu_torch.ops.osc_fill import fill_banks
from ddsp_tpu_torch.utils.profiling import check_kernel_output

BWD_LAUNCHES = 0
FILL_LAUNCHES = 0

MAX_HARMONICS = 2048  # h * (1/4096-grid phase) stays exact in float32
MAX_BATCH = 65535  # the kernels' grid.y
BANK_DTYPES = ("float32", "bfloat16")
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "osc_banked_bwd": [_P] * 8 + [_I] * 6 + [_P],
    "osc_fill_only": [_P] * 5 + [_I] * 4 + [_P, _P],
    "osc_sincos_seed_mismatches": [_P, _P],
}


def _library() -> ctypes.CDLL:
    return _build.library("osc_banked_bwd", _SIGNATURES)


def banked_bwd_plain(g, phase, amps_pad, loud_pad, h_start: int = 0,
                     bank_dtype: str = "float32"):
    """Plain version of K6: the rotation fill, every contraction operand
    rounded to bf16 once (with a bf16 bank the amplitudes are rounded
    before the 2 pi h scale too), float32 sums."""
    return render_from_phase_bwd_variant_plain(
        g, phase, amps_pad, loud_pad, h_start, fill="rot", bf16=True,
        amps_rounded_first=bank_dtype == "bfloat16",
    )


def fill_only_plain(phase, amps_pad) -> Tuple[torch.Tensor, ...]:
    """Plain version of S2: (dphase (B, T, hop), da_l, da_m, da_r (B, T, H),
    dloud (B, T, 3) zeros)."""
    b, t, _ = phase.shape
    h = amps_pad.shape[-1]
    hb = -(-h // 8) * 8
    sines, coses = fill_banks(phase, hb, 0, "rot")
    dphase = sines[..., 0] + coses[..., hb - 1]
    da = (amps_pad[:, :-2].clone(), amps_pad[:, 1:-1].clone(), amps_pad[:, 2:].clone())
    return (dphase, *da, phase.new_zeros((b, t, 3)))


def _check(name, phase, amps_pad, loud_pad=None, g=None, h_start=0) -> str:
    if phase.dim() != 3:
        raise ValueError(f"phase must be (B, T, hop), got {tuple(phase.shape)}")
    b, t, hop = phase.shape
    h = amps_pad.shape[-1] if amps_pad.dim() == 3 else -1
    tensors = [("amps_pad", amps_pad, (b, t + 2, h))]
    if loud_pad is not None:
        tensors.append(("loud_pad", loud_pad, (b, t + 2)))
    if g is not None:
        tensors.append(("g", g, (b, t * hop)))
    for label, x, want in tensors:
        if tuple(x.shape) != want:
            raise ValueError(f"{label} must be {want}, got {tuple(x.shape)}")
    if h < 1 or h_start < 0 or h_start + h > MAX_HARMONICS:
        raise ValueError(f"harmonics {h_start + 1}..{h_start + h} outside [1, {MAX_HARMONICS}]")
    all_t = [phase] + [x for _, x, _ in tensors]
    if len({x.device for x in all_t}) != 1:
        raise ValueError(f"{name} inputs lie on different devices")
    device = phase.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    if device.type == "cuda":
        if any(x.dtype != torch.float32 for x in all_t):
            raise ValueError(f"{name} takes float32 tensors only")
        if not all(x.is_contiguous() for x in all_t):
            raise ValueError(f"{name} takes contiguous tensors only")
        if b > MAX_BATCH:
            raise ValueError(f"B={b} exceeds {MAX_BATCH}")
    return device.type


def osc_banked_bwd_windows(g, phase, amps_pad, loud_pad, h_start: int = 0,
                           bank_dtype: str = "float32"):
    """Launch K6 alone on CUDA tensors: (dphase (B, T, hop), da_win
    (B, T, 3, H), dl_win (B, T, 3)), each frame's window gradients."""
    global BWD_LAUNCHES
    if bank_dtype not in BANK_DTYPES:
        raise ValueError(f"bank_dtype must be one of {BANK_DTYPES}, got {bank_dtype!r}")
    h_start = int(h_start)
    if _check("osc_banked_bwd", phase, amps_pad, loud_pad, g, h_start) != "cuda":
        raise ValueError("osc_banked_bwd_windows takes CUDA tensors only")
    b, t, hop = phase.shape
    h = amps_pad.shape[-1]
    device = phase.device
    w = hop_weights_on(hop, device)
    dphase = torch.empty_like(phase)
    da_win = torch.empty((b, t, 3, h), dtype=torch.float32, device=device)
    dl_win = torch.empty((b, t, 3), dtype=torch.float32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.osc_banked_bwd(
            g.data_ptr(), phase.data_ptr(), amps_pad.data_ptr(), loud_pad.data_ptr(),
            w.data_ptr(), dphase.data_ptr(), da_win.data_ptr(), dl_win.data_ptr(),
            b, t, hop, h, h_start, int(bank_dtype == "bfloat16"), stream,
        )
    if rc != 0:
        raise RuntimeError(f"osc_banked_bwd launch failed: CUDA error {rc}")
    BWD_LAUNCHES += 1
    check_kernel_output("osc_banked_bwd", dphase, da_win, dl_win)
    return dphase, da_win, dl_win


def osc_banked_bwd(g, phase, amps_pad, loud_pad, h_start: int = 0,
                   bank_dtype: str = "float32"):
    """K6 for the audio gradient ``g`` (B, T*hop): (dphase (B, T, hop),
    d amps_pad (B, T+2, H), d loud_pad (B, T+2)).  CUDA tensors launch the
    kernel and the overlap-add kernel; CPU tensors take
    :func:`banked_bwd_plain`."""
    if bank_dtype not in BANK_DTYPES:
        raise ValueError(f"bank_dtype must be one of {BANK_DTYPES}, got {bank_dtype!r}")
    if _check("osc_banked_bwd", phase, amps_pad, loud_pad, g, int(h_start)) == "cpu":
        return banked_bwd_plain(g, phase, amps_pad, loud_pad, int(h_start), bank_dtype)
    dphase, da_win, dl_win = osc_banked_bwd_windows(g, phase, amps_pad, loud_pad, h_start,
                                                    bank_dtype)
    return (dphase, *osc_overlap_add(da_win, dl_win, phase.shape[1]))


def osc_fill_only(phase, amps_pad) -> Tuple[torch.Tensor, ...]:
    """S2: (dphase (B, T, hop), da_l, da_m, da_r (B, T, H), dloud (B, T, 3)).
    CUDA tensors launch the kernel; CPU tensors take :func:`fill_only_plain`."""
    global FILL_LAUNCHES
    if _check("osc_fill_only", phase, amps_pad) == "cpu":
        return fill_only_plain(phase, amps_pad)
    b, t, hop = phase.shape
    h = amps_pad.shape[-1]
    dphase = torch.empty_like(phase)
    da_win = torch.empty((b, t, 3, h), dtype=torch.float32, device=phase.device)
    dl_win = torch.empty((b, t, 3), dtype=torch.float32, device=phase.device)
    lib = _library()
    with torch.cuda.device(phase.device):
        stream = torch.cuda.current_stream(phase.device).cuda_stream
        rc = lib.osc_fill_only(
            phase.data_ptr(), amps_pad.data_ptr(), dphase.data_ptr(),
            da_win.data_ptr(), dl_win.data_ptr(), b, t, hop, h, None, stream,
        )
    if rc != 0:
        raise RuntimeError(f"osc_fill_only launch failed: CUDA error {rc}")
    FILL_LAUNCHES += 1
    check_kernel_output("osc_fill_only", dphase, da_win, dl_win)
    return (dphase, da_win[:, :, 0], da_win[:, :, 1], da_win[:, :, 2], dl_win)


def sincos_seed_mismatches(device) -> int:
    """How many of the 1,065,353,216 float fractions f in [0, 1) give the
    kernels' seed sincos at 2 pi f bits other than CUDA's ``sincosf``
    (one launch on the card)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("sincos_seed_mismatches runs on a CUDA device")
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        rc = _library().osc_sincos_seed_mismatches(
            bad.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"osc_sincos_seed_mismatches launch failed: CUDA error {rc}")
    return int(bad.item())
