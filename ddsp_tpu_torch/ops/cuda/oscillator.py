"""Slot-hop oscillator kernel: CUDA C++ for Hopper, bound with ctypes.

Counterpart of ``ddsp_tpu/ops/pallas/oscillator.py:pallas_render_hop_slots``
(kernel ``_kernel_banked``), after the caller's Nyquist normalisation and
phase stage, without the TPU's padding: N serving slots, each with its own
(previous, current, next) amplitude and loudness rows, render one hop.
The offline ``_pallas_forward(impl='banked')`` reaches the same kernel with
one row per frame of a batch and a harmonic offset ``h_start``
(``ops/cuda/osc_variants.py``).

* ``osc_hop_slots`` -- the entry.  On CUDA tensors it launches the kernel
  in ``csrc/osc_hop_slots.cu``; on CPU tensors it runs
  ``render_hop_slots_plain``.  Any other input raises: there is no
  fallback from the card to the plain version.
* ``fill``: 'exact' (every harmonic's own sine, the XLA path's function)
  or 'rot' (``_kernel_banked``'s own fill, ``_fill_sine_banks_cat``: the
  first 8 harmonics seeded exactly, every later tile rotated by
  ``e^{i 2 pi 8 x}``), each its own instantiation of the kernel.
* ``LAUNCHES`` counts kernel launches (and nothing else), so a run can
  show that its main path went through the kernel; ``VARIANT_LAUNCHES``
  counts them by fill (``osc_hop_slots`` / ``osc_hop_slots[fill=rot]``).
* ``ops/cuda/build.py`` compiles the source with ``nvcc`` for ``sm_90a``
  into ``ddsp_tpu_torch/_build/`` on first use; the library has a plain C
  entry point and is loaded with ``ctypes``.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from ddsp_tpu_torch.ops.cuda import build as _build
from ddsp_tpu_torch.ops.osc_fill import fill_banks
from ddsp_tpu_torch.ops.oscillator import harmonic_sines
from ddsp_tpu_torch.utils.profiling import check_kernel_output

LAUNCHES = 0
VARIANT_LAUNCHES: collections.Counter = collections.Counter()
FILLS = ("exact", "rot")  # csrc/osc_hop_slots.cu's instantiations

MAX_HARMONICS = 2048  # h * (1/4096-grid phase) stays exact in float32
MAX_SLOTS = 65535  # the kernel's grid.y
_SIGNATURES = {
    "osc_hop_slots": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
}


def render_hop_slots_plain(
    phase: torch.Tensor,  # (N, hop) fundamental phase, cycles
    amps_l: torch.Tensor,  # (N, H) previous-frame amplitudes
    amps_m: torch.Tensor,  # (N, H) current-frame amplitudes
    amps_r: torch.Tensor,  # (N, H) next-frame amplitudes
    loud: torch.Tensor,  # (N, 3) loudness of the three frames
    w: torch.Tensor,  # (hop, 3) interpolation weights
    h_start: int = 0,  # amps[..., i] drives harmonic h_start + i + 1
    fill: str = "exact",  # 'exact' or 'rot' (ops/osc_fill.fill_banks)
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``render_from_phase_plain`` at T=1,
    its sines from ``fill``.

    Materialises the (N, hop, H) sine tensor.  Returns (N, hop).
    """
    if fill == "exact":
        sines = harmonic_sines(phase, amps_l.shape[-1], h_start)  # (N, hop, H)
    else:
        sines, _ = fill_banks(phase, amps_l.shape[-1], h_start, fill, cos=False)
    amp_win = torch.stack([amps_l, amps_m, amps_r], dim=1)  # (N, 3, H)
    s = torch.einsum("njh,nkh->njk", sines, amp_win)
    harm = torch.einsum("njk,jk->nj", s, w)
    loud_up = torch.einsum("nk,jk->nj", loud, w)
    return loud_up * harm


def _library() -> ctypes.CDLL:
    return _build.library("osc_hop_slots", _SIGNATURES)


def _check(phase, amps_l, amps_m, amps_r, loud, w, h_start, fill) -> None:
    if fill not in FILLS:
        raise ValueError(f"osc_hop_slots fills {FILLS}, got {fill!r}")
    tensors = (phase, amps_l, amps_m, amps_r, loud, w)
    if any(t.requires_grad for t in tensors):
        raise ValueError("osc_hop_slots is forward only: inputs require grad")
    if phase.dim() != 2:
        raise ValueError(f"phase must be (N, hop), got {tuple(phase.shape)}")
    n, hop = phase.shape
    h = amps_l.shape[-1] if amps_l.dim() == 2 else -1
    want = {
        "amps_l": (n, h), "amps_m": (n, h), "amps_r": (n, h),
        "loud": (n, 3), "w": (hop, 3),
    }
    for name, t in zip(want, tensors[1:]):
        if tuple(t.shape) != want[name]:
            raise ValueError(
                f"{name} must be {want[name]}, got {tuple(t.shape)}"
            )
    if h < 1 or h_start < 0 or h_start + h > MAX_HARMONICS:
        raise ValueError(
            f"harmonics {h_start + 1}..{h_start + h} outside [1, {MAX_HARMONICS}]"
        )
    if len({t.device for t in tensors}) != 1:
        raise ValueError("osc_hop_slots inputs lie on different devices")


def osc_hop_slots(
    phase: torch.Tensor,
    amps_l: torch.Tensor,
    amps_m: torch.Tensor,
    amps_r: torch.Tensor,
    loud: torch.Tensor,
    w: torch.Tensor,
    h_start: int = 0,
    fill: str = "exact",
) -> torch.Tensor:
    """(N, hop) phase, 3 x (N, H) amps, (N, 3) loudness, (hop, 3) weights
    -> (N, hop) float32 audio; ``amps_*[:, i]`` drives harmonic
    ``h_start + i + 1``; sines by ``fill`` ('exact' or 'rot').  CUDA
    tensors launch the kernel; CPU tensors take
    :func:`render_hop_slots_plain`; anything else raises."""
    global LAUNCHES
    h_start = int(h_start)
    _check(phase, amps_l, amps_m, amps_r, loud, w, h_start, fill)
    tensors = (phase, amps_l, amps_m, amps_r, loud, w)
    device = phase.device
    if device.type == "cpu":
        return render_hop_slots_plain(phase, amps_l, amps_m, amps_r, loud, w, h_start, fill)
    if device.type != "cuda":
        raise ValueError(f"osc_hop_slots: unsupported device {device}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("osc_hop_slots takes float32 tensors only")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("osc_hop_slots takes contiguous tensors only")
    n, hop = phase.shape
    if n > MAX_SLOTS:
        raise ValueError(f"N={n} slots exceeds {MAX_SLOTS}")
    lib = _library()
    out = torch.empty((n, hop), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.osc_hop_slots(
            *(t.data_ptr() for t in tensors), out.data_ptr(),
            n, hop, amps_l.shape[-1], h_start, FILLS.index(fill), stream,
        )
    if rc != 0:
        raise RuntimeError(f"osc_hop_slots launch failed: CUDA error {rc}")
    LAUNCHES += 1
    VARIANT_LAUNCHES[variant_name(fill)] += 1
    check_kernel_output("osc_hop_slots", out)
    return out


def variant_name(fill: str = "exact") -> str:
    """The launch-counter key of a fill: ``osc_hop_slots`` (exact) or
    ``osc_hop_slots[fill=rot]``."""
    return "osc_hop_slots" if fill == "exact" else f"osc_hop_slots[fill={fill}]"
