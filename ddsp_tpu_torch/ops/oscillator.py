"""Harmonic oscillator bank: phase in cycles, split-precision sines.

Counterpart of ``ddsp_tpu/ops/oscillator.py``.  The reference oscillator
(model/ddsp/harmonic_oscillator.py) zeroes harmonics above Nyquist,
renormalises their amplitudes, accumulates phase sample by sample and sums
``loudness * amp_h * sin(phase_h)``.  As in the JAX package:

* only the fundamental's phase is accumulated, in cycles, because every
  harmonic's phase is an integer multiple of it (mod 1);
* linear upsampling makes the within-hop partial sums of the phase
  increments a fixed (hop, 3) map of the three neighbouring frames, so the
  only sequential dependency is a frame-rate prefix, done in 128-frame
  blocks with an exact 1/4096-grid split and a Kahan carry across blocks;
* ``sin(2 pi h phi)`` is evaluated from a split ``phi = hi + lo`` with
  ``hi`` on the 1/4096 grid, so ``h * hi`` is exact in float32.

The audio-rate stage dispatches by device: ``render_hop_rows`` (one hop
per serving slot) to ``ops/cuda/oscillator.osc_hop_slots``, and
``render_padded`` / ``oscillator_bank`` (offline frames, differentiable)
to ``ops/cuda/osc_frames.render_from_phase`` -- the CUDA kernels for CUDA
tensors, their plain PyTorch versions for CPU tensors.  Each takes a
``fill``: 'exact' (every harmonic's own sine, the XLA path's function) or
'rot' (the TPU kernels' rotation fill, ``ops/osc_fill.py``);
``models/synths.osc_fill`` resolves it from ``Config.osc_impl``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ddsp_tpu_torch.ops.interp import (
    edge_pad_frames,
    hop_weight_cumsum_on,
    hop_weights_on,
)

TWO_PI = 2.0 * np.pi
QUANT = 4096.0  # split grid: h * coarse phase is exact in f32 for h <= 2048
_PHASE_BLOCK = 128  # two-level phase prefix: parallel within, Kahan across


def nyquist_normalized_amps(
    f0: torch.Tensor,
    harm_amps: torch.Tensor,
    sample_rate: int,
    *,
    h_start: int = 0,
    normalize: bool = True,
) -> torch.Tensor:
    """Zero amplitudes of harmonics above Nyquist, renormalise to sum 1.

    Strict ``h * f0 > sample_rate // 2`` comparison and division without
    epsilon, as the reference (harmonic_oscillator.py:24-33).

    Args:
      f0: (..., 1) fundamental frequency in Hz.
      harm_amps: (..., H) harmonic amplitude distribution.
      h_start: ``harm_amps[..., i]`` belongs to harmonic ``h_start + i + 1``
        (a slice of the bank).
      normalize: False returns the masked amplitudes undivided, for a
        caller that divides by a sum over every slice of the bank
        (``parallel/tp.py``).
    """
    n_harmonics = harm_amps.shape[-1]
    h = torch.arange(1, n_harmonics + 1, dtype=f0.dtype, device=f0.device) + h_start
    amps = torch.where((f0 * h) > (sample_rate // 2), 0.0, harm_amps)
    return amps / amps.sum(dim=-1, keepdim=True) if normalize else amps


def _fundamental_phase_cycles(
    f0_pad: torch.Tensor,
    hop: int,
    sample_rate: int,
    initial_phase: torch.Tensor,
) -> torch.Tensor:
    """Fractional fundamental phase (cycles, [0, 1)) at audio rate.

    Args:
      f0_pad: (B, T+2) fundamental in Hz with one frame of context each side.
      initial_phase: (B,) fundamental phase (cycles) entering the span.

    Returns:
      (B, T, hop) fractional cycles.  Within blocks of 128 frames the hop
      boundaries come from a parallel prefix on the exact 1/4096-grid split
      (the coarse partial sums are exact; the residual's are ~1e-8); only
      the per-block totals go through a Kahan-compensated carry.
    """
    w = f0_pad / sample_rate  # cycles per sample, frame rate
    left, mid, right = w[:, :-2], w[:, 1:-1], w[:, 2:]  # (B, T)
    csum = hop_weight_cumsum_on(hop, f0_pad.device)
    partial = (
        left[:, :, None] * csum[:, 0]
        + mid[:, :, None] * csum[:, 1]
        + right[:, :, None] * csum[:, 2]
    )  # (B, T, hop) inclusive within-hop partial sums
    delta = partial[:, :, -1]
    delta = delta - torch.floor(delta)  # whole cycles are phase-irrelevant

    b, t = delta.shape
    block = _PHASE_BLOCK
    nb = -(-t // block)
    d = F.pad(delta, (0, nb * block - t)).reshape(b, nb, block)
    hi = torch.floor(d * QUANT) * (1.0 / QUANT)
    lo = d - hi
    csum_hi = torch.cumsum(hi, dim=-1)  # exact: grid multiples <= block
    csum_lo = torch.cumsum(lo, dim=-1)
    excl_hi = csum_hi - hi
    excl_lo = csum_lo - lo
    excl = (excl_hi - torch.floor(excl_hi)) + excl_lo  # (B, nb, block)

    tot_hi = csum_hi[..., -1]
    totals = (tot_hi - torch.floor(tot_hi)) + csum_lo[..., -1]  # (B, nb)

    s = initial_phase - torch.floor(initial_phase)
    c = torch.zeros_like(s)
    starts = []
    for i in range(nb):  # Kahan carry over blocks (nb = 1 for a serving hop)
        starts.append(s)
        y = totals[:, i] - c
        tt = s + y
        c = (tt - s) - y
        s = tt - torch.floor(tt)
    block0 = torch.stack(starts, dim=1)  # (B, nb)

    boundary = block0[:, :, None] + excl
    boundary = (boundary - torch.floor(boundary)).reshape(b, nb * block)[:, :t]
    phi = boundary[:, :, None] + partial
    return phi - torch.floor(phi)


def harmonic_sines(
    phase1: torch.Tensor, n_harmonics: int, h_start: int = 0
) -> torch.Tensor:
    """sin(2 pi h phi) for h = h_start+1..h_start+H from the fundamental
    phase, (..., H).

    ``phi = hi + lo`` with ``hi`` on the 1/4096 grid makes ``h * hi`` exact,
    so the harmonic phase error stays ~h * ulp(phi) instead of ulp(h * phi).
    """
    h = torch.arange(
        1, n_harmonics + 1, dtype=phase1.dtype, device=phase1.device
    ) + h_start
    hi = torch.floor(phase1 * QUANT) / QUANT
    lo = phase1 - hi
    coarse = hi[..., None] * h  # exact
    coarse = coarse - torch.floor(coarse)
    frac = coarse + lo[..., None] * h
    frac = frac - torch.floor(frac)
    return torch.sin(TWO_PI * frac)


def render_from_phase_plain(
    phase1: torch.Tensor,  # (B, T, hop) fractional fundamental phase
    amps_pad: torch.Tensor,  # (B, T+2, H) masked + renormalised amplitudes
    loud_pad: torch.Tensor,  # (B, T+2) overall loudness
    h_start: int = 0,
) -> torch.Tensor:
    """sum_h amp_h(i) sin(2 pi h phi(i)) with linearly interpolated controls.

    The plain version of the frame kernels (``ops/cuda/osc_frames.py``):
    it materialises the (B, T, hop, H) sine tensor and contracts it with
    the three amplitude windows.  Returns (B, T*hop).
    """
    b, t, hop = phase1.shape
    sines = harmonic_sines(phase1, amps_pad.shape[-1], h_start)
    amp_win = torch.stack(
        [amps_pad[:, :-2], amps_pad[:, 1:-1], amps_pad[:, 2:]], dim=2
    )  # (B, T, 3, H)
    s = torch.einsum("btjh,btkh->btjk", sines, amp_win)
    w = hop_weights_on(hop, phase1.device)
    harm = torch.einsum("btjk,jk->btj", s, w)
    loud_win = torch.stack(
        [loud_pad[:, :-2], loud_pad[:, 1:-1], loud_pad[:, 2:]], dim=2
    )
    loud_up = torch.einsum("btk,jk->btj", loud_win, w)
    return (loud_up * harm).reshape(b, t * hop)


def render_padded(
    f0_pad: torch.Tensor,
    amps_pad: torch.Tensor,
    loud_pad: torch.Tensor,
    *,
    sample_rate: int,
    hop: int,
    initial_phase: Optional[torch.Tensor] = None,
    frame_chunk: Optional[int] = None,
    h_start: int = 0,
    normalize_amps: bool = True,
    fill: str = "exact",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render audio from frame-rate controls that carry 1 frame of context.

    Args:
      f0_pad: (B, T+2, 1) Hz.  amps_pad: (B, T+2, H).  loud_pad: (B, T+2, 1).
        Index 0 is the frame before the span, index T+1 the frame after.
      initial_phase: (B,) fundamental phase entering the span, in cycles.
      frame_chunk: CPU tensors only: render in chunks of this many frames
        under ``torch.utils.checkpoint``, so the backward recomputes each
        chunk's sine tensor instead of keeping the whole one.  CUDA tensors
        ignore it: the kernel pair never materialises the harmonic tensor
        (as the JAX package's Pallas path ignores it).
      h_start: harmonic-number offset of ``amps_pad``'s slice of the bank.
      normalize_amps: apply the Nyquist mask and renormalisation here.
      fill: the sine fill, 'exact' or 'rot' (forward and backward).

    Returns:
      (audio (B, T*hop), final fundamental phase (B,)).
    """
    from ddsp_tpu_torch.ops.cuda.osc_frames import render_from_phase

    b, tp2, _ = f0_pad.shape
    t = tp2 - 2
    if initial_phase is None:
        initial_phase = torch.zeros(b, dtype=f0_pad.dtype, device=f0_pad.device)
    if normalize_amps:
        amps_pad = nyquist_normalized_amps(
            f0_pad, amps_pad, sample_rate, h_start=h_start
        )
    phase1 = _fundamental_phase_cycles(
        f0_pad[..., 0], hop, sample_rate, initial_phase
    )
    final_phase = phase1[:, -1, -1]
    loudp = loud_pad[..., 0]
    if phase1.device.type != "cpu" or frame_chunk is None or frame_chunk >= t:
        return render_from_phase(phase1, amps_pad, loudp, h_start, fill), final_phase
    if t % frame_chunk:
        raise ValueError(f"frame_chunk {frame_chunk} must divide T={t}")

    def chunk(ph, amps, loud):
        return render_from_phase(ph, amps, loud, h_start, fill)

    parts = []
    for i in range(0, t, frame_chunk):
        window = slice(i, i + frame_chunk + 2)  # the chunk's frames + context
        parts.append(checkpoint(
            chunk, phase1[:, i : i + frame_chunk], amps_pad[:, window],
            loudp[:, window], use_reentrant=False,
        ))
    return torch.cat(parts, dim=1), final_phase


def oscillator_bank(
    f0: torch.Tensor,
    harm_amps: torch.Tensor,
    loudness: torch.Tensor,
    *,
    sample_rate: int,
    hop: int,
    initial_phase: Optional[torch.Tensor] = None,
    frame_chunk: Optional[int] = None,
    fill: str = "exact",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Offline additive synthesis from frame-rate controls.

    Args:
      f0: (B, T, 1) Hz.  harm_amps: (B, T, H).  loudness: (B, T, 1).
      fill: the sine fill ('exact' or 'rot'), as in :func:`render_padded`.

    Returns:
      (audio (B, T*hop), final fundamental phase (B,)), with
      edge-replicated interpolation context (the reference
      ``OscillatorBank.forward``, harmonic_oscillator.py:57-62).
    """
    return render_padded(
        edge_pad_frames(f0),
        edge_pad_frames(harm_amps),
        edge_pad_frames(loudness),
        sample_rate=sample_rate,
        hop=hop,
        initial_phase=initial_phase,
        frame_chunk=frame_chunk,
        fill=fill,
    )


def render_hop_rows(
    f0_pad: torch.Tensor,  # (N, 3, 1): each row's (prev, cur, next) f0
    amps_pad: torch.Tensor,  # (N, 3, H)
    loud_pad: torch.Tensor,  # (N, 3, 1)
    *,
    sample_rate: int,
    hop: int,
    initial_phase: torch.Tensor,  # (N,) per-row fundamental phase, cycles
    fill: str = "exact",  # the sine fill, 'exact' or 'rot'
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render ONE hop for N independent rows (the serving case).

    Semantically ``render_padded`` at T=1, each row a separate stream with
    its own 3-frame context.  The audio-rate stage is ``osc_hop_slots``:
    the CUDA kernel on a CUDA tensor, the plain version on a CPU tensor.
    Forward only.  Returns (audio (N, hop), final phase (N,)).
    """
    from ddsp_tpu_torch.ops.cuda.oscillator import osc_hop_slots

    amps_n = nyquist_normalized_amps(f0_pad, amps_pad, sample_rate)
    phase1 = _fundamental_phase_cycles(
        f0_pad[..., 0], hop, sample_rate, initial_phase
    )  # (N, 1, hop)
    w = hop_weights_on(hop, f0_pad.device)
    audio = osc_hop_slots(
        phase1[:, 0].contiguous(),
        amps_n[:, 0].contiguous(),
        amps_n[:, 1].contiguous(),
        amps_n[:, 2].contiguous(),
        loud_pad[..., 0].contiguous(),
        w,
        fill=fill,
    )
    return audio, phase1[:, -1, -1]
