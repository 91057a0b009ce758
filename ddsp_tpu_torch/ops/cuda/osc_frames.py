"""Frame oscillator kernels (forward and backward): CUDA C++ for Hopper.

Counterpart of ``ddsp_tpu/ops/pallas/oscillator.py:pallas_render_from_phase``
and its ``custom_vjp`` ``_render_h`` (kernels ``_kernel_banked2`` and
``_kernel_banked2_bwd``), after the caller's Nyquist normalisation and
phase stage, without the TPU's padding:

* inputs: phase (B, T, hop) in cycles, amps_pad (B, T+2, H), loud_pad
  (B, T+2), the (hop, 3) hop weights and an integer ``h_start``
  (``amps_pad[..., i]`` drives harmonic ``h_start + i + 1``);
* ``osc_frames_fwd`` launches the forward kernel: audio (B, T*hop);
* ``osc_frames_bwd`` launches the backward kernel and overlap-adds its
  per-window gradients onto the padded frame axis: (dphase (B, T, hop),
  d amps_pad (B, T+2, H), d loud_pad (B, T+2));
* ``OscFrames`` joins the two in one ``torch.autograd.Function``;
* ``render_from_phase`` dispatches by device only: a CUDA tensor takes
  ``OscFrames``, a CPU tensor the plain version with ordinary autograd.
  Nothing falls back from the card to the plain version.

``FWD_LAUNCHES`` and ``BWD_LAUNCHES`` count kernel launches and nothing
else.  ``render_from_phase_plain`` (defined in ``ops/oscillator.py``) and
``render_from_phase_bwd_plain`` are the plain PyTorch versions the tests
and ``chip_smoke.py`` hold the kernels against.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ddsp_tpu_torch.ops.cuda import build as _build
from ddsp_tpu_torch.ops.interp import hop_weights_on
from ddsp_tpu_torch.ops.oscillator import render_from_phase_plain

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

MAX_HARMONICS = 2048  # h * (1/4096-grid phase) stays exact in float32
MAX_BATCH = 65535  # the kernels' grid.y
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "osc_frames_fwd": [_P] * 5 + [_I] * 5 + [_P],
    "osc_frames_bwd": [_P] * 8 + [_I] * 5 + [_P],
}


def _library() -> ctypes.CDLL:
    return _build.library("osc_frames", _SIGNATURES)


def render_from_phase_bwd_plain(
    g: torch.Tensor,
    phase: torch.Tensor,
    amps_pad: torch.Tensor,
    loud_pad: torch.Tensor,
    h_start: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel: ``torch.autograd.grad`` of
    :func:`render_from_phase_plain` for the audio gradient ``g``
    (B, T*hop).  Returns (dphase, d amps_pad, d loud_pad)."""
    with torch.enable_grad():
        inputs = [x.detach().requires_grad_(True) for x in (phase, amps_pad, loud_pad)]
        audio = render_from_phase_plain(*inputs, h_start)
        return torch.autograd.grad(audio, inputs, g)


def _check(phase, amps_pad, loud_pad, h_start, g=None) -> None:
    if phase.dim() != 3:
        raise ValueError(f"phase must be (B, T, hop), got {tuple(phase.shape)}")
    b, t, hop = phase.shape
    h = amps_pad.shape[-1] if amps_pad.dim() == 3 else -1
    want = {"amps_pad": (b, t + 2, h), "loud_pad": (b, t + 2)}
    for name, x in (("amps_pad", amps_pad), ("loud_pad", loud_pad)):
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(x.shape)}")
    if g is not None and tuple(g.shape) != (b, t * hop):
        raise ValueError(f"g must be {(b, t * hop)}, got {tuple(g.shape)}")
    if h < 1 or h_start < 0 or h_start + h > MAX_HARMONICS:
        raise ValueError(
            f"harmonics {h_start + 1}..{h_start + h} outside [1, {MAX_HARMONICS}]"
        )
    tensors = [phase, amps_pad, loud_pad] + ([] if g is None else [g])
    if any(x.device.type != "cuda" for x in tensors):
        raise ValueError("osc_frames kernels take CUDA tensors only")
    if len({x.device for x in tensors}) != 1:
        raise ValueError("osc_frames inputs lie on different devices")
    if any(x.dtype != torch.float32 for x in tensors):
        raise ValueError("osc_frames kernels take float32 tensors only")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("osc_frames kernels take contiguous tensors only")
    if b > MAX_BATCH:
        raise ValueError(f"B={b} exceeds {MAX_BATCH}")
    if t * -(-hop // 128) >= 2**31:
        raise ValueError(f"T={t} frames of {hop} samples exceed the grid")


def osc_frames_fwd(phase, amps_pad, loud_pad, h_start: int = 0) -> torch.Tensor:
    """Launch the forward kernel: (B, T, hop), (B, T+2, H), (B, T+2) ->
    (B, T*hop) float32 audio.  CUDA tensors only."""
    global FWD_LAUNCHES
    _check(phase, amps_pad, loud_pad, h_start)
    b, t, hop = phase.shape
    device = phase.device
    w = hop_weights_on(hop, device)
    out = torch.empty((b, t * hop), dtype=torch.float32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.osc_frames_fwd(
            phase.data_ptr(), amps_pad.data_ptr(), loud_pad.data_ptr(),
            w.data_ptr(), out.data_ptr(),
            b, t, hop, amps_pad.shape[-1], int(h_start), stream,
        )
    if rc != 0:
        raise RuntimeError(f"osc_frames_fwd launch failed: CUDA error {rc}")
    FWD_LAUNCHES += 1
    return out


def osc_frames_bwd(
    g, phase, amps_pad, loud_pad, h_start: int = 0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernel for the audio gradient ``g`` (B, T*hop):
    (dphase (B, T, hop), d amps_pad (B, T+2, H), d loud_pad (B, T+2)).
    CUDA tensors only."""
    global BWD_LAUNCHES
    _check(phase, amps_pad, loud_pad, h_start, g)
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
        rc = lib.osc_frames_bwd(
            g.data_ptr(), phase.data_ptr(), amps_pad.data_ptr(),
            loud_pad.data_ptr(), w.data_ptr(), dphase.data_ptr(),
            da_win.data_ptr(), dl_win.data_ptr(),
            b, t, hop, h, int(h_start), stream,
        )
    if rc != 0:
        raise RuntimeError(f"osc_frames_bwd launch failed: CUDA error {rc}")
    BWD_LAUNCHES += 1
    # window k of frame t belongs to padded row t + k
    d_amps = torch.zeros_like(amps_pad)
    d_loud = torch.zeros_like(loud_pad)
    for k in range(3):
        d_amps[:, k : k + t] += da_win[:, :, k]
        d_loud[:, k : k + t] += dl_win[:, :, k]
    return dphase, d_amps, d_loud


class OscFrames(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient.  The
    gradient with respect to ``h_start`` is none (``_render_h``'s VJP
    returns zeros for it)."""

    @staticmethod
    def forward(ctx, phase, amps_pad, loud_pad, h_start: int):
        ctx.save_for_backward(phase, amps_pad, loud_pad)
        ctx.h_start = h_start
        return osc_frames_fwd(phase, amps_pad, loud_pad, h_start)

    @staticmethod
    def backward(ctx, g):
        phase, amps_pad, loud_pad = ctx.saved_tensors
        dphase, d_amps, d_loud = osc_frames_bwd(
            g.contiguous(), phase, amps_pad, loud_pad, ctx.h_start
        )
        return dphase, d_amps, d_loud, None


def render_from_phase(
    phase: torch.Tensor,
    amps_pad: torch.Tensor,
    loud_pad: torch.Tensor,
    h_start: int = 0,
) -> torch.Tensor:
    """(B, T, hop) phase, (B, T+2, H) amps, (B, T+2) loudness -> (B, T*hop).

    CUDA tensors go through :class:`OscFrames` (the kernel pair); CPU
    tensors take :func:`render_from_phase_plain`; any other device raises.
    """
    device = phase.device
    if device.type == "cpu":
        return render_from_phase_plain(phase, amps_pad, loud_pad, h_start)
    if device.type != "cuda":
        raise ValueError(f"render_from_phase: unsupported device {device}")
    return OscFrames.apply(
        phase.contiguous(), amps_pad.contiguous(), loud_pad.contiguous(),
        int(h_start),
    )
