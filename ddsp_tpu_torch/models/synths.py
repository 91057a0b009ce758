"""Synthesizer modules: oscillator bank, filtered noise, learned reverb.

Counterpart of ``ddsp_tpu/models/synths.py`` (reference
model/ddsp/harmonic_oscillator.py, filtered_noise.py, reverb.py):

* ``oscillator_apply``, ``noise_apply`` and ``reverb_apply`` are the
  offline (training) render of a controls dict; the oscillator dispatches
  by device to the CUDA kernel pair or its plain version
  (ops/oscillator.py), with the sine fill that :func:`osc_fill` resolves
  from ``conf.osc_impl``;
* ``oscillator_live`` renders a block of frames carrying the fundamental
  phase across blocks, on the same renderer (K1 on the card);
* the streaming reverb splits the IR into P block-sized partitions whose
  2*block rDFT spectra multiply the stored spectra of the last P dry
  windows (overlap-save); the P-deep line carries the IR's whole memory,
  so block output equals offline convolution.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.ops.fft import irfft_pair, rfft_pair
from ddsp_tpu_torch.ops.fir import fft_convolve, filtered_noise
from ddsp_tpu_torch.ops.interp import edge_pad_frames
from ddsp_tpu_torch.ops.oscillator import oscillator_bank, render_padded


OSC_IMPLS = ("auto", "xla", "pallas")


def osc_fill(osc_impl: str, device) -> str:
    """The oscillator's sine fill for ``Config.osc_impl`` on a device
    (a ``torch.device`` or its type), as ``ddsp_tpu/models/synths.py:28-42``
    chooses a path: 'pallas', and 'auto' on the card, take the TPU kernels'
    rotation fill ('rot', ``_fill_sine_banks_cat``); 'xla', and 'auto' on
    the CPU (where JAX runs its XLA einsum), the exact fill ('exact').  The
    device still decides whether the CUDA kernels or their plain versions
    compute it."""
    if osc_impl not in OSC_IMPLS:
        raise ValueError(f"osc_impl must be one of {OSC_IMPLS}, got {osc_impl!r}")
    device_type = getattr(device, "type", device)
    if osc_impl == "pallas" or (osc_impl == "auto" and device_type == "cuda"):
        return "rot"
    return "exact"


def oscillator_apply(
    controls: dict,
    conf: Config,
    initial_phase: Optional[torch.Tensor] = None,
    frame_chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Offline harmonic render from a controls dict {f0, c, a}.

    Returns (audio (B, T*hop), final fundamental phase (B,)).  CUDA tensors
    run the kernel pair, CPU tensors the plain version, with the fill of
    :func:`osc_fill`; a ``frame_chunk`` takes the exact fill, as the JAX
    package takes its XLA path for one.
    """
    f0 = controls["f0"]
    fill = "exact" if frame_chunk is not None else osc_fill(conf.osc_impl, f0.device)
    return oscillator_bank(
        f0, controls["c"], controls["a"],
        sample_rate=conf.sample_rate,
        hop=conf.hop_length,
        initial_phase=initial_phase,
        frame_chunk=frame_chunk,
        fill=fill,
    )


def oscillator_live(
    controls: dict,
    conf: Config,
    phase: torch.Tensor,
    context: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming harmonic render of a block of frames {f0, c, a}, carrying
    the fundamental phase (B,) in cycles across blocks.

    ``context`` optionally holds {f0, c, a} of the frame before and after
    the block (keys 'prev', 'next'), for exact interpolation across block
    edges; without it the edges are clamped (the reference's live path,
    harmonic_oscillator.py:64-75).  Returns (audio (B, T*hop), final
    phase (B,)); the frame forward kernel K1 renders it on the card.
    """
    if context is None:
        padded = [edge_pad_frames(controls[k]) for k in ("f0", "c", "a")]
    else:
        padded = [torch.cat([context["prev"][k], controls[k], context["next"][k]], dim=1)
                  for k in ("f0", "c", "a")]
    return render_padded(
        *padded,
        sample_rate=conf.sample_rate,
        hop=conf.hop_length,
        initial_phase=phase,
        fill=osc_fill(conf.osc_impl, phase.device),
    )


def noise_apply(controls: dict, conf: Config, key: torch.Tensor,
                row_offset: int = 0) -> torch.Tensor:
    """Filtered-noise branch from a controls dict {H}: (B, T*hop) audio;
    the rows are rows ``row_offset + [0, B)`` of the batch (``ops/fir.frame_noise``)."""
    return filtered_noise(controls["H"], key, conf.hop_length, row_offset=row_offset)


class Reverb(nn.Module):
    """Trainable IR parameters: ``noise`` (ir_length,), scalar ``decay`` and
    ``wet`` (reference reverb.py:8-22; names as in its state dict)."""

    def __init__(self, conf: Config, initial_wet: float = 0.0,
                 initial_decay: float = 5.0):
        super().__init__()
        self.noise = nn.Parameter(torch.rand(conf.ir_length) * 2.0 - 1.0)
        self.decay = nn.Parameter(torch.tensor(float(initial_decay)))
        self.wet = nn.Parameter(torch.tensor(float(initial_wet)))


def reverb_init(conf: Config, seed: int = 0, initial_wet: float = 0.0,
                initial_decay: float = 5.0) -> Reverb:
    """A :class:`Reverb` with U(-1, 1) noise drawn from ``seed``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return Reverb(conf, initial_wet, initial_decay)


def reverb_impulse(reverb: Reverb, conf: Config) -> torch.Tensor:
    """Decaying learned IR with a unit dry path (reference reverb.py:24-29)."""
    t = torch.arange(conf.ir_length, dtype=torch.float32,
                     device=reverb.noise.device) / conf.sample_rate
    envelope = torch.exp(-F.softplus(-reverb.decay) * t * 500.0)
    impulse = reverb.noise * envelope * torch.sigmoid(reverb.wet)
    return torch.cat([impulse.new_ones(1), impulse[1:]])


def reverb_apply(reverb: Reverb, x: torch.Tensor, conf: Config) -> torch.Tensor:
    """Convolve (B, L) audio with the learned IR (reference reverb.py:31-38).

    The forward is the float32 ``torch.fft`` convolution; the backward runs
    at ``conf.reverb_grad_matmul_dtype`` (``ops/fir.fft_convolve``), as in
    the JAX package: the default 'bfloat16' takes the permuted-CT
    d/dsignal (the S1 kernel on the card), 'float32' plain autograd.
    """
    impulse = reverb_impulse(reverb, conf)
    return fft_convolve(x, impulse[None, :], kernel_len=impulse.shape[-1],
                        grad_matmul_dtype=conf.reverb_grad_matmul_dtype)


class ReverbLiveState(NamedTuple):
    """Frequency-delay line of the streaming reverb.

    ``spec_re``/``spec_im``: (B, P, block+1) rDFT spectra of the last P
    overlap-save windows, newest at partition 0.  ``prev``: (B, block)
    previous dry block (the left half of the next window).
    """

    spec_re: torch.Tensor
    spec_im: torch.Tensor
    prev: torch.Tensor


def reverb_partitions(conf: Config, block: int) -> int:
    """Number of block-sized IR partitions covering the learned IR."""
    return -(-conf.ir_length // block)


def reverb_live_init(conf: Config, batch: int, block: int,
                     device=None) -> ReverbLiveState:
    p = reverb_partitions(conf, block)
    return ReverbLiveState(
        spec_re=torch.zeros((batch, p, block + 1), device=device),
        spec_im=torch.zeros((batch, p, block + 1), device=device),
        prev=torch.zeros((batch, block), device=device),
    )


def reverb_ir_spectra(
    reverb: Reverb, conf: Config, block: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(P, block+1) rDFT spectra of the IR's partitions.  Serving steps
    keep the reverb fixed, so they compute these once, not every hop."""
    p = reverb_partitions(conf, block)
    impulse = reverb_impulse(reverb, conf)
    hpad = F.pad(impulse, (0, p * block - impulse.shape[-1]))
    return rfft_pair(hpad.reshape(p, block), 2 * block)


def reverb_live(
    reverb: Reverb,
    state: ReverbLiveState,
    x: torch.Tensor,
    conf: Config,
    ir_spec: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, ReverbLiveState]:
    """Streaming reverb by partitioned convolution.

    Args:
      state: :func:`reverb_live_init` state (zeros at stream start).
      x: (B, block) current dry block; ``block`` must match the state's.
      ir_spec: precomputed :func:`reverb_ir_spectra`, else computed here.

    Returns:
      (wet block (B, block), advanced state).
    """
    block = x.shape[-1]
    if state.prev.shape[-1] != block:
        raise ValueError(
            f"block {block} does not match the reverb stream state's "
            f"{state.prev.shape[-1]}; build the state with reverb_live_init"
        )
    nfft = 2 * block
    hr, hi = ir_spec if ir_spec is not None else reverb_ir_spectra(
        reverb, conf, block
    )
    window = torch.cat([state.prev, x], dim=-1)  # (B, 2*block)
    xr, xi = rfft_pair(window, nfft)  # (B, block+1)
    spec_re = torch.cat([xr[:, None], state.spec_re[:, :-1]], dim=1)
    spec_im = torch.cat([xi[:, None], state.spec_im[:, :-1]], dim=1)
    acc_re = (spec_re * hr - spec_im * hi).sum(dim=1)
    acc_im = (spec_re * hi + spec_im * hr).sum(dim=1)
    wet = irfft_pair(acc_re, acc_im, nfft)[..., block:]
    return wet, ReverbLiveState(spec_re, spec_im, x)
