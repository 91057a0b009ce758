"""Time-sharded rendering: long audio over the 'time' mesh axis.

Counterpart of ``ddsp_tpu/parallel/render.py``.  The render's only
couplings across time are the phase accumulator, the interpolation of the
frame-rate controls and the reverb, so each rank renders its own frames
with three exchanges over the time axis's group (``collectives.py``):

1. **phase carry**: each rank sums its frames' fractional phase
   increments, and an exclusive scan over an ``all_gather`` of one value a
   row gives its starting phase, handed to ``ops/oscillator.render_padded``
   as ``initial_phase``, so the card runs K1 (``osc_frames_fwd``) on every
   rank from that phase;
2. **control halo**: one neighbour frame each side (``ppermute``; the
   edge ranks clamp, as the offline edge padding does);
3. **reverb halo (overlap-save)**: the ``ir_length`` dry samples before
   the shard, from as many left neighbours as they span.

The noise is keyed by absolute frame, so it is bit-equal to the
unsharded render's.  Forward only: the
renders run under ``torch.no_grad``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.device import resolve_device
from ddsp_tpu_torch.models.synths import osc_fill, reverb_impulse
from ddsp_tpu_torch.ops.fir import fft_convolve, filtered_noise
from ddsp_tpu_torch.ops.interp import hop_weight_cumsum_on
from ddsp_tpu_torch.ops.oscillator import QUANT, nyquist_normalized_amps, render_padded
from ddsp_tpu_torch.parallel.collectives import all_gather, axis_index, axis_size, ppermute, psum
from ddsp_tpu_torch.parallel.mesh import TIME_AXIS, Mesh, time_sharding

CONTROL_KEYS = ("f0", "c", "a", "H")


def _neighbor_frame(x: torch.Tensor, direction: int, group) -> torch.Tensor:
    """The adjacent shard's edge frame (direction +1: the left neighbour's
    last frame; -1: the right neighbour's first).  The edge shards take
    their own edge frame (offline edge replication)."""
    n, idx = axis_size(group), axis_index(group)
    if direction == +1:
        edge, perm, fallback, is_edge = x[:, -1:], [(i, i + 1) for i in range(n - 1)], x[:, :1], idx == 0
    else:
        edge, perm, fallback, is_edge = x[:, :1], [(i + 1, i) for i in range(n - 1)], x[:, -1:], idx == n - 1
    got = ppermute(edge.contiguous(), group, perm)
    return fallback if is_edge else got


def _with_context(x: torch.Tensor, group) -> torch.Tensor:
    """(B, T_local, C) -> (B, T_local + 2, C) with the neighbour frames."""
    return torch.cat([_neighbor_frame(x, +1, group), x, _neighbor_frame(x, -1, group)], dim=1)


def _phase_carry(delta_frac_total: torch.Tensor, group) -> torch.Tensor:
    """Exclusive scan of the shards' phase increments: (B,) -> (B,) carry,
    the masked sum in JAX's order (index order)."""
    idx = axis_index(group)
    all_deltas = all_gather(delta_frac_total, group)  # (n, B)
    carry = torch.zeros_like(delta_frac_total)
    for i in range(all_deltas.shape[0]):
        carry = carry + all_deltas[i] * float(i < idx)
    return carry - torch.floor(carry)


def _halo_left(x: torch.Tensor, halo: int, group) -> torch.Tensor:
    """The ``halo`` samples before this shard (zeros before the start),
    from ceil(halo / local) left neighbours when the halo spans several
    shards: one ``all_gather`` of every shard's last min(halo, local)
    samples, then a select."""
    local = x.shape[-1]
    k = -(-halo // local)  # shards the halo spans
    idx = axis_index(group)
    tails = all_gather(x[..., -min(halo, local):].contiguous(), group)
    pieces = [tails[idx - j] if idx >= j else torch.zeros_like(tails[0])
              for j in range(k, 0, -1)]
    window = torch.cat(pieces, dim=-1)
    if window.shape[-1] >= halo:
        return window[..., -halo:]
    return F.pad(window, (halo - window.shape[-1], 0))


def _local_delta_total(f0_pad: torch.Tensor, hop: int, sample_rate: int) -> torch.Tensor:
    """Total fractional phase increment of this shard's hops, (B,).

    The JAX package sums the T_local fractional increments in float32,
    whose error grows with the shard (4.8e-5 cycles at 1,292 frames, far
    above the 1e-7 that 180 harmonics need).  Here, as in
    ``ops/oscillator._fundamental_phase_cycles``, the increments' parts on
    the 1/4096 grid are summed exactly (as integers) and their residuals
    apart."""
    w = f0_pad[..., 0] / sample_rate  # (B, T+2) cycles/sample
    csum = hop_weight_cumsum_on(hop, f0_pad.device)[-1]  # (3,) full-hop weights
    delta = w[:, :-2] * csum[0] + w[:, 1:-1] * csum[1] + w[:, 2:] * csum[2]  # (B, T)
    delta = delta - torch.floor(delta)
    steps = torch.floor(delta * QUANT)  # the grid parts, in 1/4096 cycles
    whole = steps.to(torch.int64).sum(dim=1) % int(QUANT)  # exact
    total = whole.to(delta.dtype) * (1.0 / QUANT) + (delta - steps * (1.0 / QUANT)).sum(dim=1)
    return total - torch.floor(total)


def tp_harmonics(f0_pad: torch.Tensor, amps_pad: torch.Tensor, loud_pad: torch.Tensor,
                 conf: Config, model_group, fill: str,
                 initial_phase: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The harmonic audio of a bank sharded over ``model_group``, on every
    rank of it: ``amps_pad`` is this rank's contiguous slice, rendered at
    its ``h_start``; the Nyquist renormalisation's denominator (a sum over
    every harmonic) and the partial audio are the two values summed over
    the group (``parallel/tp.py``'s convention)."""
    h0 = axis_index(model_group) * amps_pad.shape[-1]
    masked = nyquist_normalized_amps(f0_pad, amps_pad, conf.sample_rate, h_start=h0,
                                     normalize=False)
    denom = psum(masked.sum(dim=-1, keepdim=True), model_group)
    partial, _ = render_padded(
        f0_pad, masked / denom, loud_pad, sample_rate=conf.sample_rate, hop=conf.hop_length,
        initial_phase=initial_phase, h_start=h0, normalize_amps=False, fill=fill)
    return psum(partial, model_group)


def render_controls_local(
    reverb,
    f0: torch.Tensor,
    amps: torch.Tensor,
    loud: torch.Tensor,
    noise_mags: torch.Tensor,
    key: torch.Tensor,
    conf: Config,
    t_local: int,
    mesh: Mesh,
    impl: Optional[str] = None,
    model_axis: Optional[str] = None,
) -> torch.Tensor:
    """One shard's synthesis: this rank's frames -> its audio samples.

    Every rank of the mesh's time axis calls it together (the control
    halo, the phase carry and the reverb halo are collectives over
    ``mesh.groups[TIME_AXIS]``).  ``reverb`` is the decoder's
    ``Reverb`` module.  With ``model_axis``, ``amps`` is this rank's
    contiguous slice of the harmonic bank, rendered by
    :func:`tp_harmonics` (f0 is the same on every model rank, so is the
    carry).  ``impl`` ('xla' | 'pallas' | 'auto', None = ``conf.osc_impl``)
    picks the sine fill as ``models/synths.osc_fill`` does: on the card
    'pallas' and 'auto' run K1 on the rotation fill.
    """
    time_group = mesh.groups[TIME_AXIS]
    idx = axis_index(time_group)
    fill = osc_fill(impl or conf.osc_impl, f0.device)

    n_h = amps.shape[-1]
    ctx = _with_context(torch.cat([f0, amps, loud], dim=-1), time_group)
    f0_pad, amps_pad, loud_pad = ctx[..., :1], ctx[..., 1:1 + n_h], ctx[..., 1 + n_h:]

    delta_total = _local_delta_total(f0_pad, conf.hop_length, conf.sample_rate)
    phase0 = _phase_carry(delta_total, time_group)

    if model_axis is None:
        harm, _ = render_padded(
            f0_pad, amps_pad, loud_pad, sample_rate=conf.sample_rate, hop=conf.hop_length,
            initial_phase=phase0, fill=fill)
    else:
        harm = tp_harmonics(f0_pad, amps_pad, loud_pad, conf, mesh.groups[model_axis], fill,
                            initial_phase=phase0)
    dry = harm + filtered_noise(noise_mags, key, conf.hop_length, frame_offset=idx * t_local)

    ir_len = conf.ir_length
    window = torch.cat([_halo_left(dry, ir_len, time_group), dry], dim=-1)
    impulse = reverb_impulse(reverb, conf)
    wet = fft_convolve(window, impulse[None, :], kernel_len=ir_len)
    return wet[..., -dry.shape[-1]:]


def controls_on(controls: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """The controls {f0, c, a, H} (arrays or tensors) as float32 tensors on
    ``device``."""
    return {k: torch.as_tensor(controls[k], dtype=torch.float32, device=device)
            for k in CONTROL_KEYS}


@torch.no_grad()
def render_controls_sharded(
    reverb,
    controls: Dict,
    conf: Config,
    mesh: Mesh,
    noise_key: torch.Tensor,
    impl: Optional[str] = None,
    device="cuda",
) -> torch.Tensor:
    """Render synthesis controls with the frame axis sharded over 'time'.

    Args:
      reverb: the decoder's ``Reverb`` module (the same on every rank).
      controls: {f0 (B,T,1), c (B,T,H), a (B,T,1), H (B,T,nf)}, the whole
        render's frame-rate controls on every rank; T divisible by the
        time axis.
      device: where this rank computes ('cuda' unless the CPU is asked
        for; without a GPU 'cuda' raises).

    Returns:
      this rank's samples (B, T/n_time * hop) of the (B, T*hop) render
      (``mesh.gather_time`` assembles it), equal to the unsharded decoder
      synthesis to float32 accuracy.
    """
    dev = resolve_device(device)
    mesh.require_member()
    n_time = mesh.shape[TIME_AXIS]
    t_total = controls["f0"].shape[1]
    if t_total % n_time:
        raise ValueError(f"T={t_total} not divisible by time axis {n_time}")
    ctl = {k: time_sharding(v, mesh) for k, v in controls_on(controls, dev).items()}
    return render_controls_local(
        reverb.to(dev), ctl["f0"], ctl["c"], ctl["a"], ctl["H"], noise_key.to(dev), conf,
        t_total // n_time, mesh, impl=impl)


@torch.no_grad()
def render_long_audio(
    decoder,
    batch: Dict,
    conf: Config,
    mesh: Mesh,
    noise_key: torch.Tensor,
    impl: Optional[str] = None,
    device="cuda",
) -> torch.Tensor:
    """Controller (replicated, frame rate) -> time-sharded synthesis.

    The GRU is sequential over frames but runs at frame rate, so every rank
    runs the controller over the whole T; only the sample-rate synthesis is
    sharded.  ``batch``: {'normalized_cents', 'loudness', 'f0'}, each
    (B, T, 1), on every rank.  Returns this rank's samples, as
    :func:`render_controls_sharded`.
    """
    from ddsp_tpu_torch.models.controller import controller_apply
    from ddsp_tpu_torch.models.nn import compute_dtype_of

    dev = resolve_device(device)
    decoder = decoder.to(dev)
    feats = {k: torch.as_tensor(batch[k], dtype=torch.float32, device=dev)
             for k in ("f0", "normalized_cents", "loudness")}
    controls, _ = controller_apply(decoder.controller, feats,
                                   compute_dtype=compute_dtype_of(conf.compute_dtype))
    return render_controls_sharded(decoder.reverb, controls, conf, mesh, noise_key,
                                   impl=impl, device=dev)
