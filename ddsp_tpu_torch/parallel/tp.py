"""Tensor parallelism over the harmonic axis of the oscillator bank.

Counterpart of ``ddsp_tpu/parallel/tp.py``, its render half.  Each rank
of the 'model' axis renders a contiguous slice of the harmonic bank (the
amplitudes sliced on their channel axis, rendered at the matching
``h_start``: on the card, K1 with that offset); the Nyquist
renormalisation's denominator, a sum over every harmonic, and the partial
audio are the only values summed across the axis, one ``psum`` each.  The
frame-rate controls and the noise and reverb branches stay replicated over
'model'.  The bank is zero-padded to a multiple of the axis (zero-amplitude
harmonics render nothing).  It composes with data parallelism (mesh
('data', 'model'), rows over 'data') and with the time-sharded render
(mesh ('time', 'model')).

The train step over this mesh (``make_tp_train_step``) needs collectives
that autograd can differentiate and is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.device import resolve_device
from ddsp_tpu_torch.models.synths import noise_apply, osc_fill, reverb_apply
from ddsp_tpu_torch.ops.interp import edge_pad_frames
from ddsp_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    TIME_AXIS,
    Mesh,
    make_mesh,
    time_sharding,
)
from ddsp_tpu_torch.parallel.render import controls_on, render_controls_local, tp_harmonics


def make_dp_tp_mesh(n_data: Optional[int] = None, n_model: int = 1,
                    ranks: Optional[Sequence[int]] = None) -> Mesh:
    """('data', 'model') mesh: batch over 'data', harmonics over 'model'."""
    return make_mesh(n_data, n_model, ranks, axis_names=(DATA_AXIS, MODEL_AXIS))


def make_time_tp_mesh(n_time: int = 1, n_model: int = 1,
                      ranks: Optional[Sequence[int]] = None) -> Mesh:
    """('time', 'model') mesh: long-render frames over 'time', the harmonic
    bank over 'model'."""
    return make_mesh(n_time, n_model, ranks, axis_names=(TIME_AXIS, MODEL_AXIS))


def _bank_slice(c: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This model rank's slice of the (zero-padded) harmonic bank."""
    n_model = mesh.shape[MODEL_AXIS]
    c = F.pad(c, (0, (-c.shape[-1]) % n_model))
    h_local = c.shape[-1] // n_model
    h0 = mesh.coords[MODEL_AXIS] * h_local
    return c[..., h0:h0 + h_local]


def _rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    b_local = x.shape[0] // mesh.shape[DATA_AXIS]
    d = mesh.coords[DATA_AXIS]
    return x[d * b_local:(d + 1) * b_local]


def _render_tp_rows(reverb, controls: Dict[str, torch.Tensor], conf: Config, mesh: Mesh,
                    noise_key: torch.Tensor, impl: Optional[str], row_offset: int) -> torch.Tensor:
    """This rank's rows of the TP render, from its rows' controls with the
    whole bank (the harmonic slice is taken here)."""
    pad = [edge_pad_frames(x) for x in (controls["f0"], _bank_slice(controls["c"], mesh),
                                         controls["a"])]
    harm = tp_harmonics(*pad, conf, mesh.groups[MODEL_AXIS],
                        osc_fill(impl or conf.osc_impl, controls["f0"].device))
    dry = harm + noise_apply(controls, conf, noise_key, row_offset)
    return reverb_apply(reverb, dry, conf)


@torch.no_grad()
def render_controls_tp(
    reverb,
    controls: Dict,
    conf: Config,
    mesh: Mesh,
    noise_key: torch.Tensor,
    impl: Optional[str] = None,
    device="cuda",
) -> torch.Tensor:
    """Render controls with the harmonic bank sharded over 'model'.

    Args:
      reverb: the decoder's ``Reverb`` module.
      controls: {f0 (B,T,1), c (B,T,H), a (B,T,1), H (B,T,nf)}, the whole
        batch's, on every rank; B divisible by the 'data' axis.
      impl: 'xla' | 'pallas' | 'auto' (None = ``conf.osc_impl``), as
        ``models/synths.osc_fill`` reads it.

    Returns:
      this rank's rows (B / n_data, T*hop), the same on every model rank,
      equal to the unsharded synthesis to float32 accuracy.
    """
    dev = resolve_device(device)
    mesh.require_member()
    b_global = controls["f0"].shape[0]
    if b_global % mesh.shape[DATA_AXIS]:
        raise ValueError(f"B={b_global} not divisible by data axis {mesh.shape[DATA_AXIS]}")
    ctl = {k: _rows(v, mesh) for k, v in controls_on(controls, dev).items()}
    row_offset = mesh.coords[DATA_AXIS] * ctl["f0"].shape[0]
    return _render_tp_rows(reverb.to(dev), ctl, conf, mesh, noise_key.to(dev), impl,
                           row_offset)


@torch.no_grad()
def decoder_apply_tp(
    decoder,
    batch: Dict,
    conf: Config,
    mesh: Mesh,
    noise_key: torch.Tensor,
    device="cuda",
) -> torch.Tensor:
    """Full decode with TP synthesis: the controller on this rank's rows
    (replicated over 'model'), then the harmonic-sharded synthesis.
    Returns this rank's rows, as :func:`render_controls_tp`."""
    from ddsp_tpu_torch.models.controller import controller_apply
    from ddsp_tpu_torch.models.nn import compute_dtype_of

    dev = resolve_device(device)
    mesh.require_member()
    decoder = decoder.to(dev)
    feats = {k: _rows(torch.as_tensor(batch[k], dtype=torch.float32, device=dev), mesh)
             for k in ("f0", "normalized_cents", "loudness")}
    controls, _ = controller_apply(decoder.controller, feats,
                                   compute_dtype=compute_dtype_of(conf.compute_dtype))
    row_offset = mesh.coords[DATA_AXIS] * feats["f0"].shape[0]
    return _render_tp_rows(decoder.reverb, controls, conf, mesh, noise_key.to(dev), None,
                           row_offset)


@torch.no_grad()
def render_controls_time_tp(
    reverb,
    controls: Dict,
    conf: Config,
    mesh: Mesh,
    noise_key: torch.Tensor,
    impl: Optional[str] = None,
    device="cuda",
) -> torch.Tensor:
    """Long-render scale-out on both axes: frames over 'time', the harmonic
    bank over 'model'.  The two axes' collectives do not interact: the
    phase carry and the control and reverb halos of
    ``render.render_controls_local`` ride 'time', the renormalisation and
    the partial audio 'model'.  Returns this rank's samples (B,
    T/n_time * hop), the same on every model rank."""
    dev = resolve_device(device)
    mesh.require_member()
    n_time = mesh.shape[TIME_AXIS]
    t_total = controls["f0"].shape[1]
    if t_total % n_time:
        raise ValueError(f"T={t_total} not divisible by time axis {n_time}")
    ctl = controls_on(controls, dev)
    ctl["c"] = _bank_slice(ctl["c"], mesh)
    ctl = {k: time_sharding(v, mesh) for k, v in ctl.items()}
    return render_controls_local(
        reverb.to(dev), ctl["f0"], ctl["c"], ctl["a"], ctl["H"], noise_key.to(dev), conf,
        t_total // n_time, mesh, impl=impl, model_axis=MODEL_AXIS)
