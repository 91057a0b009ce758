"""Tensor parallelism over the harmonic axis of the oscillator bank.

Counterpart of ``ddsp_tpu/parallel/tp.py``.  Each rank of the 'model'
axis renders a contiguous slice of the harmonic bank (the amplitudes
sliced on their channel axis, rendered at the matching ``h_start``: on
the card, K1 forward and K2 backward with that offset); the Nyquist
renormalisation's denominator, a sum over every harmonic, and the partial
audio are the only values summed across the axis, one ``psum`` each.  The
frame-rate controls and the noise and reverb branches stay replicated over
'model'.  The bank is zero-padded to a multiple of the axis (zero-amplitude
harmonics render nothing).  It composes with data parallelism (mesh
('data', 'model'), rows over 'data') and with the time-sharded render
(mesh ('time', 'model')).

:func:`make_tp_train_step` is the DP x TP train step.  Its backward
takes JAX's transposes (``render.tp_harmonics``, ``render.bank_slice``):
the values every model rank holds alike enter its slice through
``pvary``, whose backward sums their cotangents over 'model', so every
model rank ends with the same, whole gradient, and the step averages it
over 'data' only.  The renders run under ``torch.no_grad``.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence

import torch

from ddsp_tpu_torch.config import Config, refuse_z
from ddsp_tpu_torch.device import resolve_device
from ddsp_tpu_torch.models.controller import controller_apply
from ddsp_tpu_torch.models.nn import compute_dtype_of
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
from ddsp_tpu_torch.parallel.render import (FEATURE_KEYS, bank_slice, controls_on,
                                            render_controls_local, tp_harmonics)
from ddsp_tpu_torch.parallel.train import all_reduce_mean
from ddsp_tpu_torch.training.trainer import loss_fn, make_train_step


def make_dp_tp_mesh(n_data: Optional[int] = None, n_model: int = 1,
                    ranks: Optional[Sequence[int]] = None) -> Mesh:
    """('data', 'model') mesh: batch over 'data', harmonics over 'model'."""
    return make_mesh(n_data, n_model, ranks, axis_names=(DATA_AXIS, MODEL_AXIS))


def make_time_tp_mesh(n_time: int = 1, n_model: int = 1,
                      ranks: Optional[Sequence[int]] = None) -> Mesh:
    """('time', 'model') mesh: long-render frames over 'time', the harmonic
    bank over 'model'."""
    return make_mesh(n_time, n_model, ranks, axis_names=(TIME_AXIS, MODEL_AXIS))


def _rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    b_local = x.shape[0] // mesh.shape[DATA_AXIS]
    d = mesh.coords[DATA_AXIS]
    return x[d * b_local:(d + 1) * b_local]


def _render_tp_rows(reverb, controls: Dict[str, torch.Tensor], conf: Config, mesh: Mesh,
                    noise_key: torch.Tensor, impl: Optional[str], row_offset: int) -> torch.Tensor:
    """This rank's rows of the TP render, from its rows' controls with the
    whole bank (the harmonic slice is taken here)."""
    pad = [edge_pad_frames(x) for x in (controls["f0"], bank_slice(controls["c"], mesh),
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


def _decode_tp_rows(decoder, feats: Dict[str, torch.Tensor], conf: Config, mesh: Mesh,
                    noise_key: torch.Tensor) -> torch.Tensor:
    """The TP decode of this rank's rows of features: the controller on
    them (replicated over 'model', ``conf.compute_dtype`` honoured), then
    the harmonic-sharded synthesis, each row's noise at its global row.
    Differentiable: the train step's decode."""
    controls, _ = controller_apply(decoder.controller, feats,
                                   compute_dtype=compute_dtype_of(conf.compute_dtype))
    row_offset = mesh.coords[DATA_AXIS] * feats["f0"].shape[0]
    return _render_tp_rows(decoder.reverb, controls, conf, mesh, noise_key, None, row_offset)


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
    ``batch``: the whole batch's features, on every rank.  Returns this
    rank's rows, as :func:`render_controls_tp`."""
    dev = resolve_device(device)
    mesh.require_member()
    feats = {k: _rows(torch.as_tensor(batch[k], dtype=torch.float32, device=dev), mesh)
             for k in FEATURE_KEYS}
    return _decode_tp_rows(decoder.to(dev), feats, conf, mesh, noise_key.to(dev))


def make_tp_train_step(conf: Config, mesh: Mesh, device="cuda"):
    """(replicated state, this rank's rows) -> (state, metrics): the DP x TP
    step over a ('data', 'model') mesh.

    Place the inputs with ``train.shard_state`` and ``train.shard_batch``,
    which takes each data rank's rows and replicates them over 'model'
    (``mesh.batch_sharding`` splits rows over 'data' and 'time' only).
    The optimizer and metrics are ``trainer.make_train_step``'s; the loss
    is ``trainer.loss_fn`` on the TP decode of this rank's rows, and the
    loss, the per-scale terms and the gradients are averaged over the
    'data' axis alone: every model rank's gradients are already the whole
    gradient of its data rank's rows (the first model rank's copy is
    averaged, ``train.sum_over``).  Every rank returns the same state and
    metrics, those of the global batch's single-device step to float32
    accuracy.
    """
    refuse_z(conf, "make_tp_train_step", "a tensor-parallel z encoder")
    resolve_device(device)
    if set(mesh.shape) != {DATA_AXIS, MODEL_AXIS}:
        raise ValueError(f"the tensor-parallel step takes a ('data', 'model') mesh, got axes "
                         f"{mesh.axis_names}")
    mesh.require_member()

    def decode(params, batch, conf_, noise_key):
        return _decode_tp_rows(params, batch, conf_, mesh, noise_key)

    def loss(params, batch, conf_, noise_key):
        return loss_fn(params, batch, conf_, noise_key, decode=decode)

    return make_train_step(conf, loss=loss, reduce=functools.partial(
        all_reduce_mean, mesh, axes=(DATA_AXIS,)))


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
    ctl["c"] = bank_slice(ctl["c"], mesh)
    ctl = {k: time_sharding(v, mesh) for k, v in ctl.items()}
    return render_controls_local(
        reverb.to(dev), ctl["f0"], ctl["c"], ctl["a"], ctl["H"], noise_key.to(dev), conf,
        t_total // n_time, mesh, impl=impl, model_axis=MODEL_AXIS)
