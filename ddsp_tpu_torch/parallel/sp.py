"""Sequence-parallel training: the MSS loss and its gradients over
time-sharded audio.

Counterpart of ``ddsp_tpu/parallel/sp.py``.  The train step runs with the
batch rows sharded over the mesh's 'data' axis and the sample axis over
its 'time' axis, so an example longer than one card's activation memory
trains as one example:

* **forward**: the controller runs at frame rate on this data rank's rows
  over the whole T, replicated over 'time'; each rank takes its frames
  and synthesises its samples with ``render.render_controls_local`` (the
  phase carry, the control halo and the overlap-save reverb halo), K1 on
  the card at the carried phase;
* **loss**: each rank takes the STFT frames it owns.  A frame of the
  centred spectrogram straddles a shard edge by up to ``n_fft//2``
  samples, so the ranks exchange that halo each way (the global edges
  reflect their own samples, as the offline reflect pad does), take
  ``torch.stft(center=False)`` over the halo'd window, and the loss is
  assembled from the |.|-sums summed over the whole mesh: the offline
  loss's arithmetic, in another order;
* **backward**: ordinary autograd through the differentiable collectives
  (``collectives.py``); K2 on the card.  Every rank's loss is the global
  one, so each rank's parameter gradients are its share of the global
  gradient, and the step sums them over ('data', 'time').

On a ('data', 'time', 'model') mesh (``mesh.make_mesh3``) the step is DP
x SP x TP: the harmonic bank is also sharded over 'model'
(``render.bank_slice``, ``render.tp_harmonics``, with their ``pvary``
transposes), each rank renders its slice of its frames, and every model
rank ends with the same gradients, so the loss and the gradients are
summed over ('data', 'time') only, never over 'model'.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ddsp_tpu_torch.config import Config, refuse_z
from ddsp_tpu_torch.device import resolve_device
from ddsp_tpu_torch.models.controller import controller_apply
from ddsp_tpu_torch.models.nn import compute_dtype_of
from ddsp_tpu_torch.ops.spectral import _window
from ddsp_tpu_torch.parallel.collectives import (axis_index, axis_size, ppermute, psum,
                                                 rank_mask)
from ddsp_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, TIME_AXIS, Mesh, time_sharding
from ddsp_tpu_torch.parallel.render import (CONTROL_KEYS, FEATURE_KEYS, bank_slice,
                                            render_controls_local)
from ddsp_tpu_torch.parallel.train import sum_over
from ddsp_tpu_torch.training.trainer import make_train_step

EPS = 1e-7  # the MSS loss's log floor (losses.sss_loss)


def _stft_halo_window(x: torch.Tensor, half: int, group) -> torch.Tensor:
    """[left halo | local | right halo] of ``half`` samples a side.

    The interior halos come from the neighbours (one ``ppermute`` each
    way); the global edges reflect the shard's own samples, as the offline
    reflect pad does (torch 'reflect': no edge repeat).  Needs a shard of
    at least ``half + 1`` samples.
    """
    n, idx = axis_size(group), axis_index(group)
    local = x.shape[-1]
    if local < half + 1:
        raise ValueError(f"local shard length {local} < n_fft//2 + 1 = {half + 1}; "
                         "use fewer time shards or longer examples")
    left = ppermute(x[..., -half:].contiguous(), group, [(i, i + 1) for i in range(n - 1)])
    left = torch.where(rank_mask(idx == 0, x), x[..., 1:half + 1].flip(-1), left)
    right = ppermute(x[..., :half].contiguous(), group, [(i + 1, i) for i in range(n - 1)])
    right = torch.where(rank_mask(idx == n - 1, x), x[..., -half - 1:-1].flip(-1), right)
    return torch.cat([left, x, right], dim=-1)


def _sharded_sss_sums(pred: torch.Tensor, true: torch.Tensor, n_fft: int, hop: int,
                      group) -> Tuple[torch.Tensor, torch.Tensor]:
    """This shard's (linear, log) |diff|-sums of one STFT scale.

    Shard s owns global frames [s Ls/hop, (s+1) Ls/hop), and the last
    shard also the final one: together the 1 + L/hop centred frames of the
    offline spectrogram.  Every shard computes Ls/hop + 1 frames of its
    halo'd window and drops the extra one, except on the last shard.
    """
    local = pred.shape[-1]
    if local % hop:
        raise ValueError(f"the shard's {local} samples are not a multiple of the STFT hop "
                         f"{hop}: its frames would leave the global frame grid")
    half = n_fft // 2
    keep = local // hop + (1 if axis_index(group) == axis_size(group) - 1 else 0)

    def power(x):
        window = _stft_halo_window(x, half, group)
        spec = torch.stft(window.reshape(-1, window.shape[-1]), n_fft, hop_length=hop,
                          window=_window(n_fft, x.dtype, x.device), center=False,
                          return_complex=True)[..., :keep]
        return spec.real * spec.real + spec.imag * spec.imag

    mp, mt = power(pred), power(true)
    lin = torch.abs(mp - mt).sum()
    log = torch.abs(torch.log2(mt + EPS) - torch.log2(mp + EPS)).sum()
    return lin, log


def _check_mesh(mesh: Mesh) -> None:
    if set(mesh.shape) not in ({DATA_AXIS, TIME_AXIS}, {DATA_AXIS, TIME_AXIS, MODEL_AXIS}):
        raise ValueError(f"the sequence-parallel step takes a ('data', 'time') or ('data', "
                         f"'time', 'model') mesh, got axes {mesh.axis_names}")
    mesh.require_member()


def make_sp_loss(conf: Config, mesh: Mesh):
    """Sequence-parallel loss with ``trainer.loss_fn``'s signature.

    ``(params, batch, conf, noise_key) -> (loss, per-scale dict)``, where
    ``batch`` is this rank's part of the global batch as
    :func:`shard_sp_batch` places it: the features of this data rank's
    rows over the whole T, the audio of those rows over this time rank's
    samples.  Every rank returns the global batch's loss.  With a 'model'
    axis, each rank renders its slice of the harmonic bank.
    """
    _check_mesh(mesh)
    n_data, n_time = mesh.shape[DATA_AXIS], mesh.shape[TIME_AXIS]
    time_group = mesh.groups[TIME_AXIS]
    model_axis = MODEL_AXIS if MODEL_AXIS in mesh.shape else None
    sum_group = mesh.group_over((DATA_AXIS, TIME_AXIS))

    def sp_loss(params, batch: Dict[str, torch.Tensor], conf_: Config, noise_key):
        del conf_  # bound at construction; kept for the signature
        b_local, t_total = batch["f0"].shape[:2]
        if t_total % n_time:
            raise ValueError(f"T={t_total} not divisible by time={n_time}")
        t_local = t_total // n_time
        controls, _ = controller_apply(params.controller, {k: batch[k] for k in FEATURE_KEYS},
                                       compute_dtype=compute_dtype_of(conf.compute_dtype))
        if model_axis is not None:
            controls = dict(controls, c=bank_slice(controls["c"], mesh))
        ctl = {k: time_sharding(controls[k], mesh) for k in CONTROL_KEYS}
        pred = render_controls_local(
            params.reverb, ctl["f0"], ctl["c"], ctl["a"], ctl["H"], noise_key, conf, t_local,
            mesh, model_axis=model_axis, row_offset=mesh.coords[DATA_AXIS] * b_local)
        hops = [int(n_fft * (1 - conf.mss_overlap)) for n_fft in conf.mss_ffts]
        sums = torch.stack([s for n_fft, hop in zip(conf.mss_ffts, hops)
                            for s in _sharded_sss_sums(pred, batch["audio"], n_fft, hop,
                                                       time_group)])
        sums = psum(sums, sum_group)  # every scale's sums in one all_reduce
        length = batch["audio"].shape[-1] * n_time
        scales = {}
        for i, (n_fft, hop) in enumerate(zip(conf.mss_ffts, hops)):
            count = b_local * n_data * (1 + length // hop) * (n_fft // 2 + 1)
            scales[f"mss_{n_fft}"] = (sums[2 * i] + conf.mss_alpha * sums[2 * i + 1]) / count
        return sum(scales.values()), scales

    return sp_loss


def shard_sp_batch(batch: Dict, mesh: Mesh, device="cuda") -> Dict[str, torch.Tensor]:
    """This rank's part of a global batch, on ``device``: the features'
    rows over 'data' (every frame), the audio's rows over 'data' and its
    samples over 'time' (JAX's ``P('data')`` and ``P('data', 'time')``),
    both replicated over 'model' where the mesh has it."""
    dev = resolve_device(device)
    _check_mesh(mesh)
    n, idx = mesh.shape[DATA_AXIS], mesh.coords[DATA_AXIS]
    b = batch["f0"].shape[0]
    if b % n:
        raise ValueError(f"B={b} not divisible by data={n}")
    rows = {k: torch.as_tensor(batch[k], device=dev)[idx * (b // n):(idx + 1) * (b // n)]
            for k in (*FEATURE_KEYS, "audio")}
    rows["audio"] = time_sharding(rows["audio"], mesh, axis=-1)
    return rows


def make_sp_train_step(conf: Config, mesh: Mesh, device="cuda"):
    """(replicated state, this rank's part of the batch) -> (state,
    metrics): the DP x SP step.

    Place the inputs with ``train.shard_state`` and :func:`shard_sp_batch`.
    The optimizer and metrics are ``trainer.make_train_step``'s; only the
    loss is swapped, and the parameter gradients are summed over ('data',
    'time') (each rank's loss is already the global one, so its gradients
    are its share of the global gradient: neither a mean nor a sum of the
    loss; on a 3-axis mesh every model rank holds the same share, and the
    first model rank's copy is summed, ``train.sum_over``).  Every rank
    returns the same state and metrics, those of the global batch's
    single-device step to float32 accuracy.
    """
    refuse_z(conf, "make_sp_train_step", "the z encoder's MFCCs over time shards")
    resolve_device(device)
    loss = make_sp_loss(conf, mesh)

    def reduce(loss_val, scales, grads):
        flat = sum_over(torch.cat([g.reshape(-1) for g in grads]), mesh, (DATA_AXIS, TIME_AXIS))
        return loss_val, scales, [f.view_as(g) for f, g in
                                  zip(flat.split([g.numel() for g in grads]), grads)]

    return make_train_step(conf, loss=loss, reduce=reduce)
