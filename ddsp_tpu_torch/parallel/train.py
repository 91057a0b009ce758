"""Data-parallel training: the single-card train step on this rank's rows.

Counterpart of ``ddsp_tpu/parallel/train.py``, where XLA partitions the
jitted step over a batch-sharded mesh and inserts the gradient
all-reduce.  Here each rank runs the port's ``training/trainer``
step on its own rows, with:

* each row's noise keyed by its global row index (``frame_noise`` keys
  row b by ``fold_in(key, b)``, so rank r draws rows r * B_local + i, as
  the whole batch's step would);
* one ``all_reduce`` of the gradients, the loss and the per-scale terms,
  averaged over the ranks before the optimizer step, so every rank takes
  the same update and the plateau schedule and the metrics see the global
  loss; ``grad_norm`` is the reduced gradient's.

The state is replicated: :func:`shard_state` broadcasts rank 0's and
checks that the replicas agree.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Sequence

import torch

from ddsp_tpu_torch.config import Config, refuse_z
from ddsp_tpu_torch.device import resolve_device
from ddsp_tpu_torch.models.controller import decoder_apply
from ddsp_tpu_torch.parallel.collectives import all_gather, psum, rank_mask
from ddsp_tpu_torch.parallel.mesh import Mesh, _row_shard, batch_sharding, replicated
from ddsp_tpu_torch.training.trainer import TrainState, loss_fn, make_train_step


def _state_tensors(state: TrainState):
    """Every tensor of the state, in a fixed order: parameters, the Adam
    moments and count, the plateau fields, the key."""
    opt = state.opt_state
    return (list(state.params.parameters()) + list(opt.adam.mu) + list(opt.adam.nu)
            + [opt.adam.count, *opt.plateau, state.rng])


def state_checksum(state: TrainState) -> torch.Tensor:
    """(n,) float64 sum of each state tensor: equal across ranks whose
    replicas agree."""
    return torch.stack([t.detach().double().sum() for t in _state_tensors(state)])


def shard_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Replicate the state over the mesh (the DP layout): rank 0's values
    on every rank, in place; raises if the replicas then differ."""
    mesh.require_member()
    with torch.no_grad():
        for t in _state_tensors(state):
            t.copy_(replicated(t, mesh))
    sums = all_gather(state_checksum(state), mesh.group)
    if not bool((sums == sums[0]).all()):
        raise RuntimeError("the state's replicas differ after the broadcast")
    return state


def shard_batch(batch: Dict, mesh: Mesh, device="cuda") -> Dict[str, torch.Tensor]:
    """This rank's rows of every array in ``batch``, on ``device``: the
    rows split over the mesh's 'data' and 'time' axes, replicated over
    'model'; the batch size must divide by that split."""
    dev = resolve_device(device)
    return {k: batch_sharding(torch.as_tensor(v, device=dev), mesh) for k, v in batch.items()}


def sum_over(x: torch.Tensor, mesh: Mesh, axes: Sequence[str]) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes``, on every rank of the
    mesh, in one ``all_reduce`` over the whole mesh.  The mesh's other
    axes hold copies of one value (the gradients of a tensor-parallel
    step's model ranks): only the copy of their first rank enters the sum,
    the others add zeros, so every rank ends with the same bits.  On the
    card the copies differ in their last bits: the MSS loss's backward
    (``torch.stft``'s reflect pad and overlapping frames) accumulates with
    atomic adds, whose order varies.  For the reductions after the
    backward: under autograd the other copies would take no cotangent."""
    first = all(mesh.coords[a] == 0 for a in mesh.axis_names if a not in axes)
    return psum(torch.where(rank_mask(first, x), x, torch.zeros_like(x)), mesh.group)


def all_reduce_mean(mesh: Mesh, loss: torch.Tensor, scales: Dict[str, torch.Tensor],
                    grads, axes: Optional[Sequence[str]] = None):
    """(loss, per-scale terms, gradients) averaged over the ranks of
    ``axes`` (None: the whole mesh) in one ``all_reduce``; a copy along
    the other axes is taken once (:func:`sum_over`)."""
    axes = mesh.axis_names if axes is None else axes
    names = sorted(scales)
    flat = torch.cat([loss.reshape(1)] + [scales[k].detach().reshape(1) for k in names]
                     + [g.reshape(-1) for g in grads])
    flat = sum_over(flat, mesh, axes) / math.prod(mesh.shape[a] for a in axes)
    out, at = [], 1 + len(names)
    for g in grads:
        out.append(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return flat[0], {k: flat[1 + i] for i, k in enumerate(names)}, out


def make_parallel_train_step(conf: Config, mesh: Mesh, device="cuda"):
    """(replicated state, this rank's rows) -> (state, metrics): the DP step.

    Place the inputs with :func:`shard_state` and :func:`shard_batch`.
    The global batch is this rank's rows times the mesh size; every rank
    returns the same state and metrics, those of the whole batch's step
    to float32 accuracy.
    """
    refuse_z(conf, "make_parallel_train_step", "the z encoder's audio among each rank's rows")
    resolve_device(device)
    mesh.require_member()
    shard, _ = _row_shard(mesh)

    def loss(params, batch, conf_, noise_key):
        offset = shard * batch["f0"].shape[0]
        return loss_fn(params, batch, conf_, noise_key,
                       decode=functools.partial(decoder_apply, noise_row_offset=offset))

    return make_train_step(conf, loss=loss,
                           reduce=functools.partial(all_reduce_mean, mesh))
