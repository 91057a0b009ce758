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
from typing import Dict

import torch

from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.device import resolve_device
from ddsp_tpu_torch.models.controller import decoder_apply
from ddsp_tpu_torch.parallel.collectives import all_gather, psum
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
    """This rank's rows of every array in ``batch``, on ``device``; the
    batch size must divide by the mesh size."""
    dev = resolve_device(device)
    return {k: batch_sharding(torch.as_tensor(v, device=dev), mesh) for k, v in batch.items()}


def all_reduce_mean(mesh: Mesh, loss: torch.Tensor, scales: Dict[str, torch.Tensor],
                    grads):
    """(loss, per-scale terms, gradients) averaged over the mesh's ranks in
    one ``all_reduce``."""
    names = sorted(scales)
    flat = torch.cat([loss.reshape(1)] + [scales[k].detach().reshape(1) for k in names]
                     + [g.reshape(-1) for g in grads])
    flat = psum(flat, mesh.group) / mesh.size
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
    resolve_device(device)
    mesh.require_member()
    shard, _ = _row_shard(mesh)

    def loss(params, batch, conf_, noise_key):
        offset = shard * batch["f0"].shape[0]
        return loss_fn(params, batch, conf_, noise_key,
                       decode=functools.partial(decoder_apply, noise_row_offset=offset))

    return make_train_step(conf, loss=loss,
                           reduce=functools.partial(all_reduce_mean, mesh))
