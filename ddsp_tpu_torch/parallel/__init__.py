"""Parallelism on ``torch.distributed``: the counterpart of ``ddsp_tpu/parallel``.

* ``mesh``: the process group, a grid of ranks with named axes
  ('data', 'time', 'model') and a process group per axis (and per pair
  of axes on a 3-axis mesh), and the counterparts of the JAX package's
  shardings as plain functions that take this rank's rows or frames of a
  global tensor and gather them back;
* ``collectives``: ``axis_index``, ``axis_size``, ``psum``, ``pvary``,
  ``all_gather`` and ``ppermute`` over an axis's group, differentiable,
  each written over ``all_reduce`` alone (forward and backward), which
  every backend takes for CPU and CUDA tensors;
* ``render``: the time-sharded long render (phase carry, control halos,
  overlap-save reverb halos) and the harmonic bank's sharding;
* ``tp``: the harmonic-sharded render and its compositions with the data
  and time axes, and the DP x TP train step ``make_tp_train_step``;
* ``train``: the data-parallel train step (the single step on this rank's
  rows plus one all-reduce);
* ``sp``: the sequence-parallel train step over a ('data', 'time') mesh
  (DP x SP) or a ('data', 'time', 'model') mesh (DP x SP x TP),
  ``make_sp_train_step``, its loss ``make_sp_loss`` and the batch's
  placement ``shard_sp_batch``;
* ``launch``: N rank processes on one machine, with a hard time limit.

The renders run under ``torch.no_grad``; the train steps train through
the sharded renders.
"""

from ddsp_tpu_torch.parallel.collectives import pvary
from ddsp_tpu_torch.parallel.sp import make_sp_train_step
from ddsp_tpu_torch.parallel.tp import make_tp_train_step

__all__ = ["make_sp_train_step", "make_tp_train_step", "pvary"]
