"""Parallelism on ``torch.distributed``: the counterpart of ``ddsp_tpu/parallel``.

* ``mesh``: the process group, a grid of ranks with named axes
  ('data', 'time', 'model') and a process group per axis, and the
  counterparts of the JAX package's shardings as plain functions that take
  this rank's rows or frames of a global tensor and gather them back;
* ``collectives``: ``axis_index``, ``axis_size``, ``psum``, ``all_gather``
  and ``ppermute`` over an axis's group, forward only, each written over
  ``all_reduce`` alone, which every backend takes for CPU and CUDA tensors;
* ``render``: the time-sharded long render (phase carry, control halos,
  overlap-save reverb halos);
* ``tp``: the harmonic-sharded render and its compositions with the data
  and time axes;
* ``train``: the data-parallel train step (the single step on this rank's
  rows plus one all-reduce);
* ``launch``: N rank processes on one machine, with a hard time limit.

The renders run under ``torch.no_grad``: their collectives are not
differentiable (the sequence-parallel loss and the tensor-parallel train
step, which need them to be, are not ported yet).
"""
