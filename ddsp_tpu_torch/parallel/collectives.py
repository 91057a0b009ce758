"""The collectives of a ``shard_map`` body, over one mesh axis's process group.

Counterparts of ``jax.lax.axis_index``, ``axis_size``, ``psum``,
``all_gather`` and ``ppermute``, forward only.  Each is written over
``all_reduce``, the one collective that every ``torch.distributed``
backend takes for both CPU and CUDA tensors (gloo's CUDA support is
``all_reduce`` and ``broadcast``; its ``send``/``recv`` are CPU only), so
a job of N ranks sharing one card over gloo runs the same code as N cards
over NCCL:

* ``all_gather`` is an ``all_reduce`` of a zeroed ``(n, ...)`` buffer that
  holds this rank's tensor in its slot: exact, since ``x + 0 = x``;
* ``ppermute`` is an ``all_gather`` and a select.  Ranks that receive
  nothing get zeros, as in JAX.

Every rank of the group must make the same calls in the same order.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist


def axis_index(group) -> int:
    """This rank's index along the axis of ``group``."""
    return dist.get_rank(group)


def axis_size(group) -> int:
    return dist.get_world_size(group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks, on every rank."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` in rank order, on every rank."""
    buf = x.new_zeros((axis_size(group), *x.shape))
    buf[axis_index(group)] = x
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf


def ppermute(x: torch.Tensor, group, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Rank ``dst`` gets ``x`` of rank ``src`` for each ``(src, dst)`` in
    ``perm``; a rank that is no ``dst`` gets zeros."""
    gathered = all_gather(x, group)
    idx = axis_index(group)
    src = [s for s, d in perm if d == idx]
    return gathered[src[0]] if src else torch.zeros_like(x)
