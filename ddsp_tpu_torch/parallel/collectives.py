"""The collectives of a ``shard_map`` body, over one mesh axis's process group.

Counterparts of ``jax.lax.axis_index``, ``axis_size``, ``psum``,
``pvary``, ``all_gather`` and ``ppermute``, differentiable under
``torch.autograd`` with the transposes ``jax.grad`` takes through a
``shard_map``.  Each is written over ``all_reduce``, forward and
backward, the one collective that every ``torch.distributed`` backend
takes for both CPU and CUDA tensors (gloo's CUDA support is
``all_reduce`` and ``broadcast``; its ``send``/``recv`` are CPU only),
so a job of N ranks sharing one card over gloo runs the same code as N
cards over NCCL:

* ``psum``'s backward hands the cotangent on unchanged, JAX's transpose
  of a ``psum`` into an invariant value (a broadcast).  It is the true
  gradient when every rank uses the sum identically, so that the
  cotangent is the same on every rank: the sequence-parallel loss
  (``sp.py``) and the harmonic-sharded render's partial audio
  (``render.tp_harmonics``) are such uses;
* ``pvary`` is the identity forward and a ``psum`` of the cotangent
  backward, JAX's ``pvary`` (Megatron's "copy to the model-parallel
  region"): where a value that every rank holds alike enters a
  computation that differs by rank, each rank's cotangent is its share
  of the gradient, and the backward sums the shares.  A sum whose ranks
  use it differently, such as the harmonic-sharded render's Nyquist
  denominator, which scales each rank's own harmonic slice, is
  ``pvary(psum(x))``: the form JAX gives an invariant sum used by a
  varying value;
* ``all_gather`` is an ``all_reduce`` of a zeroed ``(n, ...)`` buffer that
  holds this rank's tensor in its slot (exact, since ``x + 0 = x``); its
  backward is a reduce-scatter: the ``psum`` of the cotangent, then this
  rank's slot;
* ``ppermute`` is an ``all_gather`` and a select that keeps the gathered
  tensor in the graph on every rank, so its backward is the reversed
  permutation.  Ranks that receive nothing get zeros, as in JAX.

Every rank of the group must make the same calls in the same order, in
the backward too: autograd runs a node's backward only where its output
reaches the loss, so a select made by a Python branch (``a if edge else
b``) leaves the edge ranks out of the backward ``all_reduce`` the others
wait in.  Select with ``torch.where`` on :func:`rank_mask` instead, which
keeps both operands in the graph on every rank.  Likewise ``pvary``'s
backward runs only where its input requires a gradient, so its input
must require one on every rank of the group or on none.
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


def rank_mask(cond: bool, like: torch.Tensor) -> torch.Tensor:
    """``cond`` (a fact about this rank) as a 0-d bool tensor on ``like``'s
    device, for a ``torch.where`` that every rank makes alike."""
    return torch.full((), cond, dtype=torch.bool, device=like.device)


def _all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_sum(g.contiguous(), ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        buf = x.new_zeros((axis_size(group), *x.shape))
        buf[axis_index(group)] = x
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        return buf

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_sum(g.contiguous(), ctx.group)[axis_index(ctx.group)], None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks, on every rank; the backward
    passes the cotangent on unchanged (see the module docstring for when
    that is the gradient)."""
    return _Psum.apply(x, group)


def pvary(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged; the backward sums the cotangent over the group's
    ranks (see the module docstring for where it goes)."""
    return _Pvary.apply(x, group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` in rank order, on every rank."""
    return _AllGather.apply(x, group)


def ppermute(x: torch.Tensor, group, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Rank ``dst`` gets ``x`` of rank ``src`` for each ``(src, dst)`` in
    ``perm``; a rank that is no ``dst`` gets zeros."""
    gathered = all_gather(x, group)
    idx = axis_index(group)
    src = [s for s, d in perm if d == idx]
    got = gathered[src[0] if src else idx]
    return torch.where(rank_mask(bool(src), x), got, torch.zeros_like(got))
