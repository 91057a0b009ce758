"""The process group as a mesh of ranks, and the shardings as functions.

Counterpart of ``ddsp_tpu/parallel/mesh.py``.  JAX builds a ``Mesh`` of
devices in one controller and lets GSPMD place arrays; here every rank is
a process, so:

* :func:`make_mesh` / :func:`make_mesh3` lay ranks out on a grid with
  named axes ('data', 'time', 'model') and open one process group per
  line of the grid along each axis; the :class:`Mesh` a rank gets holds
  its coordinate, the axis sizes, its group along each axis and the group
  of the whole mesh.  Every rank of the job calls them, in the same order
  (``torch.distributed.new_group`` is collective), ranks outside the grid
  included; those get a mesh with no coordinate;
* :func:`replicated`, :func:`batch_sharding` and :func:`time_sharding`
  take a global tensor that every rank holds and return what this rank
  holds under the JAX package's sharding of the same name;
  :func:`gather_batch` and :func:`gather_time` gather the shards back;
* :func:`initialize_distributed` joins the job: the backend follows the
  device (``nccl`` for CUDA with one device per rank, ``gloo`` on the
  CPU, or on CUDA when the caller asks for it, as N ranks sharing one
  card must); nothing falls back from one backend or device to another.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ddsp_tpu_torch.device import resolve_device
from ddsp_tpu_torch.parallel.collectives import all_gather, psum

DATA_AXIS = "data"
TIME_AXIS = "time"
MODEL_AXIS = "model"
# JAX's default coordinator for a manual multi-process launch
DEFAULT_COORDINATOR = "127.0.0.1:12321"


class Mesh:
    """A grid of ranks with named axes, as one rank sees it.

    ``shape``: {axis: size}.  ``coords``: {axis: this rank's index}, or
    None for a rank outside the grid.  ``groups``: {axis: this rank's
    process group along that axis}.  ``group``: the whole mesh's group.
    """

    def __init__(self, grid: np.ndarray, axis_names: Sequence[str]):
        self.grid = grid
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, grid.shape))
        rank = dist.get_rank()
        at = np.argwhere(grid == rank)
        self.coords = dict(zip(self.axis_names, (int(i) for i in at[0]))) if len(at) else None
        self.groups = {}
        for axis, name in enumerate(self.axis_names):
            lines = np.moveaxis(grid, axis, -1).reshape(-1, grid.shape[axis])
            for line in lines:
                group = dist.new_group(ranks=[int(r) for r in line])
                if rank in line:
                    self.groups[name] = group
        self.group = dist.new_group(ranks=[int(r) for r in grid.flat])

    @property
    def size(self) -> int:
        return self.grid.size

    def require_member(self) -> None:
        if self.coords is None:
            raise ValueError(f"rank {dist.get_rank()} is not in this mesh "
                             f"{self.shape} of ranks {self.grid.ravel().tolist()}")


def _ranks(ranks: Optional[Sequence[int]]) -> list:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed first")
    return list(range(dist.get_world_size())) if ranks is None else list(ranks)


def _grid(shape, ranks: list) -> np.ndarray:
    needed = int(np.prod(shape))
    if needed > len(ranks):
        raise ValueError(f"mesh {'x'.join(map(str, shape))} needs {needed} ranks, "
                         f"have {len(ranks)}")
    return np.asarray(ranks[:needed]).reshape(shape)


def make_mesh(
    n_data: Optional[int] = None,
    n_time: int = 1,
    ranks: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = (DATA_AXIS, TIME_AXIS),
) -> Mesh:
    """A 2-axis mesh over ``ranks`` (all of the job's by default), laid
    out row-major; ('data', 'time') by default, ('data', 'model') for
    ``tp.make_dp_tp_mesh``, ('time', 'model') for ``tp.make_time_tp_mesh``."""
    ranks = _ranks(ranks)
    if n_data is None:
        if len(ranks) % n_time:
            raise ValueError(f"{len(ranks)} ranks not divisible by n_{axis_names[1]}={n_time}")
        n_data = len(ranks) // n_time
    return Mesh(_grid((n_data, n_time), ranks), axis_names)


def make_mesh3(
    n_data: int = 1,
    n_time: int = 1,
    n_model: int = 1,
    ranks: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = (DATA_AXIS, TIME_AXIS, MODEL_AXIS),
) -> Mesh:
    """('data', 'time', 'model') mesh: batch x sample axis x harmonic bank."""
    return Mesh(_grid((n_data, n_time, n_model), _ranks(ranks)), axis_names)


def replicated(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` as the mesh's first rank holds it, on every rank of the mesh
    (JAX's ``NamedSharding(mesh, P())``)."""
    mesh.require_member()
    first = all(i == 0 for i in mesh.coords.values())
    return psum(x if first else torch.zeros_like(x), mesh.group)


def _row_shard(mesh: Mesh):
    """(index, count) of this rank's rows under ``P((DATA_AXIS, TIME_AXIS))``."""
    mesh.require_member()
    idx, count = 0, 1
    for axis in (DATA_AXIS, TIME_AXIS):
        if axis in mesh.shape:
            idx, count = idx * mesh.shape[axis] + mesh.coords[axis], count * mesh.shape[axis]
    return idx, count


def batch_sharding(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a global batch: the leading axis split over the
    'data' and 'time' axes together (JAX's ``P((DATA_AXIS, TIME_AXIS))``).
    The batch must divide by their product."""
    idx, count = _row_shard(mesh)
    if x.shape[0] % count:
        raise ValueError(f"batch {x.shape[0]} not divisible by the mesh's {count} row shards")
    b = x.shape[0] // count
    return x[idx * b:(idx + 1) * b]


def time_sharding(x: torch.Tensor, mesh: Mesh, axis: int = 1) -> torch.Tensor:
    """This rank's frames: ``axis`` split over the 'time' axis."""
    mesh.require_member()
    n, idx = mesh.shape[TIME_AXIS], mesh.coords[TIME_AXIS]
    if x.shape[axis] % n:
        raise ValueError(f"axis {axis} of length {x.shape[axis]} not divisible by "
                         f"the time axis {n}")
    step = x.shape[axis] // n
    return x.narrow(axis, idx * step, step)


def gather_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The global batch from every rank's :func:`batch_sharding` rows."""
    mesh.require_member()
    for axis in (TIME_AXIS, DATA_AXIS):  # the inner axis first: rows (data, time)-major
        if axis in mesh.shape:
            x = torch.cat(list(all_gather(x, mesh.groups[axis])), dim=0)
    return x


def gather_time(x: torch.Tensor, mesh: Mesh, axis: int = -1) -> torch.Tensor:
    """The whole time axis from every rank's shard of it (a sharded render's
    samples, ``axis=-1``; frames, ``axis=1``)."""
    mesh.require_member()
    return torch.cat(list(all_gather(x, mesh.groups[TIME_AXIS])), dim=axis)


def initialize_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout: Optional[float] = None,
    device="cuda",
) -> torch.device:
    """Join the job; returns the device this rank computes on.

    ``coordinator``: an init method (``tcp://host:port``, ``file:///path``)
    or a bare ``host:port``.  Without one, torchrun's ``env://`` variables
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) are taken when set, else
    JAX's default ``127.0.0.1:12321`` when ``num_processes > 1``; a single
    process with none of these joins nothing.  If a process group already
    exists, it is kept, and its backend must be the one asked for (a
    ``ValueError`` otherwise).  ``backend``: None follows ``device``
    (``nccl`` for CUDA, ``gloo`` for the CPU); ``gloo`` on CUDA lets ranks
    share a card.  ``timeout``: seconds a collective may wait for a peer before it
    raises (a dead rank fails its survivors, it does not hang them).
    """
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("nccl runs on CUDA devices; pass backend='gloo' for the CPU")
    if not dist.is_initialized():
        env = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
        if coordinator is None and all(k in os.environ for k in env):
            init, world, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        elif coordinator is not None or (num_processes or 1) > 1:
            init = coordinator or DEFAULT_COORDINATOR
            init = init if "://" in init else f"tcp://{init}"
            world, rank = num_processes or 1, process_id or 0
        else:
            return dev
        if backend == "nccl" and world > torch.cuda.device_count():
            raise ValueError(f"nccl needs one device per rank: {world} ranks, "
                             f"{torch.cuda.device_count()} devices; pass backend='gloo' "
                             "for ranks that share a device")
        kwargs = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
        dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                                **kwargs)
    elif dist.get_backend() != backend:
        raise ValueError(f"a {dist.get_backend()} process group exists, and {backend} was "
                         f"asked for on {dev}")
    if dist.get_backend() == "nccl":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        return torch.device("cuda", local)
    return dev


def is_host0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0
