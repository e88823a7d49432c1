"""Device mesh on torch.distributed (port of chd_tpu/parallel/mesh.py).

``chd_tpu`` places arrays on a ``jax.sharding.Mesh`` and XLA inserts the
collectives. Here a ``Mesh`` is a grid of the ranks of a process group, a thin
holder of ``torch.distributed.device_mesh.DeviceMesh``, and the data-parallel
entry points do by hand what XLA does there:

- ``shard_batch``: this rank's contiguous slice of the leading axis (a batch
  that does not divide by the batch shards raises, as ``jax.device_put`` does
  with a ``NamedSharding``);
- ``replicate``: a broadcast from rank 0;
- ``gather``: the per-rank results back to the global batch on every rank,
  since ``chd_tpu``'s sharded calls return global arrays;
- ``Mesh.all_sum`` and ``Mesh.differentiable_sum``: sums over the batch
  shards, the second with an all-reduce of the gradient as its backward.

The batch is split over every axis but "model". The NCCL backend serves CUDA
devices, gloo the CPU.

A ``Mesh`` also takes a single-process form: ``n`` shards on one device, what
``chd_tpu`` gets on one host from ``--xla_force_host_platform_device_count``.
Its one process holds every shard, so ``shard_batch`` and ``gather`` return
the whole batch, a sum is a local one, and ``parallel.longseq`` stacks the
shards of a sequence on a leading axis. ``local_mesh`` builds it, and
``make_mesh`` does where no process group is initialized.

``chd_tpu``'s ``contact_model_shardings`` and ``named`` (the contact MLP's
tensor-parallel shardings over "model") are not ported: the model has ~0.95M
parameters (ROADMAP §1).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

BATCH_EXCLUDED = ("model",)


def mesh_grid(n_devices: int, data: Optional[int] = None, model: int = 1) -> np.ndarray:
    """The (data, model) grid of rank indices of ``make_mesh``: rank r at
    row r // model, column r % model. Raises where data x model != n."""
    if data is None:
        data = n_devices // model
    if data * model != n_devices:
        raise ValueError(f"data({data}) × model({model}) != devices({n_devices})")
    return np.arange(n_devices).reshape(data, model)


def ceil_slice(n_items: int, index: int, count: int) -> slice:
    """Part ``index`` of ``count`` contiguous parts of ``n_items``, each
    ceil(n_items / count) long but the last (which may be shorter, or empty)."""
    per = -(-n_items // count)
    return slice(min(index * per, n_items), min((index + 1) * per, n_items))


def group_device() -> torch.device:
    """The device of this rank's tensors in the initialized process group:
    its current CUDA device under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class Mesh:
    """A grid of ranks (``grid[i, j, ...]`` is a rank) with named axes.

    ``device_mesh`` is the ``DeviceMesh`` over the same grid, or None in the
    single-process form, whose grid holds shard indices and whose one process
    holds them all on ``device``."""

    def __init__(self, grid: np.ndarray, dim_names: Sequence[str], device,
                 device_mesh=None):
        self.grid = np.asarray(grid)
        self.dim_names = tuple(dim_names)
        self.device = torch.device(device)
        self.device_mesh = device_mesh
        self.batch_dims = tuple(d for d in self.dim_names if d not in BATCH_EXCLUDED)
        self.n_batch = math.prod(self.shape[d] for d in self.batch_dims)
        self._batch_group = None
        if self.distributed:
            self._batch_group = _batch_group(self)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.dim_names, self.grid.shape))

    @property
    def distributed(self) -> bool:
        """True for a grid of process-group ranks, False for the
        single-process form."""
        return self.device_mesh is not None

    @property
    def primary(self) -> bool:
        """Whether this process is rank 0 (the single process is)."""
        return not self.distributed or dist.get_rank() == 0

    def coordinate(self) -> Tuple[int, ...]:
        """This rank's index along each axis."""
        where = np.argwhere(self.grid == dist.get_rank())
        return tuple(int(i) for i in where[0])

    def batch_index(self) -> int:
        """This rank's position in the flattened batch axes (0 in the
        single-process form, which holds every batch shard)."""
        if not self.distributed:
            return 0
        coord = dict(zip(self.dim_names, self.coordinate()))
        index = 0
        for d in self.batch_dims:
            index = index * self.shape[d] + coord[d]
        return index

    @property
    def local_shards(self) -> int:
        """Batch shards this process holds: one per rank, every one in the
        single-process form."""
        return 1 if self.distributed else self.n_batch

    def global_rows(self, local_rows: int) -> int:
        """The global batch size of an evenly split batch of ``local_rows``
        rows on this process."""
        return local_rows * self.n_batch // self.local_shards

    def batch_slice(self, n: int) -> slice:
        """This process's contiguous rows of an ``n``-row batch; raises
        where ``n`` does not divide by the batch shards."""
        if n % self.n_batch:
            raise ValueError(f"a batch of {n} does not divide over {self.n_batch} "
                             f"batch shards ({dict(self.shape)})")
        per = n // self.n_batch * self.local_shards
        start = self.batch_index() * per
        return slice(start, start + per)

    def split_slice(self, n: int) -> slice:
        """This process's rows of ``n`` under a ceil split by batch shard
        (the last may hold fewer, or none): for reductions whose counts are
        summed, where an uneven split is fine."""
        if not self.distributed:
            return slice(0, n)
        return ceil_slice(n, self.batch_index(), self.n_batch)

    def batch_group(self):
        """The process group over the batch axes through this rank (None in
        the single-process form)."""
        return self._batch_group

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the batch shards' processes (a new tensor)."""
        t = t.clone()
        if self.distributed:
            dist.all_reduce(t, group=self._batch_group)
        return t

    def differentiable_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``all_sum`` whose backward all-reduces the gradient: each rank
        uses the sum, so the gradient of a local input is the sum of every
        rank's gradient of it."""
        if not self.distributed:
            return t
        return _AllSum.apply(t, self._batch_group)


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _batch_group(mesh: Mesh):
    """The group of ranks that share this rank's "model" coordinate. Every
    rank makes every such group, in one order, as ``new_group`` asks."""
    if len(mesh.batch_dims) == 1:
        return mesh.device_mesh.get_group(mesh.batch_dims[0])
    keep = [i for i, d in enumerate(mesh.dim_names) if d not in BATCH_EXCLUDED]
    grid = np.moveaxis(mesh.grid, keep, list(range(len(keep))))
    columns = grid.reshape(mesh.n_batch, -1).T
    if len(columns) == 1:
        return dist.group.WORLD
    mine = None
    for ranks in columns:
        group = dist.new_group([int(r) for r in ranks])
        if dist.get_rank() in ranks:
            mine = group
    return mine


def make_mesh(n_devices: Optional[int] = None, data: Optional[int] = None, model: int = 1,
              device=None) -> Mesh:
    """A ("data", "model") mesh, all devices on "data" by default.

    With an initialized process group it spans its ranks (``n_devices``, if
    given, must be the world size) on each rank's own device. Without one it
    is the single-process form of ``n_devices`` shards (default 1) on
    ``device`` (default ``cuda``; raises where CUDA is absent)."""
    if dist.is_initialized():
        world = dist.get_world_size()
        n = world if n_devices is None else n_devices
        if n != world:
            raise ValueError(f"a mesh spans every rank: n_devices({n}) != world size({world})")
        grid = mesh_grid(n, data, model)
        return from_grid(grid, ("data", "model"))
    return local_mesh(1 if n_devices is None else n_devices, data, model,
                      "cuda" if device is None else device)


def local_mesh(n_devices: int, data: Optional[int] = None, model: int = 1,
               device="cuda") -> Mesh:
    """The single-process form of a ("data", "model") mesh: ``n_devices``
    shards on ``device`` (default ``cuda``; raises where CUDA is absent),
    whether or not a process group is initialized."""
    return Mesh(mesh_grid(n_devices, data, model), ("data", "model"), resolve_device(device))


def from_grid(grid: np.ndarray, dim_names: Sequence[str]) -> Mesh:
    """The process-group ``Mesh`` (and its ``DeviceMesh``) over a grid of
    every rank."""
    from torch.distributed.device_mesh import DeviceMesh

    device = group_device()
    dm = DeviceMesh(device.type, torch.as_tensor(grid), mesh_dim_names=tuple(dim_names))
    return Mesh(grid, dim_names, device, dm)


# -- pytrees: tensors in tuples, lists, dicts and NamedTuples -----------------

def tree_map(fn, x):
    """``fn`` on every tensor of ``x``; other leaves as they are."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(tree_map(fn, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(tree_map(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    return x


def shard_batch(mesh: Mesh, x):
    """This process's contiguous slice of the leading axis of every tensor
    of ``x``, on the mesh's device."""
    return tree_map(lambda a: a[mesh.batch_slice(a.shape[0])].to(mesh.device), x)


def replicate(mesh: Mesh, x):
    """Every tensor of ``x`` on the mesh's device, equal to rank 0's."""
    def one(a):
        a = a.to(mesh.device).clone()
        if mesh.distributed:
            dist.broadcast(a, src=int(mesh.grid.flat[0]))
        return a

    return tree_map(one, x)


def gather(mesh: Mesh, x):
    """The per-process slices of every tensor of ``x`` (``shard_batch``'s
    even split) concatenated back to the global batch on every rank."""
    if not mesh.distributed:
        return x
    group = mesh.batch_group()

    def one(a):
        t = a.to(torch.uint8) if a.dtype == torch.bool else a.contiguous()
        parts = [torch.empty_like(t) for _ in range(mesh.n_batch)]
        dist.all_gather(parts, t, group=group)
        out = torch.cat(parts)
        return out.bool() if a.dtype == torch.bool else out

    return tree_map(one, x)
