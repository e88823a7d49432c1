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

The "model" axis carries the contact MLP's tensor parallelism:
``contact_model_shardings`` gives ``chd_tpu``'s placement of each of its
tensors (a spec: a tuple of the mesh axis each tensor axis splits over, or
None, as a ``PartitionSpec`` reads), ``named`` turns a tree of them into ``Placement``s
(this process's index slices), and ``Mesh.gather_model`` and
``Mesh.sum_model`` are the collectives over the "model" group that XLA
inserts in ``chd_tpu``: a cat and a sum in the single-process form, which
holds every "model" shard. ``parallel.tensor`` builds the sharded model on
them.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.contact_mlp import HIDDEN
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
        self._model_group = None
        if self.distributed:
            self._batch_group = _batch_group(self)
            self._model_group = device_mesh.get_group("model")

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

    @property
    def n_model(self) -> int:
        """The shards of the "model" axis."""
        return self.shape["model"]

    def model_shards(self) -> Tuple[int, ...]:
        """The "model" shards this process holds: its rank in the "model"
        group through it (the order of that group's gathers), or every one in
        the single-process form."""
        if not self.distributed:
            return tuple(range(self.n_model))
        return (dist.get_rank(self._model_group),)

    def gather_model(self, parts: Sequence[torch.Tensor], dim: int = -1) -> torch.Tensor:
        """This process's "model" shards of a tensor (``model_shards``' order)
        joined along ``dim`` into the whole, the same on every rank: an
        all-gather over the "model" group, or a cat in the single-process
        form. Differentiable: the backward sums the gradient over the group
        and keeps this rank's part (a reduce-scatter), since each rank's
        gradient of the whole holds only what flows through its own shards."""
        if not self.distributed:
            return torch.cat(list(parts), dim)
        (part,) = parts
        return _GatherModel.apply(part, dim, self._model_group)

    def sum_model(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum of partial tensors over the "model" shards, the same on
        every rank: an all-reduce over the "model" group, or a local sum in
        the single-process form. Differentiable, with the identity as its
        backward: every "model" rank computes the same loss from the sum, so
        a partial's gradient is the sum's (``differentiable_sum``'s
        all-reduce would count it once a rank)."""
        if not self.distributed:
            return torch.stack(list(parts)).sum(0)
        (part,) = parts
        return _SumModel.apply(part, self._model_group)

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


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, part, dim, group):
        part = part.contiguous()
        ctx.dim, ctx.size, ctx.group = dim, part.shape[dim], group
        parts = [torch.empty_like(part) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, part, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        # gloo has no reduce-scatter: all-reduce the whole, keep this part
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        start = dist.get_rank(ctx.group) * ctx.size
        return grad.narrow(ctx.dim, start, ctx.size), None, None


class _SumModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, part, group):
        out = part.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
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


# -- the contact MLP's tensor-parallel placement -------------------------------

def contact_model_shardings(mesh: Mesh) -> Tuple[Dict, Dict]:
    """Tensor-parallel specs of the contact MLP's (params, state) trees
    (``chd_tpu``'s keys), the same on every mesh, as ``chd_tpu``'s are:
    linear0-3 split on their output features (``w``'s rows, ``b``) over
    "model", with their BN vectors; linear4 on its input features (``w``'s
    columns), its bias whole. Weights are (out, in), ``nn.Linear``'s and
    ``chd_tpu``'s layout."""
    specs_params: Dict = {}
    specs_state: Dict = {}
    n_hidden = len(HIDDEN)
    for i in range(n_hidden + 1):
        if i < n_hidden:
            specs_params[f"linear{i}"] = {"w": ("model", None), "b": ("model",)}
            specs_params[f"bn{i}"] = {"scale": ("model",), "bias": ("model",)}
            specs_state[f"bn{i}"] = {"mean": ("model",), "var": ("model",)}
        else:
            specs_params[f"linear{i}"] = {"w": (None, "model"), "b": ()}
    return specs_params, specs_state


class Placement(NamedTuple):
    """Where a tensor lies on ``mesh``: split in ``mesh.n_model`` equal parts
    along ``axis`` over "model", or whole on every rank (``axis`` None)."""
    mesh: Mesh
    axis: Optional[int]

    def take(self, t: torch.Tensor) -> List[torch.Tensor]:
        """This process's parts of the whole tensor ``t``, one a "model" shard
        it holds (views), or ``[t]`` where it is whole."""
        if self.axis is None:
            return [t]
        m = self.mesh.n_model
        if t.shape[self.axis] % m:
            raise ValueError(f"axis {self.axis} of a {tuple(t.shape)} tensor does not split "
                             f"into {m} model shards")
        size = t.shape[self.axis] // m
        return [t.narrow(self.axis, k * size, size) for k in self.mesh.model_shards()]

    def join(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The whole tensor (a new one), on every rank, from this process's
        ``take``."""
        if self.axis is None:
            return parts[0].clone()
        return self.mesh.gather_model(parts, self.axis)


def named(mesh: Mesh, spec_tree):
    """A tree of specs (nested dicts of tuples) mapped to ``Placement``s on
    ``mesh``: what ``chd_tpu``'s ``named`` maps to ``NamedSharding``s. A
    spec may split one axis, over "model"."""
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    split = [i for i, name in enumerate(spec_tree) if name is not None]
    if len(split) > 1 or any(spec_tree[i] != "model" for i in split):
        raise ValueError(f"a spec may split one axis over 'model', not {spec_tree}")
    return Placement(mesh, split[0] if split else None)


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
