"""Multi-process runtime (port of chd_tpu/parallel/distributed.py) on
torch.distributed.

``chd_tpu`` joins one JAX process per host with ``jax.distributed.initialize``
and lays a ("slice", "data", "model") mesh over every chip, "slice" across
hosts. Here one process drives one card, as ``torchrun --nproc-per-node N``
starts them:

- ``initialize`` joins the process group from torchrun's environment
  (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``)
  or from its arguments, on NCCL for a CUDA device and gloo for the CPU (the
  device the caller names decides, never what is installed), and makes
  ``cuda:LOCAL_RANK`` this process's card. Without any of them it does
  nothing and returns False, so every entry point may call it;
- ``make_global_mesh``: ("slice", "data", "model") over the ranks, a slice
  per node by default; the batch splits over ("slice", "data");
- ``process_local_slice`` and ``global_batch_from_local``: per-process data
  loading, each rank reading its own rows;
- ``on_primary``: work that is not split over the ranks (a pipeline stage
  that writes files a later stage reads) runs on rank 0 alone, and every
  rank gets its result once it is done.

``global_grid`` and ``mesh.ceil_slice`` are the layout arithmetic alone, so that
it can be checked without starting ranks.
"""
from __future__ import annotations

import datetime
import os
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from . import mesh as mesh_lib
from .mesh import ceil_slice

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def initialize(device="cuda", *, world_size: Optional[int] = None, rank: Optional[int] = None,
               local_rank: Optional[int] = None, store=None,
               timeout: Optional[float] = None) -> bool:
    """Join the process group. Returns True where it has more than one rank.

    The arguments default from torchrun's environment; a ``store`` (a
    ``torch.distributed.Store``, with ``world_size`` and ``rank``) replaces
    ``MASTER_ADDR``/``MASTER_PORT``. ``timeout`` (seconds) bounds every
    collective, so a rank that dies does not leave its peers waiting
    forever. A no-op (False) where nothing says multi-process; where a group
    is already initialized it only reports it.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    world_size = world_size if world_size is not None else _int_env("WORLD_SIZE")
    if world_size is None and store is None:
        return False  # single-process run; nothing to join
    rank = rank if rank is not None else (_int_env("RANK") or 0)
    device = resolve_device(device)
    if device.type not in BACKENDS:
        raise ValueError(f"no process-group backend for device {device}")
    if device.type == "cuda":
        local = local_rank if local_rank is not None else (_int_env("LOCAL_RANK") or 0)
        torch.cuda.set_device(local)
    dist.init_process_group(
        BACKENDS[device.type], init_method=None if store is not None else "env://",
        store=store, world_size=-1 if world_size is None else world_size, rank=rank,
        timeout=None if timeout is None else datetime.timedelta(seconds=timeout))
    return dist.get_world_size() > 1


def multi_rank() -> bool:
    """Whether a process group of more than one rank is initialized."""
    return dist.is_initialized() and dist.get_world_size() > 1


def is_primary() -> bool:
    """Whether this process is rank 0 (or there is no process group)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def on_primary(fn: Callable, *args, **kwargs) -> Any:
    """``fn(*args, **kwargs)`` on rank 0 alone of a multi-rank group, its
    (picklable) result broadcast to every rank, which waits for it; so the
    files ``fn`` writes are whole before any rank goes on. Without such a
    group ``fn`` just runs here. (Where rank 0 raises, its peers wait until
    the launcher ends them or the group's timeout.)"""
    if not multi_rank():
        return fn(*args, **kwargs)
    out = [fn(*args, **kwargs) if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(out, src=0)
    return out[0]


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def default_slices() -> int:
    """Nodes: ``WORLD_SIZE / LOCAL_WORLD_SIZE`` of torchrun's environment, 1
    without it."""
    world, local = _int_env("WORLD_SIZE"), _int_env("LOCAL_WORLD_SIZE")
    return world // local if world and local else 1


def global_grid(n_devices: int, model: int = 1, n_slices: int = 1) -> np.ndarray:
    """The (slice, data, model) grid of rank indices: rank order kept, so
    the inner axes stay within a node and only "slice" crosses nodes."""
    if n_devices % n_slices:
        raise ValueError(f"devices({n_devices}) not divisible by slices({n_slices})")
    per = n_devices // n_slices
    if per % model:
        raise ValueError(f"per-slice devices({per}) not divisible by model({model})")
    return np.arange(n_devices).reshape(n_slices, per // model, model)


def make_global_mesh(model: int = 1, n_slices: Optional[int] = None,
                     device=None) -> mesh_lib.Mesh:
    """("slice", "data", "model") mesh over every rank of the process group
    (``n_slices`` defaults to the nodes). Without a group, the single-process
    form of one shard on ``device`` (default ``cuda``)."""
    n_slices = default_slices() if n_slices is None else n_slices
    dims = ("slice", "data", "model")
    if dist.is_initialized():
        return mesh_lib.from_grid(global_grid(dist.get_world_size(), model, n_slices), dims)
    grid = global_grid(1, model, n_slices)
    return mesh_lib.Mesh(grid, dims, resolve_device("cuda" if device is None else device))


def batch_spec() -> tuple:
    """The axes the batch splits over: both the inter- and intra-node data
    axes."""
    return ("slice", "data")


def shard_global_batch(mesh: mesh_lib.Mesh, x):
    """This rank's contiguous slice of a leading-batch pytree, split over
    ("slice", "data")."""
    return mesh_lib.shard_batch(mesh, x)


def process_local_slice(n_items: int) -> slice:
    """This process's contiguous shard of a length-``n_items`` dataset
    (per-rank data loading: each rank reads only its own video dirs)."""
    if not dist.is_initialized():
        return slice(0, n_items)
    return ceil_slice(n_items, dist.get_rank(), dist.get_world_size())


def global_batch_from_local(mesh: mesh_lib.Mesh, local, global_shape0: int) -> torch.Tensor:
    """The global batch on every rank, from each rank's rows of
    ``process_local_slice(global_shape0)`` (``local``, on the host or a
    device)."""
    local = torch.as_tensor(np.asarray(local) if not isinstance(local, torch.Tensor)
                            else local).to(mesh.device)
    if not mesh.distributed:
        if local.shape[0] != global_shape0:
            raise ValueError(f"{local.shape[0]} local rows != global {global_shape0}")
        return local
    world = dist.get_world_size()
    per = -(-global_shape0 // world)
    want = ceil_slice(global_shape0, dist.get_rank(), world)
    if local.shape[0] != want.stop - want.start:
        raise ValueError(f"rank {dist.get_rank()} holds {local.shape[0]} rows; its slice of "
                         f"{global_shape0} has {want.stop - want.start}")
    padded = local.new_zeros((per,) + tuple(local.shape[1:]))
    padded[:local.shape[0]] = local
    parts = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(parts, padded)
    lens = [len(range(global_shape0)[ceil_slice(global_shape0, r, world)]) for r in range(world)]
    return torch.cat([p[:n] for p, n in zip(parts, lens)])
