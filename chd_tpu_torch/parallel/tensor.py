"""Tensor parallelism of the contact MLP over a mesh's "model" axis.

``chd_tpu`` places the MLP's parameters, BN state and Adam moments by
``parallel.mesh.contact_model_shardings`` and jits its training step: XLA
inserts the collectives. Here the placement is explicit.
``shard_contact_model`` keeps this process's "model" shards of a
``ContactMLP`` as a ``TensorParallelContactMLP`` (plain parameters and
buffers, so Adam's elementwise step on them is that slice of the unsharded
step), and ``gather_contact_model`` puts the whole model back on every rank.

The training forward, on the full input rows of this rank's batch shard:

- linear0-3 are column-parallel: each shard computes its output features
  from the whole input;
- BN runs on the shard's features, with batch statistics summed over the
  batch group (``models.contact_mlp._batch_norm_train``) and the global
  batch's n; then ReLU;
- an all-gather along features (``Mesh.gather_model``) gives the next linear
  its whole input; dropout's (B, 128) mask applies to the gathered
  activation before linear3, the same rows on every "model" rank;
- linear3's shard goes straight into the row-parallel linear4, whose partial
  logits are summed over "model" (``Mesh.sum_model``) before its whole
  bias is added once.

Every "model" rank thus computes the same logits and loss. The all-gather's
backward is a reduce-scatter and the sum's the identity, so each shard's
gradient is that slice of the unsharded gradient, and the replicated bias's
gradient (and so its Adam state) is the same on every "model" rank. In
eval mode the shards' BN folds row by row into their linear layers
(``fold_batchnorm``), gathered: the folded layers of the gathered model,
bitwise. In the single-process form of a mesh one process holds every
shard, and the collectives are a cat and a sum.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..models import contact_mlp
from ..models.contact_mlp import BN_EPS, DROPOUT_LAYER, HIDDEN, ContactMLP
from . import mesh as mesh_lib


class _Shard(nn.Module):
    """One "model" shard: linear0-3's output rows with their BatchNorms, and
    linear4's input columns, without its bias."""

    def __init__(self, dims: List[int], m: int):
        super().__init__()
        n_hidden = len(HIDDEN)
        self.linears = nn.ModuleList(
            [nn.Linear(dims[i], dims[i + 1] // m) for i in range(n_hidden)]
            + [nn.Linear(dims[-2] // m, dims[-1], bias=False)])
        self.bns = nn.ModuleList(nn.BatchNorm1d(dims[i + 1] // m, eps=BN_EPS)
                                 for i in range(n_hidden))


class TensorParallelContactMLP(nn.Module):
    """This process's "model" shards of a ``ContactMLP`` on ``mesh`` (one,
    or every one in the single-process form), and linear4's bias whole.
    ``forward`` takes and returns what ``ContactMLP.forward`` does, on the
    mesh's device."""

    def __init__(self, in_dim: int, out_dim: int, mesh: mesh_lib.Mesh):
        super().__init__()
        m = mesh.n_model
        if any(d % m for d in HIDDEN):
            raise ValueError(f"a model axis of {m} does not divide the hidden widths {HIDDEN}")
        self.in_dim, self.out_dim, self.mesh = in_dim, out_dim, mesh
        dims = [in_dim, *HIDDEN, out_dim]
        self.shards = nn.ModuleList(_Shard(dims, m) for _ in mesh.model_shards())
        self.bias4 = nn.Parameter(torch.zeros(out_dim))

    def trees(self) -> Tuple[Dict, Dict]:
        """``ContactMLP.trees``' keys, each leaf the list of this process's
        parts in ``Placement.take``'s order (linear4's bias: one, whole)."""
        params: Dict = {}
        state: Dict = {}
        n_hidden = len(HIDDEN)
        for i in range(n_hidden + 1):
            lins = [s.linears[i] for s in self.shards]
            params[f"linear{i}"] = {"w": [lin.weight for lin in lins],
                                    "b": ([lin.bias for lin in lins] if i < n_hidden
                                          else [self.bias4])}
            if i < n_hidden:
                bns = [s.bns[i] for s in self.shards]
                params[f"bn{i}"] = {"scale": [bn.weight for bn in bns],
                                    "bias": [bn.bias for bn in bns]}
                state[f"bn{i}"] = {"mean": [bn.running_mean for bn in bns],
                                   "var": [bn.running_var for bn in bns]}
        return params, state

    def forward(self, x: torch.Tensor, dropout_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                mesh: Optional[mesh_lib.Mesh] = None) -> torch.Tensor:
        """x: (B, W, J, F) or (B, in_dim) → (B, out_dim) logits. In training
        mode x is this rank's slice of the global batch, ``mesh`` must be the
        one the model is sharded over, and ``dropout_mask`` (B, 128) or
        ``generator`` is required, as in ``ContactMLP.forward``; eval mode
        runs the folded layers (``fold_batchnorm``)."""
        h = x.reshape(x.shape[0], -1)
        if not self.training:
            logits = contact_mlp.apply_folded(fold_batchnorm(self), h, self.out_dim // 4)
            return logits.reshape(h.shape[0], -1)
        if mesh is not self.mesh:
            raise ValueError("a tensor-parallel model trains over the mesh it is sharded over")
        n_hidden = len(HIDDEN)
        for i in range(n_hidden):
            if i == DROPOUT_LAYER:
                if dropout_mask is None:
                    if generator is None:
                        raise ValueError("training mode needs a dropout_mask or a generator")
                    dropout_mask = contact_mlp.dropout_keep_mask(h.shape, generator, h.device)
                h = torch.where(dropout_mask, h / (1.0 - contact_mlp.DROPOUT_RATE), 0.0)
            parts = [torch.relu(contact_mlp._batch_norm_train(s.bns[i], s.linears[i](h), mesh))
                     for s in self.shards]
            if i < n_hidden - 1:
                h = mesh.gather_model(parts)
        partial = [s.linears[-1](p) for s, p in zip(self.shards, parts)]
        return mesh.sum_model(partial) + self.bias4


def shard_contact_model(model: ContactMLP, mesh: mesh_lib.Mesh) -> TensorParallelContactMLP:
    """This process's shards of ``model`` by ``contact_model_shardings(mesh)``,
    copied to the mesh's device in the model's dtype, in its training mode."""
    first = model.linears()[0]
    tp = TensorParallelContactMLP(first.in_features, model.linears()[-1].out_features,
                                  mesh).to(mesh.device, first.weight.dtype)
    with torch.no_grad():
        for spec, whole, parts in _zipped(mesh, model, tp):
            for dst, src in zip(parts, spec.take(whole)):
                dst.copy_(src)
        for s in tp.shards:
            for bn, src in zip(s.bns, model.batchnorms()):
                bn.num_batches_tracked.copy_(src.num_batches_tracked)
    return tp.train(model.training)


@torch.no_grad()
def gather_contact_model(tp: TensorParallelContactMLP) -> ContactMLP:
    """The whole model of ``tp``'s shards, on every rank (a collective over
    the "model" group: every rank of it calls it), with the gradients where
    the shards have them, in ``tp``'s training mode."""
    model = ContactMLP(tp.in_dim, tp.out_dim).to(tp.mesh.device, tp.bias4.dtype)
    for spec, whole, parts in _zipped(tp.mesh, model, tp):
        whole.copy_(spec.join(parts))
        if parts[0].grad is not None:
            whole.grad = spec.join([p.grad for p in parts])
    for bn, src in zip(model.batchnorms(), tp.shards[0].bns):
        bn.num_batches_tracked.copy_(src.num_batches_tracked)
    return model.train(tp.training)


@torch.no_grad()
def fold_batchnorm(tp: TensorParallelContactMLP) -> Dict[str, List[torch.Tensor]]:
    """``models.contact_mlp.fold_batchnorm`` of the sharded model: each
    shard's rows folded with its BN, gathered over "model" on every rank;
    bitwise the fold of ``gather_contact_model(tp)``."""
    mesh = tp.mesh
    ws, bs = [], []
    for i in range(len(HIDDEN)):
        rows = [contact_mlp.fold_rows(s.linears[i].weight, s.linears[i].bias, s.bns[i])
                for s in tp.shards]
        ws.append(mesh.gather_model([w for w, _ in rows], 0))
        bs.append(mesh.gather_model([b for _, b in rows], 0))
    ws.append(mesh.gather_model([s.linears[-1].weight for s in tp.shards], 1))
    bs.append(tp.bias4.detach().clone())
    return {"w": ws, "b": bs}


def _zipped(mesh: mesh_lib.Mesh, model: ContactMLP, tp: TensorParallelContactMLP):
    """(placement, whole tensor, this process's parts) for every leaf of
    the (params, state) trees."""
    for specs, whole, parts in zip(mesh_lib.contact_model_shardings(mesh), model.trees(),
                                   tp.trees()):
        placements = mesh_lib.named(mesh, specs)
        for mod, leaves in placements.items():
            for leaf, spec in leaves.items():
                yield spec, whole[mod][leaf], parts[mod][leaf]
