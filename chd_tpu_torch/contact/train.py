"""Contact-model training (port of chd_tpu/contact/train.py).

The reference trainer's recipe: Adam (lr 1e-4, L2 weight decay 1e-4 added
to the gradient), batch 64, 5000 epochs, mean BCE-with-logits loss,
validation every 20 epochs with the latest / BEST (middle-frame F1) / FINAL
weights written as ``chd_tpu``'s ``.npz``.

The dataset stays on the device. Each epoch samples one window per training
sequence there, and its steps run back to back with no host sync between
them: losses and confusion counts stay device tensors until the epoch is
logged, the counterpart of ``chd_tpu``'s one ``lax.scan`` dispatch per
epoch. Training runs autograd over ``nn.Linear`` (cuBLAS), as ``chd_tpu``
runs it through XLA, in full float32 (no TF32), which is what ``chd_tpu``
computes on the CPU. Evaluation folds BN and runs the window rows through
the fused-MLP kernel (``ops.fused_mlp``). Random draws come from one
explicit ``torch.Generator`` on the data's device, in a fixed order per
step: window targets, noise, dropout mask.

Data parallelism (``chd_tpu`` shards the batch axis of its jitted step over a
mesh, and XLA makes the BN statistics global): with a ``mesh``
(``parallel.mesh``) every rank draws the global batch's windows and dropout
mask from the same generator and keeps its slice, BN's statistics are
all-reduced sums (sync-BN), the loss is the global mean and the gradients
are summed over the ranks before Adam, so every rank takes the global
batch's step and keeps equal weights and Adam state.

Tensor parallelism (``chd_tpu`` places the parameters, BN state and Adam
moments by ``contact_model_shardings`` over the mesh's "model" axis):
``train_step`` and ``eval_step`` also take a ``parallel.tensor``
``TensorParallelContactMLP`` with the mesh it is sharded over. Its shards'
gradients are summed over the batch group alone, and Adam steps each shard.
``train`` is data-parallel only, as ``chd_tpu``'s ``train`` has no mesh.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..characters.defs import OP_JOINT_SUBSETS
from ..models import contact_mlp, torch_convert
from ..models.contact_mlp import ContactMLP
from ..ops.fused_mlp import fused_mlp
from ..parallel import mesh as mesh_lib
from ..parallel import tensor
from ..utils import metrics as metrics_lib
from ..utils.precision import full_f32
from . import data as data_lib
from . import infer

Batch = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    window_size: int = 9
    pred_size: int = 5
    batch_size: int = 64
    epochs: int = 5000
    val_every: int = 20
    classify_thresh: float = 0.5
    joint_set: str = "lower"
    use_confidence: bool = True
    lr: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4
    noise_dev: float = 0.005
    seed: int = 0

    @property
    def joint_subset(self) -> Tuple[int, ...]:
        return tuple(OP_JOINT_SUBSETS[self.joint_set])

    def model_config(self) -> contact_mlp.ModelConfig:
        return contact_mlp.ModelConfig(self.window_size, len(self.joint_subset), self.pred_size,
                                       3 if self.use_confidence else 2)


def make_optimizer(model: ContactMLP, cfg: TrainConfig) -> torch.optim.Adam:
    """Adam with coupled L2: weight_decay * param added to the gradient
    before the moments (``optax.add_decayed_weights`` then ``adam``), eps
    outside the square root, over every parameter, BN's included."""
    return torch.optim.Adam(model.parameters(), lr=cfg.lr, betas=(cfg.beta1, cfg.beta2),
                            eps=cfg.eps, weight_decay=cfg.weight_decay)


def loss_and_logits(model: ContactMLP, feats: torch.Tensor, labels: torch.Tensor,
                    pred_size: int, dropout_mask: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None, mesh=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean BCE loss and (B, P, 4) logits of a train-mode forward (which
    updates the BN running statistics). With ``mesh``, feats are this rank's
    rows and the loss is its share of the global mean (the ranks' shares sum
    to it)."""
    out = model(feats, dropout_mask=dropout_mask, generator=generator, mesh=mesh)
    logits = out.reshape(out.shape[0], pred_size, 4)
    bce = contact_mlp.bce_with_logits(logits, labels)
    if mesh is None:
        return bce.mean(), logits
    return bce.sum() / (mesh.global_rows(bce.shape[0]) * pred_size * 4), logits


def _sum_grads(model: nn.Module, mesh) -> None:
    """Every parameter's gradient summed over the batch shards' ranks, in one
    all-reduce (a tensor-parallel model's shards: their own gradients)."""
    params = [p for p in model.parameters() if p.grad is not None]
    flat = mesh.all_sum(torch.cat([p.grad.reshape(-1) for p in params]))
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad.copy_(g.view_as(p.grad))


def train_step(model: nn.Module, opt: torch.optim.Optimizer, batch_op: torch.Tensor,
               batch_contacts: torch.Tensor, cfg: TrainConfig, generator: torch.Generator,
               *, windows: Optional[Batch] = None, dropout_mask: Optional[torch.Tensor] = None,
               mesh=None) -> Tuple[torch.Tensor, metrics_lib.Confusion]:
    """One optimizer step on a batch of sequences. Windows and the dropout
    mask are drawn from ``generator`` unless given. Returns the loss and the
    middle frame's confusion counts, as device tensors.

    With ``mesh`` the batch, windows and mask given (or drawn) are the
    global batch's, the same on every rank; the step is the global batch's
    (sync-BN, summed gradients), and the loss and counts are global. The
    batch must divide over the mesh's batch shards. ``model`` is a
    ``ContactMLP`` or a ``TensorParallelContactMLP`` sharded over ``mesh``."""
    if windows is None:
        windows = data_lib.sample_train_windows(
            generator, batch_op, batch_contacts, cfg.window_size, cfg.pred_size,
            cfg.joint_subset, cfg.noise_dev, cfg.use_confidence)
    feats, labels = windows
    if dropout_mask is None:
        dropout_mask = contact_mlp.dropout_keep_mask(
            (feats.shape[0], contact_mlp.HIDDEN[2]), generator, feats.device)
    if mesh is not None:
        feats, labels, dropout_mask = mesh_lib.shard_batch(mesh, (feats, labels, dropout_mask))
    model.train()
    with full_f32():
        opt.zero_grad(set_to_none=True)
        loss, logits = loss_and_logits(model, feats, labels, cfg.pred_size, dropout_mask,
                                       mesh=mesh)
        loss.backward()
        if mesh is not None:
            _sum_grads(model, mesh)
        opt.step()
    mid = cfg.pred_size // 2
    with torch.no_grad():
        pred = torch.sigmoid(logits[:, mid]) > cfg.classify_thresh
        conf = metrics_lib.confusion_counts(pred, labels[:, mid] > 0.5)
        if mesh is not None:
            loss = mesh.all_sum(loss.detach())
            conf = metrics_lib.Confusion(*mesh.all_sum(torch.stack(tuple(conf))))
    return loss.detach(), conf


def train_epoch(model: ContactMLP, opt: torch.optim.Optimizer, train_op: torch.Tensor,
                train_ct: torch.Tensor, batch_idx: torch.Tensor, cfg: TrainConfig,
                generator: torch.Generator, mesh=None
                ) -> Tuple[torch.Tensor, metrics_lib.Confusion]:
    """One step per row of ``batch_idx`` (n_batches, B) of sequence indices
    on the device, with no host sync. Returns the per-batch losses
    (n_batches,) and the summed confusion counts, on the device. With
    ``mesh``, data-parallel global steps (``train_step``)."""
    losses, conf = [], None
    for idx in batch_idx:
        loss, c = train_step(model, opt, train_op[idx], train_ct[idx], cfg, generator,
                             mesh=mesh)
        losses.append(loss)
        conf = c if conf is None else conf + c
    return torch.stack(losses), conf


def eval_layers(model: nn.Module, cfg: TrainConfig, use_conv: bool):
    """The model's BN-folded layers for the fused-MLP kernel (a
    tensor-parallel model's gathered over its mesh's "model" axis)."""
    if isinstance(model, tensor.TensorParallelContactMLP):
        folded = tensor.fold_batchnorm(model)
    else:
        folded = contact_mlp.fold_batchnorm(model)
    return infer.mlp_layers(folded, window_size=cfg.window_size,
                            joint_subset=cfg.joint_subset,
                            use_confidence=cfg.use_confidence, use_conv=use_conv)


@torch.no_grad()
def eval_step(model: nn.Module, op_data: torch.Tensor, contacts: torch.Tensor,
              cfg: TrainConfig, overlap: bool = False, mlp=fused_mlp, mesh=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Window-level evaluation of a split: the mean loss and the (P, 4)
    confusion counts (tp, fp, fn, tn) of each target frame, on the device.
    The windows' rows run through ``mlp`` (the kernel, or its plain
    version) on the folded layers. With ``mesh`` each rank evaluates its
    contiguous part of the split (``Mesh.split_slice``: the "model" ranks
    of one batch shard share it), and the loss's sum and count and the
    confusion counts are summed over the batch shards' ranks. A
    tensor-parallel model's folded layers are gathered first, so the kernel
    runs the whole model on the rank's rows."""
    if mesh is not None:
        rows = mesh.split_slice(op_data.shape[0])
        op_data, contacts = op_data[rows], contacts[rows]
        if op_data.shape[0] == 0:
            # a ceil split can leave a rank no rows: it joins the same three
            # all-reduces (loss sum, count, counts), in order, with zeros
            zero = torch.zeros((), device=op_data.device)
            return (mesh.all_sum(zero) / mesh.all_sum(zero),
                    mesh.all_sum(torch.zeros((cfg.pred_size, 4), dtype=torch.int64,
                                             device=op_data.device)))
    feats, labels = data_lib.eval_windows(op_data, contacts, cfg.window_size, cfg.pred_size,
                                          cfg.joint_subset, overlap, cfg.use_confidence)
    flat = feats.flatten(1).contiguous()
    with full_f32():
        out = mlp(eval_layers(model, cfg, use_conv=False), flat, flat.shape[1], flat.shape[1])
    logits = out.reshape(-1, cfg.pred_size, 4)
    bce = contact_mlp.bce_with_logits(logits, labels)
    pred = torch.sigmoid(logits) > cfg.classify_thresh
    confs = torch.stack([torch.stack(tuple(metrics_lib.confusion_counts(pred[:, p],
                                                                        labels[:, p] > 0.5)))
                         for p in range(cfg.pred_size)])
    if mesh is None:
        return bce.mean(), confs
    count = torch.full((), bce.numel(), dtype=bce.dtype, device=bce.device)
    return mesh.all_sum(bce.sum()) / mesh.all_sum(count), mesh.all_sum(confs)


def train(dataset: data_lib.ContactDataset, cfg: TrainConfig = TrainConfig(),
          out_dir: Optional[str] = None, log_every: int = 5,
          verbose: bool = True, mesh=None) -> Tuple[ContactMLP, Dict]:
    """A full training run on the dataset's device. Returns the model (in
    eval mode) and the history.

    With ``mesh`` every rank holds the whole dataset and takes the global
    data-parallel steps of ``train_step`` (every batch, the ragged tail's
    too, must divide over the mesh's batch shards); validation runs
    ``eval_step`` on each rank's part of the split, and rank 0 alone writes
    the weights. A mesh with a "model" axis over 1 raises: ``chd_tpu``'s
    ``train`` has no tensor-parallel form."""
    if mesh is not None and mesh.n_model > 1:
        raise ValueError(f"train() is data-parallel only, not over a model axis of "
                         f"{mesh.n_model}: shard a model with parallel.tensor."
                         "shard_contact_model and step it with train_step")
    device = dataset.op_data.device
    model = contact_mlp.init(cfg.model_config(), torch.Generator().manual_seed(cfg.seed))
    model = model.to(device)
    opt = make_optimizer(model, cfg)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)

    train_op, train_ct = dataset.split_arrays("train")
    val_op, val_ct = dataset.split_arrays("val")
    n_train = train_op.shape[0]
    n_full = n_train // cfg.batch_size
    if mesh is not None:
        sizes = ({cfg.batch_size} if n_full else set()) | ({n_train % cfg.batch_size} - {0})
        for rows in sorted(sizes):
            if rows % mesh.n_batch:
                raise ValueError(f"a training batch of {rows} does not divide over the mesh's "
                                 f"{mesh.n_batch} batch shards")

    history = {"train_loss": [], "train_acc": [], "val_loss": [], "val_f1": [], "val_metrics": []}
    best_f1 = -np.inf
    primary = mesh is None or mesh.primary
    rng_np = np.random.default_rng(cfg.seed)

    for epoch in range(cfg.epochs):
        perm = torch.from_numpy(rng_np.permutation(n_train)).to(device)
        losses, conf = [], None
        if n_full > 0:
            batch_idx = perm[:n_full * cfg.batch_size].reshape(n_full, cfg.batch_size)
            batch_losses, conf = train_epoch(model, opt, train_op, train_ct, batch_idx, cfg, gen,
                                             mesh=mesh)
            losses.append(batch_losses)
        for s in range(n_full * cfg.batch_size, n_train, cfg.batch_size):
            # the ragged tail batch, as the reference's DataLoader keeps it
            idx = perm[s:s + cfg.batch_size]
            loss, c = train_step(model, opt, train_op[idx], train_ct[idx], cfg, gen, mesh=mesh)
            losses.append(loss[None])
            conf = c if conf is None else conf + c

        if epoch % log_every == 0:
            epoch_loss = float(torch.cat(losses).mean())
            acc = float(metrics_lib.metrics_from_confusion(conf)["accuracy"])
            history["train_loss"].append(epoch_loss)
            history["train_acc"].append(acc)
            if verbose:
                print(f"[train] epoch {epoch}: loss {epoch_loss:.4f} acc {acc:.4f}")

        if epoch % cfg.val_every == 0 and len(val_op) > 0:
            vloss, confs = eval_step(model, val_op, val_ct, cfg, mesh=mesh)
            confs = confs.cpu()
            per_frame = [metrics_lib.metric_floats(
                metrics_lib.metrics_from_confusion(metrics_lib.Confusion(*c))) for c in confs]
            f1 = per_frame[cfg.pred_size // 2]["f1"]
            history["val_loss"].append(float(vloss))
            history["val_f1"].append(f1)
            history["val_metrics"].append(per_frame)
            if verbose:
                print(f"[val]   epoch {epoch}: loss {float(vloss):.4f} mid-frame F1 {f1:.4f}")
            if out_dir and primary:
                torch_convert.save_npz(os.path.join(out_dir, "contact_weights.npz"), model)
                if f1 > best_f1:
                    best_f1 = f1
                    torch_convert.save_npz(os.path.join(out_dir, "contact_weights_BEST.npz"), model)

    if out_dir and primary:
        torch_convert.save_npz(os.path.join(out_dir, "contact_weights_FINAL.npz"), model)
    return model.eval(), history
