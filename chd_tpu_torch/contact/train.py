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
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from chd_tpu.characters.defs import OP_JOINT_SUBSETS

from ..models import contact_mlp, torch_convert
from ..models.contact_mlp import ContactMLP
from ..ops.fused_mlp import fused_mlp
from ..utils import metrics as metrics_lib
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


@contextlib.contextmanager
def full_f32():
    """float32 matmuls in full float32 inside the block (no TF32), whatever
    the process-wide setting; restored on exit."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def make_optimizer(model: ContactMLP, cfg: TrainConfig) -> torch.optim.Adam:
    """Adam with coupled L2: weight_decay * param added to the gradient
    before the moments (``optax.add_decayed_weights`` then ``adam``), eps
    outside the square root, over every parameter, BN's included."""
    return torch.optim.Adam(model.parameters(), lr=cfg.lr, betas=(cfg.beta1, cfg.beta2),
                            eps=cfg.eps, weight_decay=cfg.weight_decay)


def loss_and_logits(model: ContactMLP, feats: torch.Tensor, labels: torch.Tensor,
                    pred_size: int, dropout_mask: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean BCE loss and (B, P, 4) logits of a train-mode forward (which
    updates the BN running statistics)."""
    out = model(feats, dropout_mask=dropout_mask, generator=generator)
    logits = out.reshape(out.shape[0], pred_size, 4)
    return contact_mlp.bce_with_logits(logits, labels).mean(), logits


def train_step(model: ContactMLP, opt: torch.optim.Optimizer, batch_op: torch.Tensor,
               batch_contacts: torch.Tensor, cfg: TrainConfig, generator: torch.Generator,
               *, windows: Optional[Batch] = None, dropout_mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, metrics_lib.Confusion]:
    """One optimizer step on a batch of sequences. Windows and the dropout
    mask are drawn from ``generator`` unless given. Returns the loss and the
    middle frame's confusion counts, as device tensors."""
    if windows is None:
        windows = data_lib.sample_train_windows(
            generator, batch_op, batch_contacts, cfg.window_size, cfg.pred_size,
            cfg.joint_subset, cfg.noise_dev, cfg.use_confidence)
    feats, labels = windows
    if dropout_mask is None:
        dropout_mask = contact_mlp.dropout_keep_mask(
            (feats.shape[0], contact_mlp.HIDDEN[2]), generator, feats.device)
    model.train()
    with full_f32():
        opt.zero_grad(set_to_none=True)
        loss, logits = loss_and_logits(model, feats, labels, cfg.pred_size, dropout_mask)
        loss.backward()
        opt.step()
    mid = cfg.pred_size // 2
    with torch.no_grad():
        pred = torch.sigmoid(logits[:, mid]) > cfg.classify_thresh
        conf = metrics_lib.confusion_counts(pred, labels[:, mid] > 0.5)
    return loss.detach(), conf


def train_epoch(model: ContactMLP, opt: torch.optim.Optimizer, train_op: torch.Tensor,
                train_ct: torch.Tensor, batch_idx: torch.Tensor, cfg: TrainConfig,
                generator: torch.Generator) -> Tuple[torch.Tensor, metrics_lib.Confusion]:
    """One step per row of ``batch_idx`` (n_batches, B) of sequence indices
    on the device, with no host sync. Returns the per-batch losses
    (n_batches,) and the summed confusion counts, on the device."""
    losses, conf = [], None
    for idx in batch_idx:
        loss, c = train_step(model, opt, train_op[idx], train_ct[idx], cfg, generator)
        losses.append(loss)
        conf = c if conf is None else conf + c
    return torch.stack(losses), conf


def eval_layers(model: ContactMLP, cfg: TrainConfig, use_conv: bool):
    """The model's BN-folded layers for the fused-MLP kernel."""
    return infer.mlp_layers(contact_mlp.fold_batchnorm(model), window_size=cfg.window_size,
                            joint_subset=cfg.joint_subset,
                            use_confidence=cfg.use_confidence, use_conv=use_conv)


@torch.no_grad()
def eval_step(model: ContactMLP, op_data: torch.Tensor, contacts: torch.Tensor,
              cfg: TrainConfig, overlap: bool = False, mlp=fused_mlp
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Window-level evaluation of a split: the mean loss and the (P, 4)
    confusion counts (tp, fp, fn, tn) of each target frame, on the device.
    The windows' rows run through ``mlp`` (the kernel, or its plain
    version) on the folded layers."""
    feats, labels = data_lib.eval_windows(op_data, contacts, cfg.window_size, cfg.pred_size,
                                          cfg.joint_subset, overlap, cfg.use_confidence)
    flat = feats.flatten(1).contiguous()
    with full_f32():
        out = mlp(eval_layers(model, cfg, use_conv=False), flat, flat.shape[1], flat.shape[1])
    logits = out.reshape(-1, cfg.pred_size, 4)
    loss = contact_mlp.bce_with_logits(logits, labels).mean()
    pred = torch.sigmoid(logits) > cfg.classify_thresh
    confs = [torch.stack(tuple(metrics_lib.confusion_counts(pred[:, p], labels[:, p] > 0.5)))
             for p in range(cfg.pred_size)]
    return loss, torch.stack(confs)


def train(dataset: data_lib.ContactDataset, cfg: TrainConfig = TrainConfig(),
          out_dir: Optional[str] = None, log_every: int = 5,
          verbose: bool = True) -> Tuple[ContactMLP, Dict]:
    """A full training run on the dataset's device. Returns the model (in
    eval mode) and the history."""
    device = dataset.op_data.device
    model = contact_mlp.init(cfg.model_config(), torch.Generator().manual_seed(cfg.seed))
    model = model.to(device)
    opt = make_optimizer(model, cfg)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)

    train_op, train_ct = dataset.split_arrays("train")
    val_op, val_ct = dataset.split_arrays("val")
    n_train = train_op.shape[0]
    n_full = n_train // cfg.batch_size

    history = {"train_loss": [], "train_acc": [], "val_loss": [], "val_f1": [], "val_metrics": []}
    best_f1 = -np.inf
    rng_np = np.random.default_rng(cfg.seed)

    for epoch in range(cfg.epochs):
        perm = torch.from_numpy(rng_np.permutation(n_train)).to(device)
        losses, conf = [], None
        if n_full > 0:
            batch_idx = perm[:n_full * cfg.batch_size].reshape(n_full, cfg.batch_size)
            batch_losses, conf = train_epoch(model, opt, train_op, train_ct, batch_idx, cfg, gen)
            losses.append(batch_losses)
        for s in range(n_full * cfg.batch_size, n_train, cfg.batch_size):
            # the ragged tail batch, as the reference's DataLoader keeps it
            idx = perm[s:s + cfg.batch_size]
            loss, c = train_step(model, opt, train_op[idx], train_ct[idx], cfg, gen)
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
            vloss, confs = eval_step(model, val_op, val_ct, cfg)
            confs = confs.cpu()
            per_frame = [metrics_lib.metric_floats(
                metrics_lib.metrics_from_confusion(metrics_lib.Confusion(*c))) for c in confs]
            f1 = per_frame[cfg.pred_size // 2]["f1"]
            history["val_loss"].append(float(vloss))
            history["val_f1"].append(f1)
            history["val_metrics"].append(per_frame)
            if verbose:
                print(f"[val]   epoch {epoch}: loss {float(vloss):.4f} mid-frame F1 {f1:.4f}")
            if out_dir:
                torch_convert.save_npz(os.path.join(out_dir, "contact_weights.npz"), model)
                if f1 > best_f1:
                    best_f1 = f1
                    torch_convert.save_npz(os.path.join(out_dir, "contact_weights_BEST.npz"), model)

    if out_dir:
        torch_convert.save_npz(os.path.join(out_dir, "contact_weights_FINAL.npz"), model)
    return model.eval(), history
