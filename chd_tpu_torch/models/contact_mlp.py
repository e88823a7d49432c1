"""The foot-contact MLP as a torch module (port of chd_tpu/models/contact_mlp.py).

Architecture of the reference OpenPoseModel: flattened ``window*joints*feat``
input → Linear(1024) → BN → ReLU → Linear(512) → BN → ReLU → Linear(128) →
BN → ReLU → Dropout(0.3) → Linear(32) → BN → ReLU → Linear(4*pred_size).
``ContactMLP.model`` is that ``nn.Sequential``, so its ``state_dict`` keys are
the reference's ``model.{0,1,3,4,6,7,10,11,13}.*`` and reference checkpoints
load with no key mapping.

For inference the eval-mode BN folds into the linear layers
(``fold_batchnorm``), leaving a chain of five matmuls: the form that
``ops.fused_mlp`` runs as one kernel.

In training mode ``forward`` is ``chd_tpu``'s ``apply(train=True)``:
BatchNorm normalizes with the batch's biased variance and moves the running
variance towards ``var * n / max(n - 1, 1)``, so a batch of one row (the
ragged tail of an epoch) gives variance 0 and the BN bias, where
``nn.BatchNorm1d`` would raise; dropout keeps 0.7 of the 128-wide
activations before ``linear3`` and scales them by 1 / 0.7, from an explicit
mask or generator, never the global RNG.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

HIDDEN = (1024, 512, 128, 32)
DROPOUT_LAYER = 3          # dropout applied to the 128-d activations, before linear3
DROPOUT_RATE = 0.3
BN_MOMENTUM = 0.1  # torch BatchNorm1d default
BN_EPS = 1e-5
LINEAR_IDX = (0, 3, 6, 10, 13)  # Linear positions in ContactMLP.model
BN_IDX = (1, 4, 7, 11)          # BatchNorm1d positions


class ModelConfig(NamedTuple):
    window_size: int = 9
    num_joints: int = 13
    pred_size: int = 5
    feat_size: int = 3  # (x, y, confidence)

    @property
    def in_dim(self) -> int:
        return self.window_size * self.num_joints * self.feat_size

    @property
    def out_dim(self) -> int:
        return 4 * self.pred_size


class ContactMLP(nn.Module):
    """The reference contact model; ``forward`` returns (B, out_dim) logits."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        dims = [in_dim, *HIDDEN, out_dim]
        layers: List[nn.Module] = []
        for i in range(len(HIDDEN)):
            if i == DROPOUT_LAYER:
                layers.append(nn.Dropout(DROPOUT_RATE))
            layers += [nn.Linear(dims[i], dims[i + 1]),
                       nn.BatchNorm1d(dims[i + 1], eps=BN_EPS), nn.ReLU()]
        layers.append(nn.Linear(dims[-2], dims[-1]))
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, dropout_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, mesh=None) -> torch.Tensor:
        """x: (B, W, J, F) or (B, in_dim) → (B, out_dim) logits.

        In training mode BN uses (and updates) batch statistics, and dropout
        keeps the True entries of ``dropout_mask`` (B, 128), or of a mask
        drawn from ``generator``; one of the two is required. With ``mesh``
        (``parallel.mesh.Mesh``), x is this rank's slice of the global batch
        and the BN statistics are the global batch's (sync-BN).
        """
        h = x.reshape(x.shape[0], -1)
        if not self.training:
            return self.model(h)
        for layer in self.model:
            if isinstance(layer, nn.BatchNorm1d):
                h = _batch_norm_train(layer, h, mesh)
            elif isinstance(layer, nn.Dropout):
                if dropout_mask is None:
                    if generator is None:
                        raise ValueError("training mode needs a dropout_mask or a generator")
                    dropout_mask = dropout_keep_mask(h.shape, generator, h.device)
                keep = 1.0 - layer.p
                h = torch.where(dropout_mask, h / keep, 0.0)
            else:
                h = layer(h)
        return h

    def linears(self) -> List[nn.Linear]:
        return [self.model[i] for i in LINEAR_IDX]

    def batchnorms(self) -> List[nn.BatchNorm1d]:
        return [self.model[i] for i in BN_IDX]

    def trees(self) -> Tuple[Dict, Dict]:
        """The module's own tensors as ``chd_tpu``'s (params, state) trees:
        ``linear{i}.w/b``, ``bn{i}.scale/bias`` and ``bn{i}.mean/var``."""
        params: Dict = {}
        state: Dict = {}
        for i, lin in enumerate(self.linears()):
            params[f"linear{i}"] = {"w": lin.weight, "b": lin.bias}
        for i, bn in enumerate(self.batchnorms()):
            params[f"bn{i}"] = {"scale": bn.weight, "bias": bn.bias}
            state[f"bn{i}"] = {"mean": bn.running_mean, "var": bn.running_var}
        return params, state


def _batch_norm_train(bn: nn.BatchNorm1d, h: torch.Tensor, mesh=None) -> torch.Tensor:
    """Train-mode BN with ``chd_tpu``'s statistics; updates ``bn``'s buffers.
    With ``mesh`` the mean and the biased variance (two passes) come from
    sums over every rank's rows, differentiable through the all-reduce, and
    n is the global batch."""
    if mesh is None:
        n = h.shape[0]
        mean = h.mean(dim=0)
        var = h.var(dim=0, unbiased=False)
    else:
        n = mesh.global_rows(h.shape[0])
        mean = mesh.differentiable_sum(h.sum(dim=0)) / n
        var = mesh.differentiable_sum(((h - mean) ** 2).sum(dim=0)) / n
    with torch.no_grad():
        m = BN_MOMENTUM
        bn.running_mean.copy_((1 - m) * bn.running_mean + m * mean)
        bn.running_var.copy_((1 - m) * bn.running_var + m * (var * n / max(n - 1, 1)))
        bn.num_batches_tracked.add_(1)
    return (h - mean) * torch.rsqrt(var + BN_EPS) * bn.weight + bn.bias


def dropout_keep_mask(shape, generator: torch.Generator, device) -> torch.Tensor:
    """A Bernoulli(1 - DROPOUT_RATE) keep mask drawn from ``generator``."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - DROPOUT_RATE


def init(cfg: ModelConfig, generator: torch.Generator) -> ContactMLP:
    """Xavier-uniform weights and bias 0.01, as the reference initializes."""
    model = ContactMLP(cfg.in_dim, cfg.out_dim)
    with torch.no_grad():
        for lin in model.linears():
            fan_out, fan_in = lin.weight.shape
            a = math.sqrt(6.0 / (fan_in + fan_out))
            lin.weight.uniform_(-a, a, generator=generator)
            lin.bias.fill_(0.01)
    return model


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-element binary cross-entropy with logits (reduction='none')."""
    z = logits
    return torch.clamp(z, min=0.0) - z * labels + torch.log1p(torch.exp(-z.abs()))


def fold_rows(w: torch.Tensor, b: torch.Tensor, bn: nn.BatchNorm1d
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode ``bn`` folded into the linear layer (w (out, in), b (out,))
    before it: each output row on its own, so a slice of rows folds to the
    same slice of the fold."""
    scale = bn.weight / torch.sqrt(bn.running_var + BN_EPS)
    return w * scale[:, None], (b - bn.running_mean) * scale + bn.bias


@torch.no_grad()
def fold_batchnorm(model: ContactMLP) -> Dict[str, List[torch.Tensor]]:
    """Fold eval-mode BN into the preceding linear layers.

    y = ((xWᵀ + b) - μ)/σ·γ + β ≡ x(W')ᵀ + b' with W' = (γ/σ)·W and
    b' = (b - μ)·γ/σ + β, σ = sqrt(var + 1e-5). Returns {'w': [5 × (out, in)],
    'b': [5 × (out,)]}, the layout of ``chd_tpu``'s ``fold_batchnorm``.
    """
    ws, bs = [], []
    bns = model.batchnorms()
    for i, lin in enumerate(model.linears()):
        w, b = lin.weight.detach(), lin.bias.detach()
        if i < len(bns):
            w, b = fold_rows(w, b, bns[i])
        ws.append(w.clone())
        bs.append(b.clone())
    return {"w": ws, "b": bs}


def apply_folded(folded: Dict, x: torch.Tensor, pred_size: int) -> torch.Tensor:
    """Eval forward through BN-folded weights: 5 matmuls + ReLUs → (B, P, 4)."""
    h = torch.addmm(folded["b"][0], x.reshape(x.shape[0], -1), folded["w"][0].T)
    if len(folded["w"]) > 1:
        h = torch.relu(h)
    return apply_folded_tail(folded, h, pred_size)


def apply_folded_tail(folded: Dict, h: torch.Tensor, pred_size: int) -> torch.Tensor:
    """Layers 1..n of the folded chain on first-layer activations h (B, H)."""
    n = len(folded["w"])
    for i in range(1, n):
        h = torch.addmm(folded["b"][i], h, folded["w"][i].T)
        if i < n - 1:
            h = torch.relu(h)
    return h.reshape(h.shape[0], pred_size, 4)
