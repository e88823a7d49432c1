"""Contact-model evaluation (port of chd_tpu/contact/evaluate.py).

The reference's ``test.py`` as functions: window-level metrics per target
frame, and full-video evaluation with sliding-window vote merging and the
merged metrics. The rows of both run through the fused-MLP kernel on the
BN-folded weights (its plain version on the CPU); metrics come back as
Python floats.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..models.contact_mlp import ContactMLP
from ..ops import voting
from ..ops.fused_mlp import fused_mlp
from ..utils import metrics as metrics_lib
from . import data as data_lib
from . import infer
from .train import TrainConfig, eval_layers, eval_step, full_f32


def evaluate_windows(model: ContactMLP, dataset: data_lib.ContactDataset, split: str = "test",
                     cfg: TrainConfig = TrainConfig(), overlap: bool = False,
                     mlp=fused_mlp) -> Dict:
    """Window-level evaluation: the mean loss and each target frame's metrics."""
    op, ct = dataset.split_arrays(split)
    loss, confs = eval_step(model, op, ct, cfg, overlap=overlap, mlp=mlp)
    return {
        "loss": float(loss),
        "per_frame": [metrics_lib.metric_floats(
            metrics_lib.metrics_from_confusion(metrics_lib.Confusion(*c))) for c in confs.cpu()],
    }


@torch.no_grad()
def evaluate_full_video(model: ContactMLP, dataset: data_lib.ContactDataset,
                        split: str = "test", cfg: TrainConfig = TrainConfig(),
                        mlp=fused_mlp) -> Dict:
    """Full-video evaluation: every window of every (already gap-filled)
    sequence through ``mlp`` in conv mode, sigmoid > threshold, the vote
    merge, and the metrics of the merged (B, F, 4) predictions against the
    labels, with the overlapping window-level metrics."""
    op, ct = dataset.split_arrays(split)
    joints, root, appended = infer.subset_joints(cfg.joint_subset)
    with full_f32():
        logits = infer.mlp_logits(op[:, :, joints], eval_layers(model, cfg, use_conv=True),
                                  window_size=cfg.window_size, root_in_subset=root,
                                  root_appended=appended, use_confidence=cfg.use_confidence,
                                  use_conv=True, mlp=mlp)
    B, F = op.shape[:2]
    probs = torch.sigmoid(logits).reshape(B, F - cfg.window_size + 1, cfg.pred_size, 4)
    merged_pred = voting.merge_votes_batch((probs > cfg.classify_thresh).to(torch.float32),
                                           cfg.window_size)
    conf = metrics_lib.confusion_counts(merged_pred > 0.5, ct > 0.5)
    window_res = evaluate_windows(model, dataset, split, cfg, overlap=True, mlp=mlp)
    return {
        **window_res,
        "merged": metrics_lib.metric_floats(metrics_lib.metrics_from_confusion(conf)),
        "merged_predictions": merged_pred.cpu().numpy(),
    }
