"""Classification metrics for contact detection (port of
chd_tpu/utils/metrics.py).

Confusion counts and the metrics derived from them stay tensors on the
device they were computed on: nothing here reads a value back to the host,
so a training epoch can sum them without a sync. ``format_metrics`` is the
one that reads them, to print.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Confusion(NamedTuple):
    tp: torch.Tensor
    fp: torch.Tensor
    fn: torch.Tensor
    tn: torch.Tensor

    def __add__(self, other):
        return Confusion(*(a + b for a, b in zip(self, other)))


def confusion_counts(pred_bool: torch.Tensor, label_bool: torch.Tensor) -> Confusion:
    """Element-wise confusion totals over all axes."""
    p = pred_bool.to(torch.int64)
    lab = label_bool.to(torch.int64)
    return Confusion(
        tp=(p * lab).sum(),
        fp=(p * (1 - lab)).sum(),
        fn=((1 - p) * lab).sum(),
        tn=((1 - p) * (1 - lab)).sum(),
    )


def format_metrics(m: dict) -> str:
    """One-line metric summary."""
    return (
        f"accuracy {float(m['accuracy']):.4f}  precision {float(m['precision']):.4f}  "
        f"recall {float(m['recall']):.4f}  F1 {float(m['f1']):.4f}"
    )


def metrics_from_confusion(c: Confusion) -> dict:
    """accuracy, precision, recall, F1 as float32 tensors, and the confusion."""
    tp, fp, fn, tn = (torch.as_tensor(x).to(torch.float32) for x in c)
    total = tp + fp + fn + tn
    precision = tp / torch.clamp(tp + fp, min=1)
    recall = tp / torch.clamp(tp + fn, min=1)
    return {
        "accuracy": (tp + tn) / torch.clamp(total, min=1),
        "precision": precision,
        "recall": recall,
        "f1": 2 * precision * recall / torch.clamp(precision + recall, min=1e-12),
        "confusion": c,
    }


def metric_floats(m: dict) -> dict:
    """The metrics of ``metrics_from_confusion`` as Python floats (a sync)."""
    return {k: float(v) for k, v in m.items() if k != "confusion"}
