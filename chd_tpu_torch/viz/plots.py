"""Training/evaluation plots (matplotlib Agg; port of chd_tpu/viz/plots.py:
inputs may be tensors on any device).

Replaces src/contact_learning/utils.py plotting: train curves
(plot_train_stats:166-192), confusion matrices (plot_confusion_mat:122-163),
accuracy histograms (plot_accuracy_hist:110-120), and towr_utils.plot_3curve
(:124-141).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .video import to_host

_CURVES = ("train_loss", "val_loss", "train_acc", "val_f1")


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_train_curves(history: dict, out_path: str):
    """``history``: the dict ``contact.train.train`` returns; its curves may
    be lists of floats or of tensors, or tensors."""
    history = {k: [float(v) for v in np.asarray(to_host(vals), dtype=float).reshape(-1)]
               for k, vals in history.items() if k in _CURVES}
    plt = _plt()
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    axes[0].plot(history.get("train_loss", []), label="train")
    if history.get("val_loss"):
        axes[0].plot(
            np.linspace(0, max(len(history["train_loss"]) - 1, 1), len(history["val_loss"])),
            history["val_loss"], label="val",
        )
    axes[0].set_title("loss"); axes[0].legend()
    axes[1].plot(history.get("train_acc", []), label="train acc")
    if history.get("val_f1"):
        axes[1].plot(
            np.linspace(0, max(len(history["train_acc"]) - 1, 1), len(history["val_f1"])),
            history["val_f1"], label="val F1",
        )
    axes[1].set_ylim(0.0, 1.0)
    axes[1].set_title("accuracy / F1"); axes[1].legend()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return out_path


def plot_confusion_matrix(confusion, out_path: str):
    """confusion: (tp, fp, fn, tn) counts → normalized 2×2 heatmap."""
    plt = _plt()
    tp, fp, fn, tn = [float(x) for x in to_host(confusion)]
    total = max(tp + fp + fn + tn, 1)
    mat = np.array([[tp, fn], [fp, tn]]) / total
    fig, ax = plt.subplots(figsize=(4, 4))
    im = ax.imshow(mat, cmap="Blues", vmin=0, vmax=1)
    for (i, j), v in np.ndenumerate(mat):
        ax.text(j, i, f"{v:.3f}", ha="center", va="center")
    ax.set_xticks([0, 1], ["pred contact", "pred none"])
    ax.set_yticks([0, 1], ["label contact", "label none"])
    fig.colorbar(im)
    fig.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_accuracy_hist(accuracies: Sequence[float], out_path: str):
    accuracies = to_host(accuracies)
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.bar(range(len(accuracies)), accuracies)
    ax.set_ylim(0.8, 1.0)  # reference's operating range (utils.py:116)
    ax.set_xlabel("target frame"); ax.set_ylabel("accuracy")
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return out_path


def plot_3curve(arr: np.ndarray, dt: float, out_path: str, ylabel: str = ""):
    arr, dt = to_host((arr, dt))
    plt = _plt()
    t = np.arange(arr.shape[0]) * dt
    fig, ax = plt.subplots()
    for i, (c, lbl) in enumerate(zip("rgb", "XYZ")):
        ax.plot(t, arr[:, i], f"-{c}", label=lbl)
    ax.set_xlabel("time (s)"); ax.set_ylabel(ylabel); ax.legend()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return out_path
