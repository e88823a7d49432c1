"""Sliding-window featurization for contact detection (port of
chd_tpu/ops/windows.py).

``featurize_batch`` materializes every window of every video (the
``use_conv=False`` path). ``layer1_conv_kernel`` folds featurization and the
MLP's first layer into one temporal-conv weight, which ``ops.fused_mlp`` reads
as an implicit im2col over the raw frames (the default path).
"""
from __future__ import annotations

import torch


def num_windows(num_frames: int, window_size: int) -> int:
    """Overlapping windows: every frame except the edges is a target frame."""
    return num_frames - 2 * (window_size // 2)


def featurize_batch(x: torch.Tensor, window_size: int, root_in_subset: int,
                    use_confidence: bool = True) -> torch.Tensor:
    """(V, F, J, 3) preprocessed subset keypoints → (V, N, W, J, feat).

    Every window's x/y are relative to the root of its target (middle) frame,
    whose own root slot holds that absolute root position.
    """
    F = x.shape[1]
    N = F - window_size + 1
    mid = window_size // 2
    wins = torch.stack([x[:, w:w + N] for w in range(window_size)], dim=2)
    r = x[:, mid:mid + N, root_in_subset, :2]  # (V, N, 2) target roots
    xy = wins[..., :2] - r[:, :, None, None, :]
    xy[:, :, mid, root_in_subset, :] = r
    if not use_confidence:
        return xy
    return torch.cat([xy, wins[..., 2:]], dim=-1)


def layer1_conv_kernel(w1: torch.Tensor, window_size: int, n_joints: int,
                       root_idx: int, n_model_joints: int,
                       use_confidence: bool = True) -> torch.Tensor:
    """The folded first-layer weight w1 (H, W * n_model_joints * Cm) as a
    temporal-conv kernel over the preprocessed frames u (.., F, n_joints * 3).

    Every featurized xy entry is ``u[n+w, j, c] - r[n, c]`` with
    ``r[n, c] = u[n+mid, root, c]``, and the mid-frame root slot holds r
    itself, so ``W1 @ f[n] = Σ_w K_w @ u[n+w]``: K is W1 per tap, with
    ``S[o, c] = Σ_(w,j)≠(mid,root) W1[o, w, j, c]`` (c ∈ {x, y}) subtracted
    at the (mid, root) tap. Returns (W, n_joints * 3, H), the 'WIO' layout of
    ``chd_tpu``; reshaped to (W * n_joints * 3, H) it is the (in, out)
    first-layer weight of one window's contiguous W-frame strip of u.
    """
    H = w1.shape[0]
    Cm = 3 if use_confidence else 2
    W = window_size
    mid = W // 2
    w1r = w1.reshape(H, W, n_model_joints, Cm)
    K = torch.zeros((W, n_joints, 3, H), dtype=w1.dtype, device=w1.device)
    K[:, :n_model_joints, :Cm, :] = w1r.permute(1, 2, 3, 0)
    S = w1r[:, :, :, :2].sum(dim=(1, 2))  # (H, 2)
    if root_idx < n_model_joints:
        S = S - w1r[:, mid, root_idx, :2]
    K[mid, root_idx, :2, :] -= S.T
    return K.reshape(W, n_joints * 3, H)
