"""Sliding-window vote aggregation for full-video contact prediction (port of
chd_tpu/ops/voting.py).

Per-window binary predictions become per-frame votes, a width-P box filter
over the window axis, then the reference's edge-aware thresholds and edge
padding. The votes are P shifted adds rather than a ``conv1d``: cuDNN runs a
float32 convolution in TF32 by default, and the adds are exact on any device.
"""
from __future__ import annotations

import torch


def vote_thresholds(num_votes: int, pred_size: int, dtype=torch.float32,
                    device=None) -> torch.Tensor:
    """Interior frames need (P+1)/2 votes; frames near the edges were target
    frames of fewer windows and need only (offset//2)+1."""
    t = torch.full((num_votes,), (pred_size + 1) / 2.0, dtype=dtype)
    for e in range(pred_size - 1):
        t[e] = e // 2 + 1
        t[num_votes - 1 - e] = e // 2 + 1
    return t.to(device)


def merge_votes_batch(window_preds: torch.Tensor, window_size: int) -> torch.Tensor:
    """(V, N, P, C) 0/1 window predictions → (V, N + W - 1, C) int32 contacts."""
    V, N, P, C = window_preds.shape
    if (window_size - P) % 2 != 0:
        raise ValueError(
            f"window_size ({window_size}) and pred_size ({P}) must have equal "
            "parity (the reference coerces window_size odd); otherwise the "
            "output frame count would silently be off by one"
        )
    votes = window_preds.new_zeros((V, N + P - 1, C))
    for p in range(P):
        votes[:, p:p + N] += window_preds[:, :, p]
    thresh = vote_thresholds(N + P - 1, P, votes.dtype, votes.device)
    contact = (votes >= thresh[None, :, None]).to(torch.int32)
    pad = (window_size - P) // 2
    lead = contact[:, :1].expand(V, pad, C)
    tail = contact[:, -1:].expand(V, pad, C)
    return torch.cat([lead, contact, tail], dim=1)
