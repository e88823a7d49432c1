"""Low-confidence gap filling for 2D keypoint tracks (port of
chd_tpu/ops/gapfill.py).

For every (frame, joint) below the confidence threshold, x/y are linearly
interpolated from the nearest valid frames on either side, copied from the
one valid side at a sequence edge, and left untouched when the whole track is
invalid: the reference's per-joint while-loop, batched.

``chd_tpu`` finds the nearest valid frames with two associative scans (a TPU
gather along the frame axis serializes badly). Here a running max of
``where(valid, t, -1)`` gives each frame its previous valid frame, a running
min of ``where(valid, t, F)`` over the flipped axis its next one, and a
gather reads their values: exact, and plain torch ops on any device.
"""
from __future__ import annotations

import torch


def fill_low_confidence(joints2d: torch.Tensor, confidence: torch.Tensor,
                        thresh: float = 0.2) -> torch.Tensor:
    """joints2d (..., F, J, 2), confidence (..., F, J) → joints2d with the
    sub-threshold detections filled."""
    x = joints2d
    F = x.shape[-3]
    valid = confidence >= thresh
    t = torch.arange(F, device=x.device).view(F, 1).expand_as(valid)
    i_prev = torch.where(valid, t, -1).cummax(dim=-2).values
    i_next = torch.where(valid, t, F).flip(-2).cummin(dim=-2).values.flip(-2)
    has_prev = (i_prev >= 0)[..., None]
    has_next = (i_next < F)[..., None]

    def at(frames):
        idx = frames.clamp(0, F - 1)[..., None].expand_as(x)
        return torch.gather(x, -3, idx)

    v_prev, v_next = at(i_prev), at(i_next)
    denom = torch.clamp(i_next - i_prev, min=1).to(x.dtype)
    w = ((t - i_prev).to(x.dtype) / denom)[..., None]
    interp = (1.0 - w) * v_prev + w * v_next
    filled = torch.where(has_prev & has_next, interp,
                         torch.where(has_prev, v_prev,
                                     torch.where(has_next, v_next, x)))
    return torch.where(valid[..., None], x, filled)


def preprocess_keypoints(op_data: torch.Tensor, thresh: float = 0.2,
                         normalization: float = 1.0) -> torch.Tensor:
    """(..., F, J, 3) [x, y, confidence] → the same shape with x/y gap-filled
    and divided by ``normalization``; confidence untouched."""
    xy = fill_low_confidence(op_data[..., :2], op_data[..., 2], thresh)
    return torch.cat([xy / normalization, op_data[..., 2:3]], dim=-1)
