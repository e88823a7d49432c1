"""2D keypoint overlay videos (cv2, headless; port of
chd_tpu/viz/keypoints2d.py: inputs may be tensors on any device).

Replaces openpose_utils.render_2d_keypoints (src/utils/openpose_utils.py:
98-178) and the per-frame contact overlay viz_full_video_simple
(src/contact_learning/utils.py:194-290): draws skeleton(s) over video frames
or a blank canvas, with per-joint validity thresholding and optional contact
state badges, writing straight to a VideoSink.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..characters import defs
from .video import VideoSink, to_host

_COLORS = [(0, 200, 0), (220, 0, 0), (0, 0, 220)]


def render_keypoint_video(
    joint2d_list: Sequence[np.ndarray],
    out_path: str,
    adjacency: Optional[Sequence[np.ndarray]] = None,
    video_path: Optional[str] = None,
    dimensions=(1920, 1080),
    conf_thresh: float = 0.1,
    fps: float = 30.0,
    contacts: Optional[np.ndarray] = None,
    contact_names=("LH", "LT", "RH", "RT"),
) -> str:
    """joint2d_list: list of (F, J, 2|3) pixel keypoints; contacts: (F, 4)
    binary labels rendered as colored badges."""
    import cv2

    joint2d_list, adjacency, contacts = to_host((joint2d_list, adjacency, contacts))
    if adjacency is None:
        adjacency = [defs.BODY_25_ADJ_LIST] * len(joint2d_list)
    F = min(j.shape[0] for j in joint2d_list)
    W, H = int(dimensions[0]), int(dimensions[1])

    cap = cv2.VideoCapture(video_path) if video_path else None

    with VideoSink(out_path, fps) as sink:
        for f in range(F):
            if cap is not None:
                ok, frame = cap.read()
                frame = (
                    cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                    if ok
                    else np.zeros((H, W, 3), np.uint8)
                )
                H, W = frame.shape[:2]
            else:
                frame = np.full((H, W, 3), 255, np.uint8)
            for k, pts in enumerate(joint2d_list):
                color = _COLORS[k % len(_COLORS)]
                conf = pts[f, :, 2] if pts.shape[-1] > 2 else np.ones(pts.shape[1])
                for a, b in adjacency[k]:
                    if conf[a] > conf_thresh and conf[b] > conf_thresh:
                        cv2.line(
                            frame,
                            tuple(np.int32(pts[f, a, :2])),
                            tuple(np.int32(pts[f, b, :2])),
                            color, 2,
                        )
                for j in range(pts.shape[1]):
                    if conf[j] > conf_thresh:
                        cv2.circle(frame, tuple(np.int32(pts[f, j, :2])), 4, color, -1)
            if contacts is not None:
                for c in range(contacts.shape[1]):
                    on = contacts[f, c] > 0
                    col = (220, 0, 0) if on else (160, 160, 160)
                    cv2.putText(
                        frame, contact_names[c], (20 + 70 * c, 40),
                        cv2.FONT_HERSHEY_SIMPLEX, 1.0, col, 2,
                    )
            sink.write(frame)
    if cap is not None:
        cap.release()
    return out_path
