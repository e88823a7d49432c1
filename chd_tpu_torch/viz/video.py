"""Video writing helpers (port of chd_tpu/viz/video.py): cv2's mp4 writer,
or a PNG dump where no codec opens; and ``to_host``, which every viz entry
point applies to its inputs, so that they take the port's tensors on any
device while the rendering stays numpy, matplotlib and cv2 on the host.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch


def to_host(x):
    """``x`` with every tensor in it as a host numpy array: a tensor, or a
    list, tuple, NamedTuple or dict holding them; anything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_host(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(to_host(v) for v in x)
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    return x


class VideoSink:
    """Write RGB uint8 frames to mp4 via cv2, falling back to a PNG dir."""

    def __init__(self, path: str, fps: float = 30.0):
        self.path = path
        self.fps = fps
        self._writer = None
        self._png_dir: Optional[str] = None
        self._idx = 0

    def write(self, frame: np.ndarray):
        import cv2

        if self._writer is None and self._png_dir is None:
            h, w = frame.shape[:2]
            fourcc = cv2.VideoWriter_fourcc(*"mp4v")
            writer = cv2.VideoWriter(self.path, fourcc, self.fps, (w, h))
            if writer.isOpened():
                self._writer = writer
            else:  # codec unavailable → frame dump
                self._png_dir = self.path + ".frames"
                os.makedirs(self._png_dir, exist_ok=True)
        if self._writer is not None:
            import cv2 as _cv2

            self._writer.write(_cv2.cvtColor(frame, _cv2.COLOR_RGB2BGR))
        else:
            import cv2 as _cv2

            _cv2.imwrite(
                os.path.join(self._png_dir, f"{self._idx:06d}.png"),
                _cv2.cvtColor(frame, _cv2.COLOR_RGB2BGR),
            )
        self._idx += 1

    def close(self):
        if self._writer is not None:
            self._writer.release()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def figure_to_rgb(fig) -> np.ndarray:
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())
    return buf[..., :3].copy()
