"""OpenPose keypoint ingestion (port of chd_tpu/ingest/openpose.py).

OpenPose BODY_25 JSON output directories → ``(F, 25, 3)`` arrays: first
detected person only, an all-zero row where no person was found. With
``use_native`` (the default) the C++ parser of ``utils.native`` reads whole
directories when its library builds; otherwise, or if it rejects a file, the
json module does.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from ..utils import native


def load_keypoint_file(path: str, num_joints: int = 25) -> np.ndarray:
    with open(path, "r") as f:
        d = json.load(f)
    people = d.get("people", [])
    if not people:
        return np.zeros((num_joints, 3))
    return np.asarray(people[0]["pose_keypoints_2d"], dtype=np.float64).reshape(-1, 3)


def keypoint_files(dir_path: str) -> List[str]:
    return sorted(
        os.path.join(dir_path, f)
        for f in os.listdir(dir_path)
        if f.rsplit(".", 1)[-1] == "json"
    )


def load_keypoint_dir(dir_path: str, use_native: bool = True) -> Optional[np.ndarray]:
    """A whole video's keypoints as (F, 25, 3) float64, or None if no dir."""
    if not os.path.isdir(dir_path):
        return None
    files = keypoint_files(dir_path)
    if use_native:
        try:
            arr = native.load_keypoint_dir(files)
        except OSError:
            arr = None
        if arr is not None:
            return arr
    return np.stack([load_keypoint_file(f) for f in files], axis=0)
