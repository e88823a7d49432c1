"""Video metadata probing (the port's copy of chd_tpu/pipeline/probe.py).

The reference reads the true frame rate from each clip before the physics
stage (scripts/run_phys_mocap.py:88-89, cv2.CAP_PROP_FPS rounded to int) and
threads it into prepare/viz via --fps. A hardcoded 30 fps silently corrupts
the physics dt for 24/60-fps footage, so the pipeline probes per video dir.
"""
from __future__ import annotations

import os
from typing import Optional

from ..utils.log import get_logger

log = get_logger("probe")

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm", ".m4v")


def find_video_file(video_dir: str) -> Optional[str]:
    """The clip for a video dir: prefer <dirname>.<ext> (the layout
    create_optim_data_structure.py builds), else any video file inside."""
    base = os.path.basename(os.path.abspath(video_dir))
    for ext in VIDEO_EXTS:
        p = os.path.join(video_dir, base + ext)
        if os.path.isfile(p):
            return p
    try:
        names = sorted(os.listdir(video_dir))
    except OSError:
        return None
    for name in names:
        if name.lower().endswith(VIDEO_EXTS):
            return os.path.join(video_dir, name)
    return None


def probe_fps(video_dir: str, default: float = 30.0) -> float:
    """fps of the clip in video_dir, rounded to int like the reference
    (run_phys_mocap.py:89); ``default`` when no clip / no cv2 / bad header."""
    path = find_video_file(video_dir)
    if path is None:
        log.warning(
            "no video clip found in %s; assuming %.0f fps", video_dir, default
        )
        return float(default)
    try:
        import cv2
    except ImportError:
        log.warning("cv2 unavailable; assuming %.0f fps for %s", default, path)
        return float(default)
    cap = cv2.VideoCapture(path)
    try:
        fps = cap.get(cv2.CAP_PROP_FPS)
    finally:
        cap.release()
    if not fps or fps <= 0:
        log.warning("could not read fps from %s; assuming %.0f", path, default)
        return float(default)
    probed = float(int(round(fps)))
    if probed != default:
        log.info("probed %s: %.0f fps (config default %.0f)", path, probed, default)
    return probed
