"""Drivers for the external perception binaries (OpenPose, MTC): the port
of chd_tpu/pipeline/external.py, host code with the same commands, working
directories and errors.

Functional equivalents of scripts/run_openpose.py:37-111 and
scripts/run_totalcap.py:105-186: both shell out to third-party builds the
user provides (exactly as the reference requires, README.md:19-33), so these
raise a clear error when the binaries are absent. Image resize/pad helpers
reproduce openpose_utils.pad_image/resize_image (:13-46).
"""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import Sequence


def pad_image(im, new_size):
    """Pad with black to (W, H) (openpose_utils.pad_image:13-28)."""
    import cv2
    import numpy as np

    if im.shape[1] >= new_size[0] and im.shape[0] >= new_size[1]:
        return im
    dh = new_size[1] - im.shape[0]
    dw = new_size[0] - im.shape[1]
    top, left = dh // 2, dw // 2
    return cv2.copyMakeBorder(
        im, top, dh - top, left, dw - left, cv2.BORDER_CONSTANT, value=[0, 0, 0]
    )


def resize_image(im, new_size):
    """Aspect-preserving resize so one dim hits the target
    (openpose_utils.resize_image:30-46)."""
    import cv2

    if im.shape[1] == new_size[0] or im.shape[0] == new_size[1]:
        return im
    old_h, old_w = im.shape[:2]
    des_w, des_h = new_size
    wr, hr = des_w / old_w, des_h / old_h
    if wr < hr:
        new_w, new_h = des_w, min(des_h, int(old_h * wr))
    else:
        new_w, new_h = min(des_w, int(old_w * hr)), des_h
    return cv2.resize(im, (new_w, new_h), interpolation=cv2.INTER_AREA)


def run_openpose(
    video_dirs: Sequence[str],
    openpose_dir: str,
    hands: bool = False,
    face: bool = False,
    save_video: bool = False,
):
    """Run openpose.bin per video dir → openpose_result/ JSON
    (run_openpose.py detect_pose:37-74: BODY_25, single person)."""
    binary = os.path.join(openpose_dir, "build", "examples", "openpose", "openpose.bin")
    if not os.path.exists(binary):
        raise FileNotFoundError(
            f"OpenPose binary not found at {binary}; build OpenPose and pass its root"
        )
    for vd in video_dirs:
        name = os.path.basename(os.path.abspath(vd))
        video = os.path.join(vd, name + ".mp4")
        out = os.path.join(vd, "openpose_result")
        os.makedirs(out, exist_ok=True)
        cmd = [
            binary,
            "--video", os.path.abspath(video),
            "--write_json", os.path.abspath(out),
            "--display", "0",
            "--model_pose", "BODY_25",
            "--number_people_max", "1",
        ]
        if hands:
            cmd += ["--hand"]
        if face:
            cmd += ["--face"]
        if save_video:  # rendering only needed when writing the overlay video
            cmd += ["--write_video",
                    os.path.abspath(os.path.join(vd, name + "_openpose.avi")),
                    "--render_pose", "1"]
        else:
            cmd += ["--render_pose", "0"]
        subprocess.run(cmd, cwd=openpose_dir, check=True)


def extract_frames(video_path: str, out_dir: str, target=(1920, 1080)) -> int:
    """Video → resized+padded frames for MTC (run_totalcap.py:105-130)."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frame = resize_image(frame, target)
        frame = pad_image(frame, target)
        cv2.imwrite(os.path.join(out_dir, "%08d.png" % (i + 1)), frame)
        i += 1
    return i


def run_totalcap(video_dirs: Sequence[str], mtc_dir: str):
    """Run the MonocularTotalCapture pipeline per video and collect
    tracked_results.json / openpose_result / raw_image back into the video
    dir (run_totalcap.py run_totalcap:133-164, process_output:166-186)."""
    script = os.path.join(mtc_dir, "run_pipeline_no_ffmpeg.sh")
    if not os.path.exists(script):
        raise FileNotFoundError(
            f"MTC pipeline script not found at {script}; clone/build the MTC fork"
        )
    for vd in video_dirs:
        name = os.path.basename(os.path.abspath(vd))
        video = os.path.join(vd, name + ".mp4")
        mtc_data = os.path.join(mtc_dir, "data", name)
        extract_frames(video, os.path.join(mtc_data, "raw_image"))
        subprocess.run(["bash", script, name], cwd=mtc_dir, check=True)
        # collect outputs
        for item, dst in [
            ("tracked_results.json", "tracked_results.json"),
            ("openpose_result", "openpose_result"),
            ("raw_image", "raw_image"),
        ]:
            src = os.path.join(mtc_data, item)
            dest = os.path.join(vd, dst)
            if os.path.isdir(src):
                if os.path.exists(dest):
                    shutil.rmtree(dest)
                shutil.copytree(src, dest)
            elif os.path.exists(src):
                shutil.copyfile(src, dest)
