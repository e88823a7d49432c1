"""MonocularTotalCapture (MTC) result ingestion and the combined skeleton
(port of chd_tpu/ingest/totalcap.py).

``tracked_results.json`` → a typed result struct; the MTC-format frame
re-saver; root normalization; the combined-skeleton (BODY_25 + SMPL spine)
data array; SMPL ↔ combined ↔ Mixamo axis-angle remapping. Host-side numpy,
as in ``chd_tpu``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np

from ..characters import defs
from ..characters.registry import get_character

BODY_25_ROOT_IDX = defs.BODY_25_ROOT_IDX
SMPL_ROOT_IDX = defs.SMPL_ROOT_IDX


@dataclasses.dataclass
class TotalCapResults:
    """Per-video MTC fitting output."""

    root_trans: np.ndarray        # (F, 3)
    joint3d: np.ndarray           # (F, 25, 3) BODY_25 joints
    smpl_joint3d: np.ndarray      # (F, 22, 3)
    smpl_joint_angles: np.ndarray  # (F, 22, 3) axis-angle, radians
    body_coeffs: np.ndarray       # (F, 30)
    face_coeffs: np.ndarray       # (F, 200)


def load_totalcap_results(path: str) -> Optional[TotalCapResults]:
    """Parse tracked_results.json; None if there is no such file."""
    if not os.path.isfile(path):
        return None
    with open(path, "r") as f:
        doc = json.load(f)
    frames = doc["totalcapResults"]

    def vec3(d):
        return (d["x"], d["y"], d["z"])

    root = np.array([vec3(fr["trans"]) for fr in frames], dtype=np.float64)
    joint3d = np.array(
        [[vec3(j["pos"]) for j in fr["joints"]] for fr in frames], dtype=np.float64
    )
    smpl3d = np.array(
        [[vec3(j["pos"]) for j in fr["SMPLJoints"]] for fr in frames], dtype=np.float64
    )
    smpl_ang = np.array(
        [[vec3(j["rot"]) for j in fr["SMPLJoints"]] for fr in frames], dtype=np.float64
    )
    body = np.array([fr["bodyCoeffs"] for fr in frames], dtype=np.float64)
    face = np.array([fr["faceCoeffs"] for fr in frames], dtype=np.float64)
    return TotalCapResults(root, joint3d, smpl3d, smpl_ang, body, face)


def save_totalcap_results(res: TotalCapResults, out_dir: str) -> None:
    """Re-save per-frame txt in the MTC input format: root line, pose line
    with 40 dummy hand joints appended, body coeffs, face coeffs."""
    os.makedirs(out_dir, exist_ok=True)
    F = res.smpl_joint_angles.shape[0]
    hands = np.zeros((40, 3))
    for i in range(F):
        angles = np.concatenate([res.smpl_joint_angles[i], hands], axis=0).reshape(-1)
        with open(os.path.join(out_dir, "%04d.txt" % (i + 1)), "w") as f:
            f.write(" ".join(str(v) for v in res.root_trans[i]) + "\n")
            f.write(" ".join(str(v) for v in angles) + "\n")
            f.write(" ".join(str(v) for v in res.body_coeffs[i]) + "\n")
            f.write(" ".join(str(v) for v in res.face_coeffs[i]))


def normalize_root_pos(root_trans, joint3d, root_idx: int = BODY_25_ROOT_IDX):
    """Push any residual root-joint offset into the global translation so all
    joints are root-relative."""
    root_off = joint3d[:, root_idx]
    return root_trans + root_off, joint3d - root_off[:, None, :]


def create_combined_model(body25_joint3d, smpl_joint3d):
    """Combined skeleton data array: BODY_25 joints + the 3 SMPL spine joints
    appended. Inputs must be root-relative."""
    spine = smpl_joint3d[:, np.asarray(defs.SMPL_SPINE_JOINTS)]
    return np.concatenate([body25_joint3d, spine], axis=1)


def _remap_angles(angles, index_map):
    """Gather rows of (F, Jsrc, 3) by dense map (Jdst,), -1 → zeros."""
    angles = np.asarray(angles)
    idx = np.asarray(index_map)
    safe = np.clip(idx, 0, angles.shape[1] - 1)
    out = angles[:, safe]
    out[:, idx < 0] = 0.0
    return out


def combined_angles_from_smpl(smpl_angles):
    """(F, 22, 3) SMPL axis-angles → (F, 28, 3) combined-skeleton-order angles."""
    return _remap_angles(smpl_angles, defs.SMPL_FOR_COMBINED_SKEL)


def smpl_from_combined_angles(combined_angles):
    """(F, 28, 3) combined-skeleton-order angles → (F, 22, 3) SMPL angles."""
    return _remap_angles(combined_angles, defs.COMBINED_SKEL_FOR_SMPL)


def mixamo_angles_from_smpl(smpl_angles, character: str = "ybot"):
    """(F, 22, 3) → (F, J_char, 3) via the character's to-SMPL map."""
    return _remap_angles(smpl_angles, get_character(character).to_smpl)
