"""Skeleton index tables and optimization weight vectors (the port's copy of
the tables of chd_tpu/characters/defs.py).

The "combined skeleton" (BODY_25's 25 joints + 3 SMPL spine joints = 28
joints) is the pipeline's central data model. Joints come in two orders:
DATA order (BODY_25 then the spine, the order of the pose arrays) and
SKELETON order (the template BVH's). Numpy arrays, so they drop straight
into gathers; ``tests/test_torch_core.py`` holds every table equal to
``chd_tpu``'s.
"""
from __future__ import annotations

import numpy as np

# --- BODY_25 (OpenPose) -----------------------------------------------------
BODY_25_ROOT_IDX = 8
BODY_25_NUM_JOINTS = 25
# BODY_25's bones, as (a, b) joint pairs (viz.keypoints2d draws them)
BODY_25_ADJ_LIST = np.array(
    [
        [1, 8], [1, 2], [1, 5], [2, 3], [3, 4], [5, 6], [6, 7], [8, 9],
        [9, 10], [10, 11], [8, 12], [12, 13], [13, 14], [1, 0], [0, 15],
        [15, 17], [0, 16], [16, 18], [14, 19], [19, 20], [14, 21], [11, 22],
        [22, 23], [11, 24],
    ]
)
BODY_25_PROJ_WEIGHTS = np.array(
    [0.5, 0.5, 0.5, 0.1, 0.1, 0.5, 0.1, 0.1, 0.0, 1.0, 0.1, 0.1, 1.0,
     0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1]
)
BODY_25_SMOOTH_WEIGHTS = np.array(
    [2.5, 2.5, 2.5, 1.5, 1.0, 2.5, 1.5, 1.0, 1.0, 2.5, 1.5, 1.0, 2.5,
     1.5, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]
)

# --- SMPL --------------------------------------------------------------------
SMPL_ROOT_IDX = 0
SMPL_SPINE_JOINTS = np.array([3, 6, 9])
SMPL_NUM_JOINTS = 22
SMPL_ADJ_LIST = np.array(
    [
        [11, 8], [8, 5], [5, 2], [2, 0], [10, 7], [7, 4], [4, 1], [1, 0],
        [0, 3], [3, 6], [6, 9], [9, 12], [12, 15], [12, 13], [13, 16],
        [16, 18], [18, 20], [12, 14], [14, 17], [17, 19], [19, 21],
    ]
)

# --- Combined model: BODY_25 ∪ SMPL spine (28 joints, data order) -----------
COMBINED_NUM_JOINTS = 28
COMBINED_ROOT_IDX = 8  # in BODY_25/data order (MidHip)
COMBINED_ADJ_LIST = np.array(
    [
        [1, 27], [27, 26], [26, 25], [25, 8], [1, 2], [1, 5], [2, 3], [3, 4],
        [5, 6], [6, 7], [8, 9], [9, 10], [10, 11], [8, 12], [12, 13],
        [13, 14], [1, 0], [0, 15], [15, 17], [0, 16], [16, 18], [14, 19],
        [19, 20], [14, 21], [11, 22], [22, 23], [11, 24],
    ]
)

# Per-joint optimization weight vectors in DATA order: projection is zero on
# the root and the spine.
COMBINED_PROJ_WEIGHTS = np.array(
    [0.1, 0.1, 0.3, 0.1, 0.1, 0.3, 0.1, 0.1, 0.1, 1.0, 0.1, 0.1, 1.0, 0.1,
     0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.0, 0.0, 0.0]
)
COMBINED_DATA_WEIGHTS = np.array(
    [2.5, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0,
     1.0, 2.5, 2.5, 2.5, 2.5, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0]
)
COMBINED_SMOOTH_WEIGHTS = np.array(
    [2.5, 2.5, 2.5, 1.5, 1.0, 2.5, 1.5, 1.0, 1.0, 2.5, 1.5, 1.0, 2.5, 1.5,
     1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.5, 1.5, 1.5]
)

# skel_to_data[s] = data index of skeleton joint s; data_to_skel the inverse.
COMBINED_SKEL_TO_DATA = np.array(
    [8, 12, 13, 14, 21, 19, 20, 9, 10, 11, 24, 22, 23,
     25, 26, 27, 1, 0, 16, 18, 15, 17, 5, 6, 7, 2, 3, 4]
)
_inv = np.zeros_like(COMBINED_SKEL_TO_DATA)
_inv[COMBINED_SKEL_TO_DATA] = np.arange(len(COMBINED_SKEL_TO_DATA))
COMBINED_DATA_TO_SKEL = _inv

COMBINED_SKEL_ROOT_IDX = 0  # MidHip comes first in skeleton order
COMBINED_SKEL_SPINE_JOINTS = np.array([13, 14, 15])
COMBINED_SKEL_NECK_JOINT = 16
# heel/toe joints in skeleton order: LHeel, LBigToe, LSmallToe, RHeel,
# RBigToe, RSmallToe
COMBINED_SKEL_FEET_IDX = np.array([4, 5, 6, 10, 11, 12])

# Contact-label column → data-order joints carrying the velocity constraint:
# labels are [Lheel, Ltoe, Rheel, Rtoe]; toes fan out to big+small toe joints.
CONTACT_LABEL_NAMES = ("left_heel", "left_toe", "right_heel", "right_toe")
CONTACT_TO_DATA_JOINTS = {
    0: [21],        # LHeel
    1: [19, 20],    # LBigToe, LSmallToe
    2: [24],        # RHeel
    3: [22, 23],    # RBigToe, RSmallToe
}

# --- OpenPose lower body and the joint subsets of the contact model ----------
OP_ROOT_JOINT = 8
OP_LOWER_JOINTS = np.array([8, 9, 10, 11, 12, 13, 14, 19, 20, 21, 22, 23, 24])
OP_LOWER_JOINT_NAMES = (
    "MidHip", "RHip", "RKnee", "RAnkle", "LHip", "LKnee", "LAnkle",
    "LBigToe", "LSmallToe", "LHeel", "RBigToe", "RSmallToe", "RHeel",
)
OP_LOWER_PARENTS = np.array([-1, 0, 1, 2, 0, 4, 5, 6, 7, 6, 3, 10, 3])
OP_JOINT_SUBSETS = {
    "lower": list(range(8, 15)) + list(range(19, 25)),
    "lower_knees": [10, 11, 13, 14, 19, 20, 21, 22, 23, 24],
    "lower_ankles": [11, 14, 19, 20, 21, 22, 23, 24],
    "lower_feet": [11, 14, 19, 20, 21, 22, 23, 24],
    "upper": [0, 1, 2, 3, 4, 5, 6, 7],
    "upper_hips": [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 12],
    "upper_knees": [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 13],
    "upper_ankles": list(range(15)),
    "full": list(range(25)),
}

# --- SMPL ↔ combined angle index maps ----------------------------------------
# SMPL joint whose axis-angle seeds combined joint c in SKELETON order, or -1.
SMPL_FOR_COMBINED_SKEL = np.array(
    [0, 1, 4, 7, -1, -1, 10, 2, 5, 8, -1, -1, 11,
     3, 6, 9, 12, 15, -1, -1, -1, -1, 16, 18, 20, 17, 19, 21]
)
# combined (skeleton order) joint feeding each SMPL joint, or -1.
COMBINED_SKEL_FOR_SMPL = np.array(
    [0, 1, 7, 13, 2, 8, 14, 3, 9, 15, 6, 12, 16, -1, -1, -1, 22, 25, 23, 26, 24, 27]
)

# Combined-skeleton feet metadata in skeleton order
# (character_info_utils.py:194-197).
COMBINED_FOOT_INDS = np.array([4, 5, 6, 10, 11, 12])
COMBINED_TOE_INDS = np.array([5, 6, 11, 12])
COMBINED_ANKLE_INDS = np.array([3, 9])
COMBINED_EYE_INDS = np.array([18, 20])

# MTC camera intrinsics
MTC_WIDTH = 1920
MTC_HEIGHT = 1080
MTC_FOCAL = (2000.0, 2000.0)
MTC_PP = (MTC_WIDTH / 2.0, MTC_HEIGHT / 2.0)
