"""Character metadata registry (the port's copy of chd_tpu/characters/registry.py,
numpy only, so the port imports nothing of chd_tpu).

The typed, immutable replacement for the reference's mutable
``CharacterInfo`` objects (src/utils/character_info_utils.py:9-835). Same
four characters (combined / ybot / skeletonzombie / ty), same
Zatsiorsky–de Leva mass tables, same joint index data — reorganized:

- mappings are dense int arrays (−1 = unmapped) instead of dicts, so they
  feed gathers directly;
- the segment→joints map is additionally precomputed into a padded
  ``(num_segments, max_joints)`` index matrix + weight matrix, so COM and
  inertia reduce to two einsums over all frames at once (the reference
  loops per frame per segment, towr_utils.py:505-535).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np

# Zatsiorsky–de Leva segment mass percentages
# (character_info_utils.py:143-176; see holmeslab.ca Zatsiorsky-deLeva.pdf)
SEGMENT_NAMES: Tuple[str, ...] = (
    "head", "upper_trunk", "mid_trunk", "lower_trunk",
    "left_upper_arm", "left_forearm", "left_hand",
    "left_thigh", "left_shank", "left_foot",
    "right_upper_arm", "right_forearm", "right_hand",
    "right_thigh", "right_shank", "right_foot",
)

MASS_PERC_MALE: Dict[str, float] = {
    "head": 6.94, "upper_trunk": 15.96, "mid_trunk": 16.33, "lower_trunk": 11.17,
    "left_upper_arm": 2.71, "left_forearm": 1.62, "left_hand": 0.61,
    "left_thigh": 14.16, "left_shank": 4.33, "left_foot": 1.37,
    "right_upper_arm": 2.71, "right_forearm": 1.62, "right_hand": 0.61,
    "right_thigh": 14.16, "right_shank": 4.33, "right_foot": 1.37,
}
MASS_PERC_FEMALE: Dict[str, float] = {
    "head": 6.68, "upper_trunk": 15.45, "mid_trunk": 14.65, "lower_trunk": 12.47,
    "left_upper_arm": 2.55, "left_forearm": 1.38, "left_hand": 0.56,
    "left_thigh": 14.78, "left_shank": 4.81, "left_foot": 1.29,
    "right_upper_arm": 2.55, "right_forearm": 1.38, "right_hand": 0.56,
    "right_thigh": 14.78, "right_shank": 4.81, "right_foot": 1.29,
}
MALE_MASS = 73.0  # kg (character_info_utils.py:181)
FEMALE_MASS = 61.99

HEELED_CHARACTERS = ("combined",)


def _dense_map(d: Mapping[int, int], size: int) -> np.ndarray:
    out = np.full(size, -1, dtype=int)
    for k, v in d.items():
        out[k] = v
    return out


@dataclasses.dataclass(frozen=True)
class Character:
    """Immutable per-character metadata (character_info_utils.py fields)."""

    name: str
    num_joints: int
    mass: float
    # joint-index metadata
    left_leg_chain: Tuple[int, ...]   # hip → … → toe; ankle at [-2]
    right_leg_chain: Tuple[int, ...]
    upper_body_joints: Tuple[int, ...]
    ik_blacklist: Tuple[int, ...]
    eye_indices: Tuple[int, int]
    heel_indices: Tuple[int, int] | None  # only for heeled characters
    # mappings (dense, -1 = unmapped)
    to_smpl: np.ndarray | None       # (J,) char joint → SMPL joint
    to_combined: np.ndarray | None   # (J,) char joint → combined (data-order)
    # mass model
    seg_mass_perc: Dict[str, float]
    seg_joints: Dict[str, Tuple[int, ...]]

    # -- accessors mirroring the reference get_character_* API ---------------
    @property
    def toe_inds(self) -> Tuple[int, int]:
        return (self.left_leg_chain[-1], self.right_leg_chain[-1])

    @property
    def ankle_inds(self) -> Tuple[int, int]:
        return (self.left_leg_chain[-2], self.right_leg_chain[-2])

    @property
    def hip_inds(self) -> Tuple[int, int]:
        return (self.left_leg_chain[0], self.right_leg_chain[0])

    @property
    def foot_inds(self) -> Tuple[int, int, int, int]:
        la, ra = self.ankle_inds
        lt, rt = self.toe_inds
        return (la, lt, ra, rt)

    @property
    def has_heel(self) -> bool:
        return self.heel_indices is not None

    def segment_matrices(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized mass model: (joint_idx (S, K), joint_w (S, K), mass_frac (S,)).

        ``seg_centroid[s] = Σ_k joint_w[s,k] · P[joint_idx[s,k]]`` reproduces
        the reference's per-segment joint-position mean; mass_frac is the
        segment's fraction of total mass. Padded entries have weight 0.
        """
        S = len(SEGMENT_NAMES)
        K = max(len(self.seg_joints[s]) for s in SEGMENT_NAMES)
        idx = np.zeros((S, K), dtype=int)
        w = np.zeros((S, K))
        frac = np.zeros(S)
        for i, s in enumerate(SEGMENT_NAMES):
            js = list(self.seg_joints[s])
            idx[i, : len(js)] = js
            w[i, : len(js)] = 1.0 / len(js)
            frac[i] = self.seg_mass_perc[s] / 100.0
        return idx, w, frac


def _tup(x) -> Tuple[int, ...]:
    return tuple(int(v) for v in x)


# --- combined (character_info_utils.py:255-283) -------------------------------
_combined = Character(
    name="combined",
    num_joints=28,
    mass=MALE_MASS,
    left_leg_chain=(1, 2, 3, 5),
    right_leg_chain=(7, 8, 9, 11),
    upper_body_joints=_tup([0] + list(range(13, 28))),
    ik_blacklist=(),
    eye_indices=(18, 20),
    heel_indices=(4, 10),
    to_smpl=None,
    to_combined=None,
    seg_mass_perc=MASS_PERC_MALE,
    seg_joints={
        "head": (17,),
        "upper_trunk": (15, 16),
        "mid_trunk": (14, 15),
        "lower_trunk": (13, 14),
        "left_upper_arm": (22, 23),
        "left_forearm": (23, 24),
        "left_hand": (24,),
        "left_thigh": (1, 2),
        "left_shank": (2, 3),
        "left_foot": (3, 4, 5, 6),
        "right_upper_arm": (25, 26),
        "right_forearm": (26, 27),
        "right_hand": (27,),
        "right_thigh": (7, 8),
        "right_shank": (8, 9),
        "right_foot": (9, 10, 11, 12),
    },
)

# --- ybot (character_info_utils.py:289-459) ------------------------------------
_ybot_to_combined = _dense_map(
    {0: 0, 1: 13, 2: 14, 3: 15, 4: 16, 7: 18, 8: 20, 10: 22, 11: 23, 12: 24,
     34: 25, 35: 26, 36: 27, 57: 7, 58: 8, 59: 9, 60: 11, 62: 1, 63: 2,
     64: 3, 65: 5},
    67,
)
_ybot_to_smpl = _dense_map(
    {0: 0, 1: 3, 2: 6, 3: 9, 4: 12, 9: 13, 10: 16, 11: 18, 12: 20, 33: 14,
     34: 17, 35: 19, 36: 21, 57: 2, 58: 5, 59: 8, 60: 11, 62: 1, 63: 4,
     64: 7, 65: 10},
    67,
)
_ybot = Character(
    name="ybot",
    num_joints=67,
    mass=MALE_MASS,
    left_leg_chain=(62, 63, 64, 65),
    right_leg_chain=(57, 58, 59, 60),
    upper_body_joints=_tup(range(0, 57)),
    ik_blacklist=(10, 11, 12, 34, 35, 36),
    eye_indices=(7, 8),
    heel_indices=None,
    to_smpl=_ybot_to_smpl,
    to_combined=_ybot_to_combined,
    seg_mass_perc=MASS_PERC_MALE,
    seg_joints={
        "head": (5,),
        "upper_trunk": (3,),
        "mid_trunk": (2,),
        "lower_trunk": (1,),
        "left_upper_arm": (10, 11),
        "left_forearm": (11, 12),
        "left_hand": _tup(range(12, 33)),
        "left_thigh": (62, 63),
        "left_shank": (63, 64),
        "left_foot": (64, 65, 66),
        "right_upper_arm": (34, 35),
        "right_forearm": (35, 36),
        "right_hand": _tup(range(36, 57)),
        "right_thigh": (57, 58),
        "right_shank": (58, 59),
        "right_foot": (59, 60, 61),
    },
)

# --- skeletonzombie (character_info_utils.py:465-651) ---------------------------
_zombie_to_combined = _dense_map(
    {0: 0, 1: 13, 2: 14, 3: 15, 5: 22, 6: 23, 7: 24, 28: 16, 32: 25, 33: 26,
     34: 27, 55: 1, 56: 2, 57: 3, 58: 5, 60: 7, 61: 8, 62: 9, 63: 11},
    65,
)
_zombie_to_smpl = _dense_map(
    {0: 0, 1: 3, 2: 6, 3: 9, 4: 13, 5: 16, 6: 18, 7: 20, 28: 12, 31: 14,
     32: 17, 33: 19, 34: 21, 55: 1, 56: 4, 57: 7, 58: 10, 60: 2, 61: 5,
     62: 8, 63: 11},
    65,
)
_zombie = Character(
    name="skeletonzombie",
    num_joints=65,
    mass=MALE_MASS * 2.0,
    left_leg_chain=(55, 56, 57, 58),
    right_leg_chain=(60, 61, 62, 63),
    upper_body_joints=_tup(range(0, 55)),
    ik_blacklist=(5, 6, 7, 32, 33, 34),
    eye_indices=(29, 29),  # no eyes; head joint stands in
    heel_indices=None,
    to_smpl=_zombie_to_smpl,
    to_combined=_zombie_to_combined,
    seg_mass_perc={
        "head": 3.0, "upper_trunk": 14.0, "mid_trunk": 12.0, "lower_trunk": 9.0,
        "left_upper_arm": 3.0, "left_forearm": 9.0, "left_hand": 6.0,
        "left_thigh": 9.0, "left_shank": 3.0, "left_foot": 1.0,
        "right_upper_arm": 3.0, "right_forearm": 9.0, "right_hand": 6.0,
        "right_thigh": 9.0, "right_shank": 3.0, "right_foot": 1.0,
    },
    seg_joints={
        "head": (29,),
        "upper_trunk": (3,),
        "mid_trunk": (2,),
        "lower_trunk": (1,),
        "left_upper_arm": (5, 6),
        "left_forearm": (6, 7),
        "left_hand": _tup(range(7, 28)),
        "left_thigh": (55, 56),
        "left_shank": (56, 57),
        "left_foot": (57, 58, 59),
        "right_upper_arm": (32, 33),
        "right_forearm": (33, 34),
        "right_hand": _tup(range(34, 55)),
        "right_thigh": (60, 61),
        "right_shank": (61, 62),
        "right_foot": (62, 63, 64),
    },
)

# --- ty (character_info_utils.py:657-835) ----------------------------------------
_ty_to_combined = _dense_map(
    {0: 0, 1: 13, 2: 14, 3: 15, 5: 22, 6: 23, 7: 24, 29: 25, 30: 26, 31: 27,
     52: 16, 55: 1, 56: 2, 57: 3, 58: 5, 59: 7, 60: 8, 61: 9, 62: 11},
    63,
)
_ty_to_smpl = _dense_map(
    {0: 0, 1: 3, 2: 6, 3: 9, 4: 13, 5: 16, 6: 18, 7: 20, 28: 14, 29: 17,
     30: 19, 31: 21, 52: 12, 55: 1, 56: 4, 57: 7, 58: 10, 59: 2, 60: 5,
     61: 8, 62: 11},
    63,
)
_ty = Character(
    name="ty",
    num_joints=63,
    mass=MALE_MASS * 0.5,
    left_leg_chain=(55, 56, 57, 58),
    right_leg_chain=(59, 60, 61, 62),
    upper_body_joints=_tup(range(0, 55)),
    ik_blacklist=(5, 6, 7, 29, 30, 31),
    eye_indices=(53, 53),
    heel_indices=None,
    to_smpl=_ty_to_smpl,
    to_combined=_ty_to_combined,
    seg_mass_perc={
        "head": 40.0, "upper_trunk": 9.0, "mid_trunk": 12.0, "lower_trunk": 11.0,
        "left_upper_arm": 2.0, "left_forearm": 1.0, "left_hand": 1.0,
        "left_thigh": 2.0, "left_shank": 3.0, "left_foot": 5.0,
        "right_upper_arm": 2.0, "right_forearm": 1.0, "right_hand": 1.0,
        "right_thigh": 2.0, "right_shank": 3.0, "right_foot": 5.0,
    },
    seg_joints={
        "head": (53,),
        "upper_trunk": (3,),
        "mid_trunk": (2,),
        "lower_trunk": (1,),
        "left_upper_arm": (5, 6),
        "left_forearm": (6, 7),
        "left_hand": _tup(range(7, 28)),
        "left_thigh": (55, 56),
        "left_shank": (56, 57),
        "left_foot": (57, 58),
        "right_upper_arm": (29, 30),
        "right_forearm": (30, 31),
        "right_hand": _tup(range(31, 52)),
        "right_thigh": (59, 60),
        "right_shank": (60, 61),
        "right_foot": (61, 62),
    },
)

CHARACTERS: Dict[str, Character] = {
    "combined": _combined,
    "ybot": _ybot,
    "skeletonzombie": _zombie,
    "ty": _ty,
}


def get_character(name: str) -> Character:
    try:
        return CHARACTERS[name]
    except KeyError:
        raise KeyError(
            f"unknown character {name!r}; available: {sorted(CHARACTERS)}"
        ) from None
