"""Combined-skeleton → Mixamo character retargeting (port of
chd_tpu/retarget/mixamo.py).

Replacement for src/skeleton_fitting/combined_to_mixamo.py:30-135. Template
character skeletons (ybot/ty/skeletonzombie .bvh) are user-supplied assets
exactly as in the reference (downloaded from Mixamo); pass their path or a
pre-loaded Animation.

Steps (reference line refs in parens):
1. zero both skeletons' floors via a softmin over per-frame minimum foot
   heights (:30-50, :64-72);
2. scale targets by the below-hip height ratio, preserving root x/z (:76-87);
3. seed the character's joint angles from the source eulers through the
   character→combined map, with the reference's fmod-180° wrap (:105-113);
4. 200 CK-IK iterations with per-character target map & IK blacklist,
   translate=True (:98-117);
5. ankle-offset correction + floor re-accounting on the root height
   (:120-124).

The host steps are numpy over the port's ``core`` in float64 on the CPU;
the IK runs on ``device`` (default ``cuda``; raises where CUDA is absent)
in ``dtype``.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..characters import defs, get_character
from ..core import bvh, quat
from ..core.animation import Animation
from ..kinematics.ik import IKConfig, solve_ck_ik
from ..physics.prepare import _f64, _fk
from ..utils.device import resolve_device


def softmax(x, softness: float = 1.0, axis=None):
    """max + log(softness + exp(min − max)) — the reference's smooth max
    (combined_to_mixamo.py:30-33)."""
    maxi = np.max(x, axis=axis)
    mini = np.min(x, axis=axis)
    return maxi + np.log(softness + np.exp(mini - maxi))


def softmin(x, softness: float = 1.0, axis=None):
    return -softmax(-x, softness=softness, axis=axis)


def retarget(
    src_anim: Animation,
    character: str,
    skel: Union[str, Tuple[Animation, list]],
    ik_iterations: int = 200,
    out_bvh: Optional[str] = None,
    device="cuda",
    dtype=torch.float32,
) -> Tuple[Animation, list]:
    """Retarget a combined-skeleton animation onto a Mixamo character.

    skel: path to the character template BVH, or (Animation, names).
    Returns (retargeted Animation with numpy leaves, joint names);
    optionally saves a BVH.
    """
    device = resolve_device(device)
    char = get_character(character)
    if isinstance(skel, str):
        skel_anim, names, _ = bvh.load(skel)
    else:
        skel_anim, names = skel
    skel_anim = skel_anim.to_numpy()
    src_anim = src_anim.to_numpy()

    # rest-pose character (zero rotations), template frame count
    Jc = skel_anim.num_joints
    Fs = skel_anim.num_frames
    zero_rot = quat.from_euler(torch.zeros((Fs, Jc, 3), dtype=torch.float64), "xyz",
                               world=True).numpy()
    skel_rest = skel_anim.replace(rotations=zero_rot)
    skel_targets = _fk(skel_rest)

    # character floor + below-hip height (reference :47-56)
    la, lt, ra, rt = char.foot_inds
    fid_l, fid_r = np.array([la, lt]), np.array([ra, rt])
    foot_heights = np.minimum(
        skel_targets[:, fid_l, 1], skel_targets[:, fid_r, 1]
    ).min(axis=1)
    floor_height = softmin(foot_heights, softness=0.5, axis=0)
    skel_targets[:, :, 1] -= floor_height
    foot_idx = np.array(char.foot_inds)
    skel_height = np.abs(
        np.amax(skel_targets[:, 0, 1]) - np.amin(skel_targets[:, foot_idx, 1], axis=1)
    ).max()

    # one-frame rest pose for initialization
    rest_positions = np.asarray(skel_anim.offsets)[None]

    # source motion floor/height in flipped-y space (reference :64-77)
    anim_targets = _fk(src_anim)
    anim_targets[:, :, 1] *= -1.0
    src_feet = np.asarray(defs.COMBINED_FOOT_INDS)
    fid_l = src_feet[:3]
    fid_r = src_feet[3:]
    foot_heights = np.minimum(
        anim_targets[:, fid_l, 1], anim_targets[:, fid_r, 1]
    ).min(axis=1)
    src_floor_height = softmin(foot_heights, softness=0.5, axis=0)
    anim_targets[:, :, 1] -= src_floor_height
    anim_height = np.abs(
        np.amax(anim_targets[:, 0, 1]) - np.amin(anim_targets[:, src_feet, 1], axis=1)
    ).max()
    # flip back: the floor shift stays baked in (reference :82), leaving
    # y' = y_original + src_floor_height — compensated at :124 via the root
    anim_targets[:, :, 1] *= -1.0

    height_ratio = skel_height / anim_height
    targets = anim_targets * height_ratio
    targets[:, :, [0, 2]] -= (targets[:, 0:1, [0, 2]] - anim_targets[:, 0:1, [0, 2]])

    F = targets.shape[0]

    # init animation: rest pose repeated, root driven by scaled source root
    init_pos = np.repeat(rest_positions, F, axis=0)
    init_pos[:, 0] = targets[:, 0]

    mapping = np.asarray(char.to_combined)
    src_euler = quat.to_euler(_f64(src_anim.rotations), "xyz").numpy()
    refs = np.zeros((F, Jc, 3))
    mapped = mapping > -1
    refs[:, mapped] = src_euler[:, mapping[mapped]]
    # the reference's fmod-180° wrap (:110-112), degrees with pi≈3.1415
    refs = np.fmod(refs * 180.0 / 3.1415, 180.0) * 3.1415 / 180.0
    init_rot = quat.from_euler(_f64(refs), "xyz", world=True).numpy()

    anim = Animation(
        init_rot, init_pos, np.asarray(skel_anim.orients), np.asarray(skel_anim.offsets),
        skel_anim.parents,
    )

    blacklist = set(char.ik_blacklist)
    targetmap = {
        int(i): targets[:, mapping[i]]
        for i in range(Jc)
        if mapping[i] > -1 and i not in blacklist
    }

    result = solve_ck_ik(
        Animation.from_numpy(anim, device, dtype), targetmap,
        IKConfig(iterations=ik_iterations, damping=7.0, smoothness=0.0, translate=True),
    ).to_numpy()

    # restore rest-pose local translations for non-root joints, then correct
    # the root height by the median ankle offset (reference :120-124)
    res_pos = np.array(result.positions, np.float64)
    res_pos[:, 1:] = np.repeat(rest_positions[:, 1:], F, axis=0)
    result = result.replace(rotations=np.asarray(result.rotations, np.float64),
                            positions=res_pos)

    gp = _fk(result)
    ank_diff = (
        targets[:, np.asarray(defs.COMBINED_ANKLE_INDS), 1]
        - gp[:, np.asarray(char.ankle_inds), 1]
    )
    ank_off = np.median(ank_diff)
    res_pos[:, 0, 1] += ank_off
    res_pos[:, 0, 1] -= src_floor_height
    result = result.replace(positions=res_pos)

    if out_bvh:
        bvh.save(out_bvh, result, names)
    return result, names
