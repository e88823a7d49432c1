"""Re-apply physics-optimized trajectories onto the full skeleton (port of
chd_tpu/physics/apply.py).

Equivalent of towr_utils.apply_results (src/utils/towr_utils.py:779-857):
preserve the upper body's offsets relative to the original COM, drive the
root from the optimized COM/orientation, and run translate-enabled CK-IK
(30 iterations, smoothness 1e-3, damping 7, the LU solve) with targets on
the upper-body joints, the toes, and the heels. The host part is numpy over
the port's ``core`` in float64 on the CPU; the IK runs on ``device``
(default ``cuda``; raises where CUDA is absent) in ``dtype``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..characters import get_character
from ..core import quat
from ..core.animation import Animation
from ..kinematics.ik import IKConfig, solve_ck_ik
from ..utils.device import resolve_device
from .prepare import _f64, _fk, add_heel
from .towr_io import LoadedResults


def apply_results(
    results: LoadedResults,
    anim: Animation,
    character: str,
    device="cuda",
    dtype=torch.float32,
) -> Tuple[Animation, Animation, np.ndarray]:
    """Returns (optimized anim, original anim, original COM (cm)), the
    animations with numpy leaves. ``chd_tpu``'s ``start_idx``/``end_idx``
    slice and ``run_ik=False`` have no caller: pass the slice to apply."""
    device = resolve_device(device)
    char = get_character(character)
    anim = anim.to_numpy()
    F = anim.num_frames

    if (not char.has_heel) and results.feet_pos.shape[1] == 4:
        anim = add_heel(anim, char.toe_inds, char.ankle_inds)

    init_pos = _fk(anim)
    idx, w, frac = char.segment_matrices()
    seg_pos = np.einsum("sk,fskd->fsd", w, init_pos[:, idx])
    com = np.einsum("s,fsd->fd", frac, seg_pos)  # (F, 3) cm

    upper = list(char.upper_body_joints)
    upper_offsets = init_pos[:, upper] - com[:, None, :]

    anim_og = anim.replace()
    seq = min(F, results.base_pos.shape[0])

    desired = upper_offsets[:seq] + results.base_pos[:seq, None, :] * 100.0

    rot = np.array(anim.rotations)
    rot[:seq, 0] = quat.from_euler(_f64(results.base_rot[:seq]), "xyz", world=True).numpy()
    pos = np.array(anim.positions)
    pos[:seq, 0] = desired[:, 0]
    new_anim = anim.replace(rotations=rot, positions=pos)

    targetmap = {int(j): desired[:, k] for k, j in enumerate(upper)}
    lt, rt = char.toe_inds
    targetmap[int(lt)] = results.feet_pos[:seq, 0] * 100.0
    targetmap[int(rt)] = results.feet_pos[:seq, 1] * 100.0
    if results.feet_pos.shape[1] == 4:
        if char.has_heel:
            lh, rh = char.heel_indices
        else:
            lh, rh = new_anim.num_joints - 2, new_anim.num_joints - 1
        targetmap[int(lh)] = results.feet_pos[:seq, 2] * 100.0
        targetmap[int(rh)] = results.feet_pos[:seq, 3] * 100.0

    new_anim = solve_ck_ik(
        Animation.from_numpy(new_anim.slice_frames(0, seq), device, dtype),
        targetmap,
        IKConfig(iterations=30, damping=7.0, smoothness=0.001, translate=True),
    ).to_numpy()
    return new_anim, anim_og, com


def remove_heel(anim: Animation) -> Animation:
    """Drop the two injected heel joints (towr_utils.remove_heel_from_anim
    :425-433)."""
    anim = anim.to_numpy()
    J = anim.num_joints - 2
    return Animation(anim.rotations[:, :J], anim.positions[:, :J], anim.orients[:J],
                     anim.offsets[:J], anim.parents[:J])
