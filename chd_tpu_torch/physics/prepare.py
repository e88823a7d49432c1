"""Physics-optimization input preparation (port of chd_tpu/physics/prepare.py).

In-process, vectorized replacement for ``towr_utils.prepare_input``
(src/utils/towr_utils.py:451-777), which wrote skel/motion/terrain/contact
text files for the C++ solver. Responsibilities and reference anchors:

- per-frame COM + hip offsets from the character's segment mass model
  (:499-535) — here two einsums over all frames via
  Character.segment_matrices();
- per-frame inertia about the COM, point-mass segments (:526-535);
- heel joint injection for heel-less characters (:401-423, :551-553);
- coordinate transform into TOWR space: negate all axes, swap y↔z, cm→m
  (:516-524, :556-559);
- root orientation euler with temporal unwrapping for continuity (:607-621);
- contact schedule (toe = OR of heel/toe labels per reference defaults) and
  phase durations (:707-777, find_contact_durations:435-449);
- terrain transform (:679-706).

Also writes the reference-compatible text artifacts so the original C++
solver (or its outputs) can be cross-checked file-for-file.

Host numpy around the port's ``core.fk`` and ``core.quat``, which run here
on CPU float64 tensors. The problem's leaves are cast to float32, as
``chd_tpu`` casts them; the solvers cast them on to their own dtype.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from ..characters import get_character
from ..core import quat
from ..core.animation import Animation
from ..core.fk import positions_global
from .types import PhysInput


def _f64(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _fk(anim: Animation) -> np.ndarray:
    return positions_global(_f64(anim.rotations), _f64(anim.positions), anim.parents).numpy()


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32))


def to_towr(v: np.ndarray) -> np.ndarray:
    """Animation (cm, y-down-ish) → TOWR coords (m, z-up): negate, swap y/z,
    ×0.01 (towr_utils.py:516-524)."""
    out = -np.asarray(v, np.float64)
    return out[..., [0, 2, 1]] * 0.01


def add_heel(anim: Animation, toe_inds, ankle_inds) -> Animation:
    """Append dummy left/right heel joints parented to the ankles, placed at
    the toes' vertical offset (towr_utils.add_heel_to_anim:401-423)."""
    F = anim.num_frames
    heel_off = np.zeros((2, 3))
    heel_off[:, 1] = np.asarray(anim.offsets)[list(toe_inds), 1]
    offsets = np.concatenate([np.asarray(anim.offsets), heel_off], axis=0)
    parents = tuple(anim.parents) + (int(ankle_inds[0]), int(ankle_inds[1]))
    orients = np.concatenate(
        [np.asarray(anim.orients), np.tile([1.0, 0, 0, 0], (2, 1))], axis=0
    )
    rot = np.concatenate(
        [np.asarray(anim.rotations), np.tile([1.0, 0, 0, 0], (F, 2, 1))], axis=1
    )
    pos = np.concatenate(
        [np.asarray(anim.positions), np.tile(heel_off[None], (F, 1, 1))], axis=1
    )
    return Animation(rot, pos, orients, offsets, parents)


def unwrap_angles(angles: np.ndarray) -> np.ndarray:
    """Temporal euler unwrap matching the reference loop (towr_utils:613-621):
    each frame's angle is shifted by 2π toward the previous frame's value
    until within π — the sign of the step follows the PREVIOUS value's sign."""
    out = angles.copy()
    for dim in range(out.shape[1]):
        cur = out[0, dim]
        for f in range(1, out.shape[0]):
            pre = 1.0 if cur >= 0.0 else -1.0
            nxt = out[f, dim]
            while abs(nxt - cur) > np.pi:
                nxt += pre * 2.0 * np.pi
            out[f, dim] = nxt
            cur = nxt
    return out


def contact_durations(flags: np.ndarray, dt: float) -> List[float]:
    """Binary per-frame flags → phase duration list
    (towr_utils.find_contact_durations:435-449). Note the reference iterates
    F−1 steps, so the final frame contributes via the trailing phase."""
    durations = []
    prev = flags[0]
    cur = 0.0
    for i in range(flags.shape[0] - 1):
        if flags[i] != prev:
            durations.append(cur)
            cur = dt
        else:
            cur += dt
        prev = flags[i]
    durations.append(cur)
    return durations


def prepare_input(
    anim: Animation,
    floor_normal: np.ndarray,
    floor_point: np.ndarray,
    foot_contacts: np.ndarray,
    character: str,
    start_idx: Optional[int] = None,
    end_idx: Optional[int] = None,
    dt: float = 1.0 / 30.0,
    combined_contacts: bool = False,
    out_dir: Optional[str] = None,
) -> PhysInput:
    """Build the physics problem from an animated skeleton.

    anim: skeleton-order Animation (cm); floor_*: kinematic-stage floor (cm,
    animation coords); foot_contacts: (F, 4) [Lheel, Ltoe, Rheel, Rtoe].
    Writes reference-format text files into out_dir when given.
    """
    char = get_character(character)
    F = anim.num_frames
    start = 0 if start_idx is None else start_idx
    end = F if end_idx is None else end_idx

    # --- zero-root pass for hip offsets + inertia (towr_utils:485-535) -------
    zero_rot = np.array(anim.rotations)
    zero_rot[:, 0] = [1.0, 0, 0, 0]
    zero_pos = np.array(anim.positions)
    zero_pos[:, 0] = 0.0
    anim0 = anim.replace(rotations=zero_rot, positions=zero_pos)
    norm_pos = _fk(anim0)  # cm, root at origin

    # leg length down the left chain (cm → m)
    left_chain = list(char.left_leg_chain)
    offsets = np.asarray(anim.offsets)
    max_leg_length = np.linalg.norm(offsets[left_chain[1:]], axis=1).sum() * 0.01

    idx, w, frac = char.segment_matrices()
    seg_pos = np.einsum("sk,fskd->fsd", w, norm_pos[:, idx])
    frame_coms = np.einsum("s,fsd->fd", frac, seg_pos)  # (F, 3) cm

    # hip offsets: ×0.01 then negate then swap (towr_utils:517-519)
    hip_l = -(norm_pos[:, char.hip_inds[0]] - frame_coms) * 0.01
    hip_l = hip_l[:, [0, 2, 1]]
    hip_r = -(norm_pos[:, char.hip_inds[1]] - frame_coms) * 0.01
    hip_r = hip_r[:, [0, 2, 1]]

    # inertia about the COM in TOWR coords: positions centered at COM,
    # negated + swapped + meters (towr_utils:521-535)
    centered = (norm_pos - frame_coms[:, None, :]) * 0.01
    centered = -centered
    centered = centered[..., [0, 2, 1]]
    seg_c = np.einsum("sk,fskd->fsd", w, centered[:, idx])
    seg_mass = frac * char.mass
    r2 = np.einsum("fsd,fsd->fs", seg_c, seg_c)
    eye = np.eye(3)
    inertia = np.einsum(
        "s,fsij->fij",
        seg_mass,
        r2[..., None, None] * eye - seg_c[..., :, None] * seg_c[..., None, :],
    )

    # --- full-pose pass for trajectories (towr_utils:544-581) ---------------
    toe_l, toe_r = char.toe_inds
    ankle_l, ankle_r = char.ankle_inds
    if char.has_heel:
        heel_anim = anim
        heel_l, heel_r = char.heel_indices
    else:
        heel_anim = add_heel(anim, (toe_l, toe_r), (ankle_l, ankle_r))
        heel_l, heel_r = heel_anim.num_joints - 2, heel_anim.num_joints - 1
    anim_pos = to_towr(_fk(heel_anim))  # (F, J(+2), 3) meters, towr coords

    left_foot = anim_pos[:, toe_l]
    right_foot = anim_pos[:, toe_r]
    left_heel = anim_pos[:, heel_l]
    right_heel = anim_pos[:, heel_r]
    heel_dist = np.mean(np.linalg.norm(left_foot - left_heel, axis=1))

    heel_offsets = np.asarray(heel_anim.offsets)
    max_heel_length = (
        np.linalg.norm(offsets[left_chain[1:-1]], axis=1).sum()
        + np.linalg.norm(heel_offsets[heel_l])
    ) * 0.01

    # root orientation: angle-axis → negate + swap axis → euler, unwrapped
    rot_angle, rot_axis = quat.to_angle_axis(_f64(anim.rotations))
    rot_axis = rot_axis.numpy().copy()
    rot_axis *= -1.0
    rot_axis = rot_axis[..., [0, 2, 1]]
    q2 = quat.from_angle_axis(rot_angle, _f64(rot_axis))
    root_rot = quat.to_euler(q2, "xyz").numpy()[:, 0, :]
    root_rot = unwrap_angles(root_rot)

    # COM trajectory in towr coords over the heeled skeleton (:629-637)
    idx_h, w_h, frac_h = char.segment_matrices()
    seg_pos_t = np.einsum("sk,fskd->fsd", w_h, anim_pos[:, idx_h])
    anim_com = np.einsum("s,fsd->fd", frac_h, seg_pos_t)

    # --- floor (towr_utils:679-706) ------------------------------------------
    fn = np.asarray(floor_normal, np.float64).copy()
    fp = np.asarray(floor_point, np.float64) * 0.01
    fn *= -1.0
    fn = fn[[0, 2, 1]]
    fp = -fp
    fp = fp[[0, 2, 1]]

    # --- contacts (towr_utils:707-738) ----------------------------------------
    fc = np.asarray(foot_contacts)
    left_any = np.amax(fc[:, [0, 1]], axis=1)[start:end]
    right_any = np.amax(fc[:, [2, 3]], axis=1)[start:end]
    # columns → [left toe, left heel, right toe, right heel]
    contacts_all = fc[start:end][:, [1, 0, 3, 2]]
    # The actual toe SCHEDULE (what defines the phase durations): toe-only
    # flags in the default heel mode, heel∨toe in combined mode
    # (towr_utils:729-737). The reference additionally writes a start-contact
    # flag sourced from the OTHER variant (:719-725) — a quirk reproduced
    # only in the text writer below.
    lt = left_any if combined_contacts else contacts_all[:, 0]
    rt = right_any if combined_contacts else contacts_all[:, 2]
    lh = contacts_all[:, 1]
    rh = contacts_all[:, 3]
    contact = np.stack([lt, rt, lh, rh], axis=0)
    start_flag_quirk = np.array(
        [
            contacts_all[0, 0] if combined_contacts else left_any[0],
            contacts_all[0, 2] if combined_contacts else right_any[0],
            lh[0],
            rh[0],
        ],
        dtype=int,
    )

    phys = PhysInput(
        dt=_f32(dt),
        base_lin=_f32(anim_com[start:end]),
        base_ang=_f32(root_rot[start:end]),
        ee_pos=_f32(np.stack([left_foot, right_foot, left_heel, right_heel])[:, start:end]),
        contact=_f32(contact),
        left_hip=_f32(hip_l[start:end]),
        right_hip=_f32(hip_r[start:end]),
        inertia=_f32(inertia[start:end]),
        mass=_f32(char.mass),
        max_leg_length=_f32(max_leg_length),
        max_heel_length=_f32(max_heel_length),
        heel_dist=_f32(heel_dist),
        floor_normal=_f32(fn),
        floor_point=_f32(fp),
    )

    if out_dir is not None:
        write_input_files(phys, out_dir, dt, start_flags=start_flag_quirk)
    return phys


def write_input_files(phys: PhysInput, out_dir: str, dt: float, start_flags=None):
    """Emit skel/motion/terrain/contact_info.txt in the reference's format
    (towr_utils.py:585-777) for cross-checking against the C++ solver."""
    os.makedirs(out_dir, exist_ok=True)
    F = int(phys.base_lin.shape[0])

    def row(v):
        return " ".join(str(float(x)) for x in v)

    with open(os.path.join(out_dir, "skel_info.txt"), "w") as f:
        for fr in range(F):
            f.write(row(np.asarray(phys.left_hip)[fr]) + "\n")
        for fr in range(F):
            f.write(row(np.asarray(phys.right_hip)[fr]) + "\n")
        f.write(f"{float(phys.max_leg_length)}\n{float(phys.max_heel_length)}\n")
        f.write(f"{float(phys.heel_dist)}\n{float(phys.mass)}\n")
        I = np.asarray(phys.inertia)
        for fr in range(F):
            m = I[fr]
            f.write(
                f"{m[0,0]} {m[1,1]} {m[2,2]} {m[0,1]} {m[0,2]} {m[1,2]}\n"
            )

    def flat(a):
        return " ".join(str(float(x)) for x in np.asarray(a).reshape(-1))

    with open(os.path.join(out_dir, "motion_info.txt"), "w") as f:
        f.write(f"{dt}\n")
        f.write(flat(phys.base_lin) + "\n")
        f.write(flat(phys.base_ang) + "\n")
        # order in the file: left toe, LEFT HEEL, right toe, right heel
        # (towr_utils:654-677 / phys_optim ReadMotionInfo:199-204)
        ee = np.asarray(phys.ee_pos)
        f.write(flat(ee[0]) + "\n")
        f.write(flat(ee[2]) + "\n")
        f.write(flat(ee[1]) + "\n")
        f.write(flat(ee[3]) + "\n")

    with open(os.path.join(out_dir, "terrain_info.txt"), "w") as f:
        n = np.asarray(phys.floor_normal)
        p = np.asarray(phys.floor_point)
        f.write(f"{n[0]} {n[1]} {n[2]}\n{p[0]} {p[1]} {p[2]}")

    contact = np.asarray(phys.contact).astype(int)
    if start_flags is None:
        start_flags = contact[:, 0]
    with open(os.path.join(out_dir, "contact_info.txt"), "w") as f:
        # file order: left toe, left heel, right toe, right heel (:744-777);
        # the start flag reproduces the reference's OR/toe-only quirk
        for k in [0, 2, 1, 3]:
            durs = contact_durations(contact[k], dt)
            f.write(f"{int(start_flags[k])}\n{len(durs)}\n")
            f.write(" ".join(str(d) for d in durs) + "\n")
