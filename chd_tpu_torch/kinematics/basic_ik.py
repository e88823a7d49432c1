"""Secondary IK solvers (port of chd_tpu/kinematics/basic_ik.py): the rest of
the reference's IK family beside the CK solver of ``kinematics/ik.py``.

- ``solve_basic_ik``: per-joint rotations that align the current child
  directions with the target directions, averaged in the quaternion log
  space, applied joint by joint down the tree;
- ``solve_jacobian_ik``: damped least squares, with an optional
  nullspace-projected secondary task pulling all joints toward reference
  positions.

No pipeline stage calls them. Each runs on the device and in the dtype of
the Animation of tensors it receives (an Animation of arrays goes to
``device``, the card unless the caller asks for the CPU); the per-frame
normal equations go to ``torch.linalg.solve`` (a host sync: these solvers
are not captured), their products in full float32 whatever the
process-wide TF32 setting.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core import quat
from ..core.animation import on_device
from ..core.fk import Tree, fk
from ..core.skeleton import children_list
from ..core.skinning import _tensor as _as
from ..utils.precision import full_f32
from .ik import IKConfig, IKLayout, _build_jacobian


def solve_basic_ik(anim, target_positions, iterations: int = 1, device="cuda"):
    """Direction-matching IK toward full-body target positions (F, J, 3)."""
    anim = on_device(anim, device)
    rot = anim.rotations.clone()
    pos = _as(anim.positions, rot)
    tgt = _as(target_positions, rot)
    tree = Tree(anim.parents, rot.device)
    children = children_list(anim.parents)
    for _ in range(iterations):
        for j in range(anim.num_joints):
            if len(children[j]) == 0:
                continue
            c = torch.as_tensor(children[j], device=rot.device)
            gq, gp = fk(rot, pos, tree)
            jdirs = gp.index_select(1, c) - gp[:, j:j + 1]
            ddirs = tgt.index_select(1, c) - gp[:, j:j + 1]
            jn = jdirs / (torch.linalg.vector_norm(jdirs, dim=-1, keepdim=True) + 1e-10)
            dn = ddirs / (torch.linalg.vector_norm(ddirs, dim=-1, keepdim=True) + 1e-10)
            cross = torch.linalg.cross(jn, dn, dim=-1)
            # chd_tpu's arccos(clip(jn·dn)), as the better-conditioned
            # atan2: near 0 arccos loses ~1/θ ulps (measured on the card:
            # 1.9e-5 of a quaternion in float32 after 2 iterations)
            angles = torch.atan2(torch.linalg.vector_norm(cross, dim=-1), (jn * dn).sum(-1))
            # the axis in the joint's local frame
            axes = quat.rotate(quat.conjugate(gq[:, j:j + 1]), cross)
            rots = quat.from_angle_axis(angles, axes)  # (F, C, 4)
            avg = rots[:, 0] if len(children[j]) == 1 else quat.exp(quat.log(rots).mean(-2))
            rot[:, j] = quat.mul(rot[:, j], avg)
    return anim.replace(rotations=rot, positions=pos)


def solve_jacobian_ik(
    anim,
    targets: Dict[int, np.ndarray],
    cfg: IKConfig = IKConfig(),
    reference_positions: Optional[np.ndarray] = None,
    secondary: float = 0.25,
    weights: Optional[np.ndarray] = None,
    device="cuda",
):
    """Plain damped-least-squares IK toward {joint: (F, 3)} targets, with an
    optional positional secondary task: the result is biased toward
    ``reference_positions`` (F, J, 3) in the nullspace of the targets."""
    anim = on_device(anim, device)
    rot = anim.rotations
    pos = _as(anim.positions, rot)
    J, F = anim.num_joints, anim.num_frames
    tidx = tuple(sorted(targets.keys()))
    tpos = torch.stack([_as(targets[j], rot) for j in tidx], dim=1)  # (F, T, 3)
    refs = _as(reference_positions, rot) if reference_positions is not None else None
    ones = torch.ones(J, dtype=rot.dtype, device=rot.device)
    w = _as(weights, rot) if weights is not None else ones
    lay = IKLayout(anim.parents, tidx, cfg, w, ones)
    lay_all = IKLayout(anim.parents, range(J), cfg, w, ones) if refs is not None else None
    eye = torch.eye(lay.ndof, dtype=rot.dtype, device=rot.device)

    with full_f32():
        for _ in range(cfg.iterations):
            gq, gp = fk(rot, pos, lay.tree)
            x = quat.to_euler(rot, "xyz").reshape(F, J * 3)
            if cfg.translate:
                x = torch.cat([x, pos.reshape(F, J * 3)], dim=-1)
            eul = x[:, :J * 3].reshape(F, J, 3)
            Jm = _build_jacobian(eul, gq, gp, lay)
            e = cfg.gamma * (tpos.reshape(F, -1) - gp.index_select(1, lay.tcols).reshape(F, -1))
            Jt = Jm.transpose(1, 2)
            JtJ = Jt @ Jm
            A = JtJ + lay.D
            dx = torch.linalg.solve(A, (Jt @ e.unsqueeze(-1))).squeeze(-1)
            if refs is not None:
                ns = eye - torch.linalg.solve(A, JtJ)
                J2 = _build_jacobian(eul, gq, gp, lay_all)
                e2 = secondary * (refs.reshape(F, -1) - gp.reshape(F, -1))
                J2t = J2.transpose(1, 2)
                dx2 = torch.linalg.solve(J2t @ J2 + lay.D, J2t @ e2.unsqueeze(-1))
                dx = dx + (ns @ dx2).squeeze(-1)
            x = x + dx
            rot = quat.from_euler(x[:, :J * 3].reshape(F, J, 3), "xyz", world=True)
            if cfg.translate:
                pos = x[:, J * 3:].reshape(F, J, 3)
    return anim.replace(rotations=rot, positions=pos)
