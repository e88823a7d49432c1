"""ICP mesh-fitting IK (port of chd_tpu/kinematics/icp.py).

Fits an animation so that its linear-blend-skinned mesh matches per-frame
goal point clouds: damped least squares on euler (and translation)
variables with a skinning-weighted Jacobian, optionally re-associating each
vertex with its nearest goal point every iteration. No pipeline stage calls
it; it is part of the animation library's surface. It runs on the device
and in the dtype of the Animation of tensors it receives (an Animation of
arrays goes to ``device``, the card unless the caller asks for the CPU),
one batched per-frame ``torch.linalg.solve`` an iteration (not captured: a
host sync is allowed), its products in full float32.
"""
from __future__ import annotations

import torch

from ..core import quat
from ..core.animation import on_device
from ..core.fk import Tree, fk
from ..core.skeleton import descendants_mask
from ..core.skinning import _tensor as _as
from ..core.skinning import _topk, skin
from ..utils.precision import full_f32
from .ik import IKConfig, _axis_columns


def solve_icp(
    anim,
    rest_anim,
    vertex_weights,
    mesh,
    goal,
    cfg: IKConfig = IKConfig(iterations=10, damping=10.0, translate=True),
    maxjoints: int = 4,
    find_closest: bool = True,
    device="cuda",
):
    """anim/rest_anim: posed/rest Animations; vertex_weights (V, J);
    mesh (V, 3) rest vertices; goal (F, V, 3) target clouds. Runs on anim's
    device (``device`` for array leaves)."""
    anim = on_device(anim, device)
    rot = anim.rotations
    pos = _as(anim.positions, rot)
    dtype, device = rot.dtype, rot.device
    J, F = anim.num_joints, anim.num_frames
    tree = Tree(anim.parents, device)
    w_all = _as(vertex_weights, rot)
    top_w, top_idx = _topk(w_all, min(maxjoints, J))
    top_w = top_w / top_w.sum(1, keepdim=True)
    dsc = _as(descendants_mask(anim.parents), rot) + torch.eye(J, dtype=dtype, device=device)
    goal = _as(goal, rot)
    V = goal.shape[1]
    ndof = J * 3 * (2 if cfg.translate else 1)
    D = torch.diag(torch.full((ndof,), cfg.damping, dtype=dtype, device=device) ** 2)
    # vertex v moves with joint j's dofs iff j is an ancestor-or-self of one
    # of its influencing joints, weighted by skinning: (V, J)
    gate = torch.zeros((V, J), dtype=dtype, device=device).scatter(1, top_idx, top_w) @ dsc.T
    gate5 = gate.T[None, :, None, :, None]  # (1, J, 1, V, 1)
    eye = torch.eye(3, dtype=dtype, device=device)
    parent_idx = torch.as_tensor([max(p, 0) for p in anim.parents], device=device)
    is_root = (torch.arange(J, device=device) == 0).unsqueeze(-1)

    with full_f32():
        for _ in range(cfg.iterations):
            gq, gp = fk(rot, pos, tree)
            curr = skin(anim.replace(rotations=rot, positions=pos), rest_anim, w_all, mesh,
                        maxjoints)  # (F, V, 3)
            if find_closest:
                d2 = ((curr.unsqueeze(2) - goal.unsqueeze(1)) ** 2).sum(-1)  # (F, V, V)
                nearest = torch.argmin(d2, dim=2)  # the first of equal minima
                tgt = torch.gather(goal, 1, nearest.unsqueeze(-1).expand(F, V, 3))
            else:
                tgt = goal
            e = cfg.gamma * (tgt - curr).reshape(F, V * 3)

            x = quat.to_euler(rot, "xyz").reshape(F, J * 3)
            if cfg.translate:
                x = torch.cat([x, pos.reshape(F, J * 3)], dim=-1)
            parent_rot = torch.where(is_root, quat.identity((), dtype, device),
                                     gq.index_select(1, parent_idx))
            axes = _axis_columns(x[:, :J * 3].reshape(F, J, 3), parent_rot, eye)  # (F, J, 3, 3)

            # rotation block: gate[v, j] · (axis × (v − p_j)) for vertex v,
            # joint j, axis a
            diff = curr.unsqueeze(1) - gp.unsqueeze(2)  # (F, J, V, 3)
            gated = gate5 * diff.unsqueeze(2)  # (F, J, 1, V, 3) -> (F, J, 3, V, 3) below
            jrot = torch.linalg.cross(axes.unsqueeze(3).expand(F, J, 3, V, 3),
                                      gated.expand(F, J, 3, V, 3), dim=-1)
            Jm = jrot.reshape(F, J * 3, V * 3).transpose(1, 2)
            if cfg.translate:
                taxes = torch.stack([quat.rotate(parent_rot, ax) for ax in eye], dim=-2)
                jt = (gate5 * taxes.unsqueeze(3)).reshape(F, J * 3, V * 3).transpose(1, 2)
                Jm = torch.cat([Jm, jt], dim=-1)

            Jt = Jm.transpose(1, 2)
            dx = torch.linalg.solve(Jt @ Jm + D, Jt @ e.unsqueeze(-1)).squeeze(-1)
            x = x + dx
            rot = quat.from_euler(x[:, :J * 3].reshape(F, J, 3), "xyz", world=True)
            if cfg.translate:
                pos = x[:, J * 3:].reshape(F, J, 3)
    return anim.replace(rotations=rot, positions=pos)
