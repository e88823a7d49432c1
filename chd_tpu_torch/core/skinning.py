"""Linear-blend skinning and wrapped angles (port of chd_tpu/core/skinning.py).

The rest of the animation library's surface: LBS mesh skinning (used by the
ICP mesh-fitting solver, ``kinematics/icp.py``) and the wrapped-angle
semantics of the reference's Pivots (angles kept in (−π, π]). ``skin`` runs
on the device and in the dtype of the animation's rotations; an animation
of arrays goes to ``device``, the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import quat
from ..utils.device import resolve_device
from .animation import on_device
from .fk import fk


def _tensor(a, like: torch.Tensor) -> torch.Tensor:
    """An array or tensor on ``like``'s device, in its dtype."""
    a = a if isinstance(a, torch.Tensor) else np.asarray(a)
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def skin(anim, rest_anim, vertex_weights, mesh, maxjoints: int = 4,
         device="cuda") -> torch.Tensor:
    """Linear-blend skin mesh vertices through an animation.

    anim/rest_anim: posed and rest Animations (same skeleton); vertex_weights:
    (V, J) skinning weights; mesh: (V, 3) rest vertices. Uses the
    top-``maxjoints`` weights per vertex. Returns (F, V, 3) on anim's device
    (``device`` for array leaves, ``core.animation.on_device``).
    """
    rot = on_device(anim, device).rotations
    w = _tensor(vertex_weights, rot)
    J = w.shape[1]
    top_w, top_idx = _topk(w, min(maxjoints, J))
    # all-zero weight rows (unskinned prop vertices) stay bound rigidly to
    # joint 0 rather than emitting NaNs
    wsum = top_w.sum(1, keepdim=True)
    top_w = torch.where(wsum > 0, top_w / torch.clamp(wsum, min=1e-12), 0.0)
    first = torch.where(wsum[:, 0] > 0, top_w[:, 0], 1.0)
    top_w = torch.cat([first.unsqueeze(1), top_w[:, 1:]], dim=1)

    # rest frame 0 defines the bind pose (only that frame's FK is needed)
    gq_r, gp_r = fk(_tensor(rest_anim.rotations, rot)[:1],
                    _tensor(rest_anim.positions, rot)[:1], rest_anim.parents)
    gq_p, gp_p = fk(rot, _tensor(anim.positions, rot), anim.parents)
    bind_q, bind_p = gq_r[0], gp_r[0]

    mesh = _tensor(mesh, rot)
    # each vertex in each influencing joint's bind-local frame: (V, k, 3)
    local = quat.rotate(quat.conjugate(bind_q[top_idx]), mesh.unsqueeze(1) - bind_p[top_idx])
    posed = quat.rotate(gq_p[:, top_idx], local.unsqueeze(0)) + gp_p[:, top_idx]  # (F, V, k, 3)
    return (posed * top_w[None, :, :, None]).sum(2)


def _topk(w: torch.Tensor, k: int):
    """The k largest weights of each row and their joints, ties in joint
    order: a stable sort, as ``jnp.argsort`` is (skinning weights tie at 0
    all the time)."""
    idx = torch.argsort(-w, dim=1, stable=True)[:, :k]
    return torch.gather(w, 1, idx), idx


def wrap_angles(a, device="cuda") -> torch.Tensor:
    """Wrap to (−π, π] (the reference's Pivots): a floor modulo. A tensor
    stays on its device; an array goes to ``device``."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.asarray(a), device=resolve_device(device))
    return -(torch.remainder(-a + math.pi, 2 * math.pi) - math.pi)
