"""Kinematic refinement problems made from the seed (NumPy, float64): a
smooth motion of the configuration's skeleton (eulers drifting linearly
between two random poses, the root walking 15 cm in x and z) seen by the
MTC camera, SMPL angles at its eulers negated, full 2D confidence on the 25
OpenPose joints and none on the 3 spine joints, and random contacts.

Parameters (the cell's ``traffic``): ``sequences``, ``frames``,
``euler0`` (half-width of the first pose), ``euler_drift`` (half-width of
the change to the second), ``contact_p`` (a label is on with probability
1 - contact_p).
"""
from __future__ import annotations

import numpy as np


def _rot(axis: int, a: np.ndarray) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    R = np.zeros(a.shape + (3, 3))
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    R[..., axis, axis] = 1.0
    R[..., i, i], R[..., j, j] = c, c
    sign = -1.0 if axis != 1 else 1.0
    R[..., i, j], R[..., j, i] = sign * s, -sign * s
    return R


def positions(eulers: np.ndarray, offsets: np.ndarray, parents) -> np.ndarray:
    """Root-relative joint positions (..., J, 3) of world-'xyz' eulers (...,
    J, 3) (R = Rz Ry Rx per joint) on bone ``offsets`` (J, 3)."""
    R = _rot(2, eulers[..., 2]) @ _rot(1, eulers[..., 1]) @ _rot(0, eulers[..., 0])
    G = np.zeros_like(R)
    P = np.zeros(eulers.shape)
    for j, p in enumerate(parents):
        if p < 0:
            G[..., j, :, :] = R[..., j, :, :]
            P[..., j, :] = offsets[j]
        else:
            G[..., j, :, :] = G[..., p, :, :] @ R[..., j, :, :]
            P[..., j, :] = P[..., p, :] + G[..., p, :, :] @ offsets[j]
    return P


def problem(rng, cfg: dict, p: dict) -> dict:
    """One problem in the keys of ``optimize_trajectory_batch``."""
    sk, cb = cfg["skeleton"], cfg["combined"]
    parents, offsets = sk["parents"], np.asarray(sk["offsets"])
    J, F = len(parents), p["frames"]
    e0 = rng.uniform(-p["euler0"], p["euler0"], size=(J, 3))
    e1 = e0 + rng.uniform(-p["euler_drift"], p["euler_drift"], size=(J, 3))
    t = np.linspace(0, 1, F)[:, None, None]
    es = (1 - t) * e0[None] + t * e1[None]
    root = np.stack([np.linspace(0, 15, F), np.full(F, -95.0), np.linspace(380, 395, F)], axis=1)
    skel_to_data = np.asarray(cb["skel_to_data"])
    data_to_skel = np.argsort(skel_to_data)
    y = positions(es, offsets, parents)[:, data_to_skel]
    ri = cb["root_idx"]
    pose3d = y.copy()
    pose3d[:, ri] = 0.0
    world = y + root[:, None]
    world[:, ri] = root
    (fx, fy), (cx, cy) = cfg["camera"]["focal"], cfg["camera"]["pp"]
    pose2d = np.stack([fx * world[..., 0] / world[..., 2] + cx,
                       fy * world[..., 1] / world[..., 2] + cy], axis=-1)
    conf = np.ones((F, 28))
    conf[:, 25:] = 0
    labels = (rng.uniform(size=(F, 4)) > p["contact_p"]).astype(int)
    vc = np.zeros((F, 28))
    for col, joints in cb["contact_to_data"].items():
        vc[:, joints] = labels[:, int(col), None]
    return dict(pose2d=pose2d, conf2d=conf, pose3d=pose3d, root_pos=root, smpl_angles=-es,
                vel_constraints=vc)


def problems(seed: int, cfg: dict, p: dict) -> list:
    rng = np.random.default_rng(seed)
    return [problem(rng, cfg, p) for _ in range(p["sequences"])]
