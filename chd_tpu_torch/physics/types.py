"""Data structures for the physics trajectory optimization (port of
chd_tpu/physics/types.py).

In-memory replacements for the four whitespace text files the reference
pipeline shuttles between python and the C++ IPOPT front-end
(src/utils/towr_utils.py:451-777 writers ↔ towr_phys_optim/phys_optim.cpp:
169-267 readers). All quantities are in TOWR convention: meters, seconds,
and the swizzled axes (x, z_up) — see prepare.py for the transform.

The leaves are tensors (or arrays, on the host side of ``prepare``). One
problem has the shapes noted below; the solvers take a batch of them, each
leaf with a leading axis B (``parallel.batch.pad_phys_inputs``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NUM_EE = 4  # left toe, right toe, left heel, right heel (phys_optim.cpp:104)
GRAVITY = 9.80665  # m/s² (TOWR DynamicModel)


class PhysInput(NamedTuple):
    """One sequence's physics problem (frame grid, dt = 1/fps)."""

    dt: torch.Tensor              # () seconds between frames
    base_lin: torch.Tensor        # (F, 3) COM position init
    base_ang: torch.Tensor        # (F, 3) base euler angles init (radians, xyz)
    ee_pos: torch.Tensor          # (4, F, 3) EE position init (lt, rt, lh, rh)
    contact: torch.Tensor         # (4, F) binary contact schedule
    left_hip: torch.Tensor        # (F, 3) hip offset in COM (body) frame
    right_hip: torch.Tensor       # (F, 3)
    inertia: torch.Tensor         # (F, 3, 3) body-frame inertia about COM
    mass: torch.Tensor            # ()
    max_leg_length: torch.Tensor  # () hip→toe
    max_heel_length: torch.Tensor  # () hip→heel
    heel_dist: torch.Tensor       # () toe↔heel separation
    floor_normal: torch.Tensor    # (3,) unit, points away from ground
    floor_point: torch.Tensor     # (3,)
    frame_mask: torch.Tensor = None  # (F,) 1 = real frame; None = all real.
    # Ragged batches pad to a common F (parallel/batch.pad_phys_inputs);
    # masked frames contribute no cost or constraint residuals at all.


class PhysWeights(NamedTuple):
    """Pipeline cost weights (scripts/run_phys_mocap.py:33-44 defaults,
    flags at phys_optim.cpp:27-31)."""

    w_com_lin: float = 0.4
    w_com_ang: float = 1.7
    w_ee: float = 0.3
    w_smooth: float = 0.1
    w_dur: float = 0.1


class PhysResult(NamedTuple):
    """Optimized solution on the frame grid (sol_out_*.txt content)."""

    dt: torch.Tensor
    base_lin: torch.Tensor   # (F, 3)
    base_ang: torch.Tensor   # (F, 3) radians
    ee_pos: torch.Tensor     # (4, F, 3)
    ee_force: torch.Tensor   # (4, F, 3)
    contact: torch.Tensor    # (4, F)
