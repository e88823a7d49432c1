"""Single-rigid-body dynamics with time-varying inertia (port of
chd_tpu/physics/srbd.py, over a batch of sequences).

Re-derivation of the reference's HumanoidRigidBodyDynamics
(towr_phys_optim/src/models/humanoid_rigid_body_dynamics.cpp:89-115): the
Newton–Euler violation

    ang: I_w ω̇ + ω × (I_w ω) − Σ_e (p_e − c) × f_e
    lin: m c̈ − Σ_e f_e − m g ĝ        (ĝ = −floor normal, :208-211)

with the per-frame body inertia tensor picked by time (:81-87) and
I_w = R I_b Rᵀ (:104). The base orientation convention matches TOWR's
EulerConverter: world rotation R = Rz(θz)·Ry(θy)·Rx(θx) and world angular
velocity ω = M(θ)·θ̇ with columns M = [Rz·Ry·x̂ | Rz·ŷ | ẑ].

Everything is finite differences on the frame grid + autodiff. Frame-indexed
tensors carry a leading batch axis: (B, F, ...), or (B, 4, F, ...) for the
end effectors; per-sequence scalars are (B,).
"""
from __future__ import annotations

import torch

from .types import GRAVITY


def rot_zyx(ang: torch.Tensor) -> torch.Tensor:
    """R = Rz(θz)·Ry(θy)·Rx(θx) for ang (..., 3) = (θx, θy, θz)."""
    x, y, z = ang[..., 0], ang[..., 1], ang[..., 2]
    cx, sx = torch.cos(x), torch.sin(x)
    cy, sy = torch.cos(y), torch.sin(y)
    cz, sz = torch.cos(z), torch.sin(z)
    r00 = cz * cy
    r01 = cz * sy * sx - sz * cx
    r02 = cz * sy * cx + sz * sx
    r10 = sz * cy
    r11 = sz * sy * sx + cz * cx
    r12 = sz * sy * cx - cz * sx
    r20 = -sy
    r21 = cy * sx
    r22 = cy * cx
    return torch.stack([r00, r01, r02, r10, r11, r12, r20, r21, r22], -1).unflatten(-1, (3, 3))


def euler_rate_matrix(ang: torch.Tensor) -> torch.Tensor:
    """M(θ) with ω_world = M · (θ̇x, θ̇y, θ̇z)."""
    y, z = ang[..., 1], ang[..., 2]
    cy, sy = torch.cos(y), torch.sin(y)
    cz, sz = torch.cos(z), torch.sin(z)
    zero = torch.zeros_like(y)
    one = torch.ones_like(y)
    # column 0: Rz·Ry·x̂ ; column 1: Rz·ŷ ; column 2: ẑ (rows listed here)
    return torch.stack([cz * cy, -sz, zero,
                        sz * cy, cz, zero,
                        -sy, zero, one], -1).unflatten(-1, (3, 3))


def _per_seq(dt: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B,) per-sequence scalars shaped to broadcast against ``like``."""
    return dt.reshape(dt.shape + (1,) * (like.dim() - dt.dim()))


def central_diff(x: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
    """(B, F, ...) → time derivative along F, central interior / one-sided
    edges; dt (B,)."""
    dt = _per_seq(dt, x[:, :1])
    interior = (x[:, 2:] - x[:, :-2]) / (2.0 * dt)
    first = (x[:, 1:2] - x[:, :1]) / dt
    last = (x[:, -1:] - x[:, -2:-1]) / dt
    return torch.cat([first, interior, last], dim=1)


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.matmul(m, v.unsqueeze(-1)).squeeze(-1)


def angular_velocity(base_ang: torch.Tensor, dt: torch.Tensor):
    """World-frame ω and ω̇ from euler trajectories via finite differences."""
    ang_rate = central_diff(base_ang, dt)          # (B, F, 3)
    omega = _matvec(euler_rate_matrix(base_ang), ang_rate)
    return omega, central_diff(omega, dt)


def dynamic_violation(base_lin, base_ang, ee_pos, ee_force, contact, inertia, mass,
                      gravity_dir, dt) -> torch.Tensor:
    """Newton–Euler violation per frame.

    base_lin/base_ang: (B, F, 3); ee_pos/ee_force: (B, 4, F, 3); contact:
    (B, 4, F); inertia: (B, F, 3, 3) body frame; mass (B,); gravity_dir (B, 3)
    unit vector of gravity (ĝ = −floor normal); dt (B,). Returns (B, F, 6):
    [angular, linear].
    """
    R = rot_zyx(base_ang)                                       # (B, F, 3, 3)
    I_w = torch.matmul(torch.matmul(R, inertia), R.transpose(-1, -2))  # R I Rᵀ
    omega, omega_dot = angular_velocity(base_ang, dt)

    f_eff = ee_force * contact.unsqueeze(-1)   # forces vanish off contact
    f_sum = f_eff.sum(dim=1)                   # (B, F, 3)
    # τ_e = f × (c − p_e)  (reference :97-100)
    tau = torch.linalg.cross(f_eff, base_lin.unsqueeze(1) - ee_pos, dim=-1).sum(dim=1)

    acc = central_diff(central_diff(base_lin, dt), dt)

    ang = _matvec(I_w, omega_dot) + torch.linalg.cross(omega, _matvec(I_w, omega), dim=-1) - tau
    m = _per_seq(mass, acc)
    lin = m * acc - f_sum - m * GRAVITY * gravity_dir.unsqueeze(1)
    return torch.cat([ang, lin], dim=-1)
