"""Synthetic benchmark/test motion clips for the physics solver (port of
chd_tpu/physics/synth.py: the same numpy generators from the same seeds, so
the clips equal chd_tpu's to the bit).

The reference validates its solver only on downloaded example data
(`data/example_data/dance1`, README.md:60-61), which the repo does not
hold; these generators produce kinematically-plausible,
dynamically-inconsistent clips of the same shape (walking with alternating
swing phases, standing squats) used by bench.py, the trajectory scoreboard
test, and the scaling demo.
"""
from __future__ import annotations

import numpy as np
import torch

from .types import GRAVITY, PhysInput


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32))


def walking_input(F: int, dt: float = 1.0 / 30.0, seed: int = 0):
    """Walking-like sequence with alternating swing phases (so the stage-3
    duration solve has real phases to optimize). Mirrors the contact-phase
    structure the reference's `find_contact_durations` extracts from real
    clips (src/utils/towr_utils.py:435-449)."""
    rng = np.random.default_rng(seed)
    t = np.arange(F) * dt
    speed = 1.2
    # lateral sway toward the stance foot (real gait does this; without it
    # single support at y=±0.1 with the COM on the midline is dynamically
    # inconsistent — a same-y toe/heel pair has no roll authority — and the
    # solver would be forced to drag stance feet toward the midline).
    # Left single support is t mod 1 ∈ [0.15, 0.5) (right foot swinging),
    # so the sway peaks toward +y at t=0.325; one full sway per 1 s cycle.
    # Amplitude from inverted-pendulum consistency ÿ ≈ (g/z̄)(y − y_foot)
    # with y_foot = ±0.1 square-wave (fundamental 4/π·0.1): at ω = 2π rad/s,
    # A(ω² + g/z̄) = (g/z̄)(4/π)0.1 → A ≈ 0.027 m.
    sway = 0.027 * np.cos(2 * np.pi * (t - 0.325))
    base_lin = np.stack([
        speed * t, sway, 0.95 + 0.02 * np.sin(2 * np.pi * 1.6 * t)
    ], axis=1)
    base_ang = np.zeros((F, 3))
    base_ang[:, 2] = 0.05 * np.sin(2 * np.pi * 0.8 * t)

    # gait schedule with DOUBLE SUPPORT (duty factor 0.65, 1 s cycle): with
    # strictly alternating single support the center of pressure is confined
    # to one foot's heel–toe segment while the COM sweeps ±0.3 m past it —
    # no consistent CoP exists near stance edges and the solver must shift
    # feet forward. Overlapping stances let the CoP hand over, as real gait
    # does.
    cyc = t % 1.0
    left_stance = cyc < 0.65
    right_stance = ((cyc + 0.5) % 1.0) < 0.65
    contact = np.ones((4, F))
    contact[0] = contact[2] = left_stance.astype(float)
    contact[1] = contact[3] = right_stance.astype(float)
    contact[:, :3] = 1.0
    contact[:, -3:] = 1.0

    # stance-consistent foot trajectories: a foot is STATIONARY while in
    # contact (otherwise the solver's no-slip constraint cannot track the
    # input and "error vs input" measures the input's own foot sliding, not
    # solver quality). Each stance holds the position under the COM at
    # MID-stance — heel-strike ahead of the COM, toe-off behind, as in real
    # gait — keeping hip→toe/heel distances inside the leg-length bounds for
    # the whole phase.
    ee = np.zeros((4, F, 3))
    side_y = np.array([0.1, -0.1, 0.1, -0.1])
    heel_dx = np.array([0.0, 0.0, -0.2, -0.2])
    for e in range(4):
        c = contact[e]
        # stance intervals [a, b)
        bounds = np.flatnonzero(np.diff(np.concatenate([[0.0], c, [0.0]])))
        stances = [(bounds[i], bounds[i + 1]) for i in range(0, len(bounds), 2)]
        x = np.empty(F)
        z = np.zeros(F)
        holds = [heel_dx[e] + speed * t[(a + b - 1) // 2] for a, b in stances]
        for (a, b), h in zip(stances, holds):
            x[a:b] = h
        for k in range(len(stances) - 1):  # swings between stances
            f0, f1 = stances[k][1], stances[k + 1][0]
            s = np.linspace(0.0, 1.0, f1 - f0 + 2)[1:-1]
            x[f0:f1] = holds[k] + (holds[k + 1] - holds[k]) * s
            z[f0:f1] = 0.06 * np.sin(np.pi * s)
        ee[e] = np.stack([x, np.full(F, side_y[e]), z], axis=1)

    inertia = np.tile(np.eye(3) * 8.0, (F, 1, 1))
    inertia += rng.normal(0, 0.1, size=(F, 3, 3)) * np.eye(3)
    return PhysInput(
        dt=_f32(dt),
        base_lin=_f32(base_lin),
        base_ang=_f32(base_ang),
        ee_pos=_f32(ee),
        contact=_f32(contact),
        left_hip=_f32(np.tile([0.0, 0.1, -0.1], (F, 1))),
        right_hip=_f32(np.tile([0.0, -0.1, -0.1], (F, 1))),
        inertia=_f32(inertia),
        mass=_f32(73.0),
        max_leg_length=_f32(1.2),
        max_heel_length=_f32(1.15),
        heel_dist=_f32(0.2),
        floor_normal=_f32([0.0, 0.0, 1.0]),
        floor_point=torch.zeros(3),
    )


def hopping_input(F: int, dt: float = 1.0 / 30.0, seed: int = 0):
    """Standing vertical hop with a true FLIGHT phase: crouch → push-off →
    ~0.3 s airborne (all four contacts open) → land → settle. During flight
    no contact force exists, so the solver's COM must follow a ballistic
    arc — the sharpest dynamic-consistency probe the walking clip can't
    provide (reference analog: the aerial phases its duration solver was
    built for, phys_optim.cpp:663-711)."""
    rng = np.random.default_rng(seed)
    t = np.arange(F) * dt
    T_fl = 0.3                      # flight duration
    t0 = 0.45 * F * dt              # takeoff time
    t1 = t0 + T_fl
    v0 = GRAVITY * T_fl / 2.0       # ballistic takeoff speed

    z0 = 0.95
    z = np.full(F, z0)
    crouch = (t > t0 - 0.4) & (t <= t0)
    z[crouch] = z0 - 0.08 * np.sin(np.pi * (t[crouch] - (t0 - 0.4)) / 0.4)
    fl = (t > t0) & (t < t1)
    z[fl] = z0 + v0 * (t[fl] - t0) - 0.5 * GRAVITY * (t[fl] - t0) ** 2
    land = (t >= t1) & (t < t1 + 0.3)
    z[land] = z0 - 0.05 * np.sin(np.pi * (t[land] - t1) / 0.3)
    base_lin = np.stack([np.zeros(F), np.zeros(F), z], axis=1)
    base_ang = np.zeros((F, 3))

    contact = np.ones((4, F))
    contact[:, fl] = 0.0
    contact[:, :3] = 1.0
    contact[:, -3:] = 1.0

    feet_xy = np.array([[0.15, 0.1], [-0.15, 0.1], [0.15, -0.1], [-0.15, -0.1]])
    ee = np.zeros((4, F, 3))
    ee[:, :, 0] = feet_xy[:, 0:1]
    ee[:, :, 1] = feet_xy[:, 1:2]
    ee[:, fl, 2] = (z[fl] - z0)[None, :]  # feet ride the ballistic arc

    inertia = np.tile(np.eye(3) * 8.0, (F, 1, 1))
    inertia += rng.normal(0, 0.05, size=(F, 3, 3)) * np.eye(3)
    return PhysInput(
        dt=_f32(dt),
        base_lin=_f32(base_lin),
        base_ang=_f32(base_ang),
        ee_pos=_f32(ee),
        contact=_f32(contact),
        left_hip=_f32(np.tile([0.1, 0.1, -0.1], (F, 1))),
        right_hip=_f32(np.tile([-0.1, 0.1, -0.1], (F, 1))),
        inertia=_f32(inertia),
        mass=_f32(73.0),
        max_leg_length=_f32(1.2),
        max_heel_length=_f32(1.15),
        heel_dist=_f32(0.2),
        floor_normal=_f32([0.0, 0.0, 1.0]),
        floor_point=torch.zeros(3),
    )
