"""Walking clips for the physics refinement, made from the seed (NumPy; the
arrays are float32, as the physics inputs are). Nothing of the program is
imported, so no change to it can change what a cell is fed.

The recipe is the port's synthetic walking clip (``physics/synth.py``
``walking_input``): a double-support gait with stationary stance feet, each
held under the COM at mid-stance, the swing feet on a 6 cm arc, a lateral
sway toward the stance foot, a 1.6 Hz vertical bob and a 0.8 Hz yaw, and
the body's inertia 8·I with σ 0.1 noise on its diagonal. Each sequence
draws its own gait:

- ``speed`` (m/s), the COM's forward speed;
- ``cycle`` (s), one stride of both feet;
- ``duty``, the share of a cycle each foot stands (above 0.5: double
  support);
- ``phase``, the cycle's phase at the first frame, in cycles.

Left single support runs from ``duty - 0.5`` to 0.5 of a cycle, so the sway
peaks toward +y at ``duty / 2``. Its amplitude is the inverted pendulum's,
A(ω² + g/z̄) = (g/z̄)(4/π)·0.1 at ω = 2π/cycle, z̄ = 0.95 m, scaled so that a
1 s cycle gets ``walking_input``'s 0.027 m (the formula's 0.0264, rounded
there). The first and last 3 frames are stance for every foot. At a 1 s
cycle, duty 0.65, phase 0 and speed 1.2 m/s the clip is ``walking_input``'s,
bit for bit.

Parameters (the cell's ``traffic``): ``sequences``, ``frames``, and the
ranges ``speed``, ``cycle``, ``duty``, ``phase`` ([low, high], uniform),
``inertia_sigma``; the configuration gives ``fps``, the body and the floor.
"""
from __future__ import annotations

import numpy as np

G_OVER_Z = 9.80665 / 0.95
SWAY_1S = 0.027  # m, walking_input's amplitude at a 1 s cycle


def sway_amplitude(cycle: float) -> float:
    def pendulum(T):
        w = 2 * np.pi / T
        return G_OVER_Z * (4 / np.pi) * 0.1 / (w * w + G_OVER_Z)

    return SWAY_1S * (pendulum(cycle) / pendulum(1.0))


def clip(F: int, dt: float, speed: float, cycle: float, duty: float, phase: float, rng,
         body: dict, floor: dict, inertia_sigma: float = 0.1) -> dict:
    """One clip, in the keys of the program's ``PhysInput``; the inertia's
    noise is drawn from ``rng``."""
    t = np.arange(F) * dt
    s = t / cycle + phase  # cycles since the gait's origin
    cyc = s % 1.0
    sway = sway_amplitude(cycle) * np.cos(2 * np.pi * (s - duty / 2))
    base_lin = np.stack([speed * t, sway, 0.95 + 0.02 * np.sin(2 * np.pi * 1.6 * t)], axis=1)
    base_ang = np.zeros((F, 3))
    base_ang[:, 2] = 0.05 * np.sin(2 * np.pi * 0.8 * t)

    left_stance = cyc < duty
    right_stance = ((cyc + 0.5) % 1.0) < duty
    contact = np.ones((4, F))
    contact[0] = contact[2] = left_stance.astype(float)
    contact[1] = contact[3] = right_stance.astype(float)
    contact[:, :3] = 1.0
    contact[:, -3:] = 1.0

    ee = np.zeros((4, F, 3))
    side_y = np.array([0.1, -0.1, 0.1, -0.1])
    heel_dx = np.array([0.0, 0.0, -0.2, -0.2])
    for e in range(4):
        c = contact[e]
        bounds = np.flatnonzero(np.diff(np.concatenate([[0.0], c, [0.0]])))
        stances = [(bounds[i], bounds[i + 1]) for i in range(0, len(bounds), 2)]
        x = np.empty(F)
        z = np.zeros(F)
        holds = [heel_dx[e] + speed * t[(a + b - 1) // 2] for a, b in stances]
        for (a, b), h in zip(stances, holds):
            x[a:b] = h
        for k in range(len(stances) - 1):
            f0, f1 = stances[k][1], stances[k + 1][0]
            u = np.linspace(0.0, 1.0, f1 - f0 + 2)[1:-1]
            x[f0:f1] = holds[k] + (holds[k + 1] - holds[k]) * u
            z[f0:f1] = 0.06 * np.sin(np.pi * u)
        ee[e] = np.stack([x, np.full(F, side_y[e]), z], axis=1)

    inertia = np.tile(np.eye(3) * body["inertia_diag"], (F, 1, 1))
    inertia += rng.normal(0, inertia_sigma, size=(F, 3, 3)) * np.eye(3)

    def f32(a):
        return np.asarray(a, np.float32)

    return {"dt": f32(dt), "base_lin": f32(base_lin), "base_ang": f32(base_ang),
            "ee_pos": f32(ee), "contact": f32(contact),
            "left_hip": f32(np.tile(body["left_hip"], (F, 1))),
            "right_hip": f32(np.tile(body["right_hip"], (F, 1))),
            "inertia": f32(inertia), "mass": f32(body["mass"]),
            "max_leg_length": f32(body["max_leg_length"]),
            "max_heel_length": f32(body["max_heel_length"]),
            "heel_dist": f32(body["heel_dist"]), "floor_normal": f32(floor["normal"]),
            "floor_point": f32(floor["point"])}


def gaits(rng, p: dict, n: int) -> list:
    """``n`` gaits (speed, cycle, duty, phase) drawn from ``rng``."""
    return [tuple(float(rng.uniform(*p[k])) for k in ("speed", "cycle", "duty", "phase"))
            for _ in range(n)]


def clips(seed: int, cfg: dict, p: dict) -> list:
    """The cell's ``p["sequences"]`` clips of ``p["frames"]`` frames: each
    sequence's gait, then its inertia's noise, from one generator."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(p["sequences"]):
        speed, cycle, duty, phase = gaits(rng, p, 1)[0]
        out.append(clip(p["frames"], 1.0 / cfg["fps"], speed, cycle, duty, phase, rng,
                        cfg["body"], cfg["floor"], p["inertia_sigma"]))
    return out
