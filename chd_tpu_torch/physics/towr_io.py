"""Reference-compatible solution artifacts (port of chd_tpu/physics/towr_io.py:
the same text for the same arrays).

Writers/readers for ``sol_out_{no_dynamics,dynamics,durations}.txt`` and
``success_log.txt`` in the exact format of the C++ solver
(towr_phys_optim/phys_optim.cpp SaveSolution:63-143, SaveSuccessLog:145-153)
and its python consumer (towr_utils.load_results:51-122) — so downstream
viz/Blender tooling and golden-file comparisons work across implementations.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import quat
from .types import PhysResult


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def save_solution(res: PhysResult, path: str) -> None:
    base_lin = _host(res.base_lin)
    base_ang = np.degrees(_host(res.base_ang))
    ee = _host(res.ee_pos)
    force = _host(res.ee_force)
    contact = _host(res.contact).astype(int)
    F = base_lin.shape[0]
    E = ee.shape[0]

    def line(a):
        return " ".join(f"{v:.10g}" for v in np.asarray(a).reshape(-1))

    rows = [
        "dt", f"{float(res.dt):g}",
        "num_frames", str(F),
        "num_feet", str(E),
        "base_lin", line(base_lin),
        "base_ang", line(base_ang),
    ]
    for i in range(E):
        rows += [f"foot{i}_pos", line(ee[i])]
    for i in range(E):
        rows += [f"foot{i}_force", line(force[i])]
    for i in range(E):
        rows += [f"foot{i}_contact", "".join(f"{int(v)} " for v in contact[i]).rstrip()]
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


class LoadedResults(NamedTuple):
    """Parsed solution, transformed back to animation coordinates (the
    inverse swizzle of towr_utils.load_results:101-120)."""

    num_feet: int
    dt: float
    base_pos: np.ndarray   # (F, 3) animation coords, meters
    base_rot: np.ndarray   # (F, 3) euler, radians, animation coords
    base_R: np.ndarray     # (F, 3, 3)
    feet_pos: np.ndarray   # (F, E, 3)
    feet_force: np.ndarray  # (F, E, 3)
    feet_contact: np.ndarray  # (F, E)


def load_results(path: str, flip_coords: bool = True) -> LoadedResults:
    with open(path, "r") as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    vals = {}
    i = 0
    order = []
    while i + 1 < len(lines) + 1:
        if i + 1 >= len(lines):
            break
        key, data = lines[i], lines[i + 1]
        vals[key] = data
        order.append(key)
        i += 2

    dt = float(vals["dt"])
    F = int(vals["num_frames"])
    E = int(vals["num_feet"])

    def arr(key, shape):
        return np.fromiter((float(x) for x in vals[key].split()), float).reshape(shape)

    base_pos = arr("base_lin", (F, 3))
    base_rot_deg = arr("base_ang", (F, 3))
    feet_pos = np.stack([arr(f"foot{k}_pos", (F, 3)) for k in range(E)], axis=1)
    feet_force = np.stack([arr(f"foot{k}_force", (F, 3)) for k in range(E)], axis=1)
    feet_contact = np.stack(
        [np.array([int(x) for x in vals[f"foot{k}_contact"].split()]) for k in range(E)],
        axis=1,
    )

    sign = -1.0 if flip_coords else 1.0
    base_pos = sign * base_pos[:, [0, 2, 1]]
    feet_pos = sign * feet_pos[:, :, [0, 2, 1]]
    feet_force = sign * feet_force[:, :, [0, 2, 1]]

    # rotation: euler(deg) → angle-axis → swap/flip axis → euler(rad)
    q = quat.from_euler(torch.from_numpy(np.radians(base_rot_deg)), "xyz", world=True)
    angle, axis = quat.to_angle_axis(q)
    axis = axis.numpy()[:, [0, 2, 1]] * sign
    q2 = quat.from_angle_axis(angle, torch.from_numpy(axis))
    base_rot = quat.to_euler(q2, "xyz").numpy()
    base_R = quat.to_matrix(q2).numpy()

    return LoadedResults(E, dt, base_pos, base_rot, base_R, feet_pos, feet_force, feet_contact)


def save_success_log(path: str, dynamics_ok: bool, durations_ok: bool) -> None:
    with open(path, "w") as f:
        f.write(f"dynamics {int(dynamics_ok)}\n")
        f.write(f"durations {int(durations_ok)}\n")


def load_success_log(path: str):
    out = {}
    with open(path) as f:
        for ln in f:
            parts = ln.split()
            if len(parts) == 2:
                out[parts[0]] = bool(int(parts[1]))
    return out
