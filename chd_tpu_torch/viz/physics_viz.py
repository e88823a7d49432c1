"""Physics-result animation (matplotlib, headless; port of
chd_tpu/viz/physics_viz.py: inputs may be tensors on any device).

Replaces towr_utils.viz_results (src/utils/towr_utils.py:149-399): COM +
feet markers, contact coloring, force arrows, dashed traces, tiled floor,
optional full skeleton(s), side-by-side comparison with per-result offsets.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .skeleton3d import _draw_floor
from .video import VideoSink, figure_to_rgb, to_host

_FEET_COLORS = ["g", "b", "m", "purple"]


def animate_physics_results(
    results: Sequence,                      # towr_io.LoadedResults (anim coords)
    out_path: str,
    skeleton_positions: Optional[Sequence[np.ndarray]] = None,  # (F, J, 3) m
    skeleton_parents: Optional[Sequence] = None,
    floor_normal=None,
    floor_point=None,
    names: Optional[List[str]] = None,
    draw_forces: bool = True,
    draw_trace: bool = True,
    fps: float = 30.0,
    offset=2.0,
    max_frames: Optional[int] = None,
) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    results, skeleton_positions, skeleton_parents, floor_normal, floor_point = to_host(
        (results, skeleton_positions, skeleton_parents, floor_normal, floor_point))
    # y-flip for display + x-offset per result (towr_utils.py:157-167,982-987)
    disp = []
    for k, r in enumerate(results):
        base = r.base_pos.copy()
        feet = r.feet_pos.copy()
        force = r.feet_force.copy()
        base[:, 1] *= -1.0
        feet[:, :, 1] *= -1.0
        force[:, :, 1] *= -1.0
        base[:, 0] += offset * k
        feet[:, :, 0] += offset * k
        disp.append((base, feet, force, r.feet_contact))

    skels = []
    if skeleton_positions is not None:
        for k, sp in enumerate(skeleton_positions):
            s = sp.copy()
            s[:, :, 1] *= -1.0
            s[:, :, 0] += offset * k
            skels.append(s)

    all_base = np.concatenate([d[0] for d in disp])
    lo, hi = all_base.min(axis=0), all_base.max(axis=0)
    center = (lo + hi) / 2
    rad = float(np.max(hi - lo) / 2 + 1.0)

    F = min(d[0].shape[0] for d in disp)
    if max_frames is not None:
        F = min(F, max_frames)

    fig = plt.figure(figsize=(9, 6))
    ax = fig.add_subplot(111, projection="3d")

    with VideoSink(out_path, fps) as sink:
        for f in range(F):
            ax.clear()
            ax.set_xlim3d(center[0] - rad, center[0] + rad)
            ax.set_zlim3d(center[1] - rad, center[1] + rad)
            ax.set_ylim3d(center[2] - rad, center[2] + rad)
            ax.set_axis_off()
            if floor_normal is not None and floor_point is not None:
                _draw_floor(ax, floor_normal, floor_point, (center[0], center[2]),
                            tile=0.5, ntiles=16)
            for k, (base, feet, force, contact) in enumerate(disp):
                if names and k < len(names):
                    ax.text(base[:, 0].mean(), base[:, 2].mean(),
                            base[:, 1].max() + 0.4, names[k])
                if draw_trace:
                    ax.plot(base[:, 0], base[:, 2], base[:, 1], "--", color="orange", lw=1)
                ax.plot([base[f, 0]], [base[f, 2]], [base[f, 1]], "o",
                        color="orange", markersize=8)
                for e in range(feet.shape[1]):
                    col = "r" if contact is not None and contact[f, e] else _FEET_COLORS[e % 4]
                    ax.plot([feet[f, e, 0]], [feet[f, e, 2]], [feet[f, e, 1]], "o",
                            color=col, markersize=6)
                    ax.plot([base[f, 0], feet[f, e, 0]], [base[f, 2], feet[f, e, 2]],
                            [base[f, 1], feet[f, e, 1]], color=_FEET_COLORS[e % 4], lw=1)
                    if draw_forces:
                        fv = force[f, e] * 1e-3
                        ax.plot(
                            [feet[f, e, 0] - fv[0], feet[f, e, 0]],
                            [feet[f, e, 2] - fv[2], feet[f, e, 2]],
                            [feet[f, e, 1] - fv[1], feet[f, e, 1]],
                            color="r", lw=1,
                        )
            for k, s in enumerate(skels):
                if skeleton_parents is None:
                    continue
                pars = skeleton_parents[k]
                for j in range(1, s.shape[1]):
                    p = pars[j]
                    ax.plot([s[f, j, 0], s[f, p, 0]], [s[f, j, 2], s[f, p, 2]],
                            [s[f, j, 1], s[f, p, 1]], color="purple", lw=1.5)
            sink.write(figure_to_rgb(fig))
    plt.close(fig)
    return out_path
