"""3D skeleton animation (matplotlib, headless; port of
chd_tpu/viz/skeleton3d.py: inputs may be tensors on any device).

Replaces totalcap_utils.visualize_results (src/utils/totalcap_utils.py:
193-335): multiple skeletons, per-joint contact coloring, tiled floor from a
(normal, point) plane. Writes mp4/PNG frames via viz.video (no interactive
windows, no ffmpeg dependency).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .video import VideoSink, figure_to_rgb, to_host


def eval_plane(normal, point, xz):
    """Height of the plane at (x, z) (totalcap_utils.eval_plane:188-191)."""
    n, p = np.asarray(to_host(normal)), np.asarray(to_host(point))
    return (n @ p - n[0] * xz[0] - n[2] * xz[1]) / n[1]


def _draw_floor(ax, normal, point, center_xz, tile=25.0, ntiles=10, flip=True):
    pre = -1.0 if flip else 1.0
    xs = center_xz[0] + (np.arange(ntiles + 1) - ntiles / 2) * tile
    zs = center_xz[1] + (np.arange(ntiles + 1) - ntiles / 2) * tile
    for x in xs:
        ys = [pre * eval_plane(normal, point, (x, z)) for z in (zs[0], zs[-1])]
        ax.plot([x, x], [zs[0], zs[-1]], ys, color="0.6", lw=0.8)
    for z in zs:
        ys = [pre * eval_plane(normal, point, (x, z)) for x in (xs[0], xs[-1])]
        ax.plot([xs[0], xs[-1]], [z, z], ys, color="0.6", lw=0.8)


def animate_skeletons(
    joints3d: Sequence[np.ndarray],
    adjacency: Sequence[np.ndarray],
    out_path: str,
    contacts: Optional[np.ndarray] = None,
    floor_normal=None,
    floor_point=None,
    fps: float = 30.0,
    colors=("g", "b", "r"),
    figsize=(8, 6),
    max_frames: Optional[int] = None,
) -> str:
    """joints3d: list of (F, J, 3) arrays (already in display coords);
    adjacency: matching list of (E, 2) bone index pairs; contacts: (F, J)
    flags coloring joints red for the first skeleton."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    joints3d, adjacency, contacts, floor_normal, floor_point = to_host(
        (joints3d, adjacency, contacts, floor_normal, floor_point))
    all_pts = np.concatenate([j.reshape(-1, 3) for j in joints3d], axis=0)
    lo, hi = all_pts.min(axis=0), all_pts.max(axis=0)
    center = (lo + hi) / 2
    rad = float(np.max(hi - lo) / 2 + 25.0)

    F = min(j.shape[0] for j in joints3d)
    if max_frames is not None:
        F = min(F, max_frames)

    fig = plt.figure(figsize=figsize)
    ax = fig.add_subplot(111, projection="3d")

    with VideoSink(out_path, fps) as sink:
        for f in range(F):
            ax.clear()
            ax.set_xlim3d(center[0] - rad, center[0] + rad)
            ax.set_zlim3d(center[1] - rad, center[1] + rad)
            ax.set_ylim3d(center[2] - rad, center[2] + rad)
            ax.set_axis_off()
            if floor_normal is not None and floor_point is not None:
                _draw_floor(ax, floor_normal, floor_point, (center[0], center[2]))
            for k, (pts, adj) in enumerate(zip(joints3d, adjacency)):
                c = colors[k % len(colors)]
                for a, b in adj:
                    ax.plot(
                        [pts[f, a, 0], pts[f, b, 0]],
                        [pts[f, a, 2], pts[f, b, 2]],
                        [pts[f, a, 1], pts[f, b, 1]],
                        color=c, lw=2,
                    )
                jc = np.full(pts.shape[1], c, dtype=object)
                if k == 0 and contacts is not None:
                    jc[np.where(contacts[f] > 0)[0]] = "r"
                for j in range(pts.shape[1]):
                    ax.plot([pts[f, j, 0]], [pts[f, j, 2]], [pts[f, j, 1]], "o",
                            color=jc[j], markersize=3)
            sink.write(figure_to_rgb(fig))
    plt.close(fig)
    return out_path
