"""OpenPose keypoint videos for contact detection, made on the device from
the seed: x and y uniform over the training frame (1280 x 720), each
detection's confidence uniform, and a share of detections dropped to a low
confidence (the recipe of the repo's first contact benchmark).

Parameters (the cell's ``traffic``): ``videos``, ``frames``, ``x`` and
``y`` ranges in pixels, ``conf`` range, ``dropout`` share and
``dropout_conf``.
"""
from __future__ import annotations


def videos(torch, gen, p: dict, device):
    """(videos, frames, 25, 3) float32 keypoints on ``device`` from
    ``gen``, a generator on that device."""
    shape = (p["videos"], p["frames"], 25)
    u = torch.rand((4,) + shape, generator=gen, device=device)
    (x0, x1), (y0, y1), (c0, c1) = p["x"], p["y"], p["conf"]
    conf = c0 + (c1 - c0) * u[2]
    conf = torch.where(u[3] < p["dropout"], torch.full_like(conf, p["dropout_conf"]), conf)
    return torch.stack([x0 + (x1 - x0) * u[0], y0 + (y1 - y0) * u[1], conf], dim=-1)
