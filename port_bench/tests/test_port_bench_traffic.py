"""The traffic generators: the same seed gives the same inputs, another
seed others; the kinematic generator's NumPy FK agrees with the program's
forward kinematics."""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)

import harness  # noqa: E402


def test_keypoint_videos_per_seed():
    p = dict(harness.workload("detect.lower.v512x240")["traffic"], videos=4, frames=30)
    gen = harness.load("traffic", "keypoints")

    def make(seed):
        return gen.videos(torch, torch.Generator().manual_seed(seed), p, torch.device("cpu"))

    a, b, c = make(2**31 + 3), make(2**31 + 3), make(2**31 + 4)
    assert a.shape == (4, 30, 25, 3) and torch.equal(a, b) and not torch.equal(a, c)
    assert float(a[..., 0].min()) >= 200 and float(a[..., 0].max()) <= 1100
    low = (a[..., 2] == p["dropout_conf"]).double().mean()
    assert 0.01 < float(low) < 0.12


def test_kinematic_problems_per_seed_and_fk_against_the_program():
    from chd_tpu_torch.kinematics.residuals import Layout, data_order_positions

    cfg = harness.config("refine_default")
    p = dict(harness.workload("kin.combined28.b16x100")["traffic"], sequences=2, frames=8)
    gen = harness.load("traffic", "kinematic")
    a, b, c = gen.problems(5, cfg, p), gen.problems(5, cfg, p), gen.problems(6, cfg, p)
    assert all(np.array_equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    assert not np.array_equal(a[0]["pose3d"], c[0]["pose3d"])
    sk = cfg["skeleton"]
    es = np.random.default_rng(0).uniform(-0.4, 0.4, size=(3, len(sk["parents"]), 3))
    ours = gen.positions(es, np.asarray(sk["offsets"]), sk["parents"])
    x = torch.from_numpy(np.concatenate([np.zeros((3, 3)), es.reshape(3, -1)], 1))[None]
    y, _ = data_order_positions(x, torch.as_tensor(sk["offsets"], dtype=torch.float64)[None],
                                Layout(sk["parents"], "cpu", torch.float64))
    s2d = np.asarray(cfg["combined"]["skel_to_data"])
    want = y[0].numpy()[:, s2d]
    keep = np.arange(len(s2d)) != 0  # the root slot holds the root variable
    assert np.abs(ours[:, keep] - want[:, keep]).max() < 1e-7  # cm; the program's 1e-10 guards
