"""A seeded contact dataset that a model can learn, made without files.

The recipe of ``tests/test_train_learns.py`` (``chd_tpu``'s check that
training learns): each sequence's heel and toe heights oscillate, the two
feet in antiphase, over a still upper body, and a foot is in contact while
it is near its low point; pixel noise on top. Contacts are a simple
function of the pose, so a working trainer must reach a high F1. The last
``n_holdout`` sequences are the val and test split.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import gapfill
from .data import ContactDataset


def learnable_keypoints(n_seq: int, frames: int, seed: int = 0):
    """(n_seq, frames, 25, 3) keypoints and (n_seq, frames, 4) contacts,
    float32 numpy."""
    rng = np.random.default_rng(seed)
    op = np.zeros((n_seq, frames, 25, 3), np.float32)
    contacts = np.zeros((n_seq, frames, 4), np.float32)
    t = np.arange(frames)
    for s in range(n_seq):
        base_y = rng.uniform(400, 500)
        phase = rng.uniform(0, 2 * np.pi)
        freq = rng.uniform(0.2, 0.5)
        op[s, :, :, 0] = rng.uniform(500, 700, size=(1, 25))
        op[s, :, :, 1] = rng.uniform(100, 400, size=(1, 25))
        op[s, :, :, 2] = 1.0
        for side, (heel, toe, small_toe, l_heel, l_toe) in enumerate(
                [(21, 19, 20, 0, 1), (24, 22, 23, 2, 3)]):
            osc = np.sin(freq * t + phase + side * np.pi)
            y = base_y + 40 * osc
            op[s, :, heel, 1] = y
            op[s, :, toe, 1] = y + 5
            op[s, :, small_toe, 1] = y + 5
            down = osc > 0.3  # planted while low (image y grows downward)
            contacts[s, :, l_heel] = down
            contacts[s, :, l_toe] = down
        op[s, :, 8, 1] = base_y - 200  # hip above the feet
        op[s, :, 8, 0] = 600
        op[s, :, 19, 0] = 580
    op[..., :2] += rng.normal(size=op[..., :2].shape) * 2.0
    return op, contacts


def learnable_dataset(n_seq: int = 24, frames: int = 60, seed: int = 0, n_holdout: int = 4,
                      device="cpu") -> ContactDataset:
    """``learnable_keypoints`` gap-filled and normalized on ``device``."""
    op, contacts = learnable_keypoints(n_seq, frames, seed)
    norm = float(np.median(np.linalg.norm(op[:, :, 8, :2] - op[:, :, 19, :2], axis=-1)))
    proc = gapfill.preprocess_keypoints(torch.from_numpy(op).to(device), 0.2, norm)
    n_train = n_seq - n_holdout
    held = list(range(n_train, n_seq))
    return ContactDataset(op_data=proc, contacts=torch.from_numpy(contacts).to(device),
                          normalization=norm,
                          splits={"train": list(range(n_train)), "val": held, "test": held},
                          num_frames=frames, names=[f"s{i}" for i in range(n_seq)])
