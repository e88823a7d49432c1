"""The synthetic Mixamo contact dataset on one device (port of
chd_tpu/contact/data.py).

The reference's training-set layout (Character/Motion/{foot_contacts.npy,
viewN/, keypoints_viewN/, viewN_camera_params.npz}) loads into stacked
tensors that stay on the device: every sequence is gap-filled and
normalized once at load, and each training step gathers its windows there.
``chd_tpu.contact.data`` imports jax at the top, so its host helpers are
rewritten here rather than imported.

The split is the reference's: per character, a motion-level 80/10/10
train/test/val split shuffled under ``np.random.seed(0)``. The pixel
normalization is the median hip→toe distance over the whole set, before
the split.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from chd_tpu.characters.defs import OP_ROOT_JOINT

from ..ingest import openpose
from ..ops import gapfill, windows


def _subdirs(path: str) -> List[str]:
    return sorted(
        os.path.join(path, f)
        for f in os.listdir(path)
        if os.path.isdir(os.path.join(path, f)) and not f.startswith(".")
    )


def character_paths(root: str) -> List[str]:
    return _subdirs(root)


def motion_paths(character_dir: str) -> List[str]:
    return _subdirs(character_dir)


def view_names(motion_dir: str) -> List[str]:
    return sorted(
        f
        for f in os.listdir(motion_dir)
        if os.path.isdir(os.path.join(motion_dir, f)) and f.startswith("view")
    )


def motion_vid_paths(motion_dir: str) -> List[str]:
    """Rendered view videos <motion>_<view>.mp4."""
    name = os.path.basename(os.path.abspath(motion_dir))
    return [os.path.join(motion_dir, f"{name}_{v}.mp4") for v in view_names(motion_dir)]


def cam_param_paths(motion_dir: str) -> List[str]:
    """Per-view camera parameter files viewN_camera_params.npz."""
    return [os.path.join(motion_dir, f"{v}_camera_params.npz") for v in view_names(motion_dir)]


def load_cam_params(paths: Sequence[str]) -> List:
    """{P, RT, K} npz dicts, None for a missing file."""
    return [np.load(p) if os.path.exists(p) else None for p in paths]


def frame_paths(view_dir: str) -> List[str]:
    """Rendered frame images of one view."""
    if not os.path.isdir(view_dir):
        return []
    return sorted(
        os.path.join(view_dir, f)
        for f in os.listdir(view_dir)
        if not f.startswith(".") and f.rsplit(".", 1)[-1] in ("png", "jpg", "jpeg")
    )


def reference_split(num_characters: int, num_motions: int, num_views: int,
                    train_frac: float = 0.8) -> Tuple[List[int], List[int], List[int]]:
    """(train, test, val) global sequence indices, bit-identical to the
    reference's; numpy's global RNG state is restored afterwards."""
    rng_state = np.random.get_state()
    np.random.seed(0)
    try:
        split_inds: List[List[int]] = [[], [], []]
        per_char = num_motions * num_views
        for c in range(num_characters):
            inds = np.arange(num_motions)
            np.random.shuffle(inds)
            train_size = int(train_frac * num_motions)
            test_size = (num_motions - train_size) // 2
            groups = (inds[:train_size], inds[train_size:train_size + test_size],
                      inds[train_size + test_size:])
            base = c * per_char
            for i, g in enumerate(groups):
                for m in g:
                    start = base + m * num_views
                    split_inds[i] += list(range(start, start + num_views))
        return split_inds[0], split_inds[1], split_inds[2]
    finally:
        np.random.set_state(rng_state)


@dataclasses.dataclass
class ContactDataset:
    """All sequences as stacked device tensors, and the split index lists."""

    op_data: torch.Tensor     # (N, F, 25, 3) gap-filled, normalized
    contacts: torch.Tensor    # (N, F, 4)
    normalization: float
    splits: Dict[str, List[int]]
    num_frames: int
    names: List[str]

    @classmethod
    def load(cls, root: str, conf_thresh: float = 0.2, train_frac: float = 0.8,
             device="cpu") -> "ContactDataset":
        chars = character_paths(root)
        if not chars:
            raise FileNotFoundError(f"no character dirs under {root}")
        motions_per_char = len(motion_paths(chars[0]))

        seqs, labels, names = [], [], []
        num_views: Optional[int] = None
        for cdir in chars:
            for mdir in motion_paths(cdir):
                vnames = view_names(mdir)
                if num_views is None:
                    num_views = len(vnames)
                contact = np.load(os.path.join(mdir, "foot_contacts.npy"))
                for v in vnames:
                    seqs.append(openpose.load_keypoint_dir(os.path.join(mdir, f"keypoints_{v}")))
                    labels.append(contact)
                    names.append(f"{os.path.basename(cdir)}/{os.path.basename(mdir)}/{v}")

        expected = len(chars) * motions_per_char * (num_views or 0)
        if len(seqs) != expected:
            raise ValueError(
                f"ragged dataset: found {len(seqs)} sequences but {len(chars)} characters × "
                f"{motions_per_char} motions × {num_views} views = {expected}; the "
                "reference split requires a regular grid")
        op = np.stack(seqs).astype(np.float32)          # (N, F, 25, 3)
        contacts = np.stack(labels).astype(np.float32)  # (N, F, 4)

        # normalization over the whole set, before the split
        hip_toe = op[:, :, OP_ROOT_JOINT, :2] - op[:, :, 19, :2]
        normalization = float(np.median(np.linalg.norm(hip_toe, axis=-1)))
        train, test, val = reference_split(len(chars), motions_per_char, num_views, train_frac)

        proc = gapfill.preprocess_keypoints(torch.from_numpy(op).to(device), conf_thresh,
                                            normalization)
        return cls(op_data=proc, contacts=torch.from_numpy(contacts).to(device),
                   normalization=normalization,
                   splits={"train": train, "test": test, "val": val},
                   num_frames=op.shape[1], names=names)

    def split_arrays(self, split: str) -> Tuple[torch.Tensor, torch.Tensor]:
        idx = torch.tensor(self.splits[split], dtype=torch.long, device=self.op_data.device)
        return self.op_data[idx], self.contacts[idx]


# ---------------------------------------------------------------------------
# window sampling on the device
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _device_index(values: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """``values`` as an index tensor on ``device``, copied there once: a
    Python list as an index is a synchronous host-to-device copy per call,
    which a training step must not make."""
    return torch.tensor(values, dtype=torch.long, device=device)


def sample_train_windows(generator: Optional[torch.Generator], op_data: torch.Tensor,
                         contacts: torch.Tensor, window_size: int, pred_size: int,
                         joint_subset: Sequence[int], noise_dev: float = 0.005,
                         use_confidence: bool = True, *, targets: Optional[torch.Tensor] = None,
                         noise: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One random window per sequence, on the device.

    op_data (B, F, 25, 3), contacts (B, F, 4) → (feats (B, W, J, C), labels
    (B, P, 4)): a target frame per sequence uniform in [W//2, F - W//2), its
    window root-normalized and cut to ``joint_subset``, N(0, noise_dev) noise
    on x/y, and the labels of the P middle frames. ``targets`` (B,) and
    ``noise`` (B, W, J, 2, unit normal) replace the two draws from
    ``generator``, which must lie on the data's device.
    """
    B, F = op_data.shape[:2]
    half = window_size // 2
    dev = op_data.device
    if targets is None:
        targets = torch.randint(half, F - half, (B,), generator=generator, device=dev)
    starts = targets - half
    fidx = starts[:, None] + torch.arange(window_size, device=dev)[None, :]  # (B, W)
    win = op_data[torch.arange(B, device=dev)[:, None], fidx]               # (B, W, 25, 3)
    win = windows.root_normalize_windows(win, OP_ROOT_JOINT)
    win = win[:, :, _device_index(tuple(joint_subset), dev)]
    if noise is None:
        noise = torch.randn(win[..., :2].shape, generator=generator, device=dev,
                            dtype=win.dtype)
    xy = win[..., :2] + noise_dev * noise
    win = torch.cat([xy, win[..., 2:]], dim=-1) if use_confidence else xy

    off = (window_size - pred_size) // 2
    lidx = starts[:, None] + off + torch.arange(pred_size, device=dev)[None, :]
    labels = contacts[torch.arange(B, device=dev)[:, None], lidx]
    return win, labels


def eval_windows(op_data: torch.Tensor, contacts: torch.Tensor, window_size: int,
                 pred_size: int, joint_subset: Sequence[int], overlap: bool = False,
                 use_confidence: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic val/test windows: starts 0, W, 2W, ... (F // W per
    sequence), or every start with ``overlap``. Returns (feats (B·n, W, J, C),
    labels (B·n, P, 4))."""
    F = op_data.shape[1]
    dev = op_data.device
    if overlap:
        starts = torch.arange(windows.num_windows(F, window_size), device=dev)
    else:
        starts = torch.arange(F // window_size, device=dev) * window_size
    fidx = starts[:, None] + torch.arange(window_size, device=dev)[None, :]  # (n, W)
    win = op_data[:, fidx]                                                  # (B, n, W, 25, 3)
    win = windows.root_normalize_windows(win.reshape((-1,) + win.shape[2:]), OP_ROOT_JOINT)
    win = win[:, :, _device_index(tuple(joint_subset), dev)]
    if not use_confidence:
        win = win[..., :2]

    off = (window_size - pred_size) // 2
    lidx = starts[:, None] + off + torch.arange(pred_size, device=dev)[None, :]
    labels = contacts[:, lidx].reshape(-1, pred_size, contacts.shape[-1])
    return win, labels
