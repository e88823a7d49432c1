"""Animation container (port of chd_tpu/core/animation.py).

Per-frame local rotations (F, J, 4 wxyz) and local translations (F, J, 3),
rest-pose orients (J, 4) and offsets (J, 3), and the parents tuple. A plain
container: the leaves are numpy arrays (what ``bvh.load`` returns) or
tensors (what the solvers take); ``from_numpy`` and ``to_numpy`` move
between the two, so tests hand both packages the same arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device


class Animation:
    def __init__(self, rotations, positions, orients, offsets, parents):
        self.rotations = rotations  # (F, J, 4) local joint rotations, wxyz
        self.positions = positions  # (F, J, 3) local joint translations
        self.orients = orients      # (J, 4) rest orientations
        self.offsets = offsets      # (J, 3) rest offsets
        self.parents = tuple(int(p) for p in parents)

    @property
    def num_frames(self) -> int:
        return self.rotations.shape[0]

    @property
    def num_joints(self) -> int:
        return self.rotations.shape[1]

    def replace(self, **kw) -> "Animation":
        fields = dict(rotations=self.rotations, positions=self.positions,
                      orients=self.orients, offsets=self.offsets, parents=self.parents)
        fields.update(kw)
        return Animation(**fields)

    def slice_frames(self, start: int, end: int) -> "Animation":
        return self.replace(rotations=self.rotations[start:end],
                            positions=self.positions[start:end])

    @classmethod
    def from_numpy(cls, anim, device="cpu", dtype=torch.float32) -> "Animation":
        """Any animation with array leaves (this class, or ``chd_tpu``'s) →
        an ``Animation`` of tensors on ``device`` in ``dtype``."""
        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        return cls(t(anim.rotations), t(anim.positions), t(anim.orients), t(anim.offsets),
                   anim.parents)

    def to_numpy(self) -> "Animation":
        """The same animation with numpy leaves (tensors come to the host)."""
        def n(a):
            return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

        return Animation(n(self.rotations), n(self.positions), n(self.orients),
                         n(self.offsets), self.parents)


def on_device(anim, device="cuda") -> Animation:
    """``anim`` itself when its rotations are a tensor (its device and dtype
    decide); an animation with array leaves goes to ``device`` (raises for
    CUDA where there is none), as float64 if its rotations are float64, else
    float32."""
    if isinstance(anim.rotations, torch.Tensor):
        return anim
    f64 = np.asarray(anim.rotations).dtype == np.float64
    return Animation.from_numpy(anim, resolve_device(device),
                                torch.float64 if f64 else torch.float32)
