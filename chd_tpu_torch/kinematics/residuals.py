"""Residuals of the kinematic trajectory optimization, batched over sequences
(port of chd_tpu/kinematics/residuals.py).

The same block layout and per-element semantics as ``chd_tpu``, per
sequence, so outputs compare element-wise:

  [ projection (F·28·2) | velocity smoothness ((F−1)·28·3) |
    acceleration smoothness ((F−2)·28·3) | data (F·28·3) |
    contact zero-velocity ((F−1)·28·3) | floor distance (F·28) |
    euler-velocity smoothness ((F−1)·29·3) ]

Variables x: (B, F·(3 + J·3)), per frame the root translation and the
world-'xyz' euler angles in SKELETON order. Where ``chd_tpu`` vmaps one
sequence's function, every array here carries a leading sequence axis B, and
the residual of sequence b reads only sequence b's variables, so its
Jacobian is block-diagonal across the batch. FK runs with the root pinned at
the origin, so joint positions are root-relative; the root slot of the
data-order positions carries the root variable itself. Masked entries (zero
projection/data weight, no contact, padded frames) are exact zeros.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

import torch

from ..characters import defs
from ..core import quat
from ..core.fk import Tree, positions_global
from ..ops import jtjv as jtjv_ops

SMOOTH_VEL_EULER = 10.0  # euler-velocity multiplier; per-axis xyz is Layout.smooth_xyz


class TrajectoryData(NamedTuple):
    """Per-sequence problem data, each with a leading sequence axis B."""

    pose3d: torch.Tensor          # (B, F, 28, 3) data-order, root-relative (MTC init)
    root_trans: torch.Tensor      # (B, F, 3)
    pose2d_norm: torch.Tensor     # (B, F, 28, 2) normalized image coords
    proj_weights: torch.Tensor    # (B, F, 28) conf-scaled projection weights
    data_weights: torch.Tensor    # (B, F, 28)
    smooth_weights: torch.Tensor  # (B, 28) per-joint (data order)
    vel_constraints: torch.Tensor  # (B, F, 28) 1 = in contact
    floor_normal: torch.Tensor    # (B, 3)
    floor_point: torch.Tensor     # (B, 3)
    offsets: torch.Tensor         # (B, J, 3) fitted skeleton offsets (skeleton order)
    frame_mask: Optional[torch.Tensor] = None  # (B, F) 1 = real frame; None = all real
    # (ragged sequences pad to a common F; masked frames contribute no
    # residuals at all, so padding cannot perturb the real solution)


class TermWeights(NamedTuple):
    """Stage weights. Floats, or 0-d tensors (what ``lm.lm_solve`` turns
    them into, so one captured solver step serves both stages)."""

    proj: float = 1000.0
    smooth_vel: float = 0.1
    smooth_acc: float = 0.5
    data: float = 0.3
    vel: float = 10.0
    floor: float = 0.0


class Layout:
    """The device-side constants of the residual for one skeleton topology:
    its FK ``Tree``, the data-order gather, the root mask, the per-axis
    smoothness multipliers. Built once, outside a solve."""

    def __init__(self, parents: Sequence[int], device="cpu", dtype=torch.float32):
        self.tree = Tree(parents, device)
        self.parents = self.tree.parents
        self.data_to_skel = torch.as_tensor(defs.COMBINED_DATA_TO_SKEL, device=device)
        self.is_root = (torch.arange(defs.COMBINED_NUM_JOINTS, device=device)
                        == defs.COMBINED_ROOT_IDX).unsqueeze(-1)  # (28, 1)
        self.smooth_xyz = torch.tensor([1.0, 1.0, 2.0], dtype=dtype, device=device)
        quat.warm_constants(device, dtype)

    @functools.cached_property
    def residual(self) -> "TrajectoryResidual":
        """``trajectory_residuals`` on this layout, ``residual(x, data, w)``:
        one object a layout for ``lm.lm_solve``, so a captured LM step is
        found again."""
        return TrajectoryResidual(self)


class TrajectoryResidual:
    """``trajectory_residuals`` on one layout (``Layout.residual``), naming
    its JᵀJ·v for ``lm.lm_solve``: ``product_for(x0)`` is the layout's one
    kernel supplier (``kinematics/jtjv.py``) on CUDA, None elsewhere. The
    supplier is built on first use: it copies the tree's table to the
    device, and raises for a tree the kernel does not take."""

    def __init__(self, layout: Layout):
        self.layout = layout

    def __call__(self, x, data: "TrajectoryData", w: "TermWeights") -> torch.Tensor:
        return trajectory_residuals(x, data, w, self.layout)

    def product_for(self, x0: torch.Tensor):
        return jtjv_ops.supplier(x0, lambda: self.kernel)

    @functools.cached_property
    def kernel(self):
        from .jtjv import TrajectoryProduct

        return TrajectoryProduct(self.layout)


def data_order_positions(x: torch.Tensor, offsets: torch.Tensor, layout: Layout):
    """FK → data-order positions y with y[..., root, :] = root variable.

    x: (B, F, 3 + J·3); offsets (B, J, 3). Returns (y (B, F, 28, 3),
    root (B, F, 3))."""
    J = offsets.shape[-2]
    root = x[..., :3]
    euler = x[..., 3:].unflatten(-1, (J, 3))
    rot = quat.from_euler(euler, "xyz", world=True)
    pos = offsets.unsqueeze(-3).expand(rot.shape[:-1] + (3,))
    gp = positions_global(rot, pos, layout.tree)  # root at origin → root-relative
    y = gp.index_select(-2, layout.data_to_skel)
    return torch.where(layout.is_root, root.unsqueeze(-2), y), root


def trajectory_residuals(x: torch.Tensor, data: TrajectoryData, w: TermWeights,
                         layout: Layout) -> torch.Tensor:
    """(B, n) variables → (B, R) residuals, R as in ``chd_tpu`` for one
    sequence."""
    B, F = data.pose3d.shape[:2]
    x = x.reshape(B, F, -1)
    fm = (torch.ones((B, F), dtype=x.dtype, device=x.device) if data.frame_mask is None
          else data.frame_mask.to(x.dtype))
    pair = fm[:, :-1] * fm[:, 1:]          # both frames real
    triple = pair[:, :-1] * fm[:, 2:]      # three consecutive real frames
    fm4, pair4, triple4 = fm[..., None, None], pair[..., None, None], triple[..., None, None]

    y, root = data_order_positions(x, data.offsets, layout)

    # --- projection (F, 28, 2) -------------------------------------------------
    root_b = root.unsqueeze(-2)
    num = torch.where(layout.is_root, y, y + root_b)
    active = (data.proj_weights > 0).unsqueeze(-1)
    # guard masked rows' depth: the derivative of where still sees the
    # untaken branch, so a 0-depth padded joint would put NaNs in gradients
    z = torch.where(active, num[..., 2:3], 1.0)
    proj = num[..., :2] / z
    r_proj = torch.where(
        active, w.proj * data.proj_weights.unsqueeze(-1) * (proj - data.pose2d_norm), 0.0
    ) * fm4

    # --- velocity smoothness ((F-1), 28, 3) ------------------------------------
    sw = data.smooth_weights[:, None, :, None] * layout.smooth_xyz
    r_sv = w.smooth_vel * sw * (y[:, :-1] - y[:, 1:]) * pair4

    # --- acceleration smoothness ((F-2), 28, 3) ---------------------------------
    vel = y[:, 1:] - y[:, :-1]
    r_sa = w.smooth_acc * (vel[:, 1:] - vel[:, :-1]) * triple4

    # --- data term (F, 28, 3) ---------------------------------------------------
    target = torch.where(layout.is_root, data.root_trans.unsqueeze(-2), data.pose3d)
    r_data = w.data * data.data_weights.unsqueeze(-1) * (y - target) * fm4

    # --- contact zero-velocity ((F-1), 28, 3) -----------------------------------
    world = y + root_b  # the root entry becomes 2·root, but contacts are never on the root
    mask_v = (data.vel_constraints[:, :-1] == 1).unsqueeze(-1)
    r_vel = torch.where(mask_v, w.vel * (world[:, :-1] - world[:, 1:]), 0.0) * pair4

    # --- floor distance (F, 28) --------------------------------------------------
    d = ((world - data.floor_point[:, None, None, :])
         * data.floor_normal[:, None, None, :]).sum(-1)
    r_floor = torch.where(data.vel_constraints == 1, w.floor * d, 0.0) * fm[..., None]

    # --- euler-velocity smoothness ((F-1), 29, 3), root translation included ----
    xr = x.unflatten(-1, (-1, 3))
    r_es = w.smooth_vel * SMOOTH_VEL_EULER * (xr[:, :-1] - xr[:, 1:]) * pair4

    return torch.cat([r.reshape(B, -1) for r in (r_proj, r_sv, r_sa, r_data, r_vel,
                                                  r_floor, r_es)], dim=1)
