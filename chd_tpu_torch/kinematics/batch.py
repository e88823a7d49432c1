"""Batched multi-sequence kinematic optimization (port of
chd_tpu/kinematics/batch.py).

The whole refinement — CK-IK initialization, stage-1 LM, Huber floor fit and
contact pruning, stage-2 LM — runs in lockstep for a padded batch of
sequences on one device. Sequences pad to a common frame count by
replicating their last frame; padded frames carry zero weights, zero
contacts and a zero frame mask, so they add no residual and no floor-fit
point. Between the copy of the prepared arrays to the device and the copy of
the results back, nothing syncs with the host (``_refine_core``).

Each stage is a function of its own (``ik_init_batch``, ``lm_stage``,
``floor_stage``), so a caller can time them apart. The LM stages solve their
inner systems by PCG (``lm_solver="pcg"``, the default) or by the banded
direct solve of ``kinematics/banded.py`` (``"banded"``). On CUDA their
JᵀJ·v products, and the PCG's diagonal, are the trajectory residual's own
kernel (``kinematics/jtjv.py``), which the residual names to ``lm_solve``;
on the CPU they are autograd's. With a ``mesh``
(``parallel.mesh``) each rank solves its contiguous slice of the padded
batch and the results are gathered once at the end.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..characters import defs
from ..core import quat
from ..core.animation import Animation
from ..parallel import mesh as mesh_lib
from ..utils import cuda_graph
from ..utils.cuda_graph import GraphCache
from ..utils.device import resolve_device
from ..utils.profiling import span
from . import banded as banded_lib
from . import floor as floor_lib
from . import trajectory as traj_lib
from .ik import IKConfig, IKLayout, _solve as ik_solve
from .lm import LMConfig, frame_coloring_masks, lm_solve
from .residuals import Layout, TermWeights, TrajectoryData, data_order_positions

_S2D = np.asarray(defs.COMBINED_SKEL_TO_DATA)


def _pad_frames(a: np.ndarray, F: int) -> np.ndarray:
    if a.shape[0] >= F:
        return a[:F]
    reps = np.repeat(a[-1:], F - a.shape[0], axis=0)
    return np.concatenate([a, reps], axis=0)


LM_SOLVERS = ("pcg", "banded")


class BatchConsts:
    """Device constants of a batch shape: the residual layout, the IK layout,
    the coloring masks of the LM solver (the diagonal's for "pcg", the
    bands' for "banded"), the gathers of targets and feet. Built before a
    solve (they copy from the host, the residual's JᵀJ·v kernel its tree's
    table on CUDA); a ``GraphCache`` keeps one per shape and solver."""

    def __init__(self, parents: Sequence[int], num_frames: int, ik_cfg: IKConfig,
                 device, dtype, lm_solver: str = "pcg"):
        if lm_solver not in LM_SOLVERS:
            raise ValueError(f"lm_solver must be one of {LM_SOLVERS}, not {lm_solver!r}")
        J = len(parents)
        spine = set(int(s) for s in defs.COMBINED_SKEL_SPINE_JOINTS)
        tidx = tuple(j for j in range(J) if j not in spine)
        ones = torch.ones(J, dtype=dtype, device=device)
        self.layout = Layout(parents, device, dtype)
        self.ik = IKLayout(parents, tidx, ik_cfg, ones, ones)
        self.target_cols = torch.as_tensor(_S2D[list(tidx)], device=device)
        self.lm_solver = lm_solver
        masks = banded_lib.coloring_masks if lm_solver == "banded" else frame_coloring_masks
        self.masks = masks(num_frames, 3 + J * 3, dtype=dtype, device=device)
        self.feet_cols = torch.as_tensor(_S2D[defs.COMBINED_SKEL_FEET_IDX], device=device)
        self.xz = torch.as_tensor([0, 2], device=device)
        self.smooth = torch.as_tensor(defs.COMBINED_SMOOTH_WEIGHTS, dtype=dtype, device=device)
        # the supplier a solve on this device takes, built now: a tree the
        # kernel does not take raises here, not inside a solve
        self.layout.residual.product_for(self.smooth)


def batch_consts(parents, num_frames: int, ik_cfg: IKConfig, device, dtype,
                 graphs: Optional[GraphCache] = None, lm_solver: str = "pcg") -> BatchConsts:
    key = ("kinematic_batch", tuple(parents), num_frames, ik_cfg, torch.device(device), dtype,
           lm_solver)
    return cuda_graph.constant(graphs, key, lambda: BatchConsts(parents, num_frames, ik_cfg,
                                                                device, dtype, lm_solver))


def prepare_batch_arrays(problems: Sequence[dict], skeleton: Animation, cam_focal=defs.MTC_FOCAL,
                         cam_pp=defs.MTC_PP, device="cuda", dtype=torch.float32):
    """Host-side per-sequence prep: bone fit, weights and padding, stacked
    and copied to ``device`` (default ``cuda``; raises where CUDA is
    absent): the dict ``_refine_core`` consumes. Returns (arrs, F)."""
    device = resolve_device(device)
    parents = tuple(skeleton.parents)
    J = len(parents)
    F = max(p["pose2d"].shape[0] for p in problems)

    stacked = {k: [] for k in [
        "pose3d", "root", "p2dn", "pw", "dw", "vc", "offsets", "rot0", "pos0", "fmask"]}
    for p in problems:
        Fi = p["pose2d"].shape[0]
        targets = p["pose3d"][:, _S2D] + p["root_pos"][:, None, :]
        offsets = traj_lib.update_skeleton(np.asarray(skeleton.offsets), parents, targets)
        pw, dw = traj_lib.build_weights(p["conf2d"])
        p2dn = (p["pose2d"] - np.asarray(cam_pp)[None, None]) / np.asarray(cam_focal)[None, None]
        rot0 = traj_lib.init_rotations_from_smpl(p["smpl_angles"])
        pos0 = np.broadcast_to(offsets[None], (Fi, J, 3)).copy()
        pos0[:, 0] = p["root_pos"]
        real = np.concatenate([np.ones(Fi), np.zeros(F - Fi)])
        stacked["pose3d"].append(_pad_frames(p["pose3d"], F))
        stacked["root"].append(_pad_frames(p["root_pos"], F))
        stacked["p2dn"].append(_pad_frames(p2dn, F))
        stacked["pw"].append(_pad_frames(pw, F) * real[:, None])
        stacked["dw"].append(_pad_frames(dw, F) * real[:, None])
        stacked["vc"].append(_pad_frames(np.asarray(p["vel_constraints"]), F) * real[:, None])
        stacked["offsets"].append(offsets)
        stacked["rot0"].append(_pad_frames(rot0, F))
        stacked["pos0"].append(_pad_frames(pos0, F))
        stacked["fmask"].append(real)
    return {k: torch.as_tensor(np.stack(v), dtype=dtype, device=device)
            for k, v in stacked.items()}, F


def ik_init_batch(arrs, consts: BatchConsts, graphs: Optional[GraphCache] = None):
    """CK-IK initialization toward the observed joints (every joint but the
    spine), for every frame of every sequence. Returns (rotations (B, F, J,
    4), positions (B, F, J, 3))."""
    targets = arrs["pose3d"].index_select(2, consts.target_cols) + arrs["root"].unsqueeze(2)
    return ik_solve(arrs["rot0"], arrs["pos0"], targets, consts.ik, graphs=graphs)


def initial_x(rot: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """(B, F·(3 + J·3)) LM variables: root translation and world-'xyz' eulers."""
    B, F = rot.shape[:2]
    return torch.cat([pos[:, :, 0], quat.to_euler(rot, "xyz").reshape(B, F, -1)],
                     dim=-1).reshape(B, -1)


def make_data(arrs, consts: BatchConsts, vc, normal, point) -> TrajectoryData:
    B = arrs["pose3d"].shape[0]
    return TrajectoryData(
        arrs["pose3d"], arrs["root"], arrs["p2dn"], arrs["pw"], arrs["dw"],
        consts.smooth.expand(B, -1), vc, normal, point, arrs["offsets"], arrs["fmask"])


def lm_stage(x0, data: TrajectoryData, w: TermWeights, consts: BatchConsts, lm_cfg: LMConfig,
             graphs: Optional[GraphCache] = None) -> torch.Tensor:
    """One LM stage over the batch: PCG with the exact coloring diagonal, or
    the banded direct solve (``consts.lm_solver``). The products are those
    the residual names, its kernel's on CUDA and autograd's elsewhere."""
    if consts.lm_solver == "banded":
        x, _ = lm_solve(consts.layout.residual, x0, (data, w), lm_cfg, graphs=graphs,
                        banded_masks=consts.masks)
    else:
        x, _ = lm_solve(consts.layout.residual, x0, (data, w), lm_cfg, consts.masks, graphs)
    return x


def floor_stage(x, arrs, consts: BatchConsts):
    """Both Huber fits (ε=1.5 for the plane, ε=2.2 for pruning) of every
    sequence in one batched L-BFGS on the contact feet of solution x.
    Returns (normals (B, 3), points (B, 3), pruned constraints (B, F, 28)).

    The fits run in float64 whatever the solve's dtype (4 parameters, a few
    hundred points): a label is pruned when its point lies past 2.2 σ, and
    in float32 the L-BFGS's last digits move labels that sit on that line
    (measured: 4 of 48 on a synthetic clip, where chd_tpu's float32 fit and
    the float64 fits keep them all).
    """
    B, F = arrs["pose3d"].shape[:2]
    y, root = data_order_positions(x.reshape(B, F, -1), arrs["offsets"], consts.layout)
    pts = (y + root.unsqueeze(2)).index_select(2, consts.feet_cols).reshape(B, -1, 3)
    pts = pts.to(torch.float64)
    vc = arrs["vc"]
    mask = (vc.index_select(2, consts.feet_cols) == 1).reshape(B, -1)
    xz = pts.index_select(-1, consts.xz)
    eps = torch.cat([torch.full((B,), 1.5, dtype=pts.dtype, device=x.device),
                     torch.full((B,), 2.2, dtype=pts.dtype, device=x.device)])
    fit = floor_lib.fit_floor(torch.cat([xz, xz]), torch.cat([pts[..., 1], pts[..., 1]]),
                              torch.cat([mask, mask]), epsilon=eps)
    pruned = floor_lib.prune_contacts(vc, consts.feet_cols, fit.outliers[B:], mask)
    return fit.normal[:B].to(x.dtype), fit.point[:B].to(x.dtype), pruned


def _refine_core(arrs, consts: BatchConsts, w1: TermWeights, w2: TermWeights,
                 lm_cfg: LMConfig, floor: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 graphs: Optional[GraphCache] = None):
    """IK init → stage-1 LM → floor fit and contact pruning (or the given
    ``floor`` (normal, point)) → stage-2 LM, on the device with no host
    sync, each stage a span (``kin.ik``, ``kin.lm1``, ``kin.floor``,
    ``kin.lm2``; the LM spans carry their ``steps``). Returns (x2, normals,
    points, vc2, rotations, y, root)."""
    B, F = arrs["pose3d"].shape[:2]
    J = arrs["offsets"].shape[1]
    with span("kin.ik"):
        x0 = initial_x(*ik_init_batch(arrs, consts, graphs))
    zero3 = torch.zeros((B, 3), dtype=x0.dtype, device=x0.device)
    if floor is None:
        data1 = make_data(arrs, consts, arrs["vc"], zero3, zero3)
    else:
        data1 = make_data(arrs, consts, arrs["vc"], floor[0].expand(B, 3), floor[1].expand(B, 3))
    with span("kin.lm1", steps=lm_cfg.max_iters):
        x1 = lm_stage(x0, data1, w1, consts, lm_cfg, graphs)
    if floor is None:
        with span("kin.floor"):
            normals, points, vc2 = floor_stage(x1, arrs, consts)
    else:
        normals, points, vc2 = data1.floor_normal, data1.floor_point, arrs["vc"]
    data2 = make_data(arrs, consts, vc2, normals, points)
    with span("kin.lm2", steps=lm_cfg.max_iters):
        x2 = lm_stage(x1, data2, w2, consts, lm_cfg, graphs)

    xm = x2.reshape(B, F, -1)
    rot_q = quat.from_euler(xm[..., 3:].reshape(B, F, J, 3), "xyz", world=True)
    y_b, root_b = data_order_positions(xm, arrs["offsets"], consts.layout)
    return x2, normals, points, vc2, rot_q, y_b, root_b


def optimize_trajectory_batch(
    problems: Sequence[dict],
    skeleton: Animation,
    cam_focal=defs.MTC_FOCAL,
    cam_pp=defs.MTC_PP,
    ik_iterations: int = 200,
    lm_cfg: LMConfig = LMConfig(max_iters=40, cg_iters=80),
    device="cuda",
    dtype=torch.float32,
    ik_solver: str = "cg",
    floor: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    graphs: Optional[GraphCache] = None,
    lm_solver: str = "pcg",
    mesh=None,
) -> List[traj_lib.TrajectoryResult]:
    """problems: per-sequence dicts with keys pose2d (F,28,2), conf2d (F,28),
    pose3d (F,28,3), root_pos (F,3), smpl_angles (F,J,3), vel_constraints
    (F,28). Returns per-sequence TrajectoryResults (trimmed to true lengths).

    ``device`` defaults to ``cuda`` and raises where CUDA is absent. The
    default budget is ``chd_tpu``'s: 200 IK iterations (CG, 64 iterations)
    and two LM stages of 40 steps with 80 CG iterations each. ``floor``, a
    given (normal, point), skips the floor fit. ``lm_solver`` "pcg" (the
    default) or "banded" picks the LM stages' inner solve.

    On a CUDA device the LM steps and the CG IK iterations are replayed as
    CUDA graphs, bitwise the eager path's results (4.3x faster at 16 x 100 on an
    H100; PERF.md); on the CPU they run eagerly. ``graphs``, a
    ``GraphCache`` kept across calls, saves the capture of each step shape
    (13.3 s of host time at 16 x 100 on an H100, nearly all of it the LM
    step's; PERF.md); without it each call captures anew.

    With ``mesh`` (``parallel.mesh.Mesh``) the whole batch is padded first,
    so a sequence pads alike sharded or not; then each rank solves its
    slice of it (the batch must divide over the mesh's batch shards) on its
    own device (``mesh.device``, in place of ``device``), with its own CUDA
    graphs and no collective inside a step, and the results are gathered.

    A call is the span ``kin.call`` (attributes ``B``, ``F``) over
    ``kin.prepare`` (host prep and the copy to the device), the stages of
    ``_refine_core`` and ``kin.unpack`` (the copy back and the host's
    results): ``utils.profiling.snapshot()`` reads them.
    """
    if mesh is not None:
        device = mesh.device
    device = resolve_device(device)
    graphs = cuda_graph.graphs_for(device, graphs)
    parents = tuple(skeleton.parents)
    lens = [p["pose2d"].shape[0] for p in problems]
    with span("kin.call", B=len(problems), F=max(lens)):
        with span("kin.prepare"):
            arrs, F = prepare_batch_arrays(problems, skeleton, cam_focal, cam_pp, device, dtype)
            ik_cfg = IKConfig(iterations=ik_iterations, damping=7.0, solver=ik_solver)
            consts = batch_consts(parents, F, ik_cfg, device, dtype, graphs, lm_solver)
        given = None
        if floor is not None:
            given = tuple(torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
                          for v in floor)

        if mesh is None:
            out = _refine_core(arrs, consts, traj_lib.STAGE1, traj_lib.STAGE2, lm_cfg, given,
                               graphs)
        else:
            out = mesh_lib.gather(mesh, _refine_core(mesh_lib.shard_batch(mesh, arrs), consts,
                                                     traj_lib.STAGE1, traj_lib.STAGE2, lm_cfg,
                                                     given, graphs))
        with span("kin.unpack"):
            return unpack_results(out, arrs["offsets"], lens, skeleton, cam_focal, cam_pp)


def unpack_results(out, offsets: torch.Tensor, lens: Sequence[int], skeleton: Animation,
                   cam_focal, cam_pp) -> List[traj_lib.TrajectoryResult]:
    """``_refine_core``'s batched outputs → per-sequence TrajectoryResults on
    the host, trimmed to ``lens`` (pure numpy: the device work is done)."""
    x2, normals, points, vc2, rot_q, y_b, root_b = (t.cpu().numpy() for t in out)
    offsets_np = offsets.cpu().numpy()
    parents = tuple(skeleton.parents)
    J = len(parents)
    F = y_b.shape[1]
    results = []
    fx, fy = cam_focal
    cx, cy = cam_pp
    orients = np.asarray(skeleton.orients)
    for i, L in enumerate(lens):
        xm = x2[i].reshape(F, -1)[:L]
        pos = np.broadcast_to(offsets_np[i][None], (L, J, 3)).copy()
        pos[:, 0] = xm[:, :3]
        anim = Animation(rot_q[i, :L], pos, orients, offsets_np[i], parents)
        vc_i = vc2[i][:L]
        pose3d_i = np.array(y_b[i, :L] + root_b[i, :L, None, :])
        pose3d_i[:, defs.COMBINED_ROOT_IDX] = root_b[i, :L]
        proj2d_i = np.stack(
            [fx * pose3d_i[..., 0] / pose3d_i[..., 2] + cx,
             fy * pose3d_i[..., 1] / pose3d_i[..., 2] + cy],
            axis=-1,
        )
        results.append(traj_lib.TrajectoryResult(
            anim=anim, pose3d=pose3d_i, proj2d=proj2d_i,
            floor_normal=normals[i], floor_point=points[i], vel_constraints=vc_i,
            refined_contacts=traj_lib.refine_contact_labels(vc_i)))
    return results
