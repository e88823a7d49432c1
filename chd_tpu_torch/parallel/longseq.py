"""Frame-axis sharding of one long sequence (port of
chd_tpu/parallel/longseq.py).

Batching (``parallel.batch``, ``kinematics.batch``) scales across sequences;
this module spreads one sequence's frames over the shards of a mesh axis. The
trajectory objective couples frames at most ``HALO = 2`` apart (the
acceleration term spans 3 consecutive frames), so each shard needs only 2
boundary frames of each neighbour: a ring exchange. The only other
communication is the sums of the cost and of the CG dot products.

Design (permutation-invariant residuals), as in ``chd_tpu``: LM and CG never
need the globally ordered residual, only ‖r‖², Jᵀr and JᵀJ·v, which do not
depend on the order of the rows. Each shard evaluates the unmodified
``trajectory_residuals`` on its halo-extended frame window and zeroes every
row whose anchor frame it does not own (difference rows anchor at their
first frame), so the shards' rows are exactly the global rows.

Every exchange stays outside ``torch.func``'s transforms (a collective has
no rule inside a ``vjp`` or ``vmap``), as composed linear maps:
``v_ext = exchange(v)``, ``u = J_loc·v_ext``, ``w = J_locᵀ·u`` (both local,
J_loc with the ownership mask in it), ``JᵀJ·v = return_halos(w)``, where
``return_halos`` is the adjoint of ``exchange``: it sends each halo frame's
gradient back to the frame's owner. The diagonal's masks are exchanged as one
stacked tensor.

A mesh axis is either ranks of a process group (one shard a rank: P2P to the
ring's neighbours, ``all_reduce`` for the sums; in a ring of one rank the
exchange is a local copy) or the single-process form of ``n`` shards on one
device (the halo exchange is a ``roll`` over the stacked shards, a global
sum a sum over them). Every rank takes the same accept or reject, since the
cost it compares is the same all-reduced number. The LM steps run eagerly,
in both forms: no CUDA graph captures a collective here.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..characters import defs
from ..core import quat
from ..core.animation import Animation
from ..kinematics import batch as kin_batch
from ..kinematics import trajectory as traj_lib
from ..kinematics.ik import IKConfig
from ..kinematics.lm import LMConfig, _pcg
from ..kinematics.residuals import (Layout, TermWeights, TrajectoryData, data_order_positions,
                                   trajectory_residuals)
from .mesh import Mesh

HALO = 2  # max |f − f'| coupled by any residual row (the acceleration term)


class Ring:
    """The frame shards of one sequence along ``axis`` of ``mesh`` that this
    process holds, stacked on a shard axis, and the ring that joins them:
    ``n`` shards in all, ``k`` of them here, the first with global index
    ``first``."""

    def __init__(self, mesh: Mesh, axis: str = "data"):
        if axis not in mesh.shape:
            raise ValueError(f"mesh has no axis {axis!r}: {mesh.shape}")
        self.n = mesh.shape[axis]
        if not mesh.distributed:
            self.k, self.first, self.ranks = self.n, 0, [0]
            self.group = None
            return
        coord = list(mesh.coordinate())
        a = mesh.dim_names.index(axis)
        self.first, self.k = coord[a], 1
        self.ranks = []
        for i in range(self.n):
            coord[a] = i
            self.ranks.append(int(mesh.grid[tuple(coord)]))
        self.group = mesh.device_mesh.get_group(axis)

    @property
    def world(self) -> int:
        """Processes on the ring."""
        return len(self.ranks)

    def _swap(self, to_next: torch.Tensor, to_prev: torch.Tensor):
        """Send ``to_next`` to the next process on the ring and ``to_prev``
        to the previous one; returns (from the previous, from the next)."""
        me = self.ranks.index(dist.get_rank())
        nxt, prv = self.ranks[(me + 1) % self.world], self.ranks[(me - 1) % self.world]
        to_next, to_prev = to_next.contiguous(), to_prev.contiguous()
        from_prev, from_next = torch.empty_like(to_next), torch.empty_like(to_prev)
        ops = [dist.P2POp(dist.isend, to_next, nxt, self.group, tag=0),
               dist.P2POp(dist.isend, to_prev, prv, self.group, tag=1),
               dist.P2POp(dist.irecv, from_prev, prv, self.group, tag=0),
               dist.P2POp(dist.irecv, from_next, nxt, self.group, tag=1)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return from_prev, from_next

    def exchange(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """(…, k, F_loc, …) → (…, k, F_loc + 2·HALO, …): each shard's frames
        between HALO frames of its previous and of its next shard; ``dim`` is
        the shard axis and the frame axis follows it. The ring wraps: the
        first shard's left halo holds the last shard's frames, which the
        ownership mask keeps out of every residual."""
        f = dim + 1
        F_loc = x.shape[f]
        tails = x.narrow(f, F_loc - HALO, HALO)
        heads = x.narrow(f, 0, HALO)
        left = torch.roll(tails, 1, dim)    # shard j: shard j-1's last frames
        right = torch.roll(heads, -1, dim)  # shard j: shard j+1's first frames
        if self.world > 1:
            from_prev, from_next = self._swap(tails.select(dim, self.k - 1),
                                              heads.select(dim, 0))
            left.select(dim, 0).copy_(from_prev)
            right.select(dim, self.k - 1).copy_(from_next)
        return torch.cat([left, x, right], dim=f)

    def return_halos(self, g: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The adjoint of ``exchange``: (…, k, F_loc + 2·HALO, …) → (…, k,
        F_loc, …), each halo frame's value added onto the frame's owner."""
        f = dim + 1
        F_loc = g.shape[f] - 2 * HALO
        to_prev = g.narrow(f, 0, HALO)             # the previous shard's last frames
        to_next = g.narrow(f, F_loc + HALO, HALO)  # the next shard's first frames
        from_next = torch.roll(to_prev, -1, dim)
        from_prev = torch.roll(to_next, 1, dim)
        if self.world > 1:
            recv_prev, recv_next = self._swap(to_next.select(dim, self.k - 1),
                                              to_prev.select(dim, 0))
            from_prev.select(dim, 0).copy_(recv_prev)
            from_next.select(dim, self.k - 1).copy_(recv_next)
        own = g.narrow(f, HALO, F_loc).clone()
        own.narrow(f, F_loc - HALO, HALO).add_(from_next)
        own.narrow(f, 0, HALO).add_(from_prev)
        return own

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over every shard on the ring, a 0-d tensor equal
        on every process."""
        s = t.sum()
        if self.world > 1:
            dist.all_reduce(s, group=self.group)
        return s

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.sum(a * b)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(k, F_loc, …) local shards → (n·F_loc, …), every shard in order, on
        every process."""
        if self.world > 1:
            parts = [torch.empty_like(x) for _ in range(self.world)]
            dist.all_gather(parts, x.contiguous(), group=self.group)
            x = torch.cat(parts)
        return x.reshape((-1,) + tuple(x.shape[2:]))


def ownership_mask(starts: torch.Tensor, F_ext: int, F_pad: int, Jd: int, n_euler: int,
                   dtype) -> torch.Tensor:
    """(k, R) 0/1 mask over ``trajectory_residuals``' rows of each local
    shard's extended window (first global frame ``starts`` (k,) − HALO),
    keeping the rows anchored in the owned interior [HALO, F_ext − HALO)
    that also exist in the global problem.

    Block layout (kinematics/residuals.py): projection (F, 28, 2), velocity
    smoothness (F−1, 28, 3), acceleration (F−2, 28, 3), data (F, 28, 3),
    contact velocity (F−1, 28, 3), floor (F, 28), euler velocity (F−1,
    n_euler, 3). Difference rows anchor at their first frame. The global
    gating matters at the sequence's end: the last shard's ring halo wraps
    to shard 0's first frames, so a pair row anchored at the last global
    frame, or a triple row at the last two, would read wrapped frames; pair
    rows exist iff anchor <= F_pad − 2, triple rows iff anchor <= F_pad − 3.
    """
    pos = torch.arange(F_ext, device=starts.device)
    g = starts[:, None] - HALO + pos                       # global frame of each position
    own = ((pos >= HALO) & (pos < F_ext - HALO)).expand(g.shape)
    pair = own[:, :-1] & (g[:, :-1] <= F_pad - 2)
    triple = own[:, :-2] & (g[:, :-2] <= F_pad - 3)
    parts = [(own, Jd * 2), (pair, Jd * 3), (triple, Jd * 3), (own, Jd * 3), (pair, Jd * 3),
             (own, Jd), (pair, n_euler * 3)]
    return torch.cat([m.repeat_interleave(w, dim=1) for m, w in parts], dim=1).to(dtype)


def pad_frames_to(n_shards: int, *arrs, frame_mask):
    """Pad the frame axis (the first) of each array to a multiple of
    ``n_shards`` by repeating the last frame; the frame mask gets zeros, so
    padding adds no residual. Returns (arrays, frame mask, F_pad)."""
    F = arrs[0].shape[0]
    F_pad = -(-F // n_shards) * n_shards
    if F_pad == F:
        return arrs, frame_mask, F_pad
    pad = F_pad - F

    def pad_one(a):
        return torch.cat([a, a[-1:].expand((pad,) + tuple(a.shape[1:]))])

    fm = torch.cat([frame_mask, frame_mask.new_zeros(pad)])
    return tuple(pad_one(a) for a in arrs), fm, F_pad


class _Problem:
    """One sequence's problem on the local shards of a ring: the halo-
    extended data, the ownership mask and the coloring masks."""

    def __init__(self, x0, data: TrajectoryData, w: TermWeights, parents, ring: Ring,
                 device, dtype):
        def t(a):
            return torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a,
                                   dtype=dtype).to(device)

        x0 = t(x0)
        F, D = x0.shape
        first = lambda a: t(a)[0]  # noqa: E731  (TrajectoryData of one sequence, B = 1)
        fm0 = (torch.ones(F, dtype=dtype, device=device) if data.frame_mask is None
               else first(data.frame_mask))
        (x0p, pose3d, root, p2d, pw, dw, vc), fm, F_pad = pad_frames_to(
            ring.n, x0, first(data.pose3d), first(data.root_trans), first(data.pose2d_norm),
            first(data.proj_weights), first(data.data_weights), first(data.vel_constraints),
            frame_mask=fm0)
        F_loc = F_pad // ring.n
        if F_loc < HALO:
            raise ValueError(f"{F} frames pad to {F_pad} over {ring.n} shards: {F_loc} a "
                             f"shard, fewer than the halo of {HALO}")
        self.ring, self.F, self.D, self.F_loc, self.F_pad = ring, F, D, F_loc, F_pad
        self.F_ext = F_loc + 2 * HALO
        k = ring.k
        zw = fm[:, None]
        lo = ring.first * F_loc

        def local(a):
            return a[lo:lo + k * F_loc].reshape((k, F_loc) + tuple(a.shape[1:]))

        def ext(a):
            return ring.exchange(local(a))

        def per_shard(a):
            return first(a).expand((k,) + tuple(first(a).shape))

        self.data = TrajectoryData(
            ext(pose3d), ext(root), ext(p2d), ext(pw * zw), ext(dw * zw),
            per_shard(data.smooth_weights), ext(vc * zw), per_shard(data.floor_normal),
            per_shard(data.floor_point), per_shard(data.offsets), ext(fm))
        self.w = w
        self.layout = Layout(tuple(parents), device, dtype)
        starts = (ring.first + torch.arange(k, device=device)) * F_loc
        self.mask = ownership_mask(starts, self.F_ext, F_pad, pose3d.shape[1], D // 3, dtype)
        self.x0 = local(x0p).reshape(k, -1)
        # the exact diagonal's masks: dof d of every frame of color c, the
        # color (HALO + 1 = 3 periods) of the GLOBAL frame, so each shard's
        # pattern is the global one at its start frame; exchanged once
        C = HALO + 1
        color = (starts[:, None] + torch.arange(F_loc, device=device)) % C   # (k, F_loc)
        onehot_c = (color[None] == torch.arange(C, device=device)[:, None, None])
        eye = torch.eye(D, dtype=dtype, device=device)
        m = onehot_c[None, :, :, :, None].to(dtype) * eye[:, None, None, None, :]
        self.diag_masks = m.reshape(D * C, k, F_loc, D)
        self.diag_masks_ext = ring.exchange(self.diag_masks, dim=1).reshape(D * C, k, -1)

    def residual(self, x_ext: torch.Tensor) -> torch.Tensor:
        """Local rows (k, R) of the extended windows (k, F_ext·D), masked."""
        return trajectory_residuals(x_ext, self.data, self.w, self.layout) * self.mask

    def extend(self, x: torch.Tensor) -> torch.Tensor:
        k = self.ring.k
        return self.ring.exchange(x.reshape(k, self.F_loc, self.D)).reshape(k, -1)

    def retract(self, g: torch.Tensor, lead: Tuple[int, ...] = ()) -> torch.Tensor:
        k = self.ring.k
        g = g.reshape(lead + (k, self.F_ext, self.D))
        return self.ring.return_halos(g, dim=len(lead)).reshape(lead + (k, -1))

    def cost(self, x: torch.Tensor) -> torch.Tensor:
        r = self.residual(self.extend(x))
        return 0.5 * self.ring.dot(r, r)

    def linearize(self, x: torch.Tensor):
        """(r, Jᵀr, JᵀJ·) at x: the local vjp's transpose gives J_loc·v with
        no second primal pass (as ``kinematics.lm.lm_step``)."""
        r, vjp_fn = torch.func.vjp(self.residual, self.extend(x))
        g = self.retract(vjp_fn(r)[0])
        _, lin = torch.func.vjp(lambda cot: vjp_fn(cot)[0], torch.zeros_like(r))

        def jtj_ext(v_ext):
            return vjp_fn(lin(v_ext)[0])[0]

        def jtjv(v):
            return self.retract(jtj_ext(self.extend(v)))

        return r, g, jtj_ext, jtjv

    def diag(self, jtj_ext) -> torch.Tensor:
        """The exact diag(JᵀJ) of the local shards, (k, F_loc·D): one vmapped
        pass over the exchanged masks, then one return of the halos."""
        M = self.diag_masks.shape[0]
        prod = torch.func.vmap(jtj_ext)(self.diag_masks_ext)
        back = self.retract(prod, lead=(M,)).reshape(self.diag_masks.shape)
        return (self.diag_masks * back).sum(0).reshape(self.ring.k, -1)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Local (k, F_loc·D) → the whole sequence (F, D), on every process."""
        return self.ring.gather(x.reshape(self.ring.k, self.F_loc, self.D))[:self.F]


def _step(p: _Problem, cfg: LMConfig, x, lam, c):
    """One LM step with PCG on global dot products and the exact coloring
    diagonal (``chd_tpu``'s ``_build_solve``): (x, λ, cost) → (x, λ, cost),
    λ and the cost global, so every process accepts or rejects alike."""
    _, g, jtj_ext, jtjv = p.linearize(x)
    scale = torch.clamp(p.diag(jtj_ext), min=cfg.diag_floor)
    inv_diag = 1.0 / (scale * (1.0 + lam))
    delta = _pcg(lambda v: jtjv(v) + lam * scale * v, -g, inv_diag, cfg.cg_iters,
                 dot=p.ring.dot)
    x_new = x + delta
    c_new = p.cost(x_new)
    accept = c_new < c
    lam = torch.clamp(torch.where(accept, lam * cfg.lambda_down, lam * cfg.lambda_up),
                      cfg.min_lambda, cfg.max_lambda)
    return torch.where(accept, x_new, x), lam, torch.where(accept, c_new, c)


def _lm(p: _Problem, cfg: LMConfig):
    """``cfg.max_iters`` LM steps from p.x0, each run eagerly. Returns the
    local shards' x and the global cost."""
    x = p.x0
    lam = torch.full((), cfg.init_lambda, dtype=x.dtype, device=x.device)
    c = p.cost(x)
    for _ in range(cfg.max_iters):
        x, lam, c = _step(p, cfg, x, lam, c)
    return x, c


def lm_solve_frame_sharded(x0, data: TrajectoryData, w: TermWeights, parents: Sequence[int],
                           mesh: Mesh, axis: str = "data", cfg: LMConfig = LMConfig(),
                           dtype=torch.float32):
    """LM over one sequence with its frame axis sharded over ``mesh[axis]``.

    x0: (F, D) per-frame variables; ``data``: the port's TrajectoryData of
    one sequence (leading axis 1), on any device. The math of
    ``kinematics.lm.lm_solve`` with the coloring diagonal, every residual,
    tangent and transpose pass over F/n frames a shard plus 2 frames of halo
    each side. Returns (x (F, D), final cost), on ``mesh.device`` and equal
    on every process. The steps run eagerly: no CUDA graph holds a
    collective."""
    p = _Problem(x0, data, w, parents, Ring(mesh, axis), mesh.device, dtype)
    x, c = _lm(p, cfg)
    return p.gather(x), c


def probe_grad_diag(x0, data: TrajectoryData, w: TermWeights, parents: Sequence[int],
                    mesh: Mesh, axis: str = "data", dtype=torch.float32,
                    with_diag: bool = True):
    """(cost, Jᵀr (F, D), diag(JᵀJ) (F, D) or None) at x0 from the sharded
    evaluation: the LM step's building blocks, for element-wise comparison
    with the unsharded path (the iterates of a whole solve part on an
    ill-conditioned problem; these do not)."""
    p = _Problem(x0, data, w, parents, Ring(mesh, axis), mesh.device, dtype)
    r, g, jtj_ext, _ = p.linearize(p.x0)
    cost = 0.5 * p.ring.dot(r, r)
    return cost, p.gather(g), p.gather(p.diag(jtj_ext)) if with_diag else None


def optimize_trajectory_frame_sharded(
    pose2d: np.ndarray,
    conf2d: np.ndarray,
    pose3d: np.ndarray,
    root_pos: np.ndarray,
    smpl_angles_skel: np.ndarray,
    skeleton: Animation,
    vel_constraints: np.ndarray,
    mesh: Mesh,
    axis: str = "data",
    cam_focal=None,
    cam_pp=None,
    plane_normal: Optional[np.ndarray] = None,
    plane_point: Optional[np.ndarray] = None,
    ik_iterations: int = 200,
    lm_cfg: Optional[LMConfig] = None,
    dtype=torch.float32,
    stage_hook=None,
) -> traj_lib.TrajectoryResult:
    """The single-sequence kinematic refinement of
    ``kinematics.trajectory.optimize_trajectory`` (bone fit, LU CK-IK
    initialization, stage-1 LM, Huber floor fit and contact pruning, stage-2
    LM) with both LM stages frame-sharded over ``mesh[axis]``, so that one
    long video spreads over the shards. The IK and the floor fit run
    unsharded on every process (cheap, per frame or global); the LM stages
    are the O(F·iterations) bulk. Runs on ``mesh.device``. ``stage_hook(name)``, where given, is
    called after each stage ("ik", "lm1", "floor", "lm2")."""
    if cam_focal is None:
        cam_focal = defs.MTC_FOCAL
    if cam_pp is None:
        cam_pp = defs.MTC_PP
    if lm_cfg is None:
        lm_cfg = LMConfig(max_iters=50, cg_iters=100)
    hook = stage_hook or (lambda name: None)
    device = mesh.device
    parents = tuple(skeleton.parents)
    F = pose2d.shape[0]
    problem = dict(pose2d=pose2d, conf2d=conf2d, pose3d=pose3d, root_pos=root_pos,
                   smpl_angles=smpl_angles_skel, vel_constraints=vel_constraints)
    arrs, _ = kin_batch.prepare_batch_arrays([problem], skeleton, cam_focal, cam_pp, device,
                                             dtype)
    consts = kin_batch.BatchConsts(parents, F, IKConfig(iterations=ik_iterations, damping=7.0),
                                   device, dtype)
    rot_ik, pos_ik = kin_batch.ik_init_batch(arrs, consts)
    x0 = kin_batch.initial_x(rot_ik, pos_ik).reshape(F, -1)
    hook("ik")

    given = plane_normal is not None and plane_point is not None
    if given:
        normal, point = (torch.as_tensor(np.asarray(v), dtype=dtype, device=device)[None]
                         for v in (plane_normal, plane_point))
    else:
        normal = point = torch.zeros((1, 3), dtype=dtype, device=device)
    data1 = kin_batch.make_data(arrs, consts, arrs["vc"], normal, point)
    x1, _ = lm_solve_frame_sharded(x0, data1, traj_lib.STAGE1, parents, mesh, axis, lm_cfg,
                                   dtype)
    hook("lm1")
    x1 = x1.reshape(1, -1)
    vc2 = arrs["vc"]
    if not given:
        normal, point, vc2 = kin_batch.floor_stage(x1, arrs, consts)
    hook("floor")
    data2 = kin_batch.make_data(arrs, consts, vc2, normal, point)
    x2, _ = lm_solve_frame_sharded(x1.reshape(F, -1), data2, traj_lib.STAGE2, parents, mesh,
                                   axis, lm_cfg, dtype)
    hook("lm2")
    xm = x2.reshape(1, F, -1)
    J = len(parents)
    rot_q = quat.from_euler(xm[..., 3:].reshape(1, F, J, 3), "xyz", world=True)
    y, root = data_order_positions(xm, arrs["offsets"], consts.layout)
    out = (x2.reshape(1, -1), normal, point, vc2, rot_q, y, root)
    return kin_batch.unpack_results(out, arrs["offsets"], [F], skeleton, cam_focal, cam_pp)[0]
