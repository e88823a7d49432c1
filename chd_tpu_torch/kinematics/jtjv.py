"""The Gauss-Newton product JᵀJ·v of the kinematic trajectory residual as
one hand-written CUDA kernel (``csrc/traj_jtjv.cu``), with a plain-torch
emulation of its algorithm.

``lm.lm_solve`` forms JᵀJ·v by a double vjp through ``torch.func``: ~519
small kernels a product at the benchmark's 16 x 100 frames, 80 of them a
PCG step, and 261 more, vmapped, for the coloring diagonal. The kernel
computes the product of ``residuals.trajectory_residuals`` at x in one
launch: the FK at x, its tangent and its transpose through the skeleton
tree, and the seven residual blocks' tangents and cotangents in between,
a block per (tangent, sequence, tile of ``TILE`` frames with ``HALO``
frames on each side). A diagonal mode gives diag(JᵀJ), the quantity that
``lm.frame_coloring_masks``' coloring gives as Σₖ mₖ ⊙ JᵀJ mₖ.

``TrajectoryProduct(layout)`` is the kernel's supplier (``ops/jtjv.py``),
one a layout, which ``layout.residual`` names for a solve on CUDA and
``lm_solve`` takes; the CPU keeps the autograd product.

``traj_jtjv_plain`` is the kernel's algorithm in plain torch: the same
tiles and halos, the same hand-derived tangent and transpose through the
tree (joints on the last axis where the kernel has a warp's lanes), for
tests only (``TrajectoryProduct.emulated``), as
``ops.fused_mlp.fused_mlp_split_plain`` is for the MLP kernel. The
package's CPU paths never call it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..characters import defs
from ..ops import jtjv as jtjv_ops
from ..ops.jtjv import check_like
from .residuals import SMOOTH_VEL_EULER, Layout, TermWeights, TrajectoryData

TILE = 12            # a product block's own frames (kTile)
HALO = 2             # frames on each side: the acceleration term spans f..f+2
SLOTS = defs.COMBINED_NUM_JOINTS  # data-order joints of the residual
MAX_JOINTS = 31      # one lane a joint; lane 31 is the root translation
MAX_CHILDREN = 6
LANES = 32
WEIGHTS = TermWeights._fields  # proj, smooth_vel, smooth_acc, data, vel, floor


def tree_tables(parents, data_to_skel=defs.COMBINED_DATA_TO_SKEL):
    """The kernel's per-lane table (32, 4 + MAX_CHILDREN) int32: lane j's
    joint's parent (itself at the root and on unused lanes), depth (-1 on
    unused lanes), data-order slot (-1: none), the skeleton joint of slot
    j (-1 for j >= 28), and its children in joint order (-1). Returns
    (table, max depth, max children). Raises for a tree the kernel does not
    take."""
    parents = [int(p) for p in parents]
    J = len(parents)
    if not 1 <= J <= MAX_JOINTS or parents[0] != -1 or any(
            not 0 <= p < j for j, p in enumerate(parents) if j):
        raise ValueError(f"the kernel takes topologically ordered trees of 1 to {MAX_JOINTS} "
                         f"joints rooted at joint 0, not parents {parents}")
    d2s = [int(j) for j in data_to_skel]
    if len(d2s) != SLOTS or sorted(d2s) != sorted(set(d2s)) or max(d2s) >= J:
        raise ValueError(f"data_to_skel must map {SLOTS} slots to distinct joints of {J}")
    children = [[c for c in range(J) if parents[c] == j] for j in range(J)]
    max_children = max(len(c) for c in children)
    if max_children > MAX_CHILDREN:
        raise ValueError(f"a joint has {max_children} children; the kernel takes {MAX_CHILDREN}")
    depth = [0] * J
    for j in range(1, J):
        depth[j] = depth[parents[j]] + 1
    tab = np.full((LANES, 4 + MAX_CHILDREN), -1, np.int32)
    tab[:, 0] = np.arange(LANES)
    for j in range(J):
        tab[j, 0] = parents[j] if j else 0
        tab[j, 1] = depth[j]
        tab[j, 4:4 + len(children[j])] = children[j]
    for k, j in enumerate(d2s):
        tab[k, 3] = j
        tab[j, 2] = k
    return tab, max(depth), max_children


# -- the kernel ---------------------------------------------------------------

def traj_jtjv(mode: str, lin: "Linearization", vs: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """Launch the kernel for ``lin`` (``ops.jtjv.launch``; a mask broadcast
    over B by ``expand`` is read in place). The weights are 0-d tensors
    (``lm_solve`` makes them). Raises on what the kernel does not take."""
    x, data, w, product = lin.x, lin.data, lin.w, lin.product
    B, F = data.pose3d.shape[:2]
    J = data.offsets.shape[-2]
    jtjv_ops.check_x(traj_jtjv, mode, x, (B, F * (3 + 3 * J)))
    if J != product.num_joints:
        raise ValueError(f"offsets of {J} joints for a tree of {product.num_joints}")
    arrays = [check_like("proj_weights", data.proj_weights, (B, F, SLOTS), x),
              check_like("data_weights", data.data_weights, (B, F, SLOTS), x),
              check_like("smooth_weights", data.smooth_weights, (B, SLOTS), x),
              check_like("vel_constraints", data.vel_constraints, (B, F, SLOTS), x),
              check_like("floor_normal", data.floor_normal, (B, 3), x),
              check_like("offsets", data.offsets, (B, J, 3), x)]
    fmask = (None if data.frame_mask is None
             else check_like("frame_mask", data.frame_mask, (B, F), x))
    weights = [check_like(f"weight {k}", getattr(w, k), (), x) for k in WEIGHTS]
    sxyz = check_like("smooth_xyz", product.layout.smooth_xyz, (3,), x)
    if product.tables.device != x.device:
        raise ValueError(f"the tree's tables are on {product.tables.device}, not {x.device}")
    ptrs = [t.data_ptr() for t in arrays] + [0 if fmask is None else fmask.data_ptr()] \
        + [t.data_ptr() for t in weights] + [sxyz.data_ptr(), product.tables.data_ptr()]
    head = [F, J, product.root_slot, product.max_depth, product.max_children]
    tail = [t.stride(0) for t in arrays] + [0 if fmask is None else fmask.stride(0)]
    return jtjv_ops.launch(traj_jtjv, mode, x, vs, head, ptrs, tail, diag_v=x.data_ptr())


traj_jtjv.launches = dict.fromkeys(jtjv_ops.MODES, 0)


class Linearization(jtjv_ops.Linearization):
    """JᵀJ of the trajectory residual at x (``ops.jtjv.Linearization``);
    its diagonal is diag(JᵀJ)."""

    def __init__(self, product: "TrajectoryProduct", x, data: TrajectoryData, w: TermWeights):
        super().__init__(product, x)
        self.data, self.w = data, w
        self.frames, self.dofs = data.pose3d.shape[1], 3 + 3 * product.num_joints


class TrajectoryProduct(jtjv_ops.Supplier):
    """The supplier of ``trajectory_residuals`` on ``layout``:
    ``self(x, data, w)`` is the linearization at x. Built once a layout,
    outside a solve (it copies the tree's table to the layout's device; it
    raises for a tree the kernel does not take)."""

    path, emulation_path = "kernel", "emulation"
    TILE = TILE
    linearization = Linearization
    kernel = staticmethod(traj_jtjv)

    def __init__(self, layout: Layout):
        self.layout = layout
        tab, self.max_depth, self.max_children = tree_tables(layout.parents)
        self.num_joints = len(layout.parents)
        self.root_slot = int(defs.COMBINED_ROOT_IDX)
        self.tables = torch.as_tensor(tab, device=layout.tree.device)

    def plain(self, mode, lin, vs, tile):
        return traj_jtjv_plain(mode, lin, vs, tile)


# -- the emulation ------------------------------------------------------------
# Quaternions (..., 4) wxyz and vectors (..., 3); joints on the axis before
# them, where the kernel has a warp's lanes. Each function is the kernel's
# device function of the same name.

def _mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def _conj(a):
    return torch.cat([a[..., :1], -a[..., 1:]], -1)


def _dot(a, b):
    return (a * b).sum(-1, keepdim=True)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _rotate(q, v):
    u, w = q[..., 1:], q[..., :1]
    uv = _cross(u, v)
    return v + 2 * (w * uv + _cross(u, uv))


def _rotate_t(q, dq, v):
    u, du = q[..., 1:], dq[..., 1:]
    uv = _cross(u, v)
    return 2 * ((dq[..., :1] * uv + q[..., :1] * _cross(du, v))
                + (_cross(du, uv) + _cross(u, _cross(du, v))))


def _rotate_tt(q, v, pb):
    u = q[..., 1:]
    uu = _dot(u, v) * pb + _dot(u, pb) * v + (-2 * _dot(v, pb)) * u
    ub = 2 * (q[..., :1] * _cross(v, pb) + uu)
    return torch.cat([2 * _dot(_cross(u, v), pb), ub], -1)


def _axis_q(c, s, a: int, axis_norm):
    z = torch.zeros_like(c)
    parts = [c, z, z, z]
    parts[1 + a] = s * axis_norm
    return torch.stack(parts, -1)


def _axis_dq(c, s, a: int, axis_norm):
    z = torch.zeros_like(c)
    parts = [-0.5 * s, z, z, z]
    parts[1 + a] = 0.5 * c * axis_norm
    return torch.stack(parts, -1)


class _Joints:
    """FK at x of frames (..., J): the kernel's ``Joint`` on every lane."""

    def __init__(self, e, off, depth, parent, max_depth):
        self.norm = torch.tensor(1.0 / (1.0 + 1e-10), dtype=e.dtype)
        h = e / 2
        self.c, self.s = torch.cos(h), torch.sin(h)
        self.axes = [_axis_q(self.c[..., a], self.s[..., a], a, self.norm) for a in range(3)]
        self.d_axes = [_axis_dq(self.c[..., a], self.s[..., a], a, self.norm) for a in range(3)]
        q0, q1, q2 = self.axes
        self.q = _mul(q2, _mul(q1, q0))
        self.off = off.expand(e.shape)
        self.depth, self.parent, self.max_depth = depth, parent, max_depth
        self.pq = torch.zeros_like(self.q)
        self.pq[..., 0] = 1
        self.gq, self.gp = self.q, self.off
        for d in range(1, max_depth + 1):
            sel = (depth == d).unsqueeze(-1)
            pq, pp = self.gq[..., parent, :], self.gp[..., parent, :]
            self.pq = torch.where(sel, pq, self.pq)
            self.gp = torch.where(sel, pp + _rotate(pq, self.off), self.gp)
            self.gq = torch.where(sel, _mul(pq, self.q), self.gq)

    def local_t(self, de):
        (q0, q1, q2), (d0, d1, d2) = self.axes, self.d_axes
        d0, d1, d2 = (d * de[..., a:a + 1] for a, d in enumerate((d0, d1, d2)))
        return _mul(d2, _mul(q1, q0)) + _mul(q2, _mul(d1, q0) + _mul(q1, d0))

    def local_tt(self, qb):
        (q0, q1, q2), ds = self.axes, self.d_axes
        a = _mul(q1, q0)
        b2, ab = _mul(qb, _conj(a)), _mul(_conj(q2), qb)
        bs = (_mul(_conj(q1), ab), _mul(ab, _conj(q0)), b2)
        return torch.cat([_dot(d, b) for d, b in zip(ds, bs)], -1)

    def fk_t(self, dq):
        """FK's tangent from level 1: each joint's global position tangent."""
        dgq = torch.where((self.depth == 0).unsqueeze(-1), _mul(self.pq, dq), 0.0)
        dgp = torch.zeros(dq.shape[:-1] + (3,), dtype=dq.dtype)
        for d in range(1, self.max_depth + 1):
            sel = (self.depth == d).unsqueeze(-1)
            dpq, dpp = dgq[..., self.parent, :], dgp[..., self.parent, :]
            dgp = torch.where(sel, dpp + _rotate_t(self.pq, dpq, self.off), dgp)
            dgq = torch.where(sel, _mul(dpq, self.q) + _mul(self.pq, dq), dgq)
        return dgp

    def fk_tt(self, pb, children):
        """The transpose: euler cotangents (..., J, 3) from position
        cotangents pb (..., J, 3), deepest level first, each parent adding
        its children in table order."""
        qb = torch.zeros(pb.shape[:-1] + (4,), dtype=pb.dtype)
        eb = torch.zeros_like(pb)
        for d in range(self.max_depth, -1, -1):
            sel = (self.depth == d).unsqueeze(-1)
            eb = torch.where(sel, self.local_tt(_mul(_conj(self.pq), qb)), eb)
            cq = torch.where(sel, _rotate_tt(self.pq, self.off, pb) + _mul(qb, _conj(self.q)), 0.0)
            cp = torch.where(sel, pb, 0.0)
            if d == 0:
                break
            for ch in children:
                ok = (ch >= 0).unsqueeze(-1)
                idx = torch.where(ch >= 0, ch, torch.arange(len(ch)))
                qb = qb + torch.where(ok, cq[..., idx, :], 0.0)
                pb = pb + torch.where(ok, cp[..., idx, :], 0.0)
        return eb


def _proj_t(alpha, nx, dn):
    z2 = nx[..., 2:3] * nx[..., 2:3]
    return alpha.unsqueeze(-1) * (dn[..., :2] / nx[..., 2:3] - nx[..., :2] * dn[..., 2:3] / z2)


def traj_jtjv_plain(mode: str, lin: Linearization, vs: Optional[torch.Tensor] = None,
                    tile: int = TILE) -> torch.Tensor:
    """``traj_jtjv``'s algorithm in plain torch, on the CPU: tiles of
    ``tile`` own frames with ``HALO`` on each side (product mode), the FK at
    x, the tangents through the tree, the residual blocks' cotangents per
    data-order joint, the transpose. Same arguments and results."""
    x, data, w, product = lin.x, lin.data, lin.w, lin.product
    B, F = data.pose3d.shape[:2]
    J = data.offsets.shape[-2]
    D = 3 + 3 * J
    tab = product.tables.cpu().long()
    parent, depth, slot_of, joint_of = tab[:J, 0], tab[:J, 1], tab[:J, 2], tab[:SLOTS, 3]
    children = [tab[:J, 4 + i] for i in range(product.max_children)]
    rs = product.root_slot
    is_root = torch.arange(SLOTS) == rs
    dt = x.dtype
    X = x.reshape(B, F, D)
    fm = (torch.ones((B, F), dtype=dt) if data.frame_mask is None else data.frame_mask.to(dt))
    fmp = torch.nn.functional.pad(fm, (HALO, HALO))  # frame g at g + HALO; zero outside
    wt = {k: getattr(w, k) for k in WEIGHTS}
    sxyz = product.layout.smooth_xyz.to(dt)
    eta = wt["smooth_vel"] * SMOOTH_VEL_EULER

    def joints(frames):  # FK at x of frames (B, T) of valid indices
        e = X[:, frames, 3:].unflatten(-1, (J, 3))
        return _Joints(e, data.offsets[:, None], depth, parent, product.max_depth)

    def coef(frames):  # the kernel's Coef of frames (T,) for every slot: (B, T, ...)
        c = {"fm": torch.stack([fmp[:, frames + o] for o in range(5)], -1)}
        c["pw"] = data.proj_weights[:, frames]
        c["dw"] = data.data_weights[:, frames]
        c["vc"] = data.vel_constraints[:, frames] == 1
        prev = torch.clamp(frames - 1, min=0)
        c["vc_prev"] = (data.vel_constraints[:, prev] == 1) & (frames >= 1)[None, :, None]
        return c

    def slot_nx(jt, frames):  # numerators at x: y + root, the root slot's the root
        rx = X[:, frames, :3].unsqueeze(-2)
        y = jt.gp[..., joint_of, :]
        return torch.where(is_root.unsqueeze(-1), rx, y + rx)

    sw = data.smooth_weights.unsqueeze(1)  # (B, 1, 28)
    n = data.floor_normal[:, None, None, :]

    if mode == "diag":
        frames = torch.arange(F)
        jt = joints(frames)
        c = coef(frames)
        nx = slot_nx(jt, frames)
        fm5 = c["fm"]
        ep = eta * (fm5[..., 1] * fm5[..., 2])
        en = eta * (fm5[..., 2] * fm5[..., 3])
        out = torch.empty((B, F, D), dtype=dt)
        for d in range(D):
            R = torch.zeros((B, F, 1, 3), dtype=dt)
            if d < 3:
                R[..., d] = 1
                Y = torch.where(is_root.unsqueeze(-1), R, 0.0).expand(B, F, SLOTS, 3)
            else:
                de = torch.zeros((B, F, J, 3), dtype=dt)
                de[:, :, (d - 3) // 3, (d - 3) % 3] = 1
                dgp = jt.fk_t(jt.local_t(de))
                Y = torch.where(is_root.unsqueeze(-1), 0.0, dgp[..., joint_of, :])
            out[..., d] = _slot_sq(c, wt, sw, sxyz, n, is_root, nx, Y, R).sum(-1) \
                + (en * en + ep * ep)
        return out.reshape(B, F * D)

    M = vs.shape[0]
    Vt = vs.reshape(M, B, F, D)
    out = torch.empty((M, B, F, D), dtype=dt)
    for t0 in range(0, F, tile):
        g = torch.arange(t0 - HALO, t0 + tile + HALO)
        valid = (g >= 0) & (g < F)
        gc = torch.clamp(g, 0, F - 1)
        jt = joints(gc)
        dq = jt.local_t(Vt[:, :, gc, 3:].unflatten(-1, (J, 3)))
        dy = jt.fk_t(dq)[..., joint_of, :]
        yd = torch.where(is_root.unsqueeze(-1), Vt[:, :, gc, None, :3], dy)
        yd = torch.where(valid[:, None, None], yd, 0.0)  # (M, B, T + 4, 28, 3)
        own = min(tile, F - t0)
        frames = torch.arange(t0, t0 + own)
        loc = torch.arange(HALO, HALO + own)
        Y = [yd[:, :, loc + o - 2] for o in range(5)]
        Wd = [Yo + Yo[..., rs:rs + 1, :] for Yo in Y]  # world = y + root
        c = coef(frames)
        fm5 = c["fm"]
        jo = _Joints(X[:, frames, 3:].unflatten(-1, (J, 3)), data.offsets[:, None], depth,
                     parent, product.max_depth)
        nx = slot_nx(jo, frames)
        # projection
        alpha = torch.where(c["pw"] > 0, wt["proj"] * c["pw"] * fm5[..., 2:3], 0.0)
        dn = torch.where(is_root.unsqueeze(-1), Y[2], Wd[2])
        t = _proj_t(alpha, nx, dn)
        z2 = nx[..., 2:3] * nx[..., 2:3]
        nb = torch.cat([alpha.unsqueeze(-1) * t / nx[..., 2:3],
                        -alpha.unsqueeze(-1) * (t[..., :1] * nx[..., :1]
                                                + t[..., 1:] * nx[..., 1:2]) / z2], -1)
        nb = torch.where((c["pw"] > 0).unsqueeze(-1), nb, 0.0)
        ybar = nb
        rho = torch.where(is_root.unsqueeze(-1), 0.0, nb)
        # smoothness, acceleration, data
        pair_prev, pair_next = fm5[..., 1] * fm5[..., 2], fm5[..., 2] * fm5[..., 3]
        g0 = wt["smooth_acc"] * (fm5[..., 2] * fm5[..., 3] * fm5[..., 4])
        g1 = wt["smooth_acc"] * (fm5[..., 1] * fm5[..., 2] * fm5[..., 3])
        g2 = wt["smooth_acc"] * (fm5[..., 0] * fm5[..., 1] * fm5[..., 2])
        base = wt["smooth_vel"] * sw.unsqueeze(-1) * sxyz  # (B, 1, 28, 3)
        bp, bn = base * pair_prev[..., None, None], base * pair_next[..., None, None]
        g0, g1, g2 = (gi[..., None, None] for gi in (g0, g1, g2))
        delta = (wt["data"] * c["dw"] * fm5[..., 2:3]).unsqueeze(-1)
        y0, y1, y2, y3, y4 = Y
        s = bn * (bn * (y2 - y3)) - bp * (bp * (y1 - y2))
        s = s + g0 * (g0 * ((y4 - y3) - (y3 - y2)))
        s = s - 2 * g1 * (g1 * ((y3 - y2) - (y2 - y1)))
        s = s + g2 * (g2 * ((y2 - y1) - (y1 - y0)))
        s = s + delta * (delta * y2)
        ybar = ybar + s
        # contact zero-velocity and floor
        e_prev = (wt["vel"] * pair_prev)[..., None, None]
        e_next = (wt["vel"] * pair_next)[..., None, None]
        zf = (wt["floor"] * fm5[..., 2])[..., None, None]
        wb = torch.where(c["vc_prev"].unsqueeze(-1), -(e_prev * e_prev) * (Wd[1] - Wd[2]), 0.0)
        wb = wb + torch.where(c["vc"].unsqueeze(-1),
                              (e_next * e_next) * (Wd[2] - Wd[3])
                              + (zf * (zf * _dot(n, Wd[2]))) * n, 0.0)
        ybar = ybar + wb
        rho = rho + wb
        rbar = torch.where(is_root.unsqueeze(-1), rho + ybar, rho).sum(-2)  # (M, B, T, 3)
        # the transpose through the tree
        ok = (slot_of >= 0) & (slot_of != rs)
        pb = torch.where(ok.unsqueeze(-1), ybar[..., torch.clamp(slot_of, min=0), :], 0.0)
        eb = jo.fk_tt(pb, children)
        # euler-velocity smoothness on the raw variables
        v1 = Vt[:, :, frames]
        v0 = torch.where((frames >= 1)[:, None], Vt[:, :, torch.clamp(frames - 1, min=0)], 0.0)
        v2 = torch.where((frames + 1 < F)[:, None],
                         Vt[:, :, torch.clamp(frames + 1, max=F - 1)], 0.0)
        ep = (eta * pair_prev).unsqueeze(-1)
        en = (eta * pair_next).unsqueeze(-1)
        es = en * (en * (v1 - v2)) - ep * (ep * (v0 - v1))
        out[:, :, frames] = torch.cat([rbar, eb.flatten(-2)], -1) + es
    return out.reshape(M, B, F * D)


def _slot_sq(c, wt, sw, sxyz, n, is_root, nx, Y, R):
    """The kernel's ``slot_sq`` on every slot: (B, F, 28) squared residual
    tangents of a tangent that is zero off its frame."""
    fm5 = c["fm"]
    W = Y + R
    alpha = torch.where(c["pw"] > 0, wt["proj"] * c["pw"] * fm5[..., 2:3], 0.0)
    t = _proj_t(alpha, nx, torch.where(is_root.unsqueeze(-1), Y, W))
    s = torch.where(c["pw"] > 0, (t * t).sum(-1), 0.0)
    pair_prev, pair_next = fm5[..., 1] * fm5[..., 2], fm5[..., 2] * fm5[..., 3]
    g0 = wt["smooth_acc"] * (fm5[..., 2] * fm5[..., 3] * fm5[..., 4])
    g1 = 2 * (wt["smooth_acc"] * (fm5[..., 1] * fm5[..., 2] * fm5[..., 3]))
    g2 = wt["smooth_acc"] * (fm5[..., 0] * fm5[..., 1] * fm5[..., 2])
    delta = wt["data"] * c["dw"] * fm5[..., 2:3]
    ep = torch.where(c["vc_prev"], (wt["vel"] * pair_prev).unsqueeze(-1), 0.0)
    en = torch.where(c["vc"], (wt["vel"] * pair_next).unsqueeze(-1), 0.0)
    base = wt["smooth_vel"] * sw.unsqueeze(-1) * sxyz
    terms = [base * pair_prev[..., None, None] * Y, base * pair_next[..., None, None] * Y]
    terms += [gi[..., None, None] * Y for gi in (g0, g1, g2)]
    terms += [delta.unsqueeze(-1) * Y, ep.unsqueeze(-1) * W, en.unsqueeze(-1) * W]
    s = s + sum((tm * tm).sum(-1) for tm in terms)
    fl = (wt["floor"] * fm5[..., 2]).unsqueeze(-1) * _dot(n, W).squeeze(-1)
    return s + torch.where(c["vc"], fl * fl, 0.0)
