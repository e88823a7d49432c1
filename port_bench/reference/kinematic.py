"""Plain reference of the batched kinematic refinement (plain torch, float64
by default), written down from the pipeline's definition with no part of
the program: a frozen statement of the same mathematics, run eagerly.

1. bone lengths: each template offset scaled to the median observed length
   of its bone, the spine's to a third of the median root→Spine2 distance;
   weights from the 2D confidences; the initial rotations from the SMPL
   axis-angles, axis negated;
2. CK-IK initialization: ``ik_iterations`` damped least-squares steps
   toward the observed joints (all but the spine), the normal equations
   solved by ``ik_cg_iters`` Jacobi-preconditioned CG iterations (or LU);
3. stage 1: Levenberg-Marquardt over per-frame [root, world-'xyz' eulers]
   on the projection, smoothness, data and contact-velocity residuals,
   each step's system solved by PCG with the exact diag(JᵀJ) (Marquardt
   scaling) from coloring tangents;
4. the floor: a Huber fit with concomitant scale (ε 1.5) of the contact
   feet's heights, a second (ε 2.2) whose outliers clear contact labels,
   each by 100 fixed L-BFGS iterations (memory 10, a grid line search);
5. stage 2: LM again with the floor term.

Returns every sequence's global joint positions (data order), solution
variables, floor plane and pruned contacts. ``dtype``, ``matmul`` (the
matrix products) and ``keep`` (applied to every iterate) give the
controls.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

# -- quaternions (w, x, y, z) --------------------------------------------------

_MUL = (((0, 0, 1.0), (1, 1, -1.0), (2, 2, -1.0), (3, 3, -1.0)),
        ((0, 1, 1.0), (1, 0, 1.0), (2, 3, 1.0), (3, 2, -1.0)),
        ((0, 2, 1.0), (1, 3, -1.0), (2, 0, 1.0), (3, 1, 1.0)),
        ((0, 3, 1.0), (1, 2, 1.0), (2, 1, -1.0), (3, 0, 1.0)))


class Q:
    """Quaternion operations with their constants on one device and dtype
    (the Hamilton product as one gather over the outer product)."""

    def __init__(self, device, dtype):
        self.idx = torch.tensor([4 * i + j for t in _MUL for i, j, _ in t], device=device)
        self.sign = torch.tensor([s for t in _MUL for _, _, s in t], dtype=dtype, device=device)
        self.cos_rows = torch.tensor([[1.0, 0, 0, 0]] * 3, dtype=dtype, device=device)
        # each axis rotation is from_angle_axis's, whose axis over (|axis| + 1e-10)
        g = 1.0 / (1.0 + 1e-10)
        self.sin_rows = torch.tensor([[0, g, 0, 0], [0, 0, g, 0], [0, 0, 0, g]],
                                     dtype=dtype, device=device)

    def mul(self, a, b):
        outer = (a.unsqueeze(-1) * b.unsqueeze(-2)).flatten(-2)
        return (outer.index_select(-1, self.idx) * self.sign).unflatten(-1, (4, 4)).sum(-1)

    @staticmethod
    def rotate(q, v):
        u, v = torch.broadcast_tensors(q[..., 1:], v)
        uv = torch.linalg.cross(u, v, dim=-1)
        return v + 2.0 * (q[..., :1] * uv + torch.linalg.cross(u, uv, dim=-1))

    def from_euler_xyz(self, e):
        """q(z) ⊗ q(y) ⊗ q(x): R = Rz Ry Rx."""
        half = e.unsqueeze(-1) / 2.0
        qs = torch.cos(half) * self.cos_rows + torch.sin(half) * self.sin_rows
        return self.mul(qs[..., 2, :], self.mul(qs[..., 1, :], qs[..., 0, :]))

    @staticmethod
    def to_euler_xyz(q):
        q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        q0, q1, q2, q3 = q.unbind(-1)
        return torch.stack([
            torch.atan2(2 * (q0 * q1 + q2 * q3), 1 - 2 * (q1 * q1 + q2 * q2)),
            torch.asin(torch.clamp(2 * (q0 * q2 - q3 * q1), -1.0, 1.0)),
            torch.atan2(2 * (q0 * q3 + q1 * q2), 1 - 2 * (q2 * q2 + q3 * q3))], dim=-1)

    @staticmethod
    def from_angle_axis(angle, axis):
        axis = axis / (torch.linalg.vector_norm(axis, dim=-1, keepdim=True) + 1e-10)
        half = angle.unsqueeze(-1) / 2.0
        return torch.cat([torch.cos(half), axis * torch.sin(half)], dim=-1)


# -- forward kinematics, one depth level at a time ------------------------------

class Skeleton:
    def __init__(self, parents, device):
        self.parents = [int(p) for p in parents]
        J = len(parents)
        depth = [0] * J
        for j, p in enumerate(self.parents):
            depth[j] = 0 if p < 0 else depth[p] + 1
        levels = [[j for j in range(J) if depth[j] == d] for d in range(max(depth) + 1)]
        order = [j for lv in levels for j in lv]
        self.sizes = [len(lv) for lv in levels]
        self.order = torch.tensor(order, device=device)
        self.inverse = torch.tensor(np.argsort(order), device=device)
        self.links = []  # a level's parents in the level above, as an index
        for prev, cur in zip(levels, levels[1:]):
            self.links.append(torch.tensor([prev.index(self.parents[c]) for c in cur],
                                           device=device))
        desc = np.zeros((J, J))
        for j in range(J):
            p = self.parents[j]
            while p >= 0:
                desc[p, j] = 1.0
                p = self.parents[p]
        self.descendants = desc  # desc[a, b] = 1 where b lies below a

    def fk(self, q: Q, rot, pos):
        """Global (rotations, positions) of local rotations (..., J, 4) and
        translations (..., J, 3)."""
        r = rot.index_select(-2, self.order).split(self.sizes, dim=-2)
        p = pos.index_select(-2, self.order).split(self.sizes, dim=-2)
        gq, gp = [r[0]], [p[0]]
        for k, link in enumerate(self.links, start=1):
            pq, pp = gq[-1].index_select(-2, link), gp[-1].index_select(-2, link)
            gp.append(pp + q.rotate(pq, p[k]))
            gq.append(q.mul(pq, r[k]))
        return (torch.cat(gq, -2).index_select(-2, self.inverse),
                torch.cat(gp, -2).index_select(-2, self.inverse))


class Problem:
    """The batch's device arrays and constants, made from the raw problems
    and the configuration."""

    def __init__(self, problems, cfg: dict, device, dtype):
        sk, cb, cam = cfg["skeleton"], cfg["combined"], cfg["camera"]
        self.cfg, self.device, self.dtype = cfg, device, dtype
        self.parents = sk["parents"]
        J = len(self.parents)
        F = problems[0]["pose2d"].shape[0]
        if any(p["pose2d"].shape[0] != F for p in problems):
            raise ValueError("the reference takes sequences of one length")
        s2d = np.asarray(cb["skel_to_data"])
        spine = list(cb["spine_joints"])
        self.tidx = [j for j in range(J) if j not in spine]
        body = np.arange(28) < 25
        arrs = {k: [] for k in ("pose3d", "root", "p2dn", "pw", "dw", "vc", "offsets", "rot0")}
        pw_j, dw_j = np.asarray(cb["proj_weights"]), np.asarray(cb["data_weights"])
        for p in problems:
            targets = p["pose3d"][:, s2d] + p["root_pos"][:, None, :]
            off = np.asarray(sk["offsets"], np.float64).copy()
            bones = np.zeros(J)
            for j in range(1, J):
                if j in spine:
                    d = targets[:, spine[2]] - targets[:, 0]
                    bones[j] = np.median(np.linalg.norm(d, axis=1) / 3.0)
                else:
                    d = targets[:, j] - targets[:, self.parents[j]]
                    bones[j] = np.median(np.linalg.norm(d, axis=1))
            off[1:] = off[1:] / np.linalg.norm(off[1:], axis=1, keepdims=True) * bones[1:, None]
            off[0] = 0.0
            c = p["conf2d"]
            arrs["pw"].append(np.where(body, c * pw_j[None], 0.0))
            arrs["dw"].append(np.where(body, (1.0 + c) * dw_j[None], 1.4 * dw_j[None]))
            arrs["p2dn"].append((p["pose2d"] - np.asarray(cam["pp"])) / np.asarray(cam["focal"]))
            arrs["pose3d"].append(p["pose3d"])
            arrs["root"].append(p["root_pos"])
            arrs["vc"].append(np.asarray(p["vel_constraints"], np.float64))
            arrs["offsets"].append(off)
            aa = np.asarray(p["smpl_angles"], np.float64)
            angle = np.linalg.norm(aa, axis=-1)
            axis = -aa / (angle[..., None] + 1e-10)
            axis = axis / (np.linalg.norm(axis, axis=-1, keepdims=True) + 1e-10)
            arrs["rot0"].append(np.concatenate([np.cos(angle / 2)[..., None],
                                                axis * np.sin(angle / 2)[..., None]], -1))
        self.a = {k: torch.as_tensor(np.stack(v), dtype=dtype, device=device)
                  for k, v in arrs.items()}
        self.B, self.F, self.J = len(problems), F, J
        self.q = Q(device, dtype)
        self.skel = Skeleton(self.parents, device)
        self.data_to_skel = torch.as_tensor(np.argsort(s2d), device=device)
        self.root_idx = cb["root_idx"]
        self.is_root = (torch.arange(28, device=device) == self.root_idx).unsqueeze(-1)
        self.smooth = torch.as_tensor(cb["smooth_weights"], dtype=dtype, device=device)
        kin = cfg["kinematic"]
        self.smooth_xyz = torch.as_tensor(kin["smooth_xyz"], dtype=dtype, device=device)
        self.feet_cols = torch.as_tensor(s2d[cb["feet_idx"]], device=device)

    def positions(self, x):
        """(B, F·(3 + 3J)) → (data-order positions y (B, F, 28, 3) with the
        root slot holding the root, root (B, F, 3))."""
        B, F, J = self.B, self.F, self.J
        x = x.reshape(B, F, -1)
        root = x[..., :3]
        rot = self.q.from_euler_xyz(x[..., 3:].unflatten(-1, (J, 3)))
        pos = self.a["offsets"].unsqueeze(1).expand(B, F, J, 3)
        y = self.skel.fk(self.q, rot, pos)[1].index_select(-2, self.data_to_skel)
        return torch.where(self.is_root, root.unsqueeze(-2), y), root

    def residual(self, x, w: dict, vc, normal, point):
        B, F = self.B, self.F
        a = self.a
        y, root = self.positions(x)
        root_b = root.unsqueeze(-2)
        num = torch.where(self.is_root, y, y + root_b)
        active = (a["pw"] > 0).unsqueeze(-1)
        z = torch.where(active, num[..., 2:3], 1.0)
        r_proj = torch.where(active, w["proj"] * a["pw"].unsqueeze(-1)
                             * (num[..., :2] / z - a["p2dn"]), 0.0)
        sw = self.smooth[None, None, :, None] * self.smooth_xyz
        r_sv = w["smooth_vel"] * sw * (y[:, :-1] - y[:, 1:])
        vel = y[:, 1:] - y[:, :-1]
        r_sa = w["smooth_acc"] * (vel[:, 1:] - vel[:, :-1])
        target = torch.where(self.is_root, a["root"].unsqueeze(-2), a["pose3d"])
        r_data = w["data"] * a["dw"].unsqueeze(-1) * (y - target)
        world = y + root_b
        r_vel = torch.where((vc[:, :-1] == 1).unsqueeze(-1),
                            w["vel"] * (world[:, :-1] - world[:, 1:]), 0.0)
        d = ((world - point[:, None, None, :]) * normal[:, None, None, :]).sum(-1)
        r_floor = torch.where(vc == 1, w["floor"] * d, 0.0)
        xr = x.reshape(B, F, -1).unflatten(-1, (-1, 3))
        r_es = (w["smooth_vel"] * self.cfg["kinematic"]["smooth_vel_euler"]
                * (xr[:, :-1] - xr[:, 1:]))
        return torch.cat([r.reshape(B, -1) for r in (r_proj, r_sv, r_sa, r_data, r_vel,
                                                      r_floor, r_es)], dim=1)


# -- replay of a fixed step --------------------------------------------------------

def iterate(step: Callable, state: tuple, iters: int) -> tuple:
    """``iters`` times ``state = step(state)``. On a card the step is
    captured once as a CUDA graph and replayed (the same kernels on the
    same tensors; eager, the reference's launches would outlast the
    benchmark's window many times over); on the CPU it runs eagerly."""
    if state[0].device.type != "cuda" or iters == 0:
        for _ in range(iters):
            state = step(state)
        return state
    static = tuple(t.clone() for t in state)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # lazy initialisation stays out of the capture
        step(tuple(t.clone() for t in static))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for t, n in zip(static, step(static)):
            t.copy_(n)
    for _ in range(iters):
        graph.replay()
    return tuple(t.clone() for t in static)


# -- CK-IK ----------------------------------------------------------------------

def ik(pb: Problem, matmul: Callable, solver: str, keep: Callable):
    kin = pb.cfg["kinematic"]
    q, sk = pb.q, pb.skel
    B, F, J = pb.B, pb.F, pb.J
    N, T = B * F, len(pb.tidx)
    dev, dt = pb.device, pb.dtype
    tcols = torch.tensor(pb.tidx, device=dev)
    desc = torch.as_tensor(sk.descendants, dtype=dt, device=dev)
    dsc3 = desc.index_select(1, tcols)[:, None, :].expand(J, 3, T)
    lam = kin["ik_damping"] * (1.0 / (torch.ones(3 * J, dtype=dt, device=dev) + 0.001))
    D = torch.diag(lam * lam)
    eye = torch.eye(3, dtype=dt, device=dev)
    parent_idx = torch.tensor([max(p, 0) for p in pb.parents], device=dev)
    is_root = (torch.arange(J, device=dev) == 0).unsqueeze(-1)
    ident = torch.tensor([1.0, 0, 0, 0], dtype=dt, device=dev)
    s2d = torch.as_tensor(np.asarray(pb.cfg["combined"]["skel_to_data"]), device=dev)
    target = (pb.a["pose3d"].index_select(2, s2d.index_select(0, tcols))
              + pb.a["root"].unsqueeze(2))

    def solve(A, b):
        if solver == "lu":  # no host sync, so that a graph can hold it
            return torch.linalg.solve_ex(A, b.unsqueeze(-1), check_errors=False)[0].squeeze(-1)
        inv_d = 1.0 / torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1), min=1e-12)
        x, r = torch.zeros_like(b), b
        z = inv_d * b
        p, rz = z, (b * z).sum(-1, keepdim=True)
        for _ in range(kin["ik_cg_iters"]):
            Ap = matmul(A, p.unsqueeze(-1)).squeeze(-1)
            alpha = rz / torch.clamp((p * Ap).sum(-1, keepdim=True), min=1e-30)
            x, r = x + alpha * p, r - alpha * Ap
            z = inv_d * r
            rz_new = (r * z).sum(-1, keepdim=True)
            p = z + rz_new / torch.clamp(rz, min=1e-30) * p
            rz = rz_new
        return x

    pos = pb.a["offsets"].unsqueeze(1).expand(B, F, J, 3).clone()
    pos[:, :, 0] = pb.a["root"]

    def step(state):
        rot, = state
        gq, gp = sk.fk(q, rot, pos)
        x = q.to_euler_xyz(rot).reshape(B, F, 3 * J)
        gq, gp, xe = gq.reshape(N, J, 4), gp.reshape(N, J, 3), x.reshape(N, J, 3)
        prot = torch.where(is_root, ident, gq.index_select(1, parent_idx))
        qy = q.from_angle_axis(xe[..., 1], eye[1])
        qz = q.from_angle_axis(xe[..., 2], eye[2])
        pz = q.mul(prot, qz)
        axes = torch.stack([q.rotate(q.mul(pz, qy), eye[0]), q.rotate(pz, eye[1]),
                            q.rotate(prot, eye[2])], dim=-2)  # (N, J, 3, 3)
        diff = gp.index_select(1, tcols)[:, None, None] - gp[:, :, None, None]
        gated = dsc3[None, :, :, :, None] * diff
        jac = torch.linalg.cross(axes[:, :, :, None, :].expand_as(gated), gated, dim=-1)
        jac = jac.reshape(N, 3 * J, 3 * T).transpose(1, 2)
        e = (target.reshape(N, T, 3) - gp.index_select(1, tcols)).reshape(N, 3 * T)
        jt = jac.transpose(1, 2)
        A = matmul(jt, jac) + D
        x = keep(x + solve(A, matmul(jt, e.unsqueeze(-1)).squeeze(-1)).reshape(B, F, -1))
        return (q.from_euler_xyz(x.reshape(B, F, J, 3)),)

    rot, = iterate(step, (pb.a["rot0"],), kin["ik_iterations"])
    return torch.cat([pos[:, :, 0], q.to_euler_xyz(rot).reshape(B, F, -1)], -1).reshape(B, -1)


# -- Levenberg-Marquardt ------------------------------------------------------

def coloring_masks(F: int, D: int, dtype, device, bandwidth: int = 2):
    C = bandwidth + 1
    m = np.zeros((D * C, F * D))
    for d in range(D):
        for c in range(C):
            m[d * C + c, np.arange(c, F, C) * D + d] = 1.0
    return torch.as_tensor(m, dtype=dtype, device=device)


def lm(pb: Problem, x, res, masks, keep: Callable):
    c = pb.cfg["kinematic"]["lm"]
    B = x.shape[0]
    lam = torch.full((B, 1), c["init_lambda"], dtype=x.dtype, device=x.device)
    cost = 0.5 * (res(x) ** 2).sum(-1, keepdim=True)

    def step(state):
        x, lam, cost = state
        r, vjp_fn = torch.func.vjp(res, x)
        g = vjp_fn(r)[0]
        _, lin = torch.func.vjp(lambda cot: vjp_fn(cot)[0], torch.zeros_like(r))

        def jtjv(v):
            return vjp_fn(lin(v)[0])[0]

        m = masks.unsqueeze(1).expand((masks.shape[0],) + x.shape)
        diag = torch.func.vmap(lambda mk: mk * jtjv(mk))(m).sum(0)
        scale = torch.clamp(diag, min=c["diag_floor"])
        inv_diag = 1.0 / (scale * (1.0 + lam))
        b = -g
        dx, rr = torch.zeros_like(b), b
        z = inv_diag * b
        p, rz = z, (b * z).sum(-1, keepdim=True)
        for _ in range(c["cg_iters"]):
            Ap = jtjv(p) + lam * scale * p
            den = (p * Ap).sum(-1, keepdim=True)
            alpha = torch.where(den > 0, rz / torch.clamp(den, min=1e-30), 0.0)
            dx, rr = dx + alpha * p, rr - alpha * Ap
            z = inv_diag * rr
            rz_new = (rr * z).sum(-1, keepdim=True)
            p = z + rz_new / torch.clamp(rz, min=1e-30) * p
            rz = rz_new
        x_new = keep(x + dx)
        c_new = 0.5 * (res(x_new) ** 2).sum(-1, keepdim=True)
        ok = c_new < cost
        lam = torch.clamp(torch.where(ok, lam * c["lambda_down"], lam * c["lambda_up"]),
                          c["min_lambda"], c["max_lambda"])
        return torch.where(ok, x_new, x), lam, torch.where(ok, c_new, cost)

    return iterate(step, (x, lam, cost), c["max_iters"])[0]


# -- the floor -------------------------------------------------------------------

def _huber(z, eps):
    a = z.abs()
    quad = a <= eps
    return (torch.where(quad, z * z, 2 * eps * a - eps * eps),
            torch.where(quad, 2 * z, 2 * eps * torch.sign(z)))


def fit_floor(xz, y, m, eps, fc: dict):
    """Huber fit y ≈ xz·w + c with concomitant scale, per problem (B, N)
    points, by fixed-iteration L-BFGS. Returns (w, c, σ)."""
    B, dt, dev = y.shape[0], y.dtype, y.device
    alpha, M = fc["alpha"], fc["memory"]
    hi, lo = fc["step_exponents"]
    steps = torch.cat([torch.zeros(1, dtype=dt, device=dev),
                       2.0 ** torch.arange(hi, lo - 1, -1, device=dev).to(dt)])
    eps = eps.unsqueeze(-1)

    def objective(p):  # (B, K, 4) → (B, K)
        w, c, s = p[..., :2], p[..., 2:3], torch.exp(p[..., 3:4])
        r = y.unsqueeze(1) - (xz.unsqueeze(1) * w.unsqueeze(2)).sum(-1) - c
        h, _ = _huber(r / s, eps.unsqueeze(-1))
        return (m.unsqueeze(1) * (s + h * s)).sum(-1) + alpha * (w * w).sum(-1)

    def grad(p):
        w, c, s = p[:, :2], p[:, 2:3], torch.exp(p[:, 3:4])
        z = (y - (xz * w.unsqueeze(1)).sum(-1) - c) / s
        h, hp = _huber(z, eps)
        return torch.cat([-((m * hp).unsqueeze(-1) * xz).sum(1) + 2 * alpha * w,
                          -(m * hp).sum(-1, keepdim=True),
                          (m * s * (1 + h - z * hp)).sum(-1, keepdim=True)], -1)

    def dot(a, b):
        return (a * b).sum(-1, keepdim=True)

    p = torch.zeros((B, 4), dtype=dt, device=dev)
    g = grad(p)
    S = [torch.zeros_like(p) for _ in range(M)]
    Y = [torch.zeros_like(p) for _ in range(M)]
    rho = [torch.zeros((B, 1), dtype=dt, device=dev) for _ in range(M)]
    gamma = 1.0 / torch.clamp(torch.linalg.vector_norm(g, dim=-1, keepdim=True), min=1e-30)
    for it in range(fc["iters"]):
        order = [(it - 1 - k) % M for k in range(M)]
        qv, al = g, {}
        for i in order:
            al[i] = rho[i] * dot(S[i], qv)
            qv = qv - al[i] * Y[i]
        r = gamma * qv
        for i in reversed(order):
            r = r + S[i] * (al[i] - rho[i] * dot(Y[i], r))
        cand = p.unsqueeze(1) + steps[:, None] * (-r).unsqueeze(1)
        vals = torch.nan_to_num(objective(cand), nan=float("inf"))
        p_new = cand.gather(1, vals.argmin(1)[:, None, None].expand(B, 1, 4)).squeeze(1)
        g_new = grad(p_new)
        s, yv = p_new - p, g_new - g
        sy = dot(s, yv)
        good = sy > 1e-10 * torch.clamp(dot(s, s) * dot(yv, yv), min=1e-300).sqrt()
        S[it % M], Y[it % M] = s, yv
        rho[it % M] = torch.where(good, 1.0 / torch.where(good, sy, 1.0), 0.0)
        gamma = torch.where(good, sy / torch.clamp(dot(yv, yv), min=1e-30), gamma)
        p, g = p_new, g_new
    return p[:, :2], p[:, 2], torch.exp(p[:, 3])


def floor(pb: Problem, x):
    """The plane (normals, points) of solution x and its pruned contacts."""
    fc = pb.cfg["kinematic"]["floor"]
    B, F = pb.B, pb.F
    y, root = pb.positions(x)
    pts = (y + root.unsqueeze(2)).index_select(2, pb.feet_cols).reshape(B, -1, 3).double()
    vc = pb.a["vc"]
    mask = (vc.index_select(2, pb.feet_cols) == 1).reshape(B, -1)
    m = mask.double()
    xz, h = pts[..., [0, 2]], pts[..., 1]
    out = []
    for eps in (fc["eps_plane"], fc["eps_prune"]):
        e = torch.full((B,), eps, dtype=torch.float64, device=x.device)
        out.append((fit_floor(xz, h, m, e, fc), e))
    (w, c, _), _ = out[0]
    (w2, c2, s2), e2 = out[1]
    zeros = torch.zeros_like(c)

    def on_plane(vx, vz):
        return torch.stack([zeros + vx, vx * w[:, 0] + vz * w[:, 1] + c, zeros + vz], -1)

    v0, v1, v2 = on_plane(0.0, 0.0), on_plane(0.0, 100.0), on_plane(100.0, 0.0)
    n = torch.linalg.cross(v2 - v0, v1 - v2, dim=-1)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    resid = h - (xz * w2.unsqueeze(1)).sum(-1) - c2.unsqueeze(-1)
    out2 = (resid.abs() > e2[:, None] * s2[:, None]) & mask
    flat = vc.index_select(-1, pb.feet_cols).reshape(B, -1)
    keep = torch.where(out2, 0.0, flat).to(vc.dtype)
    vc2 = vc.index_copy(-1, pb.feet_cols, keep.reshape(B, F, -1))
    return n.to(x.dtype), v0.to(x.dtype), vc2


# -- the whole refinement ----------------------------------------------------------

def matmul_plain(a, b):
    return torch.matmul(a, b)


def exact(x):
    return x


def bf16_state(x):
    """An iterate held in bfloat16: the control's solver state."""
    return x.to(torch.bfloat16).to(x.dtype)


def tf32(x):
    """float32 rounded to TF32's 10-bit mantissa, to nearest."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul_tf32(a, b):
    return torch.matmul(tf32(a), tf32(b))


def refine(problems, cfg: dict, device, dtype=torch.float64,
           matmul: Callable = matmul_plain, keep: Callable = exact) -> dict:
    """The refinement of ``problems`` (the entry point's per-sequence
    dicts). Returns device tensors: ``x`` (B, F·(3+3J)), ``joints`` (B, F,
    28, 3) global in data order, ``normals``, ``points``, ``vc``. ``keep``
    rounds every iterate (``bf16_state``: the control)."""
    kin = cfg["kinematic"]
    pb = Problem(problems, cfg, device, dtype)
    x0 = ik(pb, matmul, kin["ik_solver"], keep)
    zero3 = torch.zeros((pb.B, 3), dtype=dtype, device=device)
    masks = coloring_masks(pb.F, 3 + 3 * pb.J, dtype, device)
    w1, w2 = kin["stage1"], kin["stage2"]
    x1 = lm(pb, x0, lambda v: pb.residual(v, w1, pb.a["vc"], zero3, zero3), masks, keep)
    normals, points, vc2 = floor(pb, x1)
    x2 = lm(pb, x1, lambda v: pb.residual(v, w2, vc2, normals, points), masks, keep)
    y, root = pb.positions(x2)
    joints = y + root.unsqueeze(2)
    joints[:, :, pb.root_idx] = root
    return {"x": x2, "joints": joints, "normals": normals, "points": points, "vc": vc2,
            "problem": pb}


def stage2_cost(pb: Problem, x, vc, normals, points) -> torch.Tensor:
    """½‖r‖² per sequence of the stage-2 residual at x, in float64, on the
    given floor and contacts."""
    w2 = pb.cfg["kinematic"]["stage2"]
    r = pb.residual(x.to(pb.dtype), w2, vc.to(pb.dtype), normals.to(pb.dtype),
                    points.to(pb.dtype))
    return 0.5 * (r.double() ** 2).sum(-1)


def euler_x(pb: Problem, rotations, root) -> torch.Tensor:
    """Solution variables (B, F·(3+3J)) of quaternions (B, F, J, 4) and
    root translations (B, F, 3)."""
    e = pb.q.to_euler_xyz(rotations.to(pb.dtype))
    return torch.cat([root.to(pb.dtype), e.flatten(-2)], -1).reshape(pb.B, -1)
