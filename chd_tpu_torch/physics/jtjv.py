"""The Gauss-Newton product JᵀJ·v of the physics stages' augmented-Lagrangian
residual as one hand-written CUDA kernel (``csrc/phys_jtjv.cu``), with a
plain-torch emulation of its algorithm.

``lm.lm_solve`` forms JᵀJ·v by a double vjp through ``torch.func``: ~1,074
small kernels a product at the benchmark's 32 x 100 frames, 50 of them a
PCG step, and 90 more, vmapped, for the coloring diagonal. The kernel
computes the product of ``collocation``'s AL residual (``_al_residual_fn``:
the cost residuals and the active constraint blocks, each scaled by √ρ) at x
in one launch, a warp per (tangent, sequence, tile of ``TILE`` frames)
and a lane per frame of the tile and its ``HALO`` frames on each side (the
kernel's source says why three suffice). A diagonal mode gives the
coloring quantity Σₖ mₖ ⊙ JᵀJ mₖ over ``lm.frame_coloring_masks(F, 30)``'s
90 masks (bandwidth 2), with the tangents mₖ made in the kernel. That is
not diag(JᵀJ): the angular Newton–Euler row at frame g reads θ at
g−2…g+2, and frames g−2 and g+1 share a colour, so the sum keeps their
cross terms, as the double vjp's coloring does.

The structure (acceleration terms on or off, the blocks with ρ ≠ 0) is
fixed per product object, as ``collocation._structure`` derives it; the
weights and penalties are the 0-d tensors ``lm_solve`` makes. The
inequality blocks (``force``, ``height``, ``leg``) are hinged: their rows
are scaled by the hinge's derivative at x (1 above 0, 0 below, ½ at an
exact tie, as ``torch.maximum``'s), which ``Linearization`` takes once an
LM step from ``collocation.constraints`` at x, the same operations as the
residual's, so the gradient and the product take the same rows.

``PhysicsProduct`` is the kernel's supplier (``ops/jtjv.py``), one a
structure (``product_for``), which ``collocation``'s AL residual names for
a solve on CUDA and ``lm_solve`` takes. Stage 3 (its soft schedule's
residual) and the CPU keep autograd's product.

``phys_jtjv_plain`` is the kernel's algorithm in plain torch: the same
tiles and halos, the same hand-derived tangent and transpose, for tests
only (``PhysicsProduct.emulated``), as ``kinematics.jtjv.traj_jtjv_plain``
is for the trajectory kernel. The package's CPU paths never call it.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from ..kinematics.lm import frame_coloring_masks
from ..ops import jtjv as jtjv_ops
from ..ops.jtjv import check_like
from . import collocation as co

TILE = 26            # a warp's own frames (kTile)
HALO = 3             # frames on each side (kHalo): see the kernel's note
COST = co.CostW._fields
BLOCKS = co.Constraints._fields       # dyn, force, heel, height, leg, slip, terrain
HINGED = tuple(n for n in BLOCKS if co.INEQ[n])  # force, height, leg


def hinge_factors(x, phys, lams, rho, active) -> Dict[str, torch.Tensor]:
    """The hinged blocks' derivative factors at x: 1 where √ρ·(g + λ/ρ)'s
    shifted value is above 0, ½ at 0, 0 below, from the same operations as
    ``collocation._penalties``."""
    cons = co.constraints(x, phys)
    out = {}
    for name in HINGED:
        if name in active:
            s = getattr(cons, name) + getattr(lams, name) / getattr(rho, name)
            out[name] = torch.sign(s).mul_(0.5).add_(0.5)
    return out


# -- the kernel ---------------------------------------------------------------

def phys_jtjv(mode: str, lin: "Linearization", vs: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """Launch the kernel for ``lin`` (``ops.jtjv.launch``; the diagonal's 90
    tangents are made in the kernel). The weights and penalties are 0-d
    tensors. Raises on what the kernel does not take."""
    x, phys = lin.x, lin.phys
    B, F = phys.base_lin.shape[:2]
    jtjv_ops.check_x(phys_jtjv, mode, x, (B, F * co.DOF))
    if F < 2:
        raise ValueError(f"the residual needs 2 frames or more, not {F}")
    arrays = [check_like("dt", phys.dt, (B,), x),
              check_like("mass", phys.mass, (B,), x),
              check_like("floor_normal", phys.floor_normal, (B, 3), x),
              check_like("contact", phys.contact, (B, 4, F), x),
              check_like("left_hip", phys.left_hip, (B, F, 3), x),
              check_like("right_hip", phys.right_hip, (B, F, 3), x),
              check_like("inertia", phys.inertia, (B, F, 3, 3), x)]
    optional = [None if phys.frame_mask is None
                else check_like("frame_mask", phys.frame_mask, (B, F), x)]
    shapes = {"force": (B, 4, F, 3), "height": (B, 4, F), "leg": (B, 4, F)}
    optional += [check_like(f"hinge {k}", lin.hinge[k], shapes[k], x) if k in lin.hinge
                 else None for k in HINGED]
    weights = [check_like(f"weight {k}", getattr(lin.w, k), (), x) for k in COST] \
        + [check_like(f"rho {k}", getattr(lin.rho, k), (), x) for k in BLOCKS]
    ptrs = [t.data_ptr() for t in arrays] + [0 if t is None else t.data_ptr() for t in optional] \
        + [t.data_ptr() for t in weights]
    tail = [t.stride(0) for t in arrays] + [0 if t is None else t.stride(0) for t in optional]
    return jtjv_ops.launch(phys_jtjv, mode, x, vs, [F, lin.product.flags], ptrs, tail,
                           diag_tangents=jtjv_ops.COLORS * co.DOF)


phys_jtjv.launches = dict.fromkeys(jtjv_ops.MODES, 0)


class Linearization(jtjv_ops.Linearization):
    """JᵀJ of the AL residual at x (``ops.jtjv.Linearization``); its
    diagonal is the coloring diagonal of ``lm.frame_coloring_masks(F,
    30)``. Takes the hinge factors at x on construction (once an LM step).
    x and the problem's fields may be strided (stage 4 starts from a slice
    of stage 3's augmented variables; the pipeline's batch can keep a
    transposed layout); the kernel reads contiguous copies (none where they
    are contiguous already, as in a batch of ``pad_phys_inputs``' own
    arrays)."""

    def __init__(self, product: "PhysicsProduct", x, phys, lams, w, rho):
        super().__init__(product, x.contiguous())
        self.w, self.rho = w, rho
        self.phys = type(phys)(*(None if t is None else t.contiguous() for t in phys))
        self.hinge = hinge_factors(x, phys, lams, rho, product.active)
        self.frames, self.dofs = phys.base_lin.shape[1], co.DOF


class PhysicsProduct(jtjv_ops.Supplier):
    """The supplier of the AL residual of one structure (``accel``,
    ``active``): ``self(x, phys, lams, w, rho)`` is the linearization at
    x."""

    path, emulation_path = "phys_kernel", "phys_emulation"
    TILE = TILE
    linearization = Linearization
    kernel = staticmethod(phys_jtjv)

    def __init__(self, accel: bool, active: tuple):
        unknown = set(active) - set(BLOCKS)
        if unknown:
            raise ValueError(f"no constraint blocks {sorted(unknown)}; the blocks are {BLOCKS}")
        self.accel, self.active = bool(accel), tuple(n for n in BLOCKS if n in active)
        # the kernel's structure word: bit 0 the acceleration terms, bit
        # 1 + i block BLOCKS[i]
        self.flags = int(self.accel) | sum(1 << (1 + BLOCKS.index(n)) for n in self.active)

    def plain(self, mode, lin, vs, tile):
        return phys_jtjv_plain(mode, lin, vs, tile)


@functools.lru_cache(maxsize=None)
def product_for(accel: bool, active: tuple) -> PhysicsProduct:
    """The kernel's supplier of the structure (``accel``, ``active``), one
    object a structure, so a stage's captured LM step is found again."""
    return PhysicsProduct(accel, active)


# -- the emulation ------------------------------------------------------------
# Vectors (..., 3) and matrices (..., 3, 3); frames on the axis before them,
# where the kernel has a warp's lanes. ``rot_parts`` is the kernel's ``rot``,
# ``rot_d`` and ``rate_*``; the helpers below it, its vector functions.

def rot_parts(th):
    """R(θ) = Rz·Ry·Rx, its three partials ∂R/∂θₐ, M(θ) (ω = M·θ̇) and its
    partials (∂M/∂θₓ = 0): (R, [dR0, dR1, dR2], M, [dM1, dM2])."""
    x, y, z = th.unbind(-1)
    cx, sx, cy, sy, cz, sz = torch.cos(x), torch.sin(x), torch.cos(y), torch.sin(y), \
        torch.cos(z), torch.sin(z)
    o = torch.zeros_like(x)

    def mat(*e):
        return torch.stack(e, -1).unflatten(-1, (3, 3))

    R = mat(cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx,
            sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx,
            -sy, cy * sx, cy * cx)
    dR = [mat(o, cz * sy * cx + sz * sx, -cz * sy * sx + sz * cx,
              o, sz * sy * cx - cz * sx, -sz * sy * sx - cz * cx,
              o, cy * cx, -cy * sx),
          mat(-cz * sy, cz * cy * sx, cz * cy * cx,
              -sz * sy, sz * cy * sx, sz * cy * cx,
              -cy, -sy * sx, -sy * cx),
          mat(-sz * cy, -sz * sy * sx - cz * cx, -sz * sy * cx + cz * sx,
              cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx,
              o, o, o)]
    M = mat(cz * cy, -sz, o, sz * cy, cz, o, -sy, o, o + 1)
    dM = [mat(-cz * sy, o, o, -sz * sy, o, o, -cy, o, o),
          mat(-sz * cy, -cz, o, cz * cy, -sz, o, o, o, o)]
    return R, dR, M, dM


def _mv(m, v):
    return (m * v.unsqueeze(-2)).sum(-1)


def _mtv(m, v):
    return (m * v.unsqueeze(-1)).sum(-2)


def _dot(a, b):
    return (a * b).sum(-1)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _outer(a, b):
    return a.unsqueeze(-1) * b.unsqueeze(-2)


def _sq(k, t):
    """k·(k·t): a row's tangent t back through its scale k."""
    return k * (k * t)


def phys_jtjv_plain(mode: str, lin: Linearization, vs: Optional[torch.Tensor] = None,
                    tile: int = TILE) -> torch.Tensor:
    """``phys_jtjv``'s algorithm in plain torch: warps of ``tile`` own
    frames with ``HALO`` on each side, the x-dependent coefficients of each
    frame, the tangents and cotangents level by level with neighbours read
    inside the window only (zero past it), as the kernel's lanes read shared
    memory. The diagonal runs the product on the 90 coloring tangents and
    keeps each output where its tangent is 1, as the kernel does. Same
    arguments and results."""
    x, phys, prod = lin.x, lin.phys, lin.product
    B, F = phys.base_lin.shape[:2]
    D, n = co.DOF, F * co.DOF
    dt_ = x.dtype
    if mode == "diag":
        masks = frame_coloring_masks(F, D, dtype=dt_, device=x.device)
        out = phys_jtjv_plain("product", lin, masks.unsqueeze(1).expand(-1, B, -1), tile)
        return (masks.unsqueeze(1) * out).sum(0)

    M = vs.shape[0]
    on = set(prod.active)
    sw = {k: torch.sqrt(torch.as_tensor(getattr(lin.w, k), dtype=dt_)) for k in COST}
    sr = {k: torch.sqrt(torch.as_tensor(getattr(lin.rho, k), dtype=dt_)) for k in BLOCKS}
    X = x.reshape(B, F, D)
    V = vs.reshape(M, B, F, D)
    fm = (torch.ones((B, F), dtype=dt_) if phys.frame_mask is None
          else phys.frame_mask.to(dt_))
    frames = torch.arange(F)
    fm3 = fm * fm[:, (frames + 1).clamp(max=F - 1)] * fm[:, (frames - 1).clamp(min=0)]
    pair = fm[:, :-1] * fm[:, 1:]                   # (B, F-1)
    triple = pair[:, :-1] * fm[:, 2:]               # (B, F-2)
    c = phys.contact                                # (B, 4, F)
    nrm = phys.floor_normal                         # (B, 3)
    dt = phys.dt.reshape(B, 1, 1)
    mass = phys.mass.reshape(B, 1, 1)
    hips = torch.stack([phys.left_hip, phys.right_hip, phys.left_hip, phys.right_hip], 1)
    out = torch.zeros((M, B, F, D), dtype=dt_)

    def cd_all(Y):  # central_diff over the whole sequence, (..., F, 3)
        first = (Y[..., 1:2, :] - Y[..., :1, :]) / dt
        last = (Y[..., -1:, :] - Y[..., -2:-1, :]) / dt
        return torch.cat([first, (Y[..., 2:, :] - Y[..., :-2, :]) / (2 * dt), last], -2)

    # frame-local values at x, and the level-1 tangents that read v at f ± 1
    # from memory (the kernel's lanes read them from global memory)
    th = X[..., 3:6]
    R, dR, Mm, dM = rot_parts(th)
    thd = cd_all(th)
    om = _mv(Mm, thd)
    dth = V[..., 3:6]
    dthd = cd_all(dth)
    dom = _mv(Mm, dthd) + dth[..., 1:2] * _mv(dM[0], thd) + dth[..., 2:3] * _mv(dM[1], thd)
    dcb = cd_all(V[..., 0:3])

    for t0 in range(0, F, tile):
        own = min(tile, F - t0)
        g = torch.arange(t0 - HALO, t0 + own + HALO)
        valid = (g >= 0) & (g < F)
        gc = g.clamp(0, F - 1)
        first, last = (g == 0).unsqueeze(-1), (g == F - 1).unsqueeze(-1)
        vm = valid.unsqueeze(-1)

        def win(t):  # a (..., F, k) array at the window's frames, zero off the sequence
            return torch.where(vm, t[..., gc, :], 0.0)

        def sh(Y, o):  # Y at window index i + o, zero past the window
            z = torch.zeros_like(Y[..., :abs(o), :])
            return torch.cat([Y[..., o:, :], z], -2) if o > 0 else torch.cat([z, Y[..., :o, :]], -2)

        def cd_w(Y):
            nxt, prv = sh(Y, 1), sh(Y, -1)
            return torch.where(first, (nxt - Y) / dt,
                               torch.where(last, (Y - prv) / dt, (nxt - prv) / (2 * dt)))

        def cdt_w(Yb):
            s = torch.where((g - 1 >= 0).unsqueeze(-1),
                            sh(Yb, -1) / torch.where((g - 1 == 0).unsqueeze(-1), dt, 2 * dt), 0.0)
            s = s + torch.where(first, -Yb / dt, torch.where(last, Yb / dt, 0.0))
            return s - torch.where((g + 1 <= F - 1).unsqueeze(-1),
                                   sh(Yb, 1) / torch.where((g + 1 == F - 1).unsqueeze(-1), dt,
                                                           2 * dt), 0.0)

        Xw, Vw = win(X), win(V)
        bl, ee, fo = Xw[..., 0:3], Xw[..., 6:18].unflatten(-1, (4, 3)), \
            Xw[..., 18:30].unflatten(-1, (4, 3))
        dbl, dth_w = Vw[..., 0:3], Vw[..., 3:6]
        dee, dfo = Vw[..., 6:18].unflatten(-1, (4, 3)), Vw[..., 18:30].unflatten(-1, (4, 3))
        Rw = win(R.flatten(-2)).unflatten(-1, (3, 3))
        dRw = [win(d.flatten(-2)).unflatten(-1, (3, 3)) for d in dR]
        Mw = win(Mm.flatten(-2)).unflatten(-1, (3, 3))
        dMw = [win(d.flatten(-2)).unflatten(-1, (3, 3)) for d in dM]
        thdw, omw = win(thd), win(om)
        domw, dcbw = win(dom), win(dcb)
        fmw = win(fm.unsqueeze(-1))                        # (B, W, 1)
        cw = win(c.transpose(1, 2)).unsqueeze(-1)          # (B, W, 4, 1)
        nw = nrm[:, None, None, :]                         # (B, 1, 1, 3)

        blb = torch.zeros_like(dbl)
        thb = torch.zeros_like(dbl)
        eeb = torch.zeros_like(dee)
        fob = torch.zeros_like(dfo)
        Rb = torch.zeros(dbl.shape + (3,), dtype=dt_)
        omb_loc = torch.zeros_like(dbl)
        odb = torch.zeros_like(dbl)
        accb = torch.zeros_like(dbl)
        dRv = dRw[0] * dth_w[..., 0:1, None] + dRw[1] * dth_w[..., 1:2, None] \
            + dRw[2] * dth_w[..., 2:3, None]

        # -- the Newton–Euler block
        if "dyn" in on:
            omd, domd, dacc = cd_w(omw), cd_w(domw), cd_w(dcbw)
            In = win(phys.inertia.flatten(-2)).unflatten(-1, (3, 3))
            IRt = In @ Rw.transpose(-1, -2)
            Iw = Rw @ IRt
            u = _mv(Iw, omw)
            dIw = dRv @ IRt + Rw @ In @ dRv.transpose(-1, -2)
            feff = cw * fo
            arm = bl.unsqueeze(-2) - ee
            dtau = (_cross(cw * dfo, arm) + _cross(feff, dbl.unsqueeze(-2) - dee)).sum(-2)
            dang = _mv(dIw, omd) + _mv(Iw, domd) + _cross(domw, u) \
                + _cross(omw, _mv(dIw, omw) + _mv(Iw, domw)) - dtau
            dlin = mass * dacc - (cw * dfo).sum(-2)
            k = sr["dyn"] * win((fm3).unsqueeze(-1))
            ab, lb = _sq(k, dang), _sq(k, dlin)
            Ib = _outer(ab, omd) + _outer(_cross(ab, omw), omw)
            Rb = Rb + Ib @ Rw @ In.transpose(-1, -2) + Ib.transpose(-1, -2) @ Rw @ In
            odb = _mtv(Iw, ab)
            omb_loc = _cross(u, ab) + _mtv(Iw, _cross(ab, omw))
            tb = -ab
            blb = blb + _cross(tb.unsqueeze(-2), feff).sum(-2)
            eeb = eeb - _cross(tb.unsqueeze(-2), feff)
            fob = fob + cw * _cross(arm, tb.unsqueeze(-2)) - cw * lb.unsqueeze(-2)
            accb = mass * lb
        # -- leg length (hinged)
        if "leg" in on:
            hw = win(hips.transpose(1, 2).flatten(-2)).unflatten(-1, (4, 3))   # (B, W, 4, 3)
            d = ee - (_mv(Rw.unsqueeze(-3), hw) + bl.unsqueeze(-2))
            t = _dot(d, dee - _mv(dRv.unsqueeze(-3), hw) - dbl.unsqueeze(-2))
            k = sr["leg"] * win(lin.hinge["leg"].transpose(1, 2)) * fmw
            cb = _sq(k, t).unsqueeze(-1)
            eeb = eeb + cb * d
            blb = blb - (cb * d).sum(-2)
            Rb = Rb - (_outer(cb * d, hw)).sum(-3)
        # -- heel-toe distance
        if "heel" in on:
            dh = ee[..., :2, :] - ee[..., 2:, :]
            t = _dot(dh, dee[..., :2, :] - dee[..., 2:, :])
            cb = _sq(sr["heel"] * fmw, t).unsqueeze(-1) * dh
            eeb = eeb + torch.cat([cb, -cb], -2)
        # -- above the floor (hinged), on the terrain in contact
        if "height" in on:
            k = sr["height"] * win(lin.hinge["height"].transpose(1, 2)) * fmw
            eeb = eeb - _sq(k, -_dot(nw, dee)).unsqueeze(-1) * nw
        if "terrain" in on:
            k = sr["terrain"] * cw.squeeze(-1) * fmw
            eeb = eeb + _sq(k, _dot(nw, dee)).unsqueeze(-1) * nw
        # -- no slip between consecutive contact frames: pairs (f-1, f), (f, f+1)
        if "slip" in on:
            cn = win(c.transpose(1, 2)[:, (frames + 1).clamp(max=F - 1)])
            pr = win(torch.cat([pair, pair[:, :1] * 0], 1).unsqueeze(-1))  # pair (g, g+1)
            both = cw.squeeze(-1) * cn * pr * (g + 1 <= F - 1).unsqueeze(-1)
            k = sr["slip"] * both.unsqueeze(-1)
            nxt = torch.where((g + 1 <= F - 1)[:, None, None],
                              V[..., (frames + 1).clamp(max=F - 1), 6:18][..., gc, :].unflatten(
                                  -1, (4, 3)), 0.0)
            cb = _sq(k, nxt - dee)                      # the pair (g, g+1)'s cotangent
            eeb = eeb - cb + sh(cb.flatten(-2), -1).unflatten(-1, (4, 3))
        # -- friction cone and normal-force bounds (hinged)
        if "force" in on:
            feff, dfe = cw * fo, cw * dfo
            fn = _dot(feff, nw)
            ft = feff - fn.unsqueeze(-1) * nw
            dfn = _dot(nw, dfe)
            t2 = 2 * _dot(ft, dfe - dfn.unsqueeze(-1) * nw) - 2 * co.FRICTION ** 2 * fn * dfn
            h = win(lin.hinge["force"].transpose(1, 2).flatten(-2)).unflatten(-1, (4, 3))
            k = sr["force"] * h * fmw.unsqueeze(-1)
            c0, c1, c2 = _sq(k[..., 0], -dfn), _sq(k[..., 1], dfn), _sq(k[..., 2], t2)
            gft = 2 * ft - 2 * _dot(ft, nw).unsqueeze(-1) * nw \
                - 2 * co.FRICTION ** 2 * fn.unsqueeze(-1) * nw
            fob = fob + cw * ((c1 - c0).unsqueeze(-1) * nw + c2.unsqueeze(-1) * gft)

        # -- level 2 of the transpose: ω̇ → ω → θ̇ and θ; acc → the first difference
        omb = omb_loc + cdt_w(odb)
        thdb = _mtv(Mw, omb)
        thb = thb + torch.stack([torch.zeros_like(omb[..., 0]), _dot(_mv(dMw[0], thdw), omb),
                                 _dot(_mv(dMw[1], thdw), omb)], -1)
        thb = thb + torch.stack([(Rb * d).sum((-1, -2)) for d in dRw], -1)
        cbb = cdt_w(accb)
        # -- level 1: θ̇ → θ, the first difference → base_lin
        thb = thb + cdt_w(thdb)
        blb = blb + cdt_w(cbb)
        res = torch.cat([blb, thb, eeb.flatten(-2), fob.flatten(-2)], -1)

        # -- the cost residuals (linear): data, velocity and acceleration
        # smoothness, the force pins, the first and last frames' pins
        lo = slice(HALO, HALO + own)
        of = torch.arange(t0, t0 + own)
        res = res[..., lo, :] + _costs(V, fm, pair, triple, c, dt, sw, prod.accel, of, F)
        out[:, :, t0:t0 + own] = res
    return out.reshape(M, B, n)


def _costs(V, fm, pair, triple, c, dt, sw, accel, of, F):
    """The cost residuals' JᵀJ·v at frames ``of``: (M, B, len(of), 30)."""
    M, B = V.shape[:2]
    dt_ = V.dtype
    res = torch.zeros((M, B, len(of), co.DOF), dtype=dt_)
    groups = ((slice(0, 3), "data_lin", "sv_lin"), (slice(3, 6), "data_ang", "sv_ang"),
              (slice(6, 18), "data_ee", "sv_ee"))

    def at(t, idx, ok):  # (…, F…) at frames idx, zero where not ok
        return torch.where(ok, t[:, idx.clamp(0, t.shape[1] - 1)], 0.0)

    v = V[:, :, of]
    for sl, wd, ws in groups:
        a = sw[wd] * fm[:, of].unsqueeze(-1)
        res[..., sl] += _sq(a, v[..., sl])
        for p, sign in ((of - 1, 1.0), (of, -1.0)):
            ok = (p >= 0) & (p <= F - 2)
            a = sw[ws] * at(pair, p, ok).unsqueeze(-1)
            t = _sq(a, V[:, :, (p + 1).clamp(0, F - 1), sl] - V[:, :, p.clamp(0, F - 1), sl])
            res[..., sl] += sign * torch.where(ok.unsqueeze(-1), t, 0.0)
        if accel and F >= 3:
            for q, coef in ((of, 1.0), (of - 1, -2.0), (of - 2, 1.0)):
                ok = (q >= 0) & (q <= F - 3)
                a = sw["sa"] * at(triple, q, ok).unsqueeze(-1)
                qc = q.clamp(0, F - 1)
                sec = V[:, :, (qc + 2).clamp(max=F - 1), sl] - 2 * V[:, :, (qc + 1).clamp(
                    max=F - 1), sl] + V[:, :, qc, sl]
                res[..., sl] += coef * torch.where(ok.unsqueeze(-1), _sq(a, sec), 0.0)
    cf = c[:, :, of].transpose(1, 2) * fm[:, of].unsqueeze(-1)          # (B, T, 4)
    k1 = (1e-2 * (1.0 - cf)).repeat_interleave(3, -1)
    k2 = (1e-4 * cf).repeat_interleave(3, -1)
    res[..., 18:30] += _sq(k1, v[..., 18:30]) + _sq(k2, v[..., 18:30])
    # the pins: base at frames 0 and F-1, the velocity of the first and last pairs
    p = sw["pin"]
    dtb = dt.reshape(1, B, 1)
    for f in (0, F - 1):
        sel = of == f
        res[:, :, sel, 0:6] += _sq(p, V[:, :, f:f + 1, 0:6])
    for a_, b_ in ((0, 1), (F - 2, F - 1)):
        t = p * (0.1 * ((V[:, :, b_, 0:3] - V[:, :, a_, 0:3]) / dtb))
        back = p * (0.1 * (t / dtb))
        res[:, :, of == b_, 0:3] += back.unsqueeze(2)
        res[:, :, of == a_, 0:3] -= back.unsqueeze(2)
    return res
