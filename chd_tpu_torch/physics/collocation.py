"""Physics trajectory optimization as batched direct collocation (port of
chd_tpu/physics/collocation.py).

Replacement for the TOWR/IPOPT pipeline (towr_phys_optim/phys_optim.cpp:
375-762 + the TOWR phase-based spline NLP). Design mapping:

- ALL quantities live on the fixed frame grid (dt = 1/fps): variables are
  per-frame [base_lin, base_ang, 4×ee_pos, 4×ee_force] — (F, 30).
  Derivatives are finite differences.
- IPOPT's interior-point handling of constraints becomes an augmented
  Lagrangian: each constraint block carries multipliers λ and penalty ρ;
  inner minimizations run the matrix-free Levenberg–Marquardt of the
  kinematic stage (exact Jacobi scaling via frame coloring), outer
  iterations update λ.
- the reference's staged schedule (stage refs phys_optim.cpp):
  FIT    (1.1/1.2, :554-603): data+smooth costs, kinematic constraints;
  DYNAMICS (2.1, :606-643): + Newton–Euler + friction-cone constraints,
           pipeline cost weights (w_com_lin 0.4, w_com_ang 1.7, w_ee 0.3);
  HEIGHT  (2.2, :646-661): + above-floor clearance;
  DURATIONS (3, :663-711): the binary contact schedule becomes a smooth
           function of phase-duration variables (physics/durations.py),
           which join the LM variable vector; after re-rasterization a
           frozen-duration re-solve polishes the trajectory (the
           reference's stage 4, :713-749), and failure falls back to the
           stage-2 result just like the reference.
- swing-phase forces are eliminated rather than constrained: effective force
  = contact_mask · f.

Every function here takes a batch: x (B, F·30) and a ``PhysInput`` whose
leaves carry a leading axis B (``parallel.batch.pad_phys_inputs``); row b of
a residual reads only row b of x, as the port's ``lm_solve`` requires. The
residual functions are cached per structure (which blocks are on, whether
the acceleration terms are), and take the cost weights and penalties as
arguments, which ``lm_solve`` turns into 0-d tensors: FIT, DYN, DYN_H,
stage 3 and stage 4 are five residual graphs, and a stage's AL iterations
replay one captured LM step; on CUDA the AL residual's JᵀJ·v is the
hand-written kernel of ``physics/jtjv.py`` (stage 3 keeps autograd's).
Hinges use ``torch.maximum`` with a zero, whose derivative at a tie is 1/2
as ``jnp.maximum``'s (the forces start at zero, so the friction-cone rows
sit at exact ties on the first step).

``solve_physics`` and ``solve_physics_durations`` take one problem, as
``chd_tpu``'s do, and solve it as a batch of one.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..kinematics.lm import LMConfig, lm_solve
from ..ops import jtjv as jtjv_ops
from . import durations as dur_lib
from . import srbd
from .types import NUM_EE, PhysInput, PhysResult, PhysWeights

DOF = 6 + NUM_EE * 3 + NUM_EE * 3  # 30 per frame
FRICTION = 0.5          # TOWR HeightMap default friction coefficient
FORCE_LIMIT = 1000.0    # N (parameters.cpp force_limit_in_normal_direction_)


class CostW(NamedTuple):
    data_lin: float
    data_ang: float
    data_ee: float
    sv_lin: float
    sv_ang: float
    sv_ee: float
    sa: float          # acceleration smoothing (0 = off)
    pin: float         # initial/final base state penalty


class Rho(NamedTuple):
    """Penalty strengths per constraint block (0 disables the block)."""

    dyn: float = 0.0
    leg: float = 0.0
    heel: float = 0.0
    terrain: float = 0.0
    slip: float = 0.0
    force: float = 0.0
    height: float = 0.0


class Constraints(NamedTuple):
    """The constraint blocks, in sorted order: the order ``chd_tpu``'s
    residuals concatenate them in (``sorted(cons.items())``). Also the
    multipliers' container."""

    dyn: torch.Tensor      # (B, F, 6)
    force: torch.Tensor    # (B, 4, F, 3) ≤ 0
    heel: torch.Tensor     # (B, 2, F)
    height: torch.Tensor   # (B, 4, F) ≤ 0
    leg: torch.Tensor      # (B, 4, F) ≤ 0
    slip: torch.Tensor     # (B, 4, F-1, 3)
    terrain: torch.Tensor  # (B, 4, F)


# stage schedules (see module docstring)
FIT_COST = CostW(1.0, 1.0, 1.0, 0.1, 0.1, 0.1, 0.0, 1e3)
FIT_RHO = Rho(leg=10.0, heel=100.0, terrain=100.0, slip=100.0)
DYN_COST = CostW(0.4, 1.7, 0.3, 0.001, 0.001, 0.1, 1e-4, 1e3)
DYN_RHO = Rho(dyn=0.05, leg=10.0, heel=100.0, terrain=100.0, slip=100.0, force=1e-4)
DYN_H_RHO = Rho(dyn=0.05, leg=10.0, heel=100.0, terrain=100.0, slip=100.0, force=1e-4, height=100.0)

INEQ = {"leg": True, "heel": False, "terrain": False, "slip": False, "force": True,
        "height": True, "dyn": False}


def _sqrt(v):
    return torch.sqrt(v) if isinstance(v, torch.Tensor) else math.sqrt(v)


def _hinge(v: torch.Tensor) -> torch.Tensor:
    return torch.maximum(v, v.new_zeros(()))


def split_vars(x: torch.Tensor, F: int):
    """x (B, F·30) → (base_lin (B,F,3), base_ang (B,F,3), ee (B,4,F,3),
    force (B,4,F,3))."""
    m = x.reshape(x.shape[0], F, DOF)
    ee = m[..., 6:6 + NUM_EE * 3].unflatten(-1, (NUM_EE, 3)).transpose(1, 2)
    force = m[..., 6 + NUM_EE * 3:].unflatten(-1, (NUM_EE, 3)).transpose(1, 2)
    return m[..., 0:3], m[..., 3:6], ee, force


def join_vars(base_lin, base_ang, ee, force) -> torch.Tensor:
    B, F = base_lin.shape[:2]
    m = torch.cat([base_lin, base_ang, ee.transpose(1, 2).reshape(B, F, -1),
                   force.transpose(1, 2).reshape(B, F, -1)], dim=-1)
    return m.reshape(B, -1)


def _frame_mask(phys: PhysInput, like: torch.Tensor) -> torch.Tensor:
    B, F = phys.base_lin.shape[:2]
    if phys.frame_mask is None:
        return torch.ones((B, F), dtype=like.dtype, device=like.device)
    return phys.frame_mask.to(like.dtype)


def constraints(x, phys: PhysInput, contact=None) -> Constraints:
    """All constraint values (equalities = 0, inequalities g ≤ 0).

    ``contact`` overrides phys.contact (stage 3 passes the SOFT schedule so
    everything becomes differentiable w.r.t. phase durations)."""
    F = phys.base_lin.shape[1]
    base_lin, base_ang, ee, force = split_vars(x, F)
    n = phys.floor_normal[:, None, None, :]        # (B, 1, 1, 3)
    p0 = phys.floor_point[:, None, None, :]
    c = phys.contact if contact is None else contact  # (B, 4, F)
    fm = _frame_mask(phys, base_lin)
    # finite-difference span gating: central diffs at frame f touch f±1
    fm3 = (fm * torch.cat([fm[:, 1:], fm[:, -1:]], dim=1)
           * torch.cat([fm[:, :1], fm[:, :-1]], dim=1))
    pair = fm[:, :-1] * fm[:, 1:]
    fm_e = fm.unsqueeze(1)                          # (B, 1, F)

    # dynamics (humanoid_dynamic_constraint.cpp; gravity dir = −floor normal)
    dyn = srbd.dynamic_violation(base_lin, base_ang, ee, force, c, phys.inertia, phys.mass,
                                 -phys.floor_normal, phys.dt) * fm3.unsqueeze(-1)

    # leg length (leg_length_constraint.cpp:38-60): ½‖ee − (R·hip + base)‖² ≤ ½L²
    R = srbd.rot_zyx(base_ang).unsqueeze(1)        # (B, 1, F, 3, 3)
    # heels share hip offsets (humanoid.h:45-48)
    hips = torch.stack([phys.left_hip, phys.right_hip, phys.left_hip, phys.right_hip], dim=1)
    hip_w = torch.matmul(R, hips.unsqueeze(-1)).squeeze(-1) + base_lin.unsqueeze(1)
    d2 = ((ee - hip_w) ** 2).sum(dim=-1)          # (B, 4, F)
    lmax = torch.stack([phys.max_leg_length, phys.max_leg_length, phys.max_heel_length,
                        phys.max_heel_length], dim=1)
    leg = (0.5 * d2 - 0.5 * (lmax.unsqueeze(-1) ** 2)) * fm_e

    # heel↔toe distance equality (ee_dist_constraint.cpp:34-94), pairs (0,2),(1,3)
    hd2 = ((ee[:, :2] - ee[:, 2:]) ** 2).sum(dim=-1)  # (B, 2, F)
    heel = (0.5 * hd2 - 0.5 * phys.heel_dist[:, None, None] ** 2) * fm_e

    # on-terrain during contact (TOWR TerrainConstraint)
    height = ((ee - p0) * n).sum(dim=-1)          # (B, 4, F)
    terrain = c * height * fm_e

    # stance no-slip: consecutive contact frames share the EE position
    both = (c[..., :-1] * c[..., 1:] * pair.unsqueeze(1)).unsqueeze(-1)
    slip = both * (ee[:, :, 1:] - ee[:, :, :-1])

    # friction cone + bounds on effective (masked) force
    f_eff = force * c.unsqueeze(-1)
    fn = (f_eff * n).sum(dim=-1)
    ft = f_eff - fn.unsqueeze(-1) * n
    ft2 = (ft * ft).sum(dim=-1)
    force_c = torch.stack([-fn, fn - FORCE_LIMIT, ft2 - FRICTION ** 2 * fn ** 2],
                          dim=-1) * fm_e.unsqueeze(-1)

    # above-floor clearance everywhere (height_constraint.cpp:23-58)
    return Constraints(dyn=dyn, force=force_c, heel=heel, height=-height * fm_e, leg=leg,
                       slip=slip, terrain=terrain)


def cost_residuals(x, phys: PhysInput, w: CostW, contact=None, accel=None) -> torch.Tensor:
    """(B, R) cost residuals. ``w`` holds floats or 0-d tensors; ``accel``
    (whether the acceleration terms are on) defaults to ``w.sa > 0``, which
    needs a float."""
    F = phys.base_lin.shape[1]
    base_lin, base_ang, ee, force = split_vars(x, F)
    c = phys.contact if contact is None else contact
    fm = _frame_mask(phys, base_lin)
    pair = fm[:, :-1] * fm[:, 1:]
    triple = pair[:, :-1] * fm[:, 2:]
    fm_f = fm[:, None, :, None]
    if accel is None:
        accel = w.sa > 0

    parts = [
        _sqrt(w.data_lin) * (base_lin - phys.base_lin) * fm.unsqueeze(-1),
        _sqrt(w.data_ang) * (base_ang - phys.base_ang) * fm.unsqueeze(-1),
        _sqrt(w.data_ee) * (ee - phys.ee_pos) * fm_f,
        _sqrt(w.sv_lin) * (base_lin[:, 1:] - base_lin[:, :-1]) * pair.unsqueeze(-1),
        _sqrt(w.sv_ang) * (base_ang[:, 1:] - base_ang[:, :-1]) * pair.unsqueeze(-1),
        _sqrt(w.sv_ee) * (ee[:, :, 1:] - ee[:, :, :-1]) * pair[:, None, :, None],
        # keep swing-phase force variables pinned (they're masked out of the
        # dynamics, so nothing else constrains them); padded-frame force
        # variables are likewise pinned to zero
        1e-2 * (1.0 - c.unsqueeze(-1) * fm_f) * force,
        1e-4 * c.unsqueeze(-1) * fm_f * force,
    ]
    if accel:
        sa = _sqrt(w.sa)
        parts += [
            sa * (base_lin[:, 2:] - 2 * base_lin[:, 1:-1] + base_lin[:, :-2]) * triple.unsqueeze(-1),
            sa * (base_ang[:, 2:] - 2 * base_ang[:, 1:-1] + base_ang[:, :-2]) * triple.unsqueeze(-1),
            sa * (ee[:, :, 2:] - 2 * ee[:, :, 1:-1] + ee[:, :, :-2]) * triple[:, None, :, None],
        ]

    # initial/final base pins: pos + 5-frame-averaged velocity
    # (phys_optim.cpp:442-489); on the padded length, as chd_tpu's
    dt = phys.dt.unsqueeze(-1)
    k = min(5, F - 1)
    data = phys.base_lin
    v0 = (data[:, 1:k + 1] - data[:, :k]).mean(dim=1) / dt
    vf = (data[:, F - k:] - data[:, F - k - 1:-1]).mean(dim=1) / dt
    cur_v0 = (base_lin[:, 1] - base_lin[:, 0]) / dt
    cur_vf = (base_lin[:, -1] - base_lin[:, -2]) / dt
    pins = torch.stack([
        base_lin[:, 0] - data[:, 0],
        base_lin[:, -1] - data[:, -1],
        base_ang[:, 0] - phys.base_ang[:, 0],
        base_ang[:, -1] - phys.base_ang[:, -1],
        0.1 * (cur_v0 - v0),
        0.1 * (cur_vf - vf),
    ], dim=1)
    parts.append(_sqrt(w.pin) * pins)
    return torch.cat([p.flatten(1) for p in parts], dim=-1)


def _penalties(cons: Constraints, lams: Constraints, rho: Rho, active) -> list:
    """√ρ·(g + λ/ρ) per active block, the inequalities' shifted values
    hinged at 0."""
    out = []
    for name in active:
        rho_k = getattr(rho, name)
        shifted = getattr(cons, name) + getattr(lams, name) / rho_k
        if INEQ[name]:
            shifted = _hinge(shifted)
        out.append(_sqrt(rho_k) * shifted.flatten(1))
    return out


def _structure(w: CostW, rho: Rho):
    """What fixes a residual graph: the acceleration terms on or off, and the
    blocks with ρ ≠ 0 (sorted)."""
    return w.sa > 0, tuple(n for n in Constraints._fields if getattr(rho, n) != 0.0)


@functools.lru_cache(maxsize=None)
def _al_residual_fn(accel: bool, active: tuple):
    def al_residuals(x, phys, lams, w, rho):
        r = [cost_residuals(x, phys, w, accel=accel)]
        r += _penalties(constraints(x, phys), lams, rho, active)
        return torch.cat(r, dim=-1)

    def product_for(x0):
        """The JᵀJ·v kernel of this structure for a solve on CUDA
        (``physics/jtjv.py``), None elsewhere (autograd's product)."""
        from . import jtjv

        return jtjv_ops.supplier(x0, lambda: jtjv.product_for(accel, active))

    al_residuals.product_for = product_for
    return al_residuals


def make_al_residual_fn(w: CostW, rho: Rho):
    """The AL residual ``fn(x, phys, lams, w, rho)`` of the stage schedule
    (w, rho): one function object per structure, so ``lm_solve``'s graph
    cache captures one LM step a stage. ``fn.product_for(x0)`` names its
    JᵀJ·v kernel for a solve on CUDA, which ``lm_solve`` takes in place of
    the double vjp."""
    return _al_residual_fn(*_structure(w, rho))


def init_multipliers(phys: PhysInput) -> Constraints:
    x = join_vars(phys.base_lin, phys.base_ang, phys.ee_pos, torch.zeros_like(phys.ee_pos))
    return Constraints(*(torch.zeros_like(v) for v in constraints(x, phys)))


def update_multipliers(x, phys, lams: Constraints, rho: Rho, contact=None) -> Constraints:
    """λ ← λ + ρ·g (inequalities: max(λ + ρ·g, 0)); ``rho`` of floats."""
    cons = constraints(x, phys, contact=contact)
    new = []
    for name in Constraints._fields:
        rho_k, lam, cval = getattr(rho, name), getattr(lams, name), getattr(cons, name)
        if rho_k == 0.0:
            new.append(lam)
        elif INEQ[name]:
            new.append(_hinge(lam + rho_k * cval))
        else:
            new.append(lam + rho_k * cval)
    return Constraints(*new)


@functools.lru_cache(maxsize=None)
def _stage3_residual_fn(accel: bool, active: tuple):
    def residuals(x_aug, phys, lams, spec, w, rho, w_dur):
        F = phys.base_lin.shape[1]
        x = x_aug[:, :F * DOF]
        d = x_aug[:, F * DOF:].reshape(spec.durations.shape)
        c_soft = dur_lib.soft_contact(d, spec, F, phys.dt)
        r = [cost_residuals(x, phys, w, contact=c_soft, accel=accel)]
        r += _penalties(constraints(x, phys, contact=c_soft), lams, rho, active)
        r.append(dur_lib.duration_residuals(d, spec, w_dur))
        return torch.cat(r, dim=-1)

    return residuals


def make_stage3_residual_fn(w: CostW, rho: Rho):
    """Stage-3 residuals ``fn(x_aug, phys, lams, spec, w, rho, w_dur)`` over
    the augmented vector [trajectory | durations] (B, F·30 + 4·P).

    The contact schedule becomes soft_contact(durations) so constraint
    residuals carry gradients into the phase durations (the reference's
    PhaseDurations variable sets + schedule Jacobians, phys_optim.cpp:
    663-711 / nodes_variables_dynamic_phase_based.cpp)."""
    return _stage3_residual_fn(*_structure(w, rho))


@dataclasses.dataclass(frozen=True)
class SolveConfig:
    al_iters_fit: int = 2
    al_iters_dyn: int = 3
    al_iters_height: int = 3
    al_iters_durations: int = 2
    optimize_durations: bool = True
    # chd_tpu's default budget: 25 LM steps of 50 CG iterations each
    # (reference budget analog: phys_optim.cpp:571-652)
    lm: LMConfig = LMConfig(max_iters=25, cg_iters=50, init_lambda=1e-2)


def dyn_cost_for(weights: PhysWeights, accel: float = 1e-4) -> CostW:
    """The DYN/DYN_H-stage cost weights derived from pipeline PhysWeights
    (run_phys_mocap.py:33-44 / phys_optim.cpp:27-31). ``accel=0.0`` is the
    stage-3/4 variant — no accel smoothing with duration optimization
    (vel_smooth_cost.cpp:72-79)."""
    return CostW(weights.w_com_lin, weights.w_com_ang, weights.w_ee,
                 0.001, 0.001, weights.w_smooth, accel, 1e3)


def run_stage(x, phys: PhysInput, lams: Constraints, w: CostW, rho: Rho, iters: int,
              lm_cfg: LMConfig, masks: torch.Tensor, graphs=None):
    """``iters`` AL iterations of one stage: an LM solve, then a multiplier
    update. Returns (x, lams)."""
    fn = make_al_residual_fn(w, rho)
    for _ in range(iters):
        x, _ = lm_solve(fn, x, (phys, lams, w, rho), lm_cfg, masks, graphs)
        lams = update_multipliers(x, phys, lams, rho)
    return x, lams


def violation_stats_arrays(x, phys, contact=None) -> Dict[str, torch.Tensor]:
    """Each block's largest violation per problem, (B,) tensors on the
    device (no host sync)."""
    out = {}
    for name, v in constraints(x, phys, contact=contact)._asdict().items():
        v = v.flatten(1)
        out[name] = (_hinge(v) if INEQ[name] else v.abs()).amax(dim=1)
    return out


def violation_stats(x, phys, contact=None) -> Dict[str, np.ndarray]:
    """``violation_stats_arrays`` on the host: (B,) arrays."""
    return {k: v.cpu().numpy() for k, v in violation_stats_arrays(x, phys, contact).items()}


def _dyn_tol_floor(mass) -> torch.Tensor:
    """Absolute dynamics-violation tolerance floor, scaled to body weight.

    1 N per 73 kg reference body (≈1.4e-3·m·g): a fixed 1.0 N floor would
    over-bless light characters (ty is 31 kg)."""
    return mass * 9.81 / (73.0 * 9.81)


def _to_result(x, phys: PhysInput) -> PhysResult:
    base_lin, base_ang, ee, force = split_vars(x, phys.base_lin.shape[1])
    return PhysResult(dt=phys.dt, base_lin=base_lin, base_ang=base_ang, ee_pos=ee,
                      ee_force=force * phys.contact.unsqueeze(-1), contact=phys.contact)


def solve_physics(phys: PhysInput, weights: PhysWeights = PhysWeights(),
                  cfg: SolveConfig = SolveConfig(), device="cuda", dtype=torch.float32,
                  graphs=None) -> Tuple[PhysResult, PhysResult, Dict[str, float]]:
    """The FIT → DYN → HEIGHT solve of one problem. Returns (no-dynamics
    result, dynamics result, final constraint-violation stats) on the host —
    the reference's sol_out_no_dynamics / sol_out_dynamics artifacts.
    ``device`` defaults to ``cuda`` and raises where CUDA is absent."""
    from ..parallel import batch as batch_lib

    pb, lens = batch_lib.pad_phys_inputs([phys], device=device, dtype=dtype)
    res_fit, res_dyn = batch_lib.solve_physics_batch(pb, weights, cfg, graphs=graphs)
    x = join_vars(res_dyn.base_lin, res_dyn.base_ang, res_dyn.ee_pos, res_dyn.ee_force)
    stats = {k: float(v[0]) for k, v in violation_stats(x, pb).items()}
    return (batch_lib.unbatch_results(res_fit, lens)[0],
            batch_lib.unbatch_results(res_dyn, lens)[0], stats)


def solve_physics_durations(phys: PhysInput, stage2: PhysResult,
                            weights: PhysWeights = PhysWeights(),
                            cfg: SolveConfig = SolveConfig(), device="cuda",
                            dtype=torch.float32, graphs=None
                            ) -> Tuple[PhysResult, Dict[str, float], bool]:
    """Stage 3 (phys_optim.cpp:663-711) and the stage-4 polish of one
    problem, warm-started from the stage-2 result. Returns (result with the
    re-rasterized schedule, stats, durations_ok) on the host. On failure the
    caller keeps the stage-2 result (the reference's fallback :713-749)."""
    from ..parallel import batch as batch_lib

    pb, lens = batch_lib.pad_phys_inputs([phys], device=device, dtype=dtype)
    s2 = PhysResult(*(torch.as_tensor(np.asarray(v), dtype=dtype, device=pb.dt.device)[None]
                      for v in stage2))
    res, stats, ok = batch_lib.solve_physics_durations_batch(pb, s2, weights, cfg, graphs=graphs)
    return (batch_lib.unbatch_results(res, lens)[0], {k: float(v[0]) for k, v in stats.items()},
            bool(ok[0]))
