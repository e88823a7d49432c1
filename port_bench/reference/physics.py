"""Plain reference of the physics refinement's staged solve (plain torch,
float64 by default), written down from the pipeline's definition with no
part of the program: a frozen statement of the same mathematics.

The model is TOWR's single rigid body with time-varying inertia
(``humanoid_rigid_body_dynamics.cpp:89-115``), 4 end effectors (toes,
heels) and a flat floor. Variables are per frame: COM position, base
eulers (R = Rz Ry Rx), 4 foot positions and 4 foot forces, 30 a frame.

1. constraints: Newton-Euler with I_w = R I Rᵀ, ω = M(θ)·θ̇ and central
   differences; leg and heel reach (½‖p − (R·hip + c)‖² ≤ ½L²); the
   toe-heel distance; the feet on the floor in contact and no slip between
   contact frames; the friction cone and the normal force's bounds; the
   feet above the floor;
2. costs: the data, velocity and (DYN) acceleration smoothing terms,
   swing forces pinned, and the first and last frames' position and
   5-frame velocity pinned (``phys_optim.cpp:442-489``);
3. the augmented Lagrangian: each active block as √ρ·(g + λ/ρ), the
   inequalities hinged at 0; after each inner solve λ ← λ + ρg (inequalities
   max(·, 0));
4. the inner solve: Levenberg-Marquardt with PCG under the exact
   frame-coloring diagonal (Marquardt scaling), fixed budgets;
5. stages FIT → DYN → HEIGHT (``phys_optim.cpp:554-661``), then the phase
   durations (``:663-711``): the schedule a soft function of the durations
   (a sigmoid window per contact phase at the frame centres), which join
   the variables with a cost toward their start, each foot's total time
   and a minimum length; then the schedule rasterised at the midpoint and
   a polish with the durations frozen (``:713-749``);
6. ``durations_ok``, the fallback rule: the polish is kept where its
   largest dynamics violation is at most twice stage 2's (or 1 N per 73
   kg) and its largest terrain violation at most twice stage 2's (or 2
   cm).

Departures from the C++ reference, all the port's design and all stated in
the configuration: the variables live on the frame grid (no phase-based
splines) with finite-difference derivatives; IPOPT's interior point is an
augmented Lagrangian over LM with fixed budgets; swing-phase forces are
masked by the schedule rather than constrained; the phase durations are a
soft schedule in the LM variables rather than TOWR's duration variable
sets; the fallback rule reads the violations, not IPOPT's status; the
initial durations and total time are float32 numbers, as the port's
duration spec holds them. The reference takes sequences of one length
(no padded frames) and pads the phases to ``phases``.

On a card each stage's LM step is captured once as a CUDA graph and
replayed (eager, its ~55,000 launches a step would outlast the benchmark's
window); on the CPU it runs eagerly. ``dtype``, ``matmul`` (the matrix
products) and ``keep`` (applied to every iterate) give the controls.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

FIELDS = ("dt", "base_lin", "base_ang", "ee_pos", "contact", "left_hip", "right_hip",
          "inertia", "mass", "max_leg_length", "max_heel_length", "heel_dist",
          "floor_normal", "floor_point")
BLOCKS = ("dyn", "force", "heel", "height", "leg", "slip", "terrain")
INEQ = frozenset(("force", "height", "leg"))
DOF = 30


class Data(NamedTuple):
    dt: torch.Tensor               # (B,)
    base_lin: torch.Tensor         # (B, F, 3)
    base_ang: torch.Tensor         # (B, F, 3)
    ee_pos: torch.Tensor           # (B, 4, F, 3)
    contact: torch.Tensor          # (B, 4, F)
    left_hip: torch.Tensor         # (B, F, 3)
    right_hip: torch.Tensor        # (B, F, 3)
    inertia: torch.Tensor          # (B, F, 3, 3)
    mass: torch.Tensor             # (B,)
    max_leg_length: torch.Tensor   # (B,)
    max_heel_length: torch.Tensor  # (B,)
    heel_dist: torch.Tensor        # (B,)
    floor_normal: torch.Tensor     # (B, 3)
    floor_point: torch.Tensor      # (B, 3)


class Blocks(NamedTuple):
    dyn: torch.Tensor      # (B, F, 6)
    force: torch.Tensor    # (B, 4, F, 3)
    heel: torch.Tensor     # (B, 2, F)
    height: torch.Tensor   # (B, 4, F)
    leg: torch.Tensor      # (B, 4, F)
    slip: torch.Tensor     # (B, 4, F-1, 3)
    terrain: torch.Tensor  # (B, 4, F)


class Spec(NamedTuple):
    durations: torch.Tensor  # (B, 4, P) s
    mask: torch.Tensor       # (B, 4, P) 1 on real phases
    stance: torch.Tensor     # (B, 4, P) 1 on contact phases
    total: torch.Tensor      # (B,) s


def data(clips, device, dtype) -> Data:
    return Data(*(torch.as_tensor(np.stack([np.asarray(c[k]) for c in clips]), dtype=dtype,
                                  device=device) for k in FIELDS))


# -- durations of a schedule ----------------------------------------------------------

def phase_durations(flags, dt: float) -> list:
    """Binary per-frame flags → phase durations (``towr_utils.py:435-449``:
    F − 1 steps, the last frame in the trailing phase)."""
    out, prev, cur = [], flags[0], 0.0
    for i in range(len(flags) - 1):
        if flags[i] != prev:
            out.append(cur)
            cur = dt
        else:
            cur += dt
        prev = flags[i]
    out.append(cur)
    return out


def phase_count(clips) -> int:
    """The most phases any foot of ``clips`` has."""
    return max(len(phase_durations(np.asarray(c["contact"])[e], float(c["dt"])))
               for c in clips for e in range(4))


def spec(clips, phases: Optional[int], device, dtype) -> Spec:
    P = phases or phase_count(clips)
    B = len(clips)
    d, m, st, tot = (np.zeros((B, 4, P)), np.zeros((B, 4, P)), np.zeros((B, 4, P)),
                     np.zeros(B))
    for b, c in enumerate(clips):
        contact = np.asarray(c["contact"])
        for e in range(4):
            ds = phase_durations(contact[e], float(c["dt"]))
            d[b, e, :len(ds)] = ds
            m[b, e, :len(ds)] = 1.0
            first = bool(contact[e, 0])
            for k in range(len(ds)):
                st[b, e, k] = 1.0 if (k % 2 == 0) == first else 0.0
            if e == 0:
                tot[b] = np.sum(ds)
    f32 = np.float32
    return Spec(*(torch.as_tensor(a.astype(f32), dtype=dtype, device=device)
                  for a in (d, m, st, tot)))


def _last_phase(mask):
    last = (mask.sum(-1) - 1).long()
    return torch.arange(mask.shape[-1], device=mask.device) == last.unsqueeze(-1)


def soft_schedule(durs, sp: Spec, F: int, dt, tau):
    """(B, 4, F) contact values of ``durs``: each contact phase's window
    σ((t − start)/τ)·σ((end − t)/τ) at the frame centres, summed and
    clipped to [0, 1]; the last real phase is open-ended."""
    t = ((torch.arange(F, dtype=durs.dtype, device=durs.device) + 0.5)
         * dt.unsqueeze(-1))[:, None, None, :]
    tau = tau[:, None, None, None]
    d = durs * sp.mask
    ends = torch.cumsum(d, dim=-1)
    starts = ends - d
    ends = torch.where(_last_phase(sp.mask), 1e6, ends)
    win = torch.sigmoid((t - starts.unsqueeze(-1)) / tau) * torch.sigmoid(
        (ends.unsqueeze(-1) - t) / tau)
    live = (sp.stance * sp.mask * (d > 1e-6)).unsqueeze(-1)
    zero = win.new_zeros(())
    return torch.minimum(torch.maximum((win * live).sum(dim=2), zero), zero + 1.0)


def duration_terms(durs, sp: Spec, w_dur: float, rho_total: float, min_len: float):
    """Cost toward the start (all but each foot's last phase), each foot's
    total time, the minimum length: (B, 8P + 4)."""
    m = sp.mask
    cost = math.sqrt(w_dur) * (m * ~_last_phase(m)) * (durs - sp.durations)
    total = math.sqrt(rho_total) * ((durs * m).sum(-1) - sp.total.unsqueeze(-1))
    short = math.sqrt(rho_total) * m * torch.maximum(min_len - durs, durs.new_zeros(()))
    return torch.cat([cost.flatten(1), total.flatten(1), short.flatten(1)], dim=-1)


# -- the rigid body ---------------------------------------------------------------

def rot_zyx(a):
    x, y, z = a.unbind(-1)
    cx, sx, cy, sy, cz, sz = (torch.cos(x), torch.sin(x), torch.cos(y), torch.sin(y),
                              torch.cos(z), torch.sin(z))
    return torch.stack([cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx,
                        sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx,
                        -sy, cy * sx, cy * cx], -1).unflatten(-1, (3, 3))


def rate_matrix(a):
    """ω = M(θ)·θ̇, M's columns Rz·Ry·x̂, Rz·ŷ, ẑ."""
    y, z = a[..., 1], a[..., 2]
    cy, sy, cz, sz = torch.cos(y), torch.sin(y), torch.cos(z), torch.sin(z)
    o, i = torch.zeros_like(y), torch.ones_like(y)
    return torch.stack([cz * cy, -sz, o, sz * cy, cz, o, -sy, o, i], -1).unflatten(-1, (3, 3))


def ddt(x, dt):
    """d/dt along the frame axis (1): central inside, one-sided at the ends."""
    dt = dt.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.cat([(x[:, 1:2] - x[:, :1]) / dt, (x[:, 2:] - x[:, :-2]) / (2.0 * dt),
                      (x[:, -1:] - x[:, -2:-1]) / dt], dim=1)


def split(x, F: int):
    m = x.reshape(x.shape[0], F, DOF)
    return (m[..., 0:3], m[..., 3:6], m[..., 6:18].unflatten(-1, (4, 3)).transpose(1, 2),
            m[..., 18:].unflatten(-1, (4, 3)).transpose(1, 2))


def join(lin, ang, ee, force):
    B, F = lin.shape[:2]
    return torch.cat([lin, ang, ee.transpose(1, 2).reshape(B, F, 12),
                      force.transpose(1, 2).reshape(B, F, 12)], -1).reshape(B, -1)


class Model:
    """The constraints and costs of one precision (``mm``: the matrix
    products)."""

    def __init__(self, cfg: dict, mm: Callable):
        self.cfg, self.mm = cfg, mm
        md = cfg["model"]
        self.g, self.mu, self.fmax = md["gravity"], md["friction"], md["force_limit"]

    def mv(self, m, v):
        return self.mm(m, v.unsqueeze(-1)).squeeze(-1)

    def blocks(self, x, d: Data, c) -> Blocks:
        F = d.base_lin.shape[1]
        lin, ang, ee, f = split(x, F)
        n, p0 = d.floor_normal[:, None, None, :], d.floor_point[:, None, None, :]
        fe = f * c.unsqueeze(-1)
        # Newton-Euler (gravity along −n)
        R = rot_zyx(ang)
        Iw = self.mm(self.mm(R, d.inertia), R.transpose(-1, -2))
        om = self.mv(rate_matrix(ang), ddt(ang, d.dt))
        omd = ddt(om, d.dt)
        tau = torch.linalg.cross(fe, lin.unsqueeze(1) - ee, dim=-1).sum(1)
        acc = ddt(ddt(lin, d.dt), d.dt)
        m = d.mass[:, None, None]
        dyn = torch.cat([self.mv(Iw, omd) + torch.linalg.cross(om, self.mv(Iw, om), dim=-1) - tau,
                         m * acc - fe.sum(1) - m * self.g * (-d.floor_normal).unsqueeze(1)], -1)
        # reach of toes and heels from their hip
        hips = torch.stack([d.left_hip, d.right_hip, d.left_hip, d.right_hip], 1)
        hip_w = self.mm(R.unsqueeze(1), hips.unsqueeze(-1)).squeeze(-1) + lin.unsqueeze(1)
        L = torch.stack([d.max_leg_length, d.max_leg_length, d.max_heel_length,
                         d.max_heel_length], 1)
        leg = 0.5 * ((ee - hip_w) ** 2).sum(-1) - 0.5 * (L.unsqueeze(-1) ** 2)
        heel = 0.5 * ((ee[:, :2] - ee[:, 2:]) ** 2).sum(-1) - 0.5 * d.heel_dist[:, None, None] ** 2
        h = ((ee - p0) * n).sum(-1)
        slip = (c[..., :-1] * c[..., 1:]).unsqueeze(-1) * (ee[:, :, 1:] - ee[:, :, :-1])
        fn = (fe * n).sum(-1)
        ft = fe - fn.unsqueeze(-1) * n
        cone = torch.stack([-fn, fn - self.fmax, (ft * ft).sum(-1) - self.mu ** 2 * fn ** 2], -1)
        return Blocks(dyn=dyn, force=cone, heel=heel, height=-h, leg=leg, slip=slip,
                      terrain=c * h)

    def costs(self, x, d: Data, c, w: dict):
        F = d.base_lin.shape[1]
        lin, ang, ee, f = split(x, F)
        s = {k: math.sqrt(v) for k, v in w.items()}
        parts = [s["data_lin"] * (lin - d.base_lin), s["data_ang"] * (ang - d.base_ang),
                 s["data_ee"] * (ee - d.ee_pos),
                 s["sv_lin"] * (lin[:, 1:] - lin[:, :-1]), s["sv_ang"] * (ang[:, 1:] - ang[:, :-1]),
                 s["sv_ee"] * (ee[:, :, 1:] - ee[:, :, :-1]),
                 1e-2 * (1.0 - c.unsqueeze(-1)) * f, 1e-4 * c.unsqueeze(-1) * f]
        if w["sa"] > 0:
            parts += [s["sa"] * (v[..., 2:, :] - 2 * v[..., 1:-1, :] + v[..., :-2, :])
                      for v in (lin, ang, ee)]
        dt = d.dt.unsqueeze(-1)
        k = min(5, F - 1)
        v0 = (d.base_lin[:, 1:k + 1] - d.base_lin[:, :k]).mean(1) / dt
        vf = (d.base_lin[:, F - k:] - d.base_lin[:, F - k - 1:-1]).mean(1) / dt
        pins = torch.stack([lin[:, 0] - d.base_lin[:, 0], lin[:, -1] - d.base_lin[:, -1],
                            ang[:, 0] - d.base_ang[:, 0], ang[:, -1] - d.base_ang[:, -1],
                            0.1 * ((lin[:, 1] - lin[:, 0]) / dt - v0),
                            0.1 * ((lin[:, -1] - lin[:, -2]) / dt - vf)], 1)
        parts.append(s["pin"] * pins)
        return torch.cat([p.flatten(1) for p in parts], -1)

    def al(self, x, d: Data, c, w: dict, rho: dict, lams: Blocks):
        g = self.blocks(x, d, c)
        r = [self.costs(x, d, c, w)]
        for name in BLOCKS:
            if rho.get(name, 0.0):
                v = getattr(g, name) + getattr(lams, name) / rho[name]
                if name in INEQ:
                    v = torch.maximum(v, v.new_zeros(()))
                r.append(math.sqrt(rho[name]) * v.flatten(1))
        return torch.cat(r, -1)

    def update(self, x, d: Data, c, rho: dict, lams: Blocks) -> Blocks:
        g = self.blocks(x, d, c)
        out = []
        for name in BLOCKS:
            lam = getattr(lams, name)
            if rho.get(name, 0.0):
                lam = lam + rho[name] * getattr(g, name)
                if name in INEQ:
                    lam = torch.maximum(lam, lam.new_zeros(()))
            out.append(lam)
        return Blocks(*out)

    def violations(self, x, d: Data, c) -> dict:
        """Each block's largest violation per sequence, (B,)."""
        out = {}
        for name, v in self.blocks(x, d, c)._asdict().items():
            v = v.flatten(1)
            out[name] = (torch.maximum(v, v.new_zeros(())) if name in INEQ else v.abs()).amax(1)
        return out


# -- replay of fixed steps -----------------------------------------------------

class Replay:
    """``iters`` times ``state = step(state, inputs)``: on a card each key's
    step is captured once as a CUDA graph and replayed with its state and
    inputs copied in; on the CPU it runs eagerly."""

    def __init__(self):
        self.graphs = {}

    def run(self, key, step, state: tuple, inputs: tuple, iters: int) -> tuple:
        if state[0].device.type != "cuda":
            for _ in range(iters):
                state = step(state, inputs)
            return state
        if key not in self.graphs:
            st = tuple(t.clone() for t in state)
            inp = tuple(t.clone() for t in inputs)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):  # lazy initialisation stays out of the capture
                step(tuple(t.clone() for t in st), inp)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for t, v in zip(st, step(st, inp)):
                    t.copy_(v)
            self.graphs[key] = (graph, st, inp)
        graph, st, inp = self.graphs[key]
        for t, v in zip(st + inp, state + inputs):
            t.copy_(v)
        for _ in range(iters):
            graph.replay()
        return tuple(t.clone() for t in st)


# -- Levenberg-Marquardt ------------------------------------------------------

def coloring_masks(F: int, extra: int, dtype, device):
    """One tangent per (dof, frame mod 3) (residuals couple frames at most 2
    apart, so each gives its dofs' diag(JᵀJ) exactly), then one per extra
    variable."""
    n = F * DOF
    m = np.zeros((3 * DOF + extra, n + extra))
    for d in range(DOF):
        for c in range(3):
            m[3 * d + c, np.arange(c, F, 3) * DOF + d] = 1.0
    m[3 * DOF:, n:] = np.eye(extra)
    return torch.as_tensor(m, dtype=dtype, device=device)


def lm(res: Callable, x0, inputs: tuple, lmc: dict, keep: Callable, replay: Replay, key):
    """``lmc["max_iters"]`` LM steps on ½‖res(x, inputs)‖², ``inputs[-1]``
    the coloring masks. Returns x."""
    B = x0.shape[0]
    lam = torch.full((B, 1), lmc["init_lambda"], dtype=x0.dtype, device=x0.device)
    cost = 0.5 * (res(x0, inputs) ** 2).sum(-1, keepdim=True)

    def step(state, inp):
        x, lam, cost = state
        masks = inp[-1]
        r, vjp_fn = torch.func.vjp(lambda v: res(v, inp), x)
        g = vjp_fn(r)[0]
        _, lin = torch.func.vjp(lambda cot: vjp_fn(cot)[0], torch.zeros_like(r))

        def jtjv(v):
            return vjp_fn(lin(v)[0])[0]

        m = masks.unsqueeze(1).expand((masks.shape[0],) + x.shape)
        diag = torch.func.vmap(lambda mk: mk * jtjv(mk))(m).sum(0)
        scale = torch.clamp(diag, min=lmc["diag_floor"])
        inv_diag = 1.0 / (scale * (1.0 + lam))
        b = -g
        dx, rr = torch.zeros_like(b), b
        z = inv_diag * b
        p, rz = z, (b * z).sum(-1, keepdim=True)
        for _ in range(lmc["cg_iters"]):
            Ap = jtjv(p) + lam * scale * p
            den = (p * Ap).sum(-1, keepdim=True)
            alpha = torch.where(den > 0, rz / torch.clamp(den, min=1e-30), 0.0)
            dx, rr = dx + alpha * p, rr - alpha * Ap
            z = inv_diag * rr
            rz_new = (rr * z).sum(-1, keepdim=True)
            p = z + rz_new / torch.clamp(rz, min=1e-30) * p
            rz = rz_new
        x_new = keep(x + dx)
        c_new = 0.5 * (res(x_new, inp) ** 2).sum(-1, keepdim=True)
        ok = c_new < cost
        lam = torch.clamp(torch.where(ok, lam * lmc["lambda_down"], lam * lmc["lambda_up"]),
                          lmc["min_lambda"], lmc["max_lambda"])
        return torch.where(ok, x_new, x), lam, torch.where(ok, c_new, cost)

    return replay.run(key, step, (x0, lam, cost), inputs, lmc["max_iters"])[0]


# -- the staged solve ----------------------------------------------------------

def stage_settings(cfg: dict) -> dict:
    """Each stage's cost weights and penalties from the configuration."""
    st, w = cfg["stages"], cfg["weights"]
    dyn = {"data_lin": w["w_com_lin"], "data_ang": w["w_com_ang"], "data_ee": w["w_ee"],
           "sv_ee": w["w_smooth"], **st["dyn"]["cost"]}
    polish = dict(dyn, sa=st["durations"]["sa"])
    return {"fit": (st["fit"]["cost"], st["fit"]["rho"]), "dyn": (dyn, st["dyn"]["rho"]),
            "height": (dyn, st["height"]["rho"]), "stage3": (polish, st["height"]["rho"]),
            "stage4": (polish, st["height"]["rho"])}


def zeros_like_blocks(model: Model, x, d: Data) -> Blocks:
    return Blocks(*(torch.zeros_like(v) for v in model.blocks(x, d, d.contact)))


def exact(x):
    return x


def bf16_state(x):
    """An iterate held in bfloat16: the control's solver state."""
    return x.to(torch.bfloat16).to(x.dtype)


def tf32(x):
    """float32 rounded to TF32's 10-bit mantissa, to nearest."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul_plain(a, b):
    return torch.matmul(a, b)


def matmul_tf32(a, b):
    return torch.matmul(tf32(a), tf32(b))


def result(x, d: Data, c) -> dict:
    """The solution as the program returns it: forces masked by ``c``."""
    lin, ang, ee, f = split(x, d.base_lin.shape[1])
    return {"base_lin": lin, "base_ang": ang, "ee_pos": ee, "ee_force": f * c.unsqueeze(-1),
            "contact": c}


def solve(clips, cfg: dict, device, dtype=torch.float64, phases: Optional[int] = None,
          matmul: Callable = matmul_plain, keep: Callable = exact) -> dict:
    """The staged solve of ``clips`` (dicts in the keys of ``FIELDS``, one
    length), the phases padded to ``phases``. Returns device tensors:
    ``fit``, ``dyn`` (after HEIGHT), ``final`` (the polish, on its
    rasterised schedule) and ``start`` (the polish's start on that
    schedule) as ``result`` dicts, ``x`` (each stage's
    variables), ``durations``, ``stats`` and ``stats2`` (the polish's and
    stage 2's largest violations), ``ok`` (B,) bool, and what scores a
    solution: ``data``, ``final_data`` (the rasterised schedule),
    ``lams4`` (the multipliers of the polish's last inner solve)."""
    sv, lmc = cfg["solve"], cfg["solve"]["lm"]
    dur = cfg["stages"]["durations"]
    model = Model(cfg, matmul)
    d = data(clips, device, dtype)
    sp = spec(clips, phases, device, dtype)
    B, F = d.base_lin.shape[:2]
    n = F * DOF
    settings = stage_settings(cfg)
    replay = Replay()
    masks = coloring_masks(F, 0, dtype, device)
    flat = tuple(d)
    nd, nb = len(FIELDS), len(BLOCKS)

    def al_res(name):
        w, rho = settings[name]

        def res(x, inp):
            dd, lams = Data(*inp[:nd]), Blocks(*inp[nd:nd + nb])
            return model.al(x, dd, dd.contact, w, rho, lams)
        return res

    x = join(d.base_lin, d.base_ang, d.ee_pos, torch.zeros_like(d.ee_pos))
    lams = zeros_like_blocks(model, x, d)
    xs = {}
    iters = {"fit": sv["al_iters_fit"], "dyn": sv["al_iters_dyn"],
             "height": sv["al_iters_height"]}
    for name in ("fit", "dyn", "height"):
        res = al_res(name)
        for _ in range(iters[name]):
            x = lm(res, x, flat + tuple(lams) + (masks,), lmc, keep, replay, name)
            lams = model.update(x, d, d.contact, settings[name][1], lams)
        xs[name] = x
    fit = result(xs["fit"], d, d.contact)
    dyn = result(x, d, d.contact)

    # stage 3: [trajectory | durations] behind the soft schedule
    w3, rho3 = settings["stage3"]
    P = sp.durations.shape[-1]
    masks3 = coloring_masks(F, 4 * P, dtype, device)
    tau = d.dt * dur["tau_frames"]

    def res3(xa, inp):
        dd, lams, s = Data(*inp[:nd]), Blocks(*inp[nd:nd + nb]), Spec(*inp[nd + nb:nd + nb + 4])
        durs = xa[:, n:].reshape(s.durations.shape)
        c = soft_schedule(durs, s, F, dd.dt, dd.dt * dur["tau_frames"])
        return torch.cat([model.al(xa[:, :n], dd, c, w3, rho3, lams),
                          duration_terms(durs, s, cfg["weights"]["w_dur"], dur["rho_total"],
                                         dur["min_duration"])], -1)

    x2 = join(dyn["base_lin"], dyn["base_ang"], dyn["ee_pos"], dyn["ee_force"])
    xa = torch.cat([x2, sp.durations.reshape(B, -1)], -1)
    lams = zeros_like_blocks(model, x2, d)
    for _ in range(sv["al_iters_durations"]):
        xa = lm(res3, xa, flat + tuple(lams) + tuple(sp) + (masks3,), lmc, keep, replay,
                "stage3")
        c_soft = soft_schedule(xa[:, n:].reshape(sp.durations.shape), sp, F, d.dt, tau)
        lams = model.update(xa[:, :n], d, c_soft, rho3, lams)
    xs["stage3"] = xa
    durs = xa[:, n:].reshape(sp.durations.shape)
    hard = (soft_schedule(durs, sp, F, d.dt, d.dt * dur["raster_tau_frames"]) > 0.5).to(dtype)

    # stage 4: the polish on the rasterised schedule, durations frozen
    d4 = d._replace(contact=hard)
    flat4 = tuple(d4)
    res4 = al_res("stage4")
    x = xa[:, :n]
    start = result(x, d4, hard)
    lams = zeros_like_blocks(model, x, d4)
    for _ in range(max(sv["al_iters_height"], 1)):
        lams4 = lams
        x = lm(res4, x, flat4 + tuple(lams) + (masks,), lmc, keep, replay, "stage4")
        lams = model.update(x, d4, hard, settings["stage4"][1], lams)
    xs["stage4"] = x

    ok_cfg = cfg["stages"]["ok"]
    stats = model.violations(x, d4, hard)
    stats2 = model.violations(x2, d, d.contact)
    ok = ((stats["dyn"] <= torch.maximum(ok_cfg["dyn_factor"] * stats2["dyn"],
                                         d.mass * ok_cfg["dyn_floor_n_per_kg"]))
          & (stats["terrain"] <= torch.clamp(ok_cfg["terrain_factor"] * stats2["terrain"],
                                             min=ok_cfg["terrain_floor_m"])))
    return {"fit": fit, "dyn": dyn, "final": result(x, d4, hard), "start": start, "x": xs,
            "durations": durs,
            "stats": stats, "stats2": stats2, "ok": ok, "data": d, "final_data": d4,
            "lams4": lams4, "model": model}


def final_objective(ref: dict, res: dict) -> torch.Tensor:
    """½‖r‖² per sequence of the polish's last inner objective (the
    reference's schedule and multipliers) at a solution ``res`` (a
    ``result`` dict, forces masked), in the reference's precision."""
    d4 = ref["final_data"]
    model = ref["model"]
    w, rho = stage_settings(model.cfg)["stage4"]
    x = join(*(torch.as_tensor(res[k], dtype=d4.dt.dtype, device=d4.dt.device)
               for k in ("base_lin", "base_ang", "ee_pos", "ee_force")))
    r = model.al(x, d4, d4.contact, w, rho, ref["lams4"])
    return 0.5 * (r.double() ** 2).sum(-1)


def dynamics_violation(ref: dict, res: dict) -> torch.Tensor:
    """The largest Newton-Euler violation (N, N·m) per sequence of a
    solution on its own schedule, in the reference's precision."""
    d = ref["data"]

    def t(a):
        return torch.as_tensor(a, dtype=d.dt.dtype, device=d.dt.device)

    c = t(res["contact"])
    x = join(*(t(res[k]) for k in ("base_lin", "base_ang", "ee_pos", "ee_force")))
    return ref["model"].blocks(x, d, c).dyn.abs().flatten(1).amax(1).double()
