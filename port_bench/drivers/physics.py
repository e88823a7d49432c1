"""Driver of the physics refinement cells: ``solve_physics_full_batch`` on a
batch of walking clips made from the seed, at the configuration's budgets,
every stage's LM step replayed as a CUDA graph from one ``GraphCache``.

Set-up makes the clips, pads them into one batch (``pad_phys_inputs``) and
runs one call, which builds the duration specs and captures every stage's
graphs, then one replayed call. Without that second call the window's first
call ran 1.6-3.2 s slow in 5 of 14 runs on an H100: the stream
time of the steps replayed in the first 10-15 s after the capturing call
grows by up to a fifth, while the host has already queued them and the SM
clock holds 1980 MHz, whichever graphs run then. Each graph has by then been
replayed 49-74 times, so a replay of each would not cover it: it takes that
much time of replays. The window repeats the call, whole (the specs' host
work, the five stages, the flags' copy back), until ``--seconds`` have
passed: no graph may be captured inside it. The trace profiles one
replayed DYN LM step. The check solves a sample of the batch drawn from the
seed with the plain reference in float64, its phases padded to the batch's count (every
sequence is solved on its own, so a sample is judged as in the batch), and
compares the last call's final results on it.
"""
from __future__ import annotations

import dataclasses
import random
import time

import numpy as np
import torch

import harness

SAMPLE = 8  # sequences the reference solves, drawn from the seed, half from each half
CONTROLS = ("bf16", "tf32")
RESULT_KEYS = ("base_lin", "base_ang", "ee_pos", "ee_force", "contact")


class Run:
    pass


def draw_sample(seed: int, B: int) -> list:
    """The sequences the check solves: ``SAMPLE // 2`` drawn from the seed
    in each half of the batch (all of a half that holds fewer), so a fault
    confined to either half is always sampled, and one on half of each half
    escapes 8 of 32 on 0.15 % of seeds ((C(8, 4) / C(16, 4))²)."""
    rng, h = random.Random(seed), B // 2
    lo = rng.sample(range(h), min(SAMPLE // 2, h))
    hi = rng.sample(range(h, B), min(SAMPLE - len(lo), B - h))
    return sorted(lo + hi)


def solve_config(cfg: dict):
    from chd_tpu_torch.kinematics.lm import LMConfig
    from chd_tpu_torch.physics.collocation import SolveConfig

    sv = dict(cfg["solve"])
    return SolveConfig(**{k: v for k, v in sv.items() if k != "lm"}, lm=LMConfig(**sv["lm"]))


def weights(cfg: dict):
    from chd_tpu_torch.physics.types import PhysWeights

    return PhysWeights(**cfg["weights"])


def setup(cfg: dict, wl: dict, seed: int, device) -> Run:
    from chd_tpu_torch.parallel import batch as batch_lib
    from chd_tpu_torch.physics.types import PhysInput
    from chd_tpu_torch.utils.cuda_graph import GraphCache

    run = Run()
    run.cfg, run.wl, run.seed, run.device = cfg, wl, seed, device
    run.clips = harness.load("traffic", "walking").clips(seed, cfg, wl["traffic"])
    B = len(run.clips)
    run.sample = draw_sample(seed, B)
    inputs = [PhysInput(**{k: torch.from_numpy(v) for k, v in c.items()}) for c in run.clips]
    run.batch, _ = batch_lib.pad_phys_inputs(inputs, device=device, dtype=torch.float32)
    run.solve_cfg, run.weights = solve_config(cfg), weights(cfg)
    run.graphs = GraphCache() if device.type == "cuda" else None
    run.out = call(run)  # captures every stage's LM step
    run.out = call(run)  # replays through the slow first seconds after the capture
    return run


def call(run: Run):
    from chd_tpu_torch.parallel import batch as batch_lib

    return batch_lib.solve_physics_full_batch(run.batch, run.weights, run.solve_cfg,
                                              graphs=run.graphs)


def _captures(run: Run) -> int:
    return run.graphs.captures if run.graphs is not None else 0


def _unfinished(out) -> int:
    """Sequences whose final solution holds a value that is not finite."""
    res = out[2]
    bad = torch.zeros(res.base_lin.shape[0], dtype=torch.bool, device=res.base_lin.device)
    for v in (res.base_lin, res.base_ang, res.ee_pos, res.ee_force):
        bad |= ~torch.isfinite(v.flatten(1)).all(1)
    return int(bad.sum())


def window(run: Run, seconds: float) -> dict:
    captures = _captures(run)
    t0 = time.perf_counter()
    ends, failed = [], 0
    while time.perf_counter() - t0 < seconds:
        run.out = call(run)  # ends with the flags' copy to the host: the call has ended
        ends.append(time.perf_counter() - t0)
        failed += _unfinished(run.out)
    n, elapsed = len(ends), ends[-1]
    if _captures(run) != captures:
        raise RuntimeError(f"{_captures(run) - captures} CUDA graphs captured inside the "
                           "window: a stale path")
    B = len(run.clips)
    moved = float((run.out[2].contact != run.batch.contact).double().mean())
    return {"metrics": {"kinematic_seq_per_hour": B * n / elapsed * 3600},
            "attempted": n * B, "failed": failed, "calls": n, "elapsed_s": elapsed,
            "info": {"calls": n, "seconds": elapsed, "sequences_per_call": B,
                     "call_s": [b - a for a, b in zip([0.0] + ends, ends)],
                     "durations_ok": int(np.asarray(run.out[4]).sum()),
                     "schedule_moved": moved}}


def trace(run: Run) -> dict:
    """One DYN LM step replayed from the call's graph under
    ``torch.profiler``, from the last call's stage-2 solution; it may
    capture nothing."""
    from chd_tpu_torch.kinematics import lm as lm_lib
    from chd_tpu_torch.parallel import batch as batch_lib
    from chd_tpu_torch.physics import collocation as co
    from chd_tpu_torch.utils.precision import full_f32

    captures = run.graphs.captures
    pb = run.batch
    F = pb.base_lin.shape[1]
    res_dyn = run.out[1]
    x = co.join_vars(res_dyn.base_lin, res_dyn.base_ang, res_dyn.ee_pos, res_dyn.ee_force)
    dyn_cost = co.dyn_cost_for(run.weights)
    fn = co.make_al_residual_fn(dyn_cost, co.DYN_RHO)
    args = (pb, co.init_multipliers(pb), dyn_cost, co.DYN_RHO)
    masks = batch_lib._masks(F, pb, run.graphs)
    one = dataclasses.replace(run.solve_cfg.lm, max_iters=1)

    def step():
        with full_f32():
            return lm_lib.lm_solve(fn, x, args, one, masks, run.graphs)

    prof = harness.profile(torch, step)
    prof.pop("events")
    if run.graphs.captures != captures:
        raise RuntimeError("the traced step captured a graph: it is not the call's")
    return {"busy_s": prof["busy_s"], "window_s": prof["window_s"],
            "idle_share": prof["idle_share"], "step_kernels": prof["kernels"],
            "breakdown": {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}}


def outputs(run: Run) -> dict:
    """The last call's final results and flags on the sampled sequences, as
    host arrays."""
    res, ok = run.out[2], np.asarray(run.out[4])
    idx = torch.as_tensor(run.sample, device=res.base_lin.device)
    got = {k: getattr(res, k).index_select(0, idx).double().cpu().numpy() for k in RESULT_KEYS}
    got["ok"] = ok[run.sample].astype(bool)
    return got


def reference(run: Run, **kw) -> dict:
    """The reference's solve of the sampled sequences, the phases padded to
    the batch's count."""
    mod = harness.load("reference", "physics")
    return mod.solve([run.clips[i] for i in run.sample], run.cfg, run.device,
                     phases=mod.phase_count(run.clips), **kw)


def compare(run: Run, got: dict, ref: dict) -> dict:
    """``got`` (the program's, or a control's, final results) against the
    reference's ``ref``: over the sampled sequences, the largest mean COM
    distance (cm); the largest excess of the polish's last inner objective
    (the reference's schedule and multipliers, in float64) over the
    reference's own, as a share of the polish's own decrease (0: as low as
    the reference, 1: no lower than the polish's start; a share of the
    reference's objective alone read float32's floor, 0.008-45 on sound
    runs, PERF.md §2); the largest Newton-Euler violation (each
    on its own schedule, in float64) over the reference's, less 1; the
    share of ``durations_ok`` flags that differ; and the share of the
    final schedules' contact flags that differ (the duration solve's
    result, rasterised)."""
    mod = harness.load("reference", "physics")
    fin = ref["final"]
    lin = torch.as_tensor(got["base_lin"], dtype=torch.float64, device=fin["base_lin"].device)
    gap = (lin - fin["base_lin"].double()).norm(dim=-1).mean(-1) * 100.0
    c_got, c_ref, c_start = (mod.final_objective(ref, r) for r in (got, fin, ref["start"]))
    v_got, v_ref = mod.dynamics_violation(ref, got), mod.dynamics_violation(ref, fin)
    flips = np.mean(np.asarray(got["ok"], bool) != ref["ok"].cpu().numpy())
    contacts = np.mean(np.asarray(got["contact"]) != fin["contact"].cpu().numpy())
    return {"com_gap_cm": float(gap.max()),
            "cost_excess": float(((c_got - c_ref) / (c_start - c_ref)).max()),
            "dyn_excess": float((v_got / v_ref).max() - 1.0),
            "ok_flips": float(flips), "contact_flips": float(contacts)}


def control_outputs(run: Run, name: str) -> dict:
    """The control's final results on the sampled sequences, as ``outputs``
    gives the program's: the reference in float32 with its iterates held
    in bfloat16 (``bf16``, the control), or with every matrix product's
    operands rounded to TF32 (``tf32``)."""
    mod = harness.load("reference", "physics")
    kw = {"bf16": dict(dtype=torch.float32, keep=mod.bf16_state),
          "tf32": dict(dtype=torch.float32, matmul=mod.matmul_tf32)}.get(name)
    if kw is None:
        raise ValueError(f"no control {name!r}; one of {CONTROLS}")
    c = reference(run, **kw)
    got = {k: c["final"][k].double().cpu().numpy() for k in RESULT_KEYS}
    got["ok"] = c["ok"].cpu().numpy()
    return got


def check(run: Run, control: str = None) -> list:
    """The numbers compared, each with its limit: the last call's final
    results on the sampled sequences against the reference's; with
    ``control`` (one of ``CONTROLS``) the control's results take the
    program's place. The reference is solved once a run."""
    got = outputs(run) if control is None else None
    run.out, run.graphs, run.batch = None, None, None  # the program's state goes first
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    if getattr(run, "ref", None) is None:
        run.ref = reference(run)
    if control is not None:
        got = control_outputs(run, control)
    res = compare(run, got, run.ref)
    lim = run.wl["limits"]
    return [{"name": k, "value": res[k], "limit": lim[k]} for k in lim]
