"""Driver of the kinematic refinement cells: ``optimize_trajectory_batch``
on a batch of problems made from the seed, at the configuration's budget,
its solver steps replayed as CUDA graphs from one ``GraphCache``.

Set-up makes the problems and the program's template skeleton, and runs one
call, which captures the graphs. The window repeats the call, whole, until
``--seconds`` have passed: no graph may be captured inside it. The trace
replays the call's stages from outside (IK, LM 1, floor, LM 2) with a CUDA
event between them, and profiles one replayed LM step. The check compares
the last call's results with the plain reference's solve of the same
problems in float64, on a sample of the batch drawn from the seed (every
sequence is solved on its own, so a sample is judged as in the batch; the
reference's eager float64 steps cost about the same at any batch, and
would outlast the window on all 16).
"""
from __future__ import annotations

import random
import time

import numpy as np
import torch

import harness

SAMPLE = 6  # sequences the reference solves, drawn from the seed
CONTROLS = ("bf16", "tf32")


class Run:
    pass


def skeleton(cfg: dict):
    from chd_tpu_torch.core.animation import Animation

    sk = cfg["skeleton"]
    J = len(sk["parents"])
    offsets = np.asarray(sk["offsets"], np.float64)
    rot = np.zeros((1, J, 4))
    rot[..., 0] = 1.0
    return Animation(rot, offsets[None].copy(), np.asarray(sk["orients"], np.float64), offsets,
                     list(sk["parents"]))


def lm_config(cfg: dict):
    from chd_tpu_torch.kinematics.lm import LMConfig

    return LMConfig(**cfg["kinematic"]["lm"])


def setup(cfg: dict, wl: dict, seed: int, device) -> Run:
    from chd_tpu_torch.utils.cuda_graph import GraphCache

    run = Run()
    run.cfg, run.wl, run.seed, run.device = cfg, wl, seed, device
    run.problems = harness.load("traffic", "kinematic").problems(seed, cfg, wl["traffic"])
    B = len(run.problems)
    run.sample = sorted(random.Random(seed).sample(range(B), min(SAMPLE, B)))
    run.skel = skeleton(cfg)
    run.lm_cfg = lm_config(cfg)
    run.graphs = GraphCache() if device.type == "cuda" else None
    run.out = call(run)  # captures the IK iteration and the LM step
    return run


def call(run: Run):
    from chd_tpu_torch.kinematics import batch as batch_lib

    kin = run.cfg["kinematic"]
    cam = run.cfg["camera"]
    return batch_lib.optimize_trajectory_batch(
        run.problems, run.skel, cam_focal=tuple(cam["focal"]), cam_pp=tuple(cam["pp"]),
        ik_iterations=kin["ik_iterations"], lm_cfg=run.lm_cfg, device=run.device,
        ik_solver=kin["ik_solver"], graphs=run.graphs)


def _captures(run: Run) -> int:
    return run.graphs.captures if run.graphs is not None else 0


def window(run: Run, seconds: float) -> dict:
    captures = _captures(run)
    t0 = time.perf_counter()
    ends = []
    while time.perf_counter() - t0 < seconds:
        run.out = call(run)  # returns host arrays: the call has ended
        ends.append(time.perf_counter() - t0)
    n, elapsed = len(ends), ends[-1]
    if _captures(run) != captures:
        raise RuntimeError(f"{_captures(run) - captures} CUDA graphs captured inside the "
                           "window: a stale path")
    B = len(run.problems)
    return {"metrics": {"kinematic_seq_per_hour": B * n / elapsed * 3600},
            "attempted": n * B, "failed": 0, "calls": n, "elapsed_s": elapsed,
            "info": {"calls": n, "seconds": elapsed, "sequences_per_call": B,
                     "call_s": [b - a for a, b in zip([0.0] + ends, ends)]}}


def trace(run: Run) -> dict:
    """The call's stages replayed from the same graphs with a CUDA event
    between them (no host sync), then one replayed stage-1 LM step under
    ``torch.profiler``. The replay has to give the last call's root paths
    and pruned contacts bit for bit, or it no longer times the call's
    stages and the run fails."""
    import dataclasses

    from chd_tpu_torch.kinematics import batch as batch_lib
    from chd_tpu_torch.kinematics import trajectory as traj_lib
    from chd_tpu_torch.kinematics.ik import IKConfig

    kin = run.cfg["kinematic"]
    cam = run.cfg["camera"]
    arrs, F = batch_lib.prepare_batch_arrays(run.problems, run.skel, tuple(cam["focal"]),
                                             tuple(cam["pp"]), run.device)
    ik_cfg = IKConfig(iterations=kin["ik_iterations"], damping=kin["ik_damping"],
                      solver=kin["ik_solver"], cg_iters=kin["ik_cg_iters"])
    consts = batch_lib.batch_consts(run.skel.parents, F, ik_cfg, run.device, torch.float32,
                                    run.graphs)
    captures = run.graphs.captures
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    zero3 = torch.zeros((arrs["vc"].shape[0], 3), device=run.device)
    ev[0].record()
    x0 = batch_lib.initial_x(*batch_lib.ik_init_batch(arrs, consts, run.graphs))
    ev[1].record()
    data1 = batch_lib.make_data(arrs, consts, arrs["vc"], zero3, zero3)
    x1 = batch_lib.lm_stage(x0, data1, traj_lib.STAGE1, consts, run.lm_cfg, run.graphs)
    ev[2].record()
    normals, points, vc2 = batch_lib.floor_stage(x1, arrs, consts)
    ev[3].record()
    x2 = batch_lib.lm_stage(x1, batch_lib.make_data(arrs, consts, vc2, normals, points),
                            traj_lib.STAGE2, consts, run.lm_cfg, run.graphs)
    ev[4].record()
    torch.cuda.synchronize()
    ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]
    B = len(run.problems)
    root = x2.reshape(B, F, -1)[..., :3].cpu().numpy()
    vc2 = vc2.cpu().numpy()
    if not all(np.array_equal(root[i], r.anim.positions[:, 0])
               and np.array_equal(vc2[i], r.vel_constraints) for i, r in enumerate(run.out)):
        raise RuntimeError("the replayed stages' root paths or contacts differ from "
                           "optimize_trajectory_batch's: they are not the call's stages")
    one = dataclasses.replace(run.lm_cfg, max_iters=1)
    prof = harness.profile(torch, lambda: batch_lib.lm_stage(x0, data1, traj_lib.STAGE1, consts,
                                                             one, run.graphs))
    prof.pop("events")
    if run.graphs.captures != captures:
        raise RuntimeError("the traced stages captured a graph: they are not the call's")
    return {"ik_ms": ms[0], "lm_ms": ms[1] + ms[3], "floor_ms": ms[2],
            "lm_steps": 2 * run.lm_cfg.max_iters, "stage_ms": ms,
            "busy_s": prof["busy_s"], "window_s": prof["window_s"],
            "idle_share": prof["idle_share"],
            "breakdown": {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}}


def outputs(run: Run) -> dict:
    """The last call's results on the sampled sequences, as host arrays."""
    res = [run.out[i] for i in run.sample]
    return {"joints": np.stack([r.pose3d for r in res]),
            "rotations": np.stack([r.anim.rotations for r in res]),
            "root": np.stack([r.anim.positions[:, 0] for r in res]),
            "normals": np.stack([r.floor_normal for r in res]),
            "points": np.stack([r.floor_point for r in res]),
            "vc": np.stack([r.vel_constraints for r in res])}


def compare(run: Run, got: dict, ref: dict) -> dict:
    """``got`` (the program's, or a control's, results) against the
    reference's ``ref``: the largest over sequences of the mean joint gap
    (cm), of the stage-2 objective's excess over the reference's (both
    scored in float64 on the reference's floor and contacts), of the floor
    planes' offset at the reference's point (cm) and angle (1 - |cos|).
    The pruned contacts follow from the plane; they are not compared on
    their own, since the control (iterates in bfloat16) leaves them
    unchanged on some seeds (PERF.md)."""
    mod = harness.load("reference", "kinematic")
    pb = ref["problem"]
    dev = ref["x"].device

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64, device=dev)

    joints = t(got["joints"])
    gap = (joints - ref["joints"]).norm(dim=-1).mean(dim=(1, 2))
    x = mod.euler_x(pb, t(got["rotations"]), t(got["root"]))
    c_got = mod.stage2_cost(pb, x, ref["vc"], ref["normals"], ref["points"])
    c_ref = mod.stage2_cost(pb, ref["x"], ref["vc"], ref["normals"], ref["points"])
    n_got, n_ref = t(got["normals"]), ref["normals"].double()
    offset = ((t(got["points"]) - ref["points"].double()) * n_ref).sum(-1).abs()
    cos = (n_got * n_ref).sum(-1).abs()
    return {"joint_gap_cm": float(gap.max()),
            "cost_excess": float(((c_got - c_ref) / c_ref).max()),
            "floor_offset_cm": float(offset.max()),
            "floor_angle": float((1 - cos).max())}


def reference(run: Run, **kw) -> dict:
    """The reference's solve of the sampled sequences."""
    return harness.load("reference", "kinematic").refine([run.problems[i] for i in run.sample],
                                                         run.cfg, run.device, **kw)


def control_outputs(run: Run, name: str) -> dict:
    """The control's results on the sampled sequences, as ``outputs``
    gives the program's: the reference with its iterates held in bfloat16
    (``bf16``, the control), or in float32 with every matrix product's
    operands rounded to TF32 (``tf32``, which the numbers cannot tell from
    float32, PERF.md)."""
    mod = harness.load("reference", "kinematic")
    kw = {"bf16": dict(dtype=torch.float32, keep=mod.bf16_state),
          "tf32": dict(dtype=torch.float32, matmul=mod.matmul_tf32)}.get(name)
    if kw is None:
        raise ValueError(f"no control {name!r}; one of {CONTROLS}")
    c = reference(run, **kw)
    pb = c["problem"]
    x = c["x"].reshape(pb.B, pb.F, -1)
    got = {"joints": c["joints"], "normals": c["normals"], "points": c["points"],
           "vc": c["vc"], "root": x[..., :3],
           "rotations": pb.q.from_euler_xyz(x[..., 3:].unflatten(-1, (pb.J, 3)))}
    return {k: v.double().cpu().numpy() for k, v in got.items()}


def check(run: Run, control: str = None) -> list:
    """The numbers compared, each with its limit: the last call's results
    on the sampled sequences against the reference's; with ``control``
    (one of ``CONTROLS``) the control's results take the program's place.
    The reference is solved once a run."""
    got = outputs(run) if control is None else None
    run.out, run.graphs = None, None  # the program's state goes before the reference
    torch.cuda.empty_cache()
    if getattr(run, "ref", None) is None:
        run.ref = reference(run)
    if control is not None:
        got = control_outputs(run, control)
    res = compare(run, got, run.ref)
    lim = run.wl["limits"]
    return [{"name": k, "value": res[k], "limit": lim[k]} for k in lim]
