"""Batched multi-sequence physics solving (port of the physics half of
chd_tpu/parallel/batch.py).

Every per-sequence solve runs as one lockstep batch on one device: the
variables are (B, F·30), the LM damping and CG scalars per sequence, and on
a CUDA device every LM step is replayed as a captured CUDA graph
(``utils.cuda_graph.GraphCache``). Ragged sequences pad to a common frame
count: frame-indexed fields replicate the last real frame, and a
per-sequence frame_mask zeroes every cost and constraint residual on padded
frames (see physics/collocation.py), so padding cannot perturb the real
solution. Between the copy of the inputs to the device and the copy of the
``durations_ok`` flags back, a solve makes no host sync.

With a ``mesh`` (``parallel.mesh``) the caller's batch is already padded to
one frame count and the duration specs to one phase count, so a sequence
pads alike sharded or not; each rank then solves its contiguous slice on its
own device (``mesh.device``), replaying its own CUDA graphs with no
collective inside a step, and the results are gathered once at the end.

Each stage is a span of ``utils.profiling`` (``phys.fit``, ``phys.dyn``,
``phys.height``, ``phys.stage3``, ``phys.stage4``, each with its ``steps``,
its AL iterations times ``lm.max_iters``), and a whole solve
(``solve_physics_full_batch``) is ``phys.call`` over them, its host prep
(``phys.prepare``) and the flags' copy back (``phys.unpack``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kinematics.lm import frame_coloring_masks, lm_solve
from ..parallel import mesh as mesh_lib
from ..physics import collocation
from ..physics import durations as dur_lib
from ..physics.types import PhysInput, PhysResult, PhysWeights
from ..utils import cuda_graph
from ..utils.cuda_graph import GraphCache
from ..utils.device import resolve_device
from ..utils.precision import full_f32
from ..utils.profiling import span

StageHook = Optional[Callable[[str], None]]


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def pad_phys_inputs(inputs: Sequence[PhysInput], num_frames: Optional[int] = None,
                    device="cuda", dtype=torch.float32):
    """Stack per-sequence PhysInputs into one batched PhysInput + mask, on
    ``device`` (default ``cuda``; raises where CUDA is absent) in ``dtype``.

    Frame-indexed fields repeat the final frame; the frame_mask marks
    padding so the solver ignores it entirely. Returns
    (batched PhysInput (B, F, ...), seq_lens)."""
    device = resolve_device(device)
    longest = max(int(p.base_lin.shape[0]) for p in inputs)
    F = num_frames or longest
    if F < longest:
        raise ValueError(
            f"num_frames={F} is shorter than the longest sequence ({longest}); "
            "pad_phys_inputs pads, it does not truncate"
        )

    def pad_time(a, axis):
        a = _host(a)
        n = a.shape[axis]
        if n == F:
            return a
        last = np.take(a, [-1], axis=axis)
        reps = [1] * a.ndim
        reps[axis] = F - n
        return np.concatenate([a, np.tile(last, reps)], axis=axis)

    fields = {}
    for name in PhysInput._fields:
        vals = [getattr(p, name) for p in inputs]
        if name in ("base_lin", "base_ang", "left_hip", "right_hip", "inertia"):
            arr = np.stack([pad_time(v, 0) for v in vals])
        elif name in ("ee_pos", "contact"):
            arr = np.stack([pad_time(v, 1) for v in vals])
        elif name == "frame_mask":
            continue  # built below from seq lengths
        else:
            arr = np.stack([_host(v) for v in vals])
        fields[name] = torch.as_tensor(arr, dtype=dtype, device=device)
    seq_lens = np.array([int(p.base_lin.shape[0]) for p in inputs])
    fields["frame_mask"] = torch.as_tensor(
        (np.arange(F)[None, :] < seq_lens[:, None]).astype(np.float32), dtype=dtype, device=device)
    return PhysInput(**fields), seq_lens


def pad_duration_specs(phys_batch: PhysInput) -> dur_lib.DurationSpec:
    """Per-sequence DurationSpecs from the batched (padded) contact
    schedules, padded to a common phase count P_max (zero-length phases with
    phase_mask 0 — soft_contact hard-masks them), on the batch's device and
    in its dtype. Built on the host from the concrete schedules: the one
    copy from the device it makes comes before a solve."""
    contact, dts = _host(phys_batch.contact), _host(phys_batch.dt)
    specs = [dur_lib.build_duration_spec(contact[i], float(dts[i])) for i in range(len(dts))]
    P = max(int(s.durations.shape[1]) for s in specs)

    def stack(field):
        rows = [_host(getattr(s, field)) for s in specs]
        if rows[0].ndim == 2:
            rows = [np.concatenate([r, np.zeros((r.shape[0], P - r.shape[1]), r.dtype)], axis=1)
                    for r in rows]
        return torch.as_tensor(np.stack(rows), dtype=phys_batch.dt.dtype,
                               device=phys_batch.dt.device)

    return dur_lib.DurationSpec(*(stack(f) for f in dur_lib.DurationSpec._fields))


def _masks(F: int, phys_batch: PhysInput, graphs: Optional[GraphCache]) -> torch.Tensor:
    dtype, device = phys_batch.dt.dtype, phys_batch.dt.device
    return cuda_graph.constant(graphs, ("phys_masks", F, dtype, device), lambda: (
        frame_coloring_masks(F, collocation.DOF, dtype=dtype, device=device)))


def _staged_core(phys_batch: PhysInput, weights: PhysWeights, cfg: collocation.SolveConfig,
                 graphs: Optional[GraphCache], stage_hook: StageHook = None):
    """FIT→DYN→HEIGHT on the device, no host sync. Returns (res_fit,
    res_dyn). ``stage_hook(name)``, where given, is called after each stage
    ("fit", "dyn", "height"; ``durations_core`` adds "stage3", "stage4"),
    e.g. to record a CUDA event. Each stage is the span ``phys.<name>``."""
    F = phys_batch.base_lin.shape[1]
    masks = _masks(F, phys_batch, graphs)
    dyn_cost = collocation.dyn_cost_for(weights)
    x = collocation.join_vars(phys_batch.base_lin, phys_batch.base_ang, phys_batch.ee_pos,
                              torch.zeros_like(phys_batch.ee_pos))
    lams = collocation.init_multipliers(phys_batch)
    stages = (("fit", collocation.FIT_COST, collocation.FIT_RHO, cfg.al_iters_fit),
              ("dyn", dyn_cost, collocation.DYN_RHO, cfg.al_iters_dyn),
              ("height", dyn_cost, collocation.DYN_H_RHO, cfg.al_iters_height))
    for name, w, rho, iters in stages:
        with span(f"phys.{name}", steps=iters * cfg.lm.max_iters):
            x, lams = collocation.run_stage(x, phys_batch, lams, w, rho, iters, cfg.lm, masks,
                                            graphs)
        if name == "fit":
            res_fit = collocation._to_result(x, phys_batch)
        if stage_hook is not None:
            stage_hook(name)
    return res_fit, collocation._to_result(x, phys_batch)


def _local(mesh, *trees):
    """Each tree's rows of this rank (all of them without a mesh)."""
    return trees if mesh is None else mesh_lib.shard_batch(mesh, trees)


def _global(mesh, tree):
    return tree if mesh is None else mesh_lib.gather(mesh, tree)


def solve_physics_batch(phys_batch: PhysInput, weights: PhysWeights = PhysWeights(),
                        cfg: collocation.SolveConfig = collocation.SolveConfig(),
                        graphs: Optional[GraphCache] = None,
                        mesh=None) -> Tuple[PhysResult, PhysResult]:
    """Solve B physics problems in lockstep on their device, or each rank
    its slice of them over ``mesh``. Returns batched (fit, dynamics)
    results, on the device."""
    phys_batch, = _local(mesh, phys_batch)
    with full_f32():
        return _global(mesh, _staged_core(phys_batch, weights, cfg,
                                          cuda_graph.graphs_for(phys_batch.dt.device, graphs)))


def stage3_problem(F: int, spec_b: dur_lib.DurationSpec, weights: PhysWeights,
                   graphs: Optional[GraphCache] = None):
    """The stage-3 augmented-LM problem pieces: (fn3, masks_aug, dyn_cost,
    n_traj). The augmented masks are block-diagonal: the frame coloring of
    the trajectory, and one mask per duration variable."""
    dtype, device = spec_b.durations.dtype, spec_b.durations.device
    dof_d = 4 * int(spec_b.durations.shape[-1])
    n_traj = F * collocation.DOF
    dyn_cost = collocation.dyn_cost_for(weights, accel=0.0)
    fn3 = collocation.make_stage3_residual_fn(dyn_cost, collocation.DYN_H_RHO)

    def make():
        traj = frame_coloring_masks(F, collocation.DOF, dtype=dtype, device=device)
        aug = torch.zeros((traj.shape[0] + dof_d, n_traj + dof_d), dtype=dtype, device=device)
        aug[:traj.shape[0], :n_traj] = traj
        aug[traj.shape[0]:, n_traj:] = torch.eye(dof_d, dtype=dtype, device=device)
        return aug

    masks_aug = cuda_graph.constant(graphs, ("phys_stage3_masks", F, dof_d, dtype, device), make)
    return fn3, masks_aug, dyn_cost, n_traj


def stage3_solve(phys_batch: PhysInput, x2: torch.Tensor, spec_b: dur_lib.DurationSpec,
                 weights: PhysWeights, cfg: collocation.SolveConfig,
                 graphs: Optional[GraphCache] = None):
    """Stage 3 from the stage-2 variables x2: ``cfg.al_iters_durations`` AL
    iterations over [trajectory | durations] behind the soft schedule.
    Returns (trajectory variables, durations (B, 4, P))."""
    B, F = phys_batch.base_lin.shape[:2]
    fn3, masks_aug, dyn_cost, n_traj = stage3_problem(F, spec_b, weights, graphs)
    rho = collocation.DYN_H_RHO
    x_aug = torch.cat([x2, spec_b.durations.reshape(B, -1)], dim=-1)
    lams = collocation.init_multipliers(phys_batch)
    for _ in range(cfg.al_iters_durations):
        x_aug, _ = lm_solve(fn3, x_aug, (phys_batch, lams, spec_b, dyn_cost, rho, weights.w_dur),
                            cfg.lm, masks_aug, graphs)
        d = x_aug[:, n_traj:].reshape(spec_b.durations.shape)
        c_soft = dur_lib.soft_contact(d, spec_b, F, phys_batch.dt)
        lams = collocation.update_multipliers(x_aug[:, :n_traj], phys_batch, lams, rho,
                                              contact=c_soft)
    return x_aug[:, :n_traj], x_aug[:, n_traj:].reshape(spec_b.durations.shape)


def stage4_solve(phys_new: PhysInput, x3: torch.Tensor, weights: PhysWeights,
                 cfg: collocation.SolveConfig, graphs: Optional[GraphCache] = None):
    """Stage 4: the frozen-duration polish under the re-rasterized hard
    schedule of ``phys_new`` (phys_optim.cpp:713-749). Returns x."""
    F = phys_new.base_lin.shape[1]
    x4, _ = collocation.run_stage(
        x3, phys_new, collocation.init_multipliers(phys_new),
        collocation.dyn_cost_for(weights, accel=0.0), collocation.DYN_H_RHO,
        max(cfg.al_iters_height, 1), cfg.lm, _masks(F, phys_new, graphs), graphs)
    return x4


def durations_core(phys_batch: PhysInput, stage2: PhysResult, spec_b: dur_lib.DurationSpec,
                   weights: PhysWeights = PhysWeights(),
                   cfg: collocation.SolveConfig = collocation.SolveConfig(),
                   graphs: Optional[GraphCache] = None, stage_hook: StageHook = None):
    """Stage 3 (durations) and stage 4 (the frozen-duration polish) on the
    device, no host sync, each stage a span (``phys.stage3``,
    ``phys.stage4``). ``spec_b`` comes from :func:`pad_duration_specs`.
    Returns (result, stats, ok), ok a device bool tensor (B,)."""
    x2 = collocation.join_vars(stage2.base_lin, stage2.base_ang, stage2.ee_pos, stage2.ee_force)
    with span("phys.stage3", steps=cfg.al_iters_durations * cfg.lm.max_iters):
        x3, d3 = stage3_solve(phys_batch, x2, spec_b, weights, cfg, graphs)
    if stage_hook is not None:
        stage_hook("stage3")
    F = phys_batch.base_lin.shape[1]
    phys_new = phys_batch._replace(contact=dur_lib.rasterize(d3, spec_b, F, phys_batch.dt))
    with span("phys.stage4", steps=max(cfg.al_iters_height, 1) * cfg.lm.max_iters):
        x4 = stage4_solve(phys_new, x3, weights, cfg, graphs)
    if stage_hook is not None:
        stage_hook("stage4")

    stats = collocation.violation_stats_arrays(x4, phys_new)
    old_stats = collocation.violation_stats_arrays(x2, phys_batch)
    dyn_floor = collocation._dyn_tol_floor(phys_batch.mass)
    ok = torch.logical_and(
        stats["dyn"] <= torch.maximum(2.0 * old_stats["dyn"], dyn_floor),
        stats["terrain"] <= torch.clamp(2.0 * old_stats["terrain"], min=0.02),
    )
    return collocation._to_result(x4, phys_new), stats, ok


def solve_physics_durations_batch(
    phys_batch: PhysInput,
    stage2: PhysResult,
    weights: PhysWeights = PhysWeights(),
    cfg: collocation.SolveConfig = collocation.SolveConfig(),
    graphs: Optional[GraphCache] = None,
    mesh=None,
) -> Tuple[PhysResult, Dict[str, torch.Tensor], np.ndarray]:
    """Batched stage-3 duration refinement + stage-4 frozen re-solve
    (phys_optim.cpp:663-749), over ``mesh``'s ranks where given. Returns
    (batched result, batched violation stats, per-sequence durations_ok
    flags on the host — callers keep the stage-2 result where ok is False,
    the reference's fallback rule)."""
    spec_b = pad_duration_specs(phys_batch)
    phys_batch, stage2, spec_b = _local(mesh, phys_batch, stage2, spec_b)
    with full_f32():
        res, stats, ok = _global(mesh, durations_core(
            phys_batch, stage2, spec_b, weights, cfg,
            cuda_graph.graphs_for(phys_batch.dt.device, graphs)))
    return res, stats, ok.cpu().numpy()


def solve_physics_full_batch(
    phys_batch: PhysInput,
    weights: PhysWeights = PhysWeights(),
    cfg: collocation.SolveConfig = collocation.SolveConfig(),
    spec_b: Optional[dur_lib.DurationSpec] = None,
    graphs: Optional[GraphCache] = None,
    mesh=None,
):
    """The full staged solve, FIT→DYN→HEIGHT→durations→frozen polish, on the
    batch's device with no host sync until its end, where the
    ``durations_ok`` flags come back to the host; over ``mesh``'s ranks
    where given, each its slice of the batch.

    Returns (res_fit, res_dyn, res_final, stats, durations_ok) — the
    reference's sol_out_no_dynamics / sol_out_dynamics / final artifacts
    (phys_optim.cpp:554-749); results and stats stay on the device.
    ``spec_b`` defaults to :func:`pad_duration_specs` of the whole batch (a
    copy of its schedule to the host, before the solve).

    A call is the span ``phys.call`` (attributes ``B``, ``F``) over
    ``phys.prepare`` (the duration specs' host work and copy), the five
    stages' spans and ``phys.unpack`` (the flags' copy back):
    ``utils.profiling.snapshot()`` reads them."""
    with span("phys.call", B=int(phys_batch.base_lin.shape[0]),
              F=int(phys_batch.base_lin.shape[1])):
        with span("phys.prepare"):
            if spec_b is None:
                spec_b = pad_duration_specs(phys_batch)
        phys_batch, spec_b = _local(mesh, phys_batch, spec_b)
        graphs = cuda_graph.graphs_for(phys_batch.dt.device, graphs)
        with full_f32():
            res_fit, res_dyn = _staged_core(phys_batch, weights, cfg, graphs)
            res, stats, ok = durations_core(phys_batch, res_dyn, spec_b, weights, cfg, graphs)
            res_fit, res_dyn, res, stats, ok = _global(mesh, (res_fit, res_dyn, res, stats, ok))
        with span("phys.unpack"):
            ok = ok.cpu().numpy()
    return res_fit, res_dyn, res, stats, ok


def unbatch_results(res: PhysResult, seq_lens) -> List[PhysResult]:
    """Batched results → per-sequence results on the host, trimmed to their
    true lengths."""
    host = PhysResult(*(_host(v) for v in res))
    return [PhysResult(dt=host.dt[i], base_lin=host.base_lin[i][:L],
                       base_ang=host.base_ang[i][:L], ee_pos=host.ee_pos[i][:, :L],
                       ee_force=host.ee_force[i][:, :L], contact=host.contact[i][:, :L])
            for i, L in enumerate(seq_lens)]
