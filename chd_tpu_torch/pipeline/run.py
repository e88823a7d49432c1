"""The pipeline's stages (port of chd_tpu/pipeline/run.py): kinematic,
retargeting, physics, and ``run_pipeline`` chaining them for one video dir.

Same on-disk layout as ``chd_tpu``, so any stage of either package can run
on the other's files:

  video_dir/
    openpose_result/            (input: OpenPose JSON)
    tracked_results.json        (input: MTC fit)
    foot_contacts.npy           (input: contact detection)
    kinematic_results/
      final_test.bvh, floor_out.txt, foot_contacts.npy (refined),
      <char>_out.bvh
    phys_optim_in_<char>/       (skel/motion/terrain/contact_info.txt)
    phys_optim_out_<char>/
      sol_out_no_dynamics.txt, sol_out_dynamics.txt, sol_out_durations.txt,
      success_log.txt, <video>_<char>_{no_dynamics,dynamics,durations}.bvh

Every stage runs on ``device`` (default ``cuda``; raises where CUDA is
absent) in ``dtype``.

One very long sequence (``kinematic.frame_shard_threshold`` frames or more,
in a process group of more than one rank) has its kinematic LM stages
frame-sharded over every rank (``parallel.longseq``), as ``chd_tpu`` shards
them over more than one device. In a group of several ranks, rank 0 alone
writes a stage's files, and every rank waits for them before it goes on; a
stage that is not sharded runs on rank 0 alone
(``parallel.distributed.on_primary``).
"""
from __future__ import annotations

import os
import shutil
from typing import Callable, Optional

import numpy as np
import torch

from ..characters import get_character
from ..core import bvh
from ..ingest import openpose, totalcap
from ..kinematics import trajectory as traj_lib
from ..kinematics.lm import LMConfig
from ..parallel import batch as batch_lib
from ..parallel import distributed
from ..parallel import longseq as longseq_lib
from ..parallel import mesh as mesh_lib
from ..physics import collocation, towr_io
from ..physics.apply import apply_results, remove_heel
from ..physics.prepare import prepare_input
from ..physics.types import PhysWeights
from ..retarget.mixamo import retarget
from ..utils.config import PipelineConfig
from ..utils.cuda_graph import GraphCache
from ..utils.device import resolve_device
from ..utils.log import get_logger
from ..utils.profiling import span

log = get_logger("pipeline")

# the combined-skeleton template's path in the reference repo's layout (the
# pipeline reads the configured kinematic.skel_path)
DEFAULT_SKEL = "src/skeleton_fitting/combined_body_25.bvh"


def _skel_path(cfg: PipelineConfig) -> str:
    if cfg.kinematic.skel_path:
        return cfg.kinematic.skel_path
    raise FileNotFoundError(
        "no combined-skeleton template configured; set kinematic.skel_path "
        "to a combined_body_25.bvh"
    )


def run_kinematic_stage(video_dir: str, cfg: PipelineConfig, num_frames: Optional[int] = None,
                        device="cuda", dtype=torch.float32, mesh=None) -> str:
    """Kinematic optimization of one video dir.

    Reads openpose_result/, tracked_results.json, foot_contacts.npy; writes
    kinematic_results/{final_test.bvh, floor_out.txt, foot_contacts.npy}.
    Returns the kinematic_results path. ``device`` defaults to ``cuda`` and
    raises where CUDA is absent.

    The LM stages shard the frame axis (``parallel.longseq``) over ``mesh``
    where one is given (and run on ``mesh.device``), or over every rank
    where the sequence reaches ``kinematic.frame_shard_threshold`` frames
    (0 disables) and the process group has more than one rank. In such a
    group rank 0 alone writes, and the ranks meet before they return;
    unsharded, rank 0 alone solves too.
    """
    out_dir = os.path.join(video_dir, "kinematic_results")
    os.makedirs(out_dir, exist_ok=True)

    poses2d_all = openpose.load_keypoint_dir(os.path.join(video_dir, "openpose_result"))
    if poses2d_all is None:
        raise FileNotFoundError(f"no openpose_result under {video_dir}")
    tc = totalcap.load_totalcap_results(os.path.join(video_dir, "tracked_results.json"))
    if tc is None:
        raise FileNotFoundError(f"no tracked_results.json under {video_dir}")
    fc_path = os.path.join(video_dir, "foot_contacts.npy")
    if not os.path.exists(fc_path):
        raise FileNotFoundError(f"no foot_contacts.npy under {video_dir}")
    foot_contacts = np.load(fc_path)

    available = min(poses2d_all.shape[0], tc.joint3d.shape[0], foot_contacts.shape[0])
    F = min(num_frames, available) if num_frames else available

    conf2d = poses2d_all[:F, :, 2]
    poses2d = poses2d_all[:F, :, :2]
    root_b25, body25 = totalcap.normalize_root_pos(tc.root_trans, tc.joint3d)
    _, smpl3d = totalcap.normalize_root_pos(
        tc.root_trans, tc.smpl_joint3d, root_idx=totalcap.SMPL_ROOT_IDX
    )
    pose3d = totalcap.create_combined_model(body25, smpl3d)[:F]
    root_pos = root_b25[:F]

    # pad the 2D data with the 3 spine joints at zero confidence
    poses2d = np.concatenate([poses2d, np.zeros((F, 3, 2))], axis=1)
    conf2d = np.concatenate([conf2d, np.zeros((F, 3))], axis=1)

    vel_constraints = traj_lib.contacts_to_vel_constraints(foot_contacts[:F])

    plane_normal = plane_point = None
    if cfg.kinematic.use_gt_floor:
        with open(os.path.join(video_dir, "floor_gt.txt")) as f:
            plane_normal = np.array([float(x) for x in f.readline().split()])
            plane_point = np.array([float(x) for x in f.readline().split()]) * 100.0

    smpl_skel = totalcap.combined_angles_from_smpl(tc.smpl_joint_angles[:F])
    skeleton, names, frametime = bvh.load(_skel_path(cfg))

    lm_cfg = LMConfig(max_iters=cfg.kinematic.lm_iters, cg_iters=cfg.kinematic.cg_iters)
    thresh = cfg.kinematic.frame_shard_threshold
    if mesh is None and thresh and F >= thresh and distributed.multi_rank():
        mesh = mesh_lib.make_mesh(model=1)

    def write(res):
        bvh.save(os.path.join(out_dir, "final_test.bvh"), res.anim, names, frametime=frametime)
        np.save(os.path.join(out_dir, "foot_contacts.npy"), res.refined_contacts)
        with open(os.path.join(out_dir, "floor_out.txt"), "w") as f:
            f.write(" ".join(str(v) for v in res.floor_normal) + "\n")
            f.write(" ".join(str(v) for v in res.floor_point))
        return out_dir

    def solve_unsharded():
        return write(traj_lib.optimize_trajectory(
            poses2d, conf2d, pose3d, root_pos, smpl_skel, skeleton, vel_constraints,
            cam_focal=cfg.kinematic.focal,
            cam_pp=cfg.kinematic.pp,
            plane_normal=plane_normal,
            plane_point=plane_point,
            ik_iterations=cfg.kinematic.ik_iterations,
            lm_cfg=lm_cfg,
            device=device,
            dtype=dtype,
        ))

    if mesh is None:
        return distributed.on_primary(solve_unsharded)
    res = longseq_lib.optimize_trajectory_frame_sharded(
        poses2d, conf2d, pose3d, root_pos, smpl_skel, skeleton, vel_constraints, mesh,
        cam_focal=cfg.kinematic.focal,
        cam_pp=cfg.kinematic.pp,
        plane_normal=plane_normal,
        plane_point=plane_point,
        ik_iterations=cfg.kinematic.ik_iterations,
        lm_cfg=lm_cfg,
        dtype=dtype,
    )
    if distributed.is_primary():
        write(res)
    if distributed.multi_rank():
        torch.distributed.barrier()  # the files are whole before any rank reads them
    return out_dir


def run_retarget_stage(video_dir: str, cfg: PipelineConfig, skel_bvh: Optional[str] = None,
                       device="cuda", dtype=torch.float32) -> str:
    """final_test.bvh → <character>_out.bvh (run_phys_mocap.py:117-133); on
    rank 0 alone in a multi-rank group."""
    return distributed.on_primary(_retarget_stage, video_dir, cfg, skel_bvh, device, dtype)


def _retarget_stage(video_dir, cfg, skel_bvh, device, dtype) -> str:
    kin = os.path.join(video_dir, "kinematic_results")
    final = os.path.join(kin, "final_test.bvh")
    out = os.path.join(kin, f"{cfg.character}_out.bvh")
    device = resolve_device(device)
    if cfg.character == "combined":
        shutil.copyfile(final, out)
        return out
    if skel_bvh is None:
        raise FileNotFoundError(
            f"character template BVH required to retarget to {cfg.character!r}"
        )
    src, names, _ = bvh.load(final)
    retarget(src, cfg.character, skel_bvh, out_bvh=out, device=device, dtype=dtype)
    return out


def run_physics_stage(video_dir: str, cfg: PipelineConfig, video_name: Optional[str] = None,
                      device="cuda", dtype=torch.float32,
                      graphs: Optional[GraphCache] = None) -> dict:
    """prepare → solve → artifacts (run_phys_mocap.py:136-201); on rank 0
    alone in a multi-rank group."""
    return distributed.on_primary(_physics_stage, video_dir, cfg, video_name, device, dtype,
                                  graphs)


def _physics_stage(video_dir, cfg, video_name, device, dtype, graphs) -> dict:
    device = resolve_device(device)
    kin = os.path.join(video_dir, "kinematic_results")
    char = cfg.character
    char_bvh = os.path.join(kin, f"{char}_out.bvh")
    in_dir = os.path.join(video_dir, f"phys_optim_in_{char}")
    out_dir = os.path.join(video_dir, f"phys_optim_out_{char}")
    os.makedirs(out_dir, exist_ok=True)
    video_name = video_name or os.path.basename(os.path.abspath(video_dir))

    anim, names, frametime = bvh.load(char_bvh)
    with open(os.path.join(kin, "floor_out.txt")) as f:
        normal = np.array([float(x) for x in f.readline().split()])
        point = np.array([float(x) for x in f.readline().split()])
    contacts = np.load(os.path.join(kin, "foot_contacts.npy"))

    fps = cfg.fps
    if cfg.probe_fps:
        from .probe import probe_fps

        fps = probe_fps(video_dir, default=cfg.fps)

    F = min(anim.num_frames, contacts.shape[0])
    if anim.num_frames != contacts.shape[0]:
        log.warning(
            "frame-count mismatch in %s: BVH has %d frames, foot_contacts.npy "
            "has %d (at %.0f fps); truncating to %d",
            video_dir, anim.num_frames, contacts.shape[0], fps, F,
        )
    phys = prepare_input(
        anim.slice_frames(0, F), normal, point, contacts[:F], char,
        start_idx=0, end_idx=F, dt=1.0 / fps, out_dir=in_dir,
    )

    pw = PhysWeights(
        cfg.physics.w_com_lin, cfg.physics.w_com_ang, cfg.physics.w_ee,
        cfg.physics.w_smooth, cfg.physics.w_dur,
    )
    scfg = collocation.SolveConfig(
        al_iters_fit=cfg.physics.al_iters_fit,
        al_iters_dyn=cfg.physics.al_iters_dyn,
        al_iters_height=cfg.physics.al_iters_height,
        al_iters_durations=cfg.physics.al_iters_durations,
        optimize_durations=cfg.physics.optimize_durations,
        lm=LMConfig(max_iters=cfg.physics.lm_iters, cg_iters=cfg.physics.cg_iters,
                    init_lambda=1e-2),
    )
    durations_ok = False
    if cfg.physics.optimize_durations:
        # the whole staged solve incl. stage 3/4 on a batch of one, with one
        # host sync at its end
        batched, seq_lens = batch_lib.pad_phys_inputs([phys], device=device, dtype=dtype)
        rf_b, rd_b, res3_b, stats3_b, ok_b = batch_lib.solve_physics_full_batch(
            batched, pw, scfg, graphs=graphs)
        res_fit = batch_lib.unbatch_results(rf_b, seq_lens)[0]
        res_dyn = batch_lib.unbatch_results(rd_b, seq_lens)[0]
        x2 = collocation.join_vars(rd_b.base_lin, rd_b.base_ang, rd_b.ee_pos, rd_b.ee_force)
        stats = {k: float(v[0]) for k, v in collocation.violation_stats(x2, batched).items()}
        durations_ok = bool(ok_b[0])
        res3 = batch_lib.unbatch_results(res3_b, seq_lens)[0]
        stats3 = {k: float(v[0]) for k, v in stats3_b.items()}
    else:
        res_fit, res_dyn, stats = collocation.solve_physics(phys, pw, scfg, device=device,
                                                            dtype=dtype, graphs=graphs)

    towr_io.save_solution(res_fit, os.path.join(out_dir, "sol_out_no_dynamics.txt"))
    towr_io.save_solution(res_dyn, os.path.join(out_dir, "sol_out_dynamics.txt"))
    dynamics_ok = (
        stats["dyn"] < cfg.physics.dyn_tol
        and stats["terrain"] < cfg.physics.kin_tol
        and stats["height"] < cfg.physics.kin_tol
    )

    # STAGE 3 result selection: on failure keep the stage-2 result with
    # durations frozen (the reference's stage-4 fallback,
    # phys_optim.cpp:713-749)
    res_durations = res_dyn
    if cfg.physics.optimize_durations and durations_ok:
        res_durations = res3
        stats = {**stats, **{f"dur_{k}": v for k, v in stats3.items()}}
    durations_ok = durations_ok or dynamics_ok  # fallback result converged
    towr_io.save_solution(res_durations, os.path.join(out_dir, "sol_out_durations.txt"))
    towr_io.save_success_log(os.path.join(out_dir, "success_log.txt"), dynamics_ok, durations_ok)

    # BVH exports of each result (towr_utils.py --viz branch :953-975)
    heeled = get_character(char).has_heel
    for label in ["no_dynamics", "dynamics", "durations"]:
        loaded = towr_io.load_results(os.path.join(out_dir, f"sol_out_{label}.txt"))
        applied, _, _ = apply_results(loaded, anim.slice_frames(0, F), char, device=device,
                                      dtype=dtype)
        bvh.save(
            os.path.join(out_dir, f"{video_name}_{char}_{label}.bvh"),
            applied if heeled else remove_heel(applied), names, frametime=frametime,
        )
    return {"stats": stats, "dynamics_ok": dynamics_ok, "out_dir": out_dir}


def _stage(name: str, label: str, fn: Callable, *args, **kw):
    """``fn(*args, **kw)`` as the span ``name``, logged as ``label`` when it
    starts and with the span's host seconds when it ends."""
    log.info("%s ...", label)
    sp = span(name)
    try:
        with sp:
            return fn(*args, **kw)
    finally:
        log.info("%s done in %.1fs", label, sp.host_s)


def run_pipeline(video_dir: str, cfg: PipelineConfig, char_skel_bvh: Optional[str] = None,
                 device="cuda", dtype=torch.float32) -> dict:
    """Full per-video pipeline (run_phys_mocap.py main loop): the spans
    ``run.kinematic``, ``run.retarget`` and ``run.physics``."""
    _stage("run.kinematic", f"kinematic [{video_dir}]", run_kinematic_stage, video_dir, cfg,
           device=device, dtype=dtype)
    _stage("run.retarget", f"retarget → {cfg.character}", run_retarget_stage, video_dir, cfg,
           char_skel_bvh, device=device, dtype=dtype)
    return _stage("run.physics", "physics", run_physics_stage, video_dir, cfg, device=device,
                  dtype=dtype)
