"""The kinematic stage of chd_tpu_torch end to end, against chd_tpu:
``optimize_trajectory``, ``optimize_trajectory_batch``, the ``kinematic``
CLI command, and the frozen trajectory golden.

Problems are the synthetic recipe of tests/test_kinematics_batch.py on the
golden's 28-joint combined skeleton, made from a seed by the helpers that
chip_smoke.py drives the card with. Tolerances:
- ``optimize_trajectory`` at IK 10, LM 5:15, float64, against chd_tpu's:
  joint positions max |d| <= 1e-6 cm (read: 5e-10), the same pruned
  contacts, floor normal cos >= 1 - 1e-12;
- the batched path on two ragged sequences (16 and 12 frames) against
  chd_tpu's batched path, float64, LU IK 10, LM 5:15: joint positions max
  |d| <= 1e-6 cm, the same pruned and refined contacts, floor normal cos
  >= 1 - 1e-12;
- the batched path against the single path: joint positions max |d| <= 0.5
  cm and floor normals within
  5e-2, chd_tpu's own bounds (the batch initializes with CG IK, the single
  path with LU), and the trimmed shapes;
- the headroom of chip_smoke.py [15]'s float32 stage bounds: the CPU's own
  one-ulp spread stays 4x inside them, and a TF32-rounded IK breaks its;
- the ``kinematic`` CLI with ``--device cpu`` (float32) against chd_tpu's
  ``run_kinematic_stage`` (float32) on one synthetic video dir: the same
  refined contacts, floor normal cos >= 1 - 1e-6, floor point within
  0.05 cm, BVH joint positions within 0.05 cm;
- the port's physics stage (``run_physics_stage``, ``combined``) on a
  ``kinematic_results/`` that chd_tpu's kinematic and retarget stages
  wrote: every file of chd_tpu's layout, finite stats (the pipeline's
  interchange with chd_tpu, beside the run of chd_tpu's kinematic stage
  above, whose compile it reuses; the other direction is in
  tests/test_torch_pipeline_run.py);
- the golden at its pinned 50:100: the gates of tests/test_goldens.py
  (marked slow, as chd_tpu's is: ~3 min on the CPU; ``chip_smoke.py``
  [14] holds it on the card).
"""
import os

import jax
import numpy as np
import pytest
import torch

from chd_tpu.core.animation import Animation as JaxAnimation
from chd_tpu.kinematics import batch as jax_batch
from chd_tpu.kinematics import trajectory as jax_traj
from chd_tpu.kinematics.lm import LMConfig as JaxLMConfig
from chd_tpu.pipeline.run import run_kinematic_stage as jax_run_kinematic_stage
from chd_tpu.pipeline.run import run_retarget_stage as jax_run_retarget_stage
from chd_tpu.utils.config import KinematicConfig as JaxKinematicConfig
from chd_tpu.utils.config import PipelineConfig as JaxPipelineConfig
from chd_tpu_torch.core import bvh, fk
from chd_tpu_torch.kinematics import batch, trajectory
from chd_tpu_torch.kinematics.ik import IKConfig
from chd_tpu_torch.kinematics.lm import LMConfig
from chd_tpu_torch.kinematics.residuals import Layout, data_order_positions
from chd_tpu_torch.pipeline import cli
from chd_tpu_torch.pipeline.run import run_physics_stage
from chd_tpu_torch.utils.config import PipelineConfig
from chip_smoke import (SMALL_IK_MAX_D, SMALL_LM_MAX_D, kin_problem, synth_video_dir,
                        tf32_rounded, trajectory_golden_gates)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
GOLDEN = os.path.join(FIXTURES, "trajectory_golden.npz")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's CPU solves: they are many small
    ops, whose every parallel region stalls when the other test workers
    hold the cores.
    Not raised again after the module: in one process, a count raised back
    makes MKL's next batched LU (``torch.linalg.solve_ex``) hang."""
    torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_executables():
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def skel():
    g = np.load(GOLDEN)
    return JaxAnimation(g["skel_rotations"], g["skel_positions"], g["skel_orients"],
                        g["skel_offsets"], [int(p) for p in g["skel_parents"]])


@pytest.fixture(scope="module")
def problems(skel):
    rng = np.random.default_rng(17)
    return kin_problem(rng, skel, 16, 0.3), kin_problem(rng, skel, 12, 0.3)


def _single(p, skel, **kw):
    return trajectory.optimize_trajectory(
        p["pose2d"], p["conf2d"], p["pose3d"], p["root_pos"], p["smpl_angles"], skel,
        p["vel_constraints"].copy(), ik_iterations=10, lm_cfg=LMConfig(5, 15), **kw)


def _joints(res):
    return fk.positions_global(torch.as_tensor(res.anim.rotations).double(),
                               torch.as_tensor(res.anim.positions).double(),
                               res.anim.parents).numpy()


def test_optimize_trajectory_matches_chd_tpu(problems, skel):
    p = problems[0]
    got = _single(p, skel, device="cpu", dtype=torch.float64)
    want = jax_traj.optimize_trajectory(
        p["pose2d"], p["conf2d"], p["pose3d"], p["root_pos"], p["smpl_angles"], skel,
        p["vel_constraints"].copy(), ik_iterations=10, lm_cfg=JaxLMConfig(5, 15),
        dtype=jax.numpy.float64)
    assert np.abs(got.pose3d - want.pose3d).max() <= 1e-6
    np.testing.assert_allclose(got.proj2d, want.proj2d, atol=1e-4)
    np.testing.assert_array_equal(got.vel_constraints, want.vel_constraints)
    np.testing.assert_array_equal(got.refined_contacts, want.refined_contacts)
    assert float(got.floor_normal @ want.floor_normal) >= 1 - 1e-12
    np.testing.assert_allclose(got.anim.rotations, np.asarray(want.anim.rotations), atol=1e-9)
    np.testing.assert_allclose(got.anim.positions, np.asarray(want.anim.positions), atol=1e-9)


def test_batch_matches_single(problems, skel):
    p1, p2 = problems
    res = batch.optimize_trajectory_batch([p1, p2], skel, ik_iterations=10,
                                          lm_cfg=LMConfig(5, 15), device="cpu",
                                          dtype=torch.float64)
    single = _single(p1, skel, device="cpu", dtype=torch.float64)
    assert np.abs(_joints(res[0]) - _joints(single)).max() < 0.5  # cm
    np.testing.assert_allclose(res[0].floor_normal, single.floor_normal, atol=5e-2)
    assert res[1].anim.num_frames == 12 and res[1].refined_contacts.shape == (12, 4)
    assert res[1].pose3d.shape == (12, 28, 3) and res[1].vel_constraints.shape == (12, 28)
    # a ragged sequence solved in a batch equals itself solved alone: padding
    # adds nothing
    alone = batch.optimize_trajectory_batch([p2], skel, ik_iterations=10, lm_cfg=LMConfig(5, 15),
                                            device="cpu", dtype=torch.float64)[0]
    assert np.abs(_joints(res[1]) - _joints(alone)).max() < 1e-6


def test_batch_matches_chd_tpu_batch(problems, skel):
    """Both packages' batched entry points on the ragged pair: padding, the
    frame mask, the floor stage and both LM stages. With the LU IK, which
    does not amplify roundings (the CG IK does)."""
    kw = dict(ik_iterations=10, ik_solver="lu")
    got = batch.optimize_trajectory_batch(list(problems), skel, lm_cfg=LMConfig(5, 15),
                                          device="cpu", dtype=torch.float64, **kw)
    want = jax_batch.optimize_trajectory_batch(list(problems), skel, lm_cfg=JaxLMConfig(5, 15),
                                               dtype=jax.numpy.float64, **kw)
    for a, b in zip(got, want):
        assert a.pose3d.shape == b.pose3d.shape
        assert np.abs(_joints(a) - _joints(b)).max() <= 1e-6  # cm
        np.testing.assert_array_equal(a.vel_constraints, b.vel_constraints)
        np.testing.assert_array_equal(a.refined_contacts, b.refined_contacts)
        assert float(a.floor_normal @ b.floor_normal) >= 1 - 1e-12


def test_float32_stages_stay_inside_chip_bounds(problems, skel, monkeypatch):
    """chip_smoke.py [15] holds the card's float32 stages (IK 200 LU, then
    LM 5:15 twice, each from the card's input) to the CPU's at fixed bounds.
    Here the CPU's own spread under a one-ulp change of each stage's input
    stays 4x inside them (read: IK 1.2e-4 cm, LM 1 1.2e-3 cm, LM 2 4.6e-3
    cm), and the same IK with its matmul inputs rounded to TF32 breaks the
    IK bound (read: 5.0e-3 cm)."""
    f32, eps = torch.float32, torch.finfo(torch.float32).eps
    lay64 = Layout(skel.parents, "cpu", torch.float64)

    def ik(scale):
        moved = [dict(p, pose3d=p["pose3d"] * scale) for p in problems]
        arrs, F = batch.prepare_batch_arrays(moved, skel, device="cpu", dtype=f32)
        consts = batch.batch_consts(skel.parents, F, IKConfig(200, 7.0, solver="lu"), "cpu", f32)
        return arrs, consts, batch.initial_x(*batch.ik_init_batch(arrs, consts))

    arrs, consts, x0 = ik(1.0)
    real = arrs["fmask"].bool()

    def world(x):
        y, r = data_order_positions(x.double().reshape(2, -1, 87), arrs["offsets"].double(),
                                    lay64)
        return (y + r.unsqueeze(2))[real]

    def cm(a, b):
        return float((world(a) - world(b)).abs().max())

    spread_ik = max(cm(ik(1 + k * eps)[2], x0) for k in (1, -1))
    zero3 = torch.zeros((2, 3), dtype=f32)
    data = batch.make_data(arrs, consts, arrs["vc"], zero3, zero3)

    def lm(x, d, w):
        return batch.lm_stage(x, d, w, consts, LMConfig(5, 15))

    x1 = lm(x0, data, trajectory.STAGE1)
    normal, point, vc = batch.floor_stage(x1, arrs, consts)
    data2 = batch.make_data(arrs, consts, vc, normal, point)
    x2 = lm(x1, data2, trajectory.STAGE2)
    spread_lm = max(max(cm(lm(x0 * (1 + k * eps), data, trajectory.STAGE1), x1),
                        cm(lm(x1 * (1 + k * eps), data2, trajectory.STAGE2), x2)) for k in (1, -1))
    assert spread_ik * 4 <= SMALL_IK_MAX_D, spread_ik
    assert spread_lm * 4 <= SMALL_LM_MAX_D, spread_lm
    mm = torch.matmul
    monkeypatch.setattr(torch, "matmul", lambda a, b: mm(tf32_rounded(a), tf32_rounded(b)))
    assert cm(ik(1.0)[2], x0) > SMALL_IK_MAX_D


def test_entry_points_default_to_cuda(problems, skel):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the test is of a machine without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        batch.optimize_trajectory_batch([problems[1]], skel, ik_iterations=1,
                                        lm_cfg=LMConfig(1, 1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _single(problems[1], skel)


def _read_kinematic_results(out):
    anim, names, _ = bvh.load(os.path.join(out, "final_test.bvh"))
    with open(os.path.join(out, "floor_out.txt")) as f:
        normal = np.array([float(v) for v in f.readline().split()])
        point = np.array([float(v) for v in f.readline().split()])
    return anim, names, normal, point, np.load(os.path.join(out, "foot_contacts.npy"))


def test_cli_kinematic_matches_chd_tpu(tmp_path, skel):
    skel_bvh = str(tmp_path / "combined_body_25.bvh")
    names = [f"joint_{j}" for j in range(len(skel.parents))]
    bvh.save(skel_bvh, skel.slice_frames(0, 1), names)
    port_dir = synth_video_dir(str(tmp_path / "port"), skel)
    jax_dir = synth_video_dir(str(tmp_path / "jax"), skel)
    budget = ["kinematic.ik_iterations=20", "kinematic.lm_iters=8", "kinematic.cg_iters=30"]
    assert cli.main(["kinematic", "--video-dir", port_dir, "--skel-path", skel_bvh,
                     "--device", "cpu", "--set", *budget]) == 0
    cfg = JaxPipelineConfig(kinematic=JaxKinematicConfig(
        skel_path=skel_bvh, ik_iterations=20, lm_iters=8, cg_iters=30))
    jax_run_kinematic_stage(jax_dir, cfg)

    got = _read_kinematic_results(os.path.join(port_dir, "kinematic_results"))
    want = _read_kinematic_results(os.path.join(jax_dir, "kinematic_results"))
    assert got[1] == want[1] == names
    np.testing.assert_array_equal(got[4], want[4])
    assert got[4].shape == (12, 4)
    assert float(got[2] @ want[2]) >= 1 - 1e-6
    np.testing.assert_allclose(got[3], want[3], atol=0.05)
    gp = [fk.positions_global(torch.from_numpy(a.rotations), torch.from_numpy(a.positions),
                              a.parents).numpy() for a in (got[0], want[0])]
    assert np.abs(gp[0] - gp[1]).max() < 0.05  # cm


def test_port_physics_reads_chd_tpu_kinematic_results(tmp_path, skel):
    skel_bvh = str(tmp_path / "combined_body_25.bvh")
    bvh.save(skel_bvh, skel.slice_frames(0, 1), [f"joint_{j}" for j in range(len(skel.parents))])
    jax_dir = synth_video_dir(str(tmp_path / "jax"), skel)
    cfg = JaxPipelineConfig(character="combined", kinematic=JaxKinematicConfig(
        skel_path=skel_bvh, ik_iterations=20, lm_iters=8, cg_iters=30))
    jax_run_kinematic_stage(jax_dir, cfg)
    jax_run_retarget_stage(jax_dir, cfg)
    res = run_physics_stage(jax_dir, PipelineConfig(character="combined").override(**{
        "physics.al_iters_fit": 1, "physics.al_iters_dyn": 1, "physics.al_iters_height": 1,
        "physics.al_iters_durations": 1, "physics.lm_iters": 3, "physics.cg_iters": 10}),
        device="cpu")
    assert np.isfinite(list(res["stats"].values())).all()
    assert sorted(os.listdir(os.path.join(jax_dir, "phys_optim_in_combined"))) == [
        "contact_info.txt", "motion_info.txt", "skel_info.txt", "terrain_info.txt"]
    labels = ("no_dynamics", "dynamics", "durations")
    assert sorted(os.listdir(res["out_dir"])) == sorted(
        [f"sol_out_{s}.txt" for s in labels] + ["success_log.txt"]
        + [f"dance_synth_combined_{s}.bvh" for s in labels])
    for label in labels:
        anim, _, _ = bvh.load(os.path.join(res["out_dir"], f"dance_synth_combined_{label}.bvh"))
        assert anim.num_joints == 28 and anim.num_frames == 12


@pytest.mark.slow
def test_trajectory_solution_matches_golden():
    """The port on trajectory_golden.npz at its pinned 50:100, held to the
    gates of tests/test_goldens.py::test_trajectory_solution_matches_golden
    (the code of chip_smoke.py's phase 14)."""
    _, gates = trajectory_golden_gates(np.load(GOLDEN), device="cpu")
    assert gates["cos"] > 0.9994 and gates["offset"] < 2.0, gates
    assert gates["contacts_equal"], gates
    assert gates["mean_err"] < 2.0 and gates["median_err"] < 2.0, gates
    assert gates["median_px"] < gates["px_bound"], gates
    assert gates["cost"] <= gates["golden_cost"] * 1.001, gates
