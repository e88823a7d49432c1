"""The whole per-video pipeline of chd_tpu_torch (``cli.main(["run", ...])``:
kinematic → retarget → physics) on a synthetic video dir, on the CPU, and
its artifacts against chd_tpu's.

- The ``run`` command for ``ybot`` (the in-repo 67-joint template) writes
  every artifact of chd_tpu/pipeline/run.py's layout: ``success_log.txt``
  parses, the three solutions load, the three BVHs load with 67 joints.
- For ``combined`` (retargeting is a copy, so chd_tpu's side stays small):
  chd_tpu's physics stage reads the ``kinematic_results/`` that the port's
  ``run`` wrote, and writes the same tree of files as the port's, with the
  port's ``phys_optim_in_combined/`` problem (values within 1e-6: both cast
  the problem to float32). The other direction, the port's physics stage
  on a ``kinematic_results/`` that chd_tpu wrote, is
  tests/test_torch_trajectory.py::test_port_physics_reads_chd_tpu_kinematic_results,
  beside the run of chd_tpu's kinematic stage it shares a compile with.
"""
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from chd_tpu.pipeline import run as jax_run
from chd_tpu.utils.config import PhysicsConfig as JaxPhysicsConfig
from chd_tpu.utils.config import PipelineConfig as JaxPipelineConfig
from chd_tpu_torch.core import bvh
from chd_tpu_torch.core.animation import Animation
from chd_tpu_torch.physics import towr_io
from chd_tpu_torch.pipeline import cli
from chip_smoke import synth_video_dir

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
YBOT = os.path.join(FIXTURES, "prepare_input", "ybot", "motion.bvh")
KIN = {"kinematic.ik_iterations": 20, "kinematic.lm_iters": 8, "kinematic.cg_iters": 30}
PHYS = {"physics.al_iters_fit": 1, "physics.al_iters_dyn": 1, "physics.al_iters_height": 1,
        "physics.al_iters_durations": 1, "physics.lm_iters": 3, "physics.cg_iters": 10}
INPUT_FILES = ["contact_info.txt", "motion_info.txt", "skel_info.txt", "terrain_info.txt"]


def layout(character: str, video: str = "dance_synth") -> dict:
    """chd_tpu/pipeline/run.py's artifacts of one video dir."""
    return {
        "kinematic_results": sorted(["final_test.bvh", "floor_out.txt", "foot_contacts.npy",
                                     f"{character}_out.bvh"]),
        f"phys_optim_in_{character}": INPUT_FILES,
        f"phys_optim_out_{character}": sorted(
            [f"sol_out_{s}.txt" for s in ("no_dynamics", "dynamics", "durations")]
            + ["success_log.txt"]
            + [f"{video}_{character}_{s}.bvh" for s in ("no_dynamics", "dynamics", "durations")]),
    }


def tree(video_dir: str) -> dict:
    return {d: sorted(os.listdir(os.path.join(video_dir, d))) for d in sorted(os.listdir(video_dir))
            if os.path.isdir(os.path.join(video_dir, d)) and d != "openpose_result"}


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
def skel_bvh(tmp_path_factory):
    g = np.load(os.path.join(FIXTURES, "trajectory_golden.npz"))
    skel = Animation(g["skel_rotations"], g["skel_positions"], g["skel_orients"],
                     g["skel_offsets"], [int(p) for p in g["skel_parents"]])
    path = str(tmp_path_factory.mktemp("skel") / "combined_body_25.bvh")
    bvh.save(path, skel.slice_frames(0, 1), [f"joint_{j}" for j in range(len(skel.parents))])
    return path, skel


def _run(data, character, skel_bvh, *extra):
    sets = [f"{k}={v}" for k, v in {**KIN, **PHYS}.items()]
    return cli.main(["run", "--data", data, "--character", character, "--skel-path", skel_bvh,
                     *extra, "--device", "cpu", "--set", *sets])


def test_cli_run_writes_every_artifact(tmp_path, skel_bvh):
    path, skel = skel_bvh
    vd = synth_video_dir(str(tmp_path / "data"), skel)
    assert _run(str(tmp_path / "data"), "ybot", path, "--char-bvh", YBOT) == 0
    assert tree(vd) == layout("ybot")
    out = os.path.join(vd, "phys_optim_out_ybot")
    assert set(towr_io.load_success_log(os.path.join(out, "success_log.txt"))) == {
        "dynamics", "durations"}
    for label in ("no_dynamics", "dynamics", "durations"):
        res = towr_io.load_results(os.path.join(out, f"sol_out_{label}.txt"))
        assert res.base_pos.shape == (12, 3) and np.isfinite(res.feet_force).all()
        anim, names, _ = bvh.load(os.path.join(out, f"dance_synth_ybot_{label}.bvh"))
        assert anim.num_joints == 67 and anim.num_frames == 12 and len(names) == 67
        assert np.isfinite(anim.positions).all()


def _inputs(video_dir):
    d = os.path.join(video_dir, "phys_optim_in_combined")
    out = {}
    for name in INPUT_FILES:
        with open(os.path.join(d, name)) as f:
            out[name] = [np.array([float(v) for v in ln.split()]) for ln in f if ln.strip()]
    return out


def test_chd_tpu_physics_reads_the_ports_kinematic_results(tmp_path, skel_bvh):
    path, skel = skel_bvh
    port_dir = synth_video_dir(str(tmp_path / "port"), skel)
    assert _run(str(tmp_path / "port"), "combined", path) == 0
    assert tree(port_dir) == layout("combined")

    mixed = os.path.join(str(tmp_path / "jax_on_port"), "dance_synth")
    shutil.copytree(os.path.join(port_dir, "kinematic_results"),
                    os.path.join(mixed, "kinematic_results"))
    # chd_tpu's durations branch compiles for ~45 s on the CPU; its stage-2
    # branch writes the same files
    jcfg = JaxPipelineConfig(character="combined", physics=JaxPhysicsConfig(
        al_iters_fit=1, al_iters_dyn=1, al_iters_height=1, lm_iters=3, cg_iters=10,
        optimize_durations=False))
    jax_run.run_physics_stage(mixed, jcfg)
    assert tree(mixed) == tree(port_dir)
    a, b = _inputs(mixed), _inputs(port_dir)
    for name in INPUT_FILES:
        assert len(a[name]) == len(b[name]), name
        for i, (x, y) in enumerate(zip(a[name], b[name])):
            np.testing.assert_allclose(x, y, atol=1e-6, err_msg=f"{name} line {i}")
    assert towr_io.load_success_log(os.path.join(mixed, "phys_optim_out_combined",
                                                 "success_log.txt"))
    for label in ("no_dynamics", "dynamics", "durations"):
        anim, _, _ = bvh.load(os.path.join(mixed, "phys_optim_out_combined",
                                           f"dance_synth_combined_{label}.bvh"))
        assert anim.num_joints == 28 and anim.num_frames == 12
