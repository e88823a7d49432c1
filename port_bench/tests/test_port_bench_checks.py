"""The check that decides ``correct``, on the CPU at tiny sizes: each
reference agrees with the program's CPU path, a run of each cell comes out
correct, the control in the program's place does not, and neither does a
run with a fault planted in the program's timed path."""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)

import harness  # noqa: E402
from conftest import run_cell  # noqa: E402

CELLS = ("detect.lower.v512x240", "kin.combined28.b16x100")
CELL_FAULTS = {"detect.lower.v512x240": ("detect.half", "detect.altered"),
               "kin.combined28.b16x100": ("kin.unchanged", "kin.half", "kin.altered")}


def tiny_run(cell: str):
    import copy

    from conftest import TINY_KINEMATIC, TINY_TRAFFIC

    wl = copy.deepcopy(harness.workload(cell))
    wl["traffic"].update(TINY_TRAFFIC[cell])
    cfg = copy.deepcopy(harness.config(wl["config"]))
    if cfg["name"] == "refine_default":
        for k in ("ik_iterations", "ik_solver"):
            cfg["kinematic"][k] = TINY_KINEMATIC[k]
        cfg["kinematic"]["lm"].update(TINY_KINEMATIC["lm"])
    d = harness.load("drivers", wl["driver"])
    return d, d.setup(cfg, wl, 2**31 + 17, torch.device("cpu"))


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_programs_cpu_path(cell):
    """float32 on the CPU against the reference: well inside the limits."""
    d, run = tiny_run(cell)
    d.window(run, 0.01)
    for c in d.check(run):
        assert c["value"] <= c["limit"] / 3, c


def test_kinematic_reference_in_float64_follows_the_program_in_float64():
    """With the LU IK (the tiny configuration's): the CG IK's 64 iterations
    do not converge, and part on roundings (1e-15 in its system moves its
    answer by ~1e-4)."""
    from chd_tpu_torch.kinematics import batch as batch_lib

    d, run = tiny_run("kin.combined28.b16x100")
    kin, cam = run.cfg["kinematic"], run.cfg["camera"]
    res = batch_lib.optimize_trajectory_batch(
        run.problems, run.skel, cam_focal=tuple(cam["focal"]), cam_pp=tuple(cam["pp"]),
        ik_iterations=kin["ik_iterations"], lm_cfg=run.lm_cfg, device="cpu",
        dtype=torch.float64, ik_solver=kin["ik_solver"])
    ref = d.reference(run)
    run.out = res
    got = d.compare(run, d.outputs(run), ref)
    # the LM's unconverged PCG carries roundings up to ~1e-8 cm
    assert got["joint_gap_cm"] < 1e-6 and abs(got["cost_excess"]) < 1e-9
    assert got["floor_offset_cm"] < 1e-6
    assert all(np.array_equal(r.vel_constraints, v) for r, v in zip(
        [res[i] for i in run.sample], ref["vc"].cpu().numpy()))


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_the_programs_place_is_not_correct(cell):
    """The driver's first control, judged by its own check."""
    d, run = tiny_run(cell)
    compared = d.check(run, d.CONTROLS[0])
    assert not harness.correct(compared), compared


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_of_the_cell_is_correct(bench_copy, cell):
    res = run_cell(bench_copy, cell)
    assert res["correct"], res["compared"]
    assert list(res)[-1] == "compared" and res["attempted"] > 0


@pytest.mark.parametrize("cell, fault", [(c, f) for c in CELLS for f in CELL_FAULTS[c]])
def test_a_fault_in_the_timed_path_is_not_correct(bench_copy, cell, fault):
    res = run_cell(bench_copy, cell, fault)
    assert not res["correct"], res["compared"]
