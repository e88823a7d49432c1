"""chd_tpu_torch's retargeting and the re-application of physics results
(retarget/mixamo.py, physics/apply.py) against chd_tpu's, in float64 on the
CPU.

Tolerances:
- ``retarget`` of the 28-joint combined fixture onto the 67-joint ybot
  fixture at 5 IK iterations (the LU solve of 402 unknowns a frame):
  joint positions within 1e-5 cm of chd_tpu's, the same names;
- ``apply_results`` (30 translate IK iterations toward a physics result,
  heels added) and ``remove_heel``: joint positions within 1e-5 cm, the
  original slice and the COM equal to 1e-9, 67 joints after the heels go.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chd_tpu.core import bvh as jax_bvh
from chd_tpu.core import fk as jax_fk
from chd_tpu.physics import apply as jax_apply
from chd_tpu.physics import towr_io as jax_towr_io
from chd_tpu.retarget import mixamo as jax_mixamo
from chd_tpu_torch.core import bvh, fk
from chd_tpu_torch.physics import apply, towr_io
from chd_tpu_torch.physics.prepare import prepare_input
from chd_tpu_torch.physics.types import PhysResult
from chd_tpu_torch.retarget import mixamo

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "prepare_input")
COMBINED = os.path.join(FIXTURES, "combined", "motion.bvh")
YBOT = os.path.join(FIXTURES, "ybot", "motion.bvh")


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


def _joints(anim) -> np.ndarray:
    return fk.positions_global(torch.as_tensor(np.asarray(anim.rotations), dtype=torch.float64),
                               torch.as_tensor(np.asarray(anim.positions), dtype=torch.float64),
                               anim.parents).numpy()


def test_retarget_matches_chd_tpu(tmp_path):
    src, _, _ = bvh.load(COMBINED)
    out = str(tmp_path / "ybot_out.bvh")
    got, names = mixamo.retarget(src, "ybot", YBOT, ik_iterations=5, out_bvh=out, device="cpu",
                                 dtype=torch.float64)
    jsrc, _, _ = jax_bvh.load(COMBINED)
    want, jnames = jax_mixamo.retarget(jsrc, "ybot", YBOT, ik_iterations=5)
    assert names == jnames and got.num_joints == 67
    assert np.abs(_joints(got) - _joints(want)).max() <= 1e-5  # cm
    saved, saved_names, _ = bvh.load(out)
    assert saved_names == names and saved.num_frames == src.num_frames
    np.testing.assert_allclose(_joints(saved), _joints(got), atol=1e-3)  # %f text
    for x in (np.array([0.3, -1.2, 4.0]), np.array([[1.0, 2.0], [0.5, -3.0]])):
        assert np.allclose(mixamo.softmin(x, 0.5, axis=0), jax_mixamo.softmin(x, 0.5, axis=0))
        assert np.allclose(mixamo.softmax(x), jax_mixamo.softmax(x))


def test_apply_results_and_remove_heel_match_chd_tpu(tmp_path):
    """A physics result near the prepared ybot problem (the COM moved by up
    to 2 cm, the feet by up to 1 cm), written and loaded as the pipeline
    does, then applied by both packages."""
    cdir = os.path.dirname(YBOT)
    anim, _, _ = bvh.load(YBOT)
    with open(os.path.join(cdir, "floor_out.txt")) as f:
        normal = np.array([float(x) for x in f.readline().split()])
        point = np.array([float(x) for x in f.readline().split()])
    contacts = np.load(os.path.join(cdir, "foot_contacts.npy"))
    phys = prepare_input(anim, normal, point, contacts, "ybot")
    rng = np.random.default_rng(2)
    F = contacts.shape[0]
    res = PhysResult(phys.dt, phys.base_lin + torch.from_numpy(rng.uniform(-0.02, 0.02, (F, 3))),
                     phys.base_ang, phys.ee_pos + torch.from_numpy(rng.uniform(-0.01, 0.01,
                                                                               (4, F, 3))),
                     torch.zeros(4, F, 3), phys.contact)
    sol = str(tmp_path / "sol_out_dynamics.txt")
    towr_io.save_solution(res, sol)

    got, og, com = apply.apply_results(towr_io.load_results(sol), anim, "ybot", device="cpu",
                                       dtype=torch.float64)
    janim, _, _ = jax_bvh.load(YBOT)
    want, jog, jcom = jax_apply.apply_results(jax_towr_io.load_results(sol), janim, "ybot")
    assert got.num_joints == want.num_joints == 69
    assert np.abs(_joints(got) - _joints(want)).max() <= 1e-5  # cm
    np.testing.assert_allclose(com, np.asarray(jcom), atol=1e-9)
    np.testing.assert_allclose(og.positions, np.asarray(jog.positions), atol=1e-9)
    np.testing.assert_allclose(
        _joints(og), np.asarray(jax_fk.positions_global(jnp.asarray(jog.rotations),
                                                        jnp.asarray(jog.positions),
                                                        jog.parents)), atol=1e-9)
    no_heel, jno_heel = apply.remove_heel(got), jax_apply.remove_heel(want)
    assert no_heel.num_joints == jno_heel.num_joints == 67
    assert no_heel.parents == tuple(jno_heel.parents)
    np.testing.assert_array_equal(no_heel.offsets, np.asarray(jno_heel.offsets))
    assert np.abs(_joints(no_heel) - _joints(jno_heel)).max() <= 1e-5


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the test is of a machine without it")
    src, _, _ = bvh.load(COMBINED)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mixamo.retarget(src, "ybot", YBOT, ik_iterations=1)
    loaded = towr_io.LoadedResults(4, 1 / 30, np.zeros((12, 3)), np.zeros((12, 3)),
                                   np.tile(np.eye(3), (12, 1, 1)), np.zeros((12, 4, 3)),
                                   np.zeros((12, 4, 3)), np.ones((12, 4), int))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        apply.apply_results(loaded, src, "combined")
