"""chd_tpu_torch.parallel.mesh and the data-parallel entry points over 2 gloo
ranks on the CPU, against chd_tpu (tests/test_parallel.py) and against the
port's own unsharded calls.

One module-scoped spawn of 2 ranks (``parallel.dryrun.run_ranks``) runs
every rank-side check; the tests hold what came back:
- the mesh's shape and errors against chd_tpu's ``make_mesh`` on its
  virtual 8-device mesh (the single-process form's grid is chd_tpu's
  device grid), and each rank's coordinate;
- data-parallel detection (the plain MLP on the CPU) equal to the port's
  unsharded detection on every frame, and to chd_tpu's sharded
  ``_batched`` on every frame whose label survives a ±1e-3 move of the 0.5
  threshold (float32 sums of two packages);
- the physics batch (``solve_physics_full_batch``, ``solve_physics_batch``,
  ``solve_physics_durations_batch``) and the kinematic batch
  (``optimize_trajectory_batch``, LU IK) sharded over the 2 ranks, float64,
  tiny budgets, against the same calls unsharded: within 1e-9 m and 1e-6
  cm, equal contacts and flags;
- ``replicate`` and ``distributed.global_batch_from_local``;
- a batch that does not divide over the ranks raises.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from chd_tpu.contact.infer import ContactDetector as JaxContactDetector
from chd_tpu.models import contact_mlp as jax_contact_mlp
from chd_tpu.parallel import mesh as jax_mesh
from chd_tpu_torch.contact.infer import ContactDetector
from chd_tpu_torch.kinematics import batch as kin_batch
from chd_tpu_torch.kinematics.lm import LMConfig
from chd_tpu_torch.models import torch_convert
from chd_tpu_torch.parallel import batch as phys_batch_lib
from chd_tpu_torch.parallel import mesh as mesh_lib
from chd_tpu_torch.parallel.dryrun import run_ranks
from chd_tpu_torch.physics import collocation
from chd_tpu_torch.physics.synth import walking_input
from chd_tpu_torch.physics.types import PhysWeights
from chip_smoke import SMALL_LM_MAX_D, TRAJ_GOLDEN, golden_skeleton, kin_problem
from test_torch_contact_infer import _stable

import torch_rank_workers as workers

RANKS = 2
PHYS_CFG = collocation.SolveConfig(1, 1, 1, 1, lm=LMConfig(2, 6, 1e-2))
KIN = dict(ik_iterations=10, lm_cfg=LMConfig(max_iters=5, cg_iters=15))
PHYS_MAX_D, KIN_MAX_D = 1e-9, 1e-6  # m; cm


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread (as the other solver test modules; not raised
    again: a count raised back hangs MKL's next batched LU)."""
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def inputs():
    params, state = jax_contact_mlp.init(jax.random.PRNGKey(0), jax_contact_mlp.ModelConfig())
    kp = np.random.default_rng(0).uniform(0, 5, size=(8, 40, 25, 3)).astype(np.float32)
    skel = golden_skeleton(np.load(TRAJ_GOLDEN))
    rng = np.random.default_rng(4)
    return dict(
        params=params, state=state, kp=kp,
        state_dict={k: v.numpy() for k, v in
                    torch_convert.from_jax_params(jax.tree.map(np.asarray, params),
                                                  jax.tree.map(np.asarray, state))
                    .state_dict().items()},
        phys=[walking_input(12, seed=0), walking_input(10, seed=1)],
        kin=dict(KIN, skeleton=skel, problems=[kin_problem(rng, skel, 16),
                                               kin_problem(rng, skel, 12)]))


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return run_ranks(workers.parallel_checks, RANKS, "cpu",
                     args=(inputs["kp"], inputs["state_dict"], inputs["phys"], PHYS_CFG,
                           inputs["kin"]),
                     timeout=300.0, workdir=str(tmp_path_factory.mktemp("ranks")))


@pytest.mark.parametrize("n, data, model", [(8, None, 2), (8, None, 1), (4, 2, 2), (2, None, 1),
                                            (8, 3, 2), (6, None, 4)])
def test_mesh_shapes_match_chd_tpu(n, data, model):
    """The single-process form's grid is chd_tpu's device grid; the same
    layouts raise."""
    try:
        want = jax_mesh.make_mesh(n_devices=n, data=data, model=model)
    except ValueError as e:
        with pytest.raises(ValueError, match=r"× model"):
            mesh_lib.make_mesh(n, data, model, device="cpu")
        assert "× model" in str(e)
        return
    got = mesh_lib.make_mesh(n, data, model, device="cpu")
    assert got.shape == dict(want.shape)
    np.testing.assert_array_equal(got.grid, np.vectorize(lambda d: d.id)(want.devices))
    assert not got.distributed and got.n_batch == want.shape["data"]


def test_rank_mesh_layout(ranks):
    for r, out in enumerate(ranks):
        assert out["rank"] == r
        assert out["shape"] == {"data": RANKS, "model": 1}
        assert out["coordinate"] == (r, 0) and out["batch_index"] == r


def test_replicate_and_global_batch_from_local(ranks):
    """``replicate`` gives every rank rank 0's tensor; the ceil split of 5
    rows over 2 ranks (3 and 2) comes back as the global batch."""
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["replicated"], np.zeros((2, 3)))
        assert out["local_rows"] == (3, 2)[r]
        np.testing.assert_array_equal(out["global_rows"],
                                      np.arange(15, dtype=np.float32).reshape(5, 3))


def test_dp_detection_matches_chd_tpu_sharded(ranks, inputs):
    """As tests/test_parallel.py::test_batched_contact_inference_sharded."""
    det_j = JaxContactDetector(inputs["params"], inputs["state"], use_pallas=False)
    sharded = jax_mesh.shard_batch(jax_mesh.make_mesh(model=1), jnp.asarray(inputs["kp"]))
    want_j = np.asarray(det_j._batched(sharded, det_j.folded)[0])
    det = ContactDetector(torch_convert.from_state_dict(inputs["state_dict"]), device="cpu")
    plain, probs = det.infer(torch.from_numpy(inputs["kp"]))
    stable = _stable(probs)
    assert stable.mean() > 0.95
    for out in ranks:
        np.testing.assert_array_equal(out["contacts"], plain.numpy())
        np.testing.assert_array_equal(np.where(stable, out["contacts"], 0),
                                      np.where(stable, want_j, 0))


def test_sharded_physics_batch_equals_unsharded(ranks, inputs):
    batched, _ = phys_batch_lib.pad_phys_inputs(inputs["phys"], device="cpu",
                                                dtype=torch.float64)
    res_fit, res_dyn, res, stats, ok = phys_batch_lib.solve_physics_full_batch(
        batched, PhysWeights(), PHYS_CFG)
    _, rd = phys_batch_lib.solve_physics_batch(batched, PhysWeights(), PHYS_CFG)
    _, _, ok_d = phys_batch_lib.solve_physics_durations_batch(batched, rd, PhysWeights(),
                                                              PHYS_CFG)
    want = dict(fit=res_fit.base_lin, dyn=res_dyn.base_lin, base_lin=res.base_lin,
                ee_force=res.ee_force, dyn_stat=stats["dyn"], staged_dyn=rd.base_lin)
    for out in ranks:
        got = out["physics"]
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v.numpy(), rtol=0, atol=PHYS_MAX_D, err_msg=k)
        np.testing.assert_array_equal(got["contact"], res.contact.numpy())
        np.testing.assert_array_equal(got["ok"], ok)
        np.testing.assert_array_equal(got["staged_ok"], ok_d)


def test_sharded_kinematic_batch_equals_unsharded(ranks, inputs):
    kin = inputs["kin"]
    want = kin_batch.optimize_trajectory_batch(
        kin["problems"], kin["skeleton"], ik_iterations=kin["ik_iterations"],
        lm_cfg=kin["lm_cfg"], device="cpu", dtype=torch.float64, ik_solver="lu")
    for out in ranks:
        assert len(out["kinematic"]) == len(want)
        for (pose3d, normal, refined, vc), w in zip(out["kinematic"], want):
            assert pose3d.shape == w.pose3d.shape
            np.testing.assert_allclose(pose3d, w.pose3d, rtol=0, atol=KIN_MAX_D)
            np.testing.assert_allclose(normal, w.floor_normal, rtol=0, atol=1e-12)
            np.testing.assert_array_equal(refined, w.refined_contacts)
            np.testing.assert_array_equal(vc, w.vel_constraints)


def test_indivisible_batch_raises(ranks):
    for out in ranks:
        assert out["indivisible"] is not None and "does not divide" in out["indivisible"]
    with pytest.raises(ValueError, match="does not divide"):
        mesh_lib.shard_batch(mesh_lib.make_mesh(2, device="cpu"), torch.zeros(3, 4))


@pytest.fixture(scope="module")
def cli_ranks(tmp_path_factory):
    """The ``run`` command in 2 ranks on one synthetic video dir, its
    kinematic stage frame-sharded over them (the threshold branch), and the
    same kinematic stage in one process over the single-process form of 2
    shards, on a copy of the dir."""
    from chd_tpu_torch.core import bvh
    from chd_tpu_torch.pipeline import run as run_lib
    from chd_tpu_torch.utils.config import PipelineConfig
    from chip_smoke import synth_video_dir
    from test_torch_pipeline_run import KIN, PHYS

    root = tmp_path_factory.mktemp("cli_ranks")
    skel = golden_skeleton(np.load(TRAJ_GOLDEN))
    skel_path = str(root / "combined_body_25.bvh")
    bvh.save(skel_path, skel.slice_frames(0, 1), [f"joint_{j}" for j in range(len(skel.parents))])
    vd = synth_video_dir(str(root / "data"), skel)
    one = synth_video_dir(str(root / "one"), skel)
    sets = {**KIN, **PHYS, "kinematic.frame_shard_threshold": 2}
    argv = ["run", "--data", str(root / "data"), "--character", "combined", "--skel-path",
            skel_path, "--device", "cpu", "--set", *[f"{k}={v}" for k, v in sets.items()]]
    outs = run_ranks(workers.cli_run, RANKS, "cpu", args=(argv, vd), timeout=300.0,
                     workdir=str(root))
    cfg = PipelineConfig().override(**{k: v for k, v in sets.items() if k.startswith("kin")},
                                    **{"kinematic.skel_path": skel_path})
    run_lib.run_kinematic_stage(one, cfg, device="cpu",
                                mesh=mesh_lib.local_mesh(RANKS, device="cpu"))
    return dict(outs=outs, vd=vd, one=one)


def test_cli_run_over_ranks_writes_once_and_reads_back(cli_ranks):
    """Under a 2-rank group the ``run`` command writes every artifact of the
    layout once: each rank reads back the files as they stand when the
    command ends, the kinematic results agree with those of the same shard
    in one process, and ``on_primary`` ran its function on rank 0 alone.
    The CLI solves in float32, where the two forms' sums round apart: read
    1.7e-3 cm, 2.3e-3 degrees and 8e-3 cm on the floor point; the bounds are
    chip_smoke.py's float32 bound of an LM stage (SMALL_LM_MAX_D, 0.05 cm)
    and 0.05 degrees. A halo or ownership fault moves the shard edges'
    frames by whole cm."""
    from chd_tpu_torch.core import bvh
    from test_torch_pipeline_run import layout, tree

    vd, outs = cli_ranks["vd"], cli_ranks["outs"]
    assert tree(vd) == layout("combined")
    for r, out in enumerate(outs):
        assert out["rc"] == 0
        assert out["calls"] == ([0] if r == 0 else [])
        assert out["primary_result"] == "from rank 0"
        for name, data in out["files"].items():
            with open(f"{vd}/{name}", "rb") as f:
                assert data == f.read(), (r, name)
    kin, kin_one = f"{vd}/kinematic_results", f"{cli_ranks['one']}/kinematic_results"
    got, _, _ = bvh.load(f"{kin}/final_test.bvh")
    want, _, _ = bvh.load(f"{kin_one}/final_test.bvh")
    np.testing.assert_allclose(got.positions[:, 0], want.positions[:, 0], rtol=0,
                               atol=SMALL_LM_MAX_D)
    np.testing.assert_allclose(got.rotations, want.rotations, rtol=0, atol=0.05)
    np.testing.assert_array_equal(np.load(f"{kin}/foot_contacts.npy"),
                                  np.load(f"{kin_one}/foot_contacts.npy"))
    floor, floor_one = (np.loadtxt(f"{d}/floor_out.txt") for d in (kin, kin_one))
    np.testing.assert_allclose(floor[0], floor_one[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(floor[1], floor_one[1], rtol=0, atol=SMALL_LM_MAX_D)
