"""The frame-sharded LM of chd_tpu_torch.parallel.longseq against chd_tpu's
(parallel/longseq.py) and its unsharded solve, float64, on the combined
skeleton of tests/fixtures/trajectory_golden.npz.

Three forms of a 4- or 2-way frame shard: gloo groups of 2 and 4 spawned
ranks (``parallel.dryrun.run_ranks``, one module-scoped spawn each, every
check in the ranks) and the single-process form of 4 shards. At F = 24 (an
even split) and 23 (padded), with chd_tpu's tolerances
(tests/test_longseq.py):
- the probe (cost, Jᵀr, diag(JᵀJ)): cost within rtol 1e-12, Jᵀr and the
  diagonal within atol 1e-10 of their largest element, against chd_tpu's
  sharded ``probe_grad_diag(with_diag=False)`` on 4 virtual devices and
  against its unsharded pieces (linearize, transpose, the colored
  diagonal; at 24 frames, F = 23 padded there as chd_tpu's longseq pads it);
- the damped solve (4 iterations, CG 15, init_lambda 1e2, where the iterates
  do not fork on roundings): cost within rtol 1e-9, x within atol 1e-5 of
  chd_tpu's unsharded ``lm_solve``;
- every rank holds the same global result (bitwise);
- the halo exchange's adjoint identity <exchange(x), y> = <x, return(y)>
  within 1e-12 relative, on stacked (batched) shards;
- ``optimize_trajectory_frame_sharded`` against the port's
  ``optimize_trajectory`` at F = 16, IK 10, LM 3:10: pose3d within 0.5 cm,
  floor normal within 1e-3, refined contacts equal;
- fewer frames a shard than the halo raise.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from chd_tpu.kinematics.lm import LMConfig as JaxLMConfig
from chd_tpu.kinematics.lm import frame_coloring_masks as jax_coloring_masks
from chd_tpu.kinematics.lm import lm_solve as jax_lm_solve
from chd_tpu.kinematics.residuals import TermWeights as JaxTermWeights
from chd_tpu.kinematics.residuals import TrajectoryData as JaxTrajectoryData
from chd_tpu.kinematics.residuals import residual_fn_for
from chd_tpu.parallel import longseq as jax_longseq
from chd_tpu.parallel import mesh as jax_mesh
from chd_tpu_torch.characters import defs
from chd_tpu_torch.kinematics import trajectory
from chd_tpu_torch.kinematics.lm import LMConfig
from chd_tpu_torch.kinematics.residuals import TermWeights
from chd_tpu_torch.parallel.dryrun import run_ranks
from chip_smoke import TRAJ_GOLDEN, golden_skeleton, kin_problem

import torch_rank_workers as workers

FORMS = {"gloo2": 2, "gloo4": 4, "local4": 4}
FRAMES = (24, 23)
F_MAX = max(FRAMES)
SOLVE = dict(max_iters=4, cg_iters=15, init_lambda=1e2)
REFINE = dict(F=16, ik_iterations=10, lm=dict(max_iters=3, cg_iters=10, init_lambda=1e-2))
RANK_TIMEOUT = 300.0  # seconds for a whole spawned run


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread (as the other solver test modules; not raised
    again: a count raised back hangs MKL's next batched LU)."""
    torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_executables():
    yield
    jax.clear_caches()


def make_problem(F: int, seed: int = 3) -> dict:
    """chd_tpu's tests/test_longseq.py problem on the golden's skeleton
    (offsets in cm, scaled to m as there), float64 numpy."""
    g = np.load(TRAJ_GOLDEN)
    rng = np.random.default_rng(seed)
    parents = tuple(int(p) for p in g["skel_parents"])
    D = 3 + len(parents) * 3
    conf = np.ones((F, 28))
    conf[:, 25:] = 0
    pose3d = rng.normal(size=(F, 28, 3)) * 0.3
    root = rng.normal(size=(F, 3)) + np.array([0, 0, 4.0])
    p2d = rng.normal(size=(F, 28, 2)) * 0.1
    vc = (rng.uniform(size=(F, 28)) > 0.8).astype(np.float64)
    return dict(x0=rng.normal(size=(F, D)) * 0.05, pose3d=pose3d, root=root, p2d=p2d, pw=conf,
                dw=conf.copy(), sw=np.asarray(defs.COMBINED_SMOOTH_WEIGHTS, np.float64), vc=vc,
                normal=np.array([0.0, -1.0, 0.0]), point=np.array([0.0, 0.9, 0.0]),
                offsets=np.asarray(g["skel_offsets"], np.float64) * 0.01, parents=parents)


def jax_data(p: dict) -> JaxTrajectoryData:
    a = lambda k: jnp.asarray(p[k], jnp.float64)  # noqa: E731
    return JaxTrajectoryData(a("pose3d"), a("root"), a("p2d"), a("pw"), a("dw"), a("sw"),
                             a("vc"), a("normal"), a("point"), a("offsets"))


@pytest.fixture(scope="module")
def problems():
    return {F: make_problem(F) for F in FRAMES}


@pytest.fixture(scope="module")
def refine_problem():
    skel = golden_skeleton(np.load(TRAJ_GOLDEN))
    prob = kin_problem(np.random.default_rng(11), skel, REFINE["F"])
    return dict(prob, skeleton=skel, ik_iterations=REFINE["ik_iterations"],
                lm_cfg=LMConfig(**REFINE["lm"]))


@pytest.fixture(scope="module")
def chd_tpu_refs(problems):
    """chd_tpu's sharded probe (4 virtual devices, no diagonal), its
    unsharded cost, Jᵀr and colored diagonal, and its unsharded damped
    solve, per F. The unsharded pieces run at F_MAX frames, a shorter
    problem padded as chd_tpu's longseq pads it (the last frame repeated
    under a zero frame mask, which no residual reads): one compile serves
    every F."""
    w = JaxTermWeights(floor=10.0)
    mesh = jax_mesh.make_mesh(n_devices=4, model=1)
    parents = problems[F_MAX]["parents"]
    D = problems[F_MAX]["x0"].shape[1]
    residual = residual_fn_for(parents)
    masks = jax_coloring_masks(F_MAX, D, dtype=jnp.float64)

    @jax.jit
    def unsharded(xf, data):
        r, lin = jax.linearize(lambda x: residual(x, data, w), xf)
        vjp = jax.linear_transpose(lin, xf)
        diag = jax.vmap(lambda m: m * vjp(lin(m))[0])(masks).sum(0)
        x, cost = jax_lm_solve(residual, xf, (data, w), JaxLMConfig(**SOLVE), diag_masks=masks)
        return 0.5 * jnp.vdot(r, r), vjp(r)[0], diag, x, cost

    refs = {}
    for F, p in problems.items():
        c_sh, g_sh, _ = jax_longseq.probe_grad_diag(p["x0"], jax_data(p), w, parents, mesh,
                                                    dtype=jnp.float64, with_diag=False)
        pad = lambda a: np.concatenate([a, np.repeat(a[-1:], F_MAX - F, axis=0)])  # noqa: E731
        padded = {k: pad(v) if k in workers.FRAME_KEYS else v for k, v in p.items()}
        mask = jnp.asarray(np.arange(F_MAX) < F, jnp.float64)
        out = unsharded(jnp.asarray(padded["x0"].reshape(-1)),
                        jax_data(padded)._replace(frame_mask=mask))
        c, g, d, x, cost = (np.asarray(v) for v in out)
        n = F * D
        refs[F] = dict(sharded_cost=float(c_sh), sharded_grad=np.asarray(g_sh).reshape(-1),
                       cost=float(c), grad=g[:n], diag=d[:n], x=x[:n], solve_cost=float(cost))
    return refs


@pytest.fixture(scope="module")
def port_runs(problems, refine_problem, tmp_path_factory):
    """Each form's results: a list with one entry per rank (one for the
    single-process form)."""
    args = (problems, TermWeights(floor=10.0), LMConfig(**SOLVE), refine_problem)
    runs = {}
    for form, n in FORMS.items():
        if form.startswith("gloo"):
            runs[form] = run_ranks(workers.longseq_checks, n, "cpu", args=(n,) + args,
                                   timeout=RANK_TIMEOUT,
                                   workdir=str(tmp_path_factory.mktemp(form)))
        else:
            runs[form] = [workers.longseq_checks(n, *args)]
    return runs


def _close(got, want, atol):
    scale = np.abs(want).max()
    np.testing.assert_allclose(np.asarray(got).reshape(-1) / scale, want.reshape(-1) / scale,
                               rtol=0, atol=atol)


@pytest.mark.parametrize("F", FRAMES)
@pytest.mark.parametrize("form", FORMS)
def test_probe_matches_chd_tpu(port_runs, chd_tpu_refs, form, F):
    ranks, ref = port_runs[form], chd_tpu_refs[F]
    got = ranks[0][F]
    np.testing.assert_allclose(got["cost"], ref["sharded_cost"], rtol=1e-12)
    np.testing.assert_allclose(got["cost"], ref["cost"], rtol=1e-12)
    _close(got["grad"], ref["sharded_grad"], 1e-10)
    _close(got["grad"], ref["grad"], 1e-10)
    _close(got["diag"], ref["diag"], 1e-10)
    for other in ranks[1:]:
        assert other[F]["cost"] == got["cost"]
        assert np.array_equal(other[F]["grad"], got["grad"])
        assert np.array_equal(other[F]["diag"], got["diag"])


@pytest.mark.parametrize("F", FRAMES)
@pytest.mark.parametrize("form", FORMS)
def test_damped_solve_matches_chd_tpu(port_runs, chd_tpu_refs, form, F):
    ranks, ref = port_runs[form], chd_tpu_refs[F]
    got = ranks[0][F]
    np.testing.assert_allclose(got["solve_cost"], ref["solve_cost"], rtol=1e-9)
    np.testing.assert_allclose(got["x"].reshape(-1), ref["x"], rtol=0, atol=1e-5)
    for other in ranks[1:]:
        assert np.array_equal(other[F]["x"], got["x"])


@pytest.mark.parametrize("form", FORMS)
def test_halo_exchange_adjoint(port_runs, form):
    for out in port_runs[form]:
        a, b = out["adjoint"]
        assert abs(a - b) <= 1e-12 * max(1.0, abs(a)), (a, b)


@pytest.fixture(scope="module")
def unsharded_refinement(refine_problem):
    p = refine_problem
    return trajectory.optimize_trajectory(
        p["pose2d"], p["conf2d"], p["pose3d"], p["root_pos"], p["smpl_angles"], p["skeleton"],
        p["vel_constraints"], ik_iterations=p["ik_iterations"], lm_cfg=p["lm_cfg"],
        device="cpu", dtype=torch.float64)


@pytest.mark.parametrize("form", FORMS)
def test_full_refinement_matches_optimize_trajectory(port_runs, unsharded_refinement, form):
    want = unsharded_refinement
    for out in port_runs[form]:
        got = out["refine"]
        assert np.isfinite(got["pose3d"]).all()
        np.testing.assert_allclose(got["pose3d"], want.pose3d, rtol=0, atol=0.5)
        np.testing.assert_allclose(got["floor_normal"], want.floor_normal, rtol=0, atol=1e-3)
        np.testing.assert_array_equal(got["refined_contacts"], want.refined_contacts)


@pytest.mark.parametrize("form", FORMS)
def test_fewer_frames_a_shard_than_the_halo_raise(port_runs, form):
    for out in port_runs[form]:
        assert out["short"] is not None and "fewer than the halo" in out["short"]
