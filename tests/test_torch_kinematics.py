"""chd_tpu_torch.kinematics (residuals, lm, ik, floor) against
chd_tpu.kinematics, in float64 on the same seeded numpy inputs.

Tolerances:
- residuals: atol 1e-9 (values up to ~1e4);
- gradient Jᵀr and one JᵀJ·v against ``jax.linearize``: rtol 1e-9 of the
  largest entry;
- the coloring diagonal against the diagonal of a dense
  ``torch.func.jacfwd`` Jacobian at F=5: rtol 1e-10;
- ``lm_solve`` at 3:10: variables atol 1e-6, final cost rtol 1e-9. Each LM step accepts or rejects on a cost comparison, so
  the two packages agree as long as no comparison is within a rounding;
- IK ``_solve``: "lu" atol 1e-9; "cg" atol 2e-3 at 5 iterations (read:
  5.2e-4). 64 CG iterations on an 84-dof system with condition ~1e4 are not
  converged, and there a 1e-15 relative change of the matrix moves their
  result by ~1e-5 relative (measured), so two packages that sum in other
  orders part by ~1e-4 per IK iteration; chd_tpu's own "lu" and "cg" part
  by 5e-4 after one;
- ``ck_ik_golden.npz``: the tolerances of tests/test_goldens.py (eulers
  1e-5, positions 1e-4), in float32 as chd_tpu runs it;
- ``fit_floor``: normal cos >= 1 - 1e-6, intercept within 1e-3, outliers
  equal, with outliers and masked padding in the data;
- ``prune_contacts``: equal.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chd_tpu.characters import defs
from chd_tpu.kinematics import floor as jax_floor
from chd_tpu.kinematics import ik as jax_ik
from chd_tpu.kinematics import lm as jax_lm
from chd_tpu.kinematics import residuals as jax_res
from chd_tpu_torch.core import fk, quat
from chd_tpu_torch.core.animation import Animation
from chd_tpu_torch.kinematics import banded, batch, floor, ik, lm, residuals
from chip_smoke import golden_skeleton, kin_problem

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
GOLDEN = np.load(os.path.join(FIXTURES, "trajectory_golden.npz"))
PARENTS = tuple(int(p) for p in GOLDEN["skel_parents"])
J = len(PARENTS)
D = 3 + 3 * J


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's CPU solves, as the other solver
    files set it: a process that has run one of them at one thread hangs in
    its next batched LU (``torch.linalg.solve_ex``) if the count is raised
    again, so none raises it."""
    torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_executables():
    yield
    jax.clear_caches()


def _problem(seed, F, padded):
    """One sequence's numpy TrajectoryData fields and variables."""
    r = np.random.default_rng(seed)
    data = dict(
        pose3d=r.normal(0, 30, (F, 28, 3)),
        root_trans=r.normal(0, 10, (F, 3)) + [0, -90, 380],
        pose2d_norm=r.normal(0, 0.1, (F, 28, 2)),
        proj_weights=np.where(r.uniform(size=(F, 28)) > 0.3, r.uniform(size=(F, 28)), 0.0),
        data_weights=r.uniform(size=(F, 28)),
        smooth_weights=np.asarray(defs.COMBINED_SMOOTH_WEIGHTS, float),
        vel_constraints=(r.uniform(size=(F, 28)) > 0.5).astype(float),
        floor_normal=np.array([0.0, 1.0, 0.1]) / np.sqrt(1.01),
        floor_point=np.array([0.0, 90.0, 0.0]),
        offsets=GOLDEN["skel_offsets"] * r.uniform(0.8, 1.2, (28, 1)),
        frame_mask=np.array([1.0] * (F - padded) + [0.0] * padded),
    )
    x = np.concatenate([r.normal(0, 10, (F, 3)) + [0, -90, 380],
                        r.normal(0, 0.3, (F, J * 3))], 1).reshape(-1)
    return data, x


def _batch(problems):
    data = residuals.TrajectoryData(**{k: torch.from_numpy(np.stack([p[0][k] for p in problems]))
                                       for k in problems[0][0]})
    return data, torch.from_numpy(np.stack([p[1] for p in problems]))


def _jax_data(d):
    return jax_res.TrajectoryData(**{k: jnp.asarray(v) for k, v in d.items()})


W = dict(floor=10.0)


@pytest.fixture(scope="module")
def problems():
    return [_problem(0, 6, 1), _problem(1, 6, 2)]


def test_trajectory_residuals_match_chd_tpu(problems):
    data, x = _batch(problems)
    lay = residuals.Layout(PARENTS, "cpu", torch.float64)
    got = residuals.trajectory_residuals(x, data, residuals.TermWeights(**W), lay)
    for b, (d, xb) in enumerate(problems):
        want = jax_res.trajectory_residuals(jnp.asarray(xb), _jax_data(d),
                                            jax_res.TermWeights(**W), PARENTS)
        assert got.shape[1] == want.shape[0]
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), atol=1e-9, rtol=0)
    # padded frames add nothing: residuals of a real-only copy equal the rest
    assert torch.isfinite(got).all()


def test_gradient_and_jtjv_match_jax_linearize(problems):
    data, x = _batch(problems)
    lay = residuals.Layout(PARENTS, "cpu", torch.float64)
    v = torch.from_numpy(np.random.default_rng(5).normal(size=x.shape))

    def res(z):
        return lay.residual(z, data, residuals.TermWeights(**W))

    r, vjp_fn = torch.func.vjp(res, x)
    g = vjp_fn(r)[0]
    _, lin = torch.func.vjp(lambda c: vjp_fn(c)[0], torch.zeros_like(r))
    jtjv = vjp_fn(lin(v)[0])[0]
    jtjv_fwd = vjp_fn(torch.func.jvp(res, (x,), (v,))[1])[0]
    for b, (d, xb) in enumerate(problems):
        def fj(z, d=d):
            return jax_res.trajectory_residuals(z, _jax_data(d), jax_res.TermWeights(**W),
                                                PARENTS)

        rj, jvp_lin = jax.linearize(fj, jnp.asarray(xb))
        vjp_lin = jax.linear_transpose(jvp_lin, jnp.asarray(xb))
        gj = np.asarray(vjp_lin(rj)[0])
        hj = np.asarray(vjp_lin(jvp_lin(jnp.asarray(v[b].numpy())))[0])
        np.testing.assert_allclose(g[b].numpy(), gj, atol=1e-9 * np.abs(gj).max(), rtol=0)
        for got in (jtjv, jtjv_fwd):
            np.testing.assert_allclose(got[b].numpy(), hj, atol=1e-9 * np.abs(hj).max(), rtol=0)


def test_kinematic_array_entry_points_default_to_cuda():
    """prepare_batch_arrays, lm.frame_coloring_masks and
    banded.coloring_masks put their arrays on the card unless asked for the
    CPU, as chd_tpu's put theirs on its accelerator: they raise where CUDA
    is absent, and give CPU tensors when asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the test is of a machine without it")
    skel = golden_skeleton(GOLDEN)
    problems = [kin_problem(np.random.default_rng(0), skel, 8)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        batch.prepare_batch_arrays(problems, skel)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm.frame_coloring_masks(8, D)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        banded.coloring_masks(8, D)
    arrs, F = batch.prepare_batch_arrays(problems, skel, device="cpu")
    assert F == 8 and all(a.device.type == "cpu" for a in arrs.values())
    assert lm.frame_coloring_masks(8, D, device="cpu").device.type == "cpu"
    assert banded.coloring_masks(8, D, device="cpu").device.type == "cpu"


def test_coloring_diagonal_is_exact():
    F = 5
    data, x = _batch([_problem(3, F, 0), _problem(4, F, 1)])
    lay = residuals.Layout(PARENTS, "cpu", torch.float64)

    def res(z):
        return lay.residual(z, data, residuals.TermWeights(**W))

    masks = lm.frame_coloring_masks(F, D, dtype=torch.float64, device="cpu")
    r, vjp_fn = torch.func.vjp(res, x)

    def jtjv(v):
        return vjp_fn(torch.func.jvp(res, (x,), (v,))[1])[0]

    m = masks.unsqueeze(1).expand((masks.shape[0],) + x.shape)
    diag = torch.func.vmap(lambda mk: mk * jtjv(mk))(m).sum(0)
    for b in range(2):
        jac = torch.func.jacfwd(lambda z: res(torch.stack([z, x[1 - b]]) if b == 0
                                              else torch.stack([x[0], z]))[b])(x[b])
        want = (jac * jac).sum(0)
        np.testing.assert_allclose(diag[b].numpy(), want.numpy(),
                                   atol=1e-10 * float(want.abs().max()), rtol=0)


def test_lm_solve_matches_chd_tpu(problems):
    data, x = _batch(problems)
    lay = residuals.Layout(PARENTS, "cpu", torch.float64)
    F = problems[0][0]["pose3d"].shape[0]
    cfg = lm.LMConfig(max_iters=3, cg_iters=10)
    args = (data, residuals.TermWeights(**W))
    masks_t = lm.frame_coloring_masks(F, D, dtype=torch.float64, device="cpu")
    got, cost = lm.lm_solve(lay.residual, x, args, cfg, masks_t)
    masks = jax_lm.frame_coloring_masks(F, D, dtype=jnp.float64)
    for b, (d, xb) in enumerate(problems):
        xj, cj = jax_lm.lm_solve(jax_res.residual_fn_for(PARENTS), jnp.asarray(xb),
                                 (_jax_data(d), jax_res.TermWeights(**W)),
                                 jax_lm.LMConfig(max_iters=3, cg_iters=10), diag_masks=masks)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(xj), atol=1e-6, rtol=0)
        np.testing.assert_allclose(float(cost[b]), float(cj), rtol=1e-9)
        assert float(cost[b]) < float(0.5 * (lay.residual(x, data, residuals.TermWeights(**W))[b]
                                             ** 2).sum())


def _ik_problem(seed, F=5):
    """A pose, and targets: the joints of a nearby pose (reachable, as the
    kinematic stage's are)."""
    r = np.random.default_rng(seed)
    e = torch.from_numpy(r.uniform(-0.4, 0.4, (F, J, 3)))
    rot = quat.from_euler(e, "xyz", True).numpy()
    pos = np.broadcast_to(GOLDEN["skel_offsets"], (F, J, 3)).copy()
    pos[:, 0] = r.normal(0, 5, (F, 3))
    tidx = tuple(j for j in range(J) if j not in (13, 14, 15))
    moved = quat.from_euler(e + torch.from_numpy(r.normal(0, 0.1, e.shape)), "xyz", True)
    gp = fk.positions_global(moved, torch.from_numpy(pos), PARENTS)
    tgt = gp[:, list(tidx)].numpy() + r.normal(0, 1.0, (F, len(tidx), 3))
    return rot, pos, tidx, tgt


@pytest.mark.parametrize("solver,atol", [("lu", 1e-9), ("cg", 2e-3)])
def test_ik_solve_matches_chd_tpu(solver, atol):
    rot, pos, tidx, tgt = _ik_problem(7)
    cfg = ik.IKConfig(iterations=5, damping=7.0, solver=solver)
    ones = torch.ones(J, dtype=torch.float64)
    lay = ik.IKLayout(PARENTS, tidx, cfg, ones, ones)
    got_r, got_p = ik._solve(torch.from_numpy(rot)[None], torch.from_numpy(pos)[None],
                             torch.from_numpy(tgt)[None], lay)
    jcfg = jax_ik.IKConfig(iterations=5, damping=7.0, solver=solver)
    dummy = jnp.zeros((rot.shape[0], J, 3))
    limits = (jnp.zeros(J * 3), jnp.zeros(J * 3))
    want_r, want_p = jax_ik._solve(
        jnp.asarray(rot), jnp.asarray(pos), jnp.asarray(tgt), dummy, limits, jnp.ones(J),
        jnp.ones(J), targets_idx=tidx, parents=PARENTS, cfg=jcfg, use_reference=False,
        use_limits=False)
    np.testing.assert_allclose(got_r[0].numpy(), np.asarray(want_r), atol=atol, rtol=0)
    np.testing.assert_allclose(got_p[0].numpy(), np.asarray(want_p), atol=atol, rtol=0)


def test_ik_limits_and_references_match_chd_tpu():
    rot, pos, tidx, tgt = _ik_problem(8)
    ref = np.random.default_rng(9).uniform(-0.3, 0.3, (rot.shape[0], J, 3))
    lo, hi = np.full(J * 3, -0.35), np.full(J * 3, 0.35)
    anim = Animation(torch.from_numpy(rot), torch.from_numpy(pos),
                     torch.zeros(J, 4, dtype=torch.float64),
                     torch.from_numpy(GOLDEN["skel_offsets"]), PARENTS)
    targets = {j: tgt[:, i] for i, j in enumerate(tidx)}
    cfg = ik.IKConfig(iterations=4, damping=3.0, smoothness=0.01)
    got = ik.solve_ck_ik(anim, targets, cfg, references=ref, angle_limits=(lo, hi))
    from chd_tpu.core.animation import Animation as JaxAnimation

    want = jax_ik.solve_ck_ik(
        JaxAnimation(rot, pos, np.zeros((J, 4)), GOLDEN["skel_offsets"], PARENTS), targets,
        jax_ik.IKConfig(iterations=4, damping=3.0, smoothness=0.01), references=ref,
        angle_limits=(lo, hi))
    np.testing.assert_allclose(got.rotations.numpy(), np.asarray(want.rotations), atol=1e-9)


def test_ck_ik_matches_golden():
    g = np.load(os.path.join(FIXTURES, "ck_ik_golden.npz"))
    parents = [int(p) for p in g["parents"]]
    orients = np.zeros((len(parents), 4))
    orients[:, 0] = 1.0
    # float32, as chd_tpu runs it (its dtype follows the float32 rotations)
    anim = Animation.from_numpy(Animation(g["init_rotations"], g["init_positions"], orients,
                                          g["offsets"], parents), dtype=torch.float32)
    targets = {int(j): g["targets"][:, int(j)] for j in g["target_idx"]}
    cfg = ik.IKConfig(iterations=30, damping=7.0, smoothness=1e-3, translate=True)
    got = ik.solve_ck_ik(anim, targets, cfg, references=g["references"])
    np.testing.assert_allclose(quat.to_euler(got.rotations, "xyz").numpy(), g["out_euler"],
                               atol=1e-5)
    np.testing.assert_allclose(got.positions.numpy(), g["out_positions"], atol=1e-4)


def _floor_points(seed, n=120, pad=30):
    rng = np.random.default_rng(seed)
    xz = rng.uniform(-80, 80, size=(n, 2))
    y = xz @ np.array([0.03, -0.02]) + 95.0 + rng.normal(size=n) * 0.8
    y[:12] += rng.uniform(10, 30, size=12) * rng.choice([-1, 1], size=12)
    xz = np.concatenate([xz, rng.uniform(-500, 500, size=(pad, 2))])
    y = np.concatenate([y, np.full(pad, 1e4)])
    mask = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    return xz, y, mask


@pytest.mark.parametrize("eps", [1.5, 2.2])
def test_fit_floor_matches_chd_tpu(eps):
    pts = [_floor_points(s) for s in (0, 1, 2)]
    got = floor.fit_floor(torch.from_numpy(np.stack([p[0] for p in pts])),
                          torch.from_numpy(np.stack([p[1] for p in pts])),
                          torch.from_numpy(np.stack([p[2] for p in pts])), epsilon=eps)
    for b, (xz, y, mask) in enumerate(pts):
        want = jax_floor.fit_floor(jnp.asarray(xz), jnp.asarray(y), jnp.asarray(mask),
                                   epsilon=eps)
        assert float(got.normal[b].numpy() @ np.asarray(want.normal)) >= 1 - 1e-6
        assert abs(float(got.intercept[b]) - float(want.intercept)) < 1e-3
        np.testing.assert_array_equal(got.outliers[b].numpy(), np.asarray(want.outliers))
        np.testing.assert_allclose(got.point[b].numpy(), np.asarray(want.point), atol=1e-3)
        assert 10 <= int(got.outliers[b].sum()) and not got.outliers[b, ~mask].any()


def test_fit_floor_matches_sklearn():
    sklearn = pytest.importorskip("sklearn")
    from sklearn import linear_model

    xz, y, mask = _floor_points(3, pad=0)
    got = floor.fit_floor(torch.from_numpy(xz)[None], torch.from_numpy(y)[None],
                          torch.from_numpy(mask)[None], epsilon=1.5)
    huber = linear_model.HuberRegressor(epsilon=1.5).fit(xz, y)
    assert sklearn is not None
    np.testing.assert_allclose(got.coef[0].numpy(), huber.coef_, atol=5e-3)
    np.testing.assert_allclose(float(got.intercept[0]), huber.intercept_, atol=0.3)
    np.testing.assert_array_equal(got.outliers[0].numpy(), huber.outliers_)


def test_prune_contacts_matches_chd_tpu():
    rng = np.random.default_rng(4)
    feet_cols = np.array([21, 19, 20, 24, 22, 23])
    vc = (rng.uniform(size=(2, 7, 28)) > 0.4).astype(float)
    mask = (vc[:, :, feet_cols] == 1).reshape(2, -1)
    outliers = rng.uniform(size=mask.shape) > 0.6
    got = floor.prune_contacts(torch.from_numpy(vc), torch.from_numpy(feet_cols),
                               torch.from_numpy(outliers), torch.from_numpy(mask))
    for b in range(2):
        want = jax_floor.prune_contacts(jnp.asarray(vc[b]), jnp.asarray(feet_cols),
                                        jnp.asarray(outliers[b]), jnp.asarray(mask[b]))
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
