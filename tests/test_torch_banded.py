"""chd_tpu_torch.kinematics.banded, ``lm_solve``'s three inner solves and
``optimize_trajectory_batch(lm_solver="banded")`` against chd_tpu, in
float64 on the same seeded inputs.

The problems are built from the in-repo fixtures (the 28-joint combined
skeleton of tests/fixtures/trajectory_golden.npz), in place of
tests/test_banded.py's ``traj_problem``, which reads the unmounted
reference checkout. Tolerances:
- ``block_penta_solve``: rtol 1e-8 against a dense solve (tests/test_banded.py's
  bound), atol 1e-12 against chd_tpu's; a matrix that is not positive
  definite gives NaN for its problem only, as chd_tpu's Cholesky does;
- ``banded_jtj``: every block within 1e-8 of the largest |JᵀJ| entry of a
  dense ``torch.func.jacfwd`` Jacobian (of the port's residual, which
  tests/test_torch_kinematics.py holds to chd_tpu's), zero beyond the band,
  and the masks equal to chd_tpu's;
- ``lm_solve`` at 3:10 in its λI and banded modes (the coloring-diagonal
  mode is tests/test_torch_kinematics.py's ``test_lm_solve_matches_chd_tpu``,
  on the same problems): variables atol 1e-6, final cost rtol 1e-9 (that
  test's bounds: the steps agree while no accept is decided within a
  rounding);
- ``optimize_trajectory_batch(lm_solver="banded")`` on a ragged pair (12
  and 9 frames), LU IK 10, LM 3:3: joint positions within 1e-6 cm, the same
  pruned and refined contacts, floor normal cos >= 1 - 1e-12
  (tests/test_torch_trajectory.py's bounds for the PCG batch).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chd_tpu.core.animation import Animation as JaxAnimation
from chd_tpu.kinematics import banded as jax_banded
from chd_tpu.kinematics import batch as jax_batch
from chd_tpu.kinematics import lm as jax_lm
from chd_tpu.kinematics import residuals as jax_res
from chd_tpu.kinematics.lm import LMConfig as JaxLMConfig
from chd_tpu_torch.core import fk
from chd_tpu_torch.kinematics import banded, batch, lm, residuals
from chip_smoke import kin_problem
from test_banded import _random_banded_spd
from test_torch_kinematics import D, PARENTS, W, _batch, _jax_data, _problem

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: many small solver ops, which stall when the other
    test workers hold the cores.
    Not raised again after the module: in one process, a count raised back
    makes MKL's next batched LU (``torch.linalg.solve_ex``) hang."""
    torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_executables():
    yield
    jax.clear_caches()


def _bands(A, F, Db):
    """The (F, D, D) diagonal and first two lower block bands of dense A."""
    blk = lambda r, c: A[r * Db:(r + 1) * Db, c * Db:(c + 1) * Db]  # noqa: E731
    diag = np.stack([blk(f, f) for f in range(F)])
    lo1, lo2 = np.zeros_like(diag), np.zeros_like(diag)
    for f in range(F - 1):
        lo1[f] = blk(f + 1, f)
    for f in range(F - 2):
        lo2[f] = blk(f + 2, f)
    return diag, lo1, lo2


@pytest.mark.parametrize("F,Db", [(7, 5), (8, 3), (2, 4), (3, 2)])
def test_block_penta_solve_matches_dense_and_chd_tpu(F, Db):
    rng = np.random.default_rng(0)
    cases = []
    for _ in range(2):  # two problems in lockstep
        A = _random_banded_spd(F, Db, 2, rng)
        cases.append((A, rng.normal(size=F * Db)))
    bands = [np.stack(t) for t in zip(*(_bands(A, F, Db) for A, _ in cases))]
    rhs = np.stack([b.reshape(F, Db) for _, b in cases])
    got = banded.block_penta_solve(*(torch.from_numpy(t) for t in bands), torch.from_numpy(rhs))
    assert got.shape == (2, F, Db)
    for i, (A, b) in enumerate(cases):
        np.testing.assert_allclose(got[i].numpy().reshape(-1), np.linalg.solve(A, b), rtol=1e-8)
        want = jax_banded.block_penta_solve(*(jnp.asarray(t[i]) for t in bands),
                                            jnp.asarray(rhs[i]))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), atol=1e-12, rtol=0)


def test_block_penta_solve_nan_where_not_positive_definite():
    """A failed factorization is NaN for its problem, as chd_tpu's Cholesky
    returns it (so that LM's cost comparison rejects the step), and leaves
    the other problems alone."""
    rng = np.random.default_rng(1)
    F, Db = 5, 3
    A = _random_banded_spd(F, Db, 2, rng)
    bad = A.copy()
    bad[4 * Db, 4 * Db] = -1e3  # a negative pivot in the last superblock
    bands = [np.stack(t) for t in zip(_bands(A, F, Db), _bands(bad, F, Db))]
    rhs = rng.normal(size=(2, F, Db))
    got = banded.block_penta_solve(*(torch.from_numpy(t) for t in bands), torch.from_numpy(rhs))
    assert torch.isfinite(got[0]).all() and torch.isnan(got[1]).any()
    want = jax_banded.block_penta_solve(*(jnp.asarray(t[1]) for t in bands), jnp.asarray(rhs[1]))
    np.testing.assert_array_equal(np.isnan(got[1].numpy()), np.isnan(np.asarray(want)))


def test_banded_jtj_matches_dense_jacobian():
    F = 11
    data, x = _batch([_problem(5, F, 0), _problem(6, F, 2)])
    lay = residuals.Layout(PARENTS, "cpu", torch.float64)
    w = residuals.TermWeights(**W)

    def res(z):
        return lay.residual(z, data, w)

    r, vjp_fn = torch.func.vjp(res, x)
    _, lin = torch.func.vjp(lambda cot: vjp_fn(cot)[0], torch.zeros_like(r))
    masks = banded.coloring_masks(F, D, dtype=torch.float64, device="cpu")
    U0, L1, L2 = banded.banded_jtj(torch.func.vmap(lambda v: vjp_fn(lin(v)[0])[0]), masks, 2, F,
                                   D)
    assert U0.shape == (2, F, D, D)
    np.testing.assert_array_equal(masks.numpy(), np.asarray(jax_banded.coloring_masks(F, D)))
    for b in range(2):
        jac = torch.func.jacfwd(lambda z: res(torch.stack([z, x[1]]) if b == 0
                                              else torch.stack([x[0], z]))[b])(x[b])
        A = (jac.T @ jac).numpy()
        diag, lo1, lo2 = _bands(A, F, D)
        tol = 1e-8 * np.abs(A).max()
        np.testing.assert_allclose(U0[b].numpy(), diag, atol=tol, rtol=0)
        np.testing.assert_allclose(L1[b, :F - 1].numpy(), lo1[:F - 1], atol=tol, rtol=0)
        np.testing.assert_allclose(L2[b, :F - 2].numpy(), lo2[:F - 2], atol=tol, rtol=0)
        assert not L1[b, F - 1:].any() and not L2[b, F - 2:].any()
        for f in range(F - 3):  # nothing beyond the band
            assert np.abs(A[(f + 3) * D:(f + 4) * D, f * D:(f + 1) * D]).max() < tol


@pytest.mark.parametrize("mode", ["lambda", "banded"])
def test_lm_solve_modes_match_chd_tpu(mode):
    F = 6
    problems = [_problem(0, F, 1), _problem(1, F, 2)]
    data, x = _batch(problems)
    lay = residuals.Layout(PARENTS, "cpu", torch.float64)
    args = (data, residuals.TermWeights(**W))
    cfg = lm.LMConfig(max_iters=3, cg_iters=10)
    kw = {"lambda": {}, "banded": dict(banded_spec=(F, D))}[mode]
    port_kw = {"lambda": {},
               "banded": dict(banded_masks=banded.coloring_masks(F, D, dtype=torch.float64,
                                                                  device="cpu"))}[mode]
    got, cost = lm.lm_solve(lay.residual, x, args, cfg, **port_kw)
    c0 = 0.5 * (lay.residual(x, *args) ** 2).sum(-1)
    for b, (d, xb) in enumerate(problems):
        xj, cj = jax_lm.lm_solve(jax_res.residual_fn_for(PARENTS), jnp.asarray(xb),
                                 (_jax_data(d), jax_res.TermWeights(**W)),
                                 JaxLMConfig(max_iters=3, cg_iters=10), **kw)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(xj), atol=1e-6, rtol=0)
        np.testing.assert_allclose(float(cost[b]), float(cj), rtol=1e-9)
        assert float(cost[b]) < float(c0[b])


@pytest.fixture(scope="module")
def skel():
    g = np.load(os.path.join(FIXTURES, "trajectory_golden.npz"))
    return JaxAnimation(g["skel_rotations"], g["skel_positions"], g["skel_orients"],
                        g["skel_offsets"], [int(p) for p in g["skel_parents"]])


def _joints(res):
    return fk.positions_global(torch.as_tensor(res.anim.rotations).double(),
                               torch.as_tensor(res.anim.positions).double(),
                               res.anim.parents).numpy()


def test_banded_batch_matches_chd_tpu(skel):
    rng = np.random.default_rng(18)
    problems = [kin_problem(rng, skel, 12, 0.3), kin_problem(rng, skel, 9, 0.3)]
    kw = dict(ik_iterations=10, ik_solver="lu", lm_solver="banded")
    got = batch.optimize_trajectory_batch(problems, skel, lm_cfg=lm.LMConfig(3, 3),
                                          device="cpu", dtype=torch.float64, **kw)
    want = jax_batch.optimize_trajectory_batch(problems, skel, lm_cfg=JaxLMConfig(3, 3),
                                               dtype=jnp.float64, **kw)
    assert [r.anim.num_frames for r in got] == [12, 9]
    for a, b in zip(got, want):
        assert np.abs(_joints(a) - _joints(b)).max() <= 1e-6  # cm
        np.testing.assert_array_equal(a.vel_constraints, b.vel_constraints)
        np.testing.assert_array_equal(a.refined_contacts, b.refined_contacts)
        assert float(a.floor_normal @ b.floor_normal) >= 1 - 1e-12
    with pytest.raises(ValueError, match="lm_solver"):
        batch.optimize_trajectory_batch(problems, skel, device="cpu", lm_solver="cholesky")
