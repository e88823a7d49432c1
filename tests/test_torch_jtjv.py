"""The trajectory residual's JᵀJ·v kernel (``kinematics/jtjv.py``,
``csrc/traj_jtjv.cu``): its algorithm, and who engages it, on the CPU.

The kernel itself runs only on a card (``tests/test_torch_jtjv_cuda.py``);
here ``traj_jtjv_plain``, the same tiles, halos, hand-derived tangent and
transpose in plain torch, is held against autograd's double vjp in float64:
- products within 1e-10 of the largest |JᵀJ·v| entry, on batches of 1-3
  sequences of 1, 2, 3, 4 and 7 frames (below and around a tile and its
  halo, with tiles of 1, 3 and ``TILE`` frames), every residual term
  weighted (floor weight 10), partial contacts, padded frames, joints with
  zero projection weight, the ``STAGE1`` and ``STAGE2`` weights as 0-d
  tensors; over a leading tangent axis too, a mask broadcast by ``expand``;
- the diagonal equal to ``lm_step``'s coloring diagonal within 1e-10;
- an ``lm_step`` with the emulation as its product, in its three inner
  solves, within 1e-9 of the autograd step.
And: each solve counts the path it took (a CPU kinematic call and a
physics solve take autograd), the residual's supplier goes into the graph
key, and with the emulation in the kernel's place a call takes it in both
stages and a later stage finds the call's key; the kernel's wrapper refuses
CPU tensors, and the tree tables refuse trees the kernel does not take.
Float64, one intra-op thread (as the other solver files); the file imports
no JAX.
"""
import os

import numpy as np
import pytest
import torch

from chd_tpu_torch.characters import defs
from chd_tpu_torch.core.animation import Animation
from chd_tpu_torch.kinematics import banded, batch, jtjv, lm, residuals
from chd_tpu_torch.kinematics import trajectory as traj_lib
from chd_tpu_torch.parallel import batch as phys_batch
from chd_tpu_torch.physics import collocation as co
from chd_tpu_torch.physics import synth
from chd_tpu_torch.utils import profiling
from chip_smoke import kin_problem
from torch_jtjv_helpers import RecordingGraphs, emulate

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
GOLDEN = np.load(os.path.join(FIXTURES, "trajectory_golden.npz"))
PARENTS = tuple(int(p) for p in GOLDEN["skel_parents"])
J = len(PARENTS)
D = 3 + 3 * J
F64 = torch.float64
STAGES = {"stage1": traj_lib.STAGE1, "stage2": traj_lib.STAGE2}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as the port's other solver test files pin it."""
    torch.set_num_threads(1)


def _problem(seed, F, padded):
    """One sequence's numpy TrajectoryData fields and variables: every joint
    weighted by its own smoothness, ~30 % of projection weights zero, half
    the contacts on, ``padded`` masked frames at the end."""
    r = np.random.default_rng(seed)
    data = dict(
        pose3d=r.normal(0, 30, (F, 28, 3)),
        root_trans=r.normal(0, 10, (F, 3)) + [0, -90, 380],
        pose2d_norm=r.normal(0, 0.1, (F, 28, 2)),
        proj_weights=np.where(r.uniform(size=(F, 28)) > 0.3, r.uniform(size=(F, 28)), 0.0),
        data_weights=r.uniform(size=(F, 28)),
        smooth_weights=np.asarray(defs.COMBINED_SMOOTH_WEIGHTS, float) * r.uniform(0.5, 1.5, 28),
        vel_constraints=(r.uniform(size=(F, 28)) > 0.5).astype(float),
        floor_normal=np.array([0.0, 1.0, 0.1]) / np.sqrt(1.01),
        floor_point=np.array([0.0, 90.0, 0.0]),
        offsets=GOLDEN["skel_offsets"] * r.uniform(0.8, 1.2, (28, 1)),
        frame_mask=np.array([1.0] * (F - padded) + [0.0] * padded),
    )
    x = np.concatenate([r.normal(0, 10, (F, 3)) + [0, -90, 380],
                        r.normal(0, 0.3, (F, J * 3))], 1).reshape(-1)
    return data, x


def _batch(B, F, seed=0, padded=1):
    """B sequences of F frames; every sequence past the first has ``padded``
    masked frames (fewer where F is shorter)."""
    probs = [_problem(seed + b, F, min(padded, F - 1) if b else 0) for b in range(B)]
    data = residuals.TrajectoryData(**{k: torch.from_numpy(np.stack([p[0][k] for p in probs]))
                                       for k in probs[0][0]})
    return data, torch.from_numpy(np.stack([p[1] for p in probs]))


def _weights(stage):
    return type(stage)(*(torch.tensor(float(v), dtype=F64) for v in stage))


def _autograd(data, x, w, lay):
    """JᵀJ·v at x by lm_step's double vjp."""
    r, vjp_fn = torch.func.vjp(lambda z: lay.residual(z, data, w), x)
    _, lin = torch.func.vjp(lambda c: vjp_fn(c)[0], torch.zeros_like(r))
    return lambda v: vjp_fn(lin(v)[0])[0]


def _close(got, want, rel):
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("B,F,tile,stage", [
    (1, 1, jtjv.TILE, "stage2"), (2, 1, 1, "stage1"), (3, 2, jtjv.TILE, "stage2"),
    (2, 2, 1, "stage2"), (1, 3, 3, "stage1"), (3, 3, 1, "stage2"), (2, 4, 3, "stage2"),
    (1, 4, jtjv.TILE, "stage1"), (2, 7, 3, "stage2"), (3, 7, jtjv.TILE, "stage1"),
    (2, 7, 1, "stage2"),
])
def test_emulated_product_matches_autograd(B, F, tile, stage):
    data, x = _batch(B, F, seed=10 * F + B, padded=2)
    lay = residuals.Layout(PARENTS, "cpu", F64)
    w = _weights(STAGES[stage])
    v = torch.from_numpy(np.random.default_rng(F).normal(size=x.shape))
    want = _autograd(data, x, w, lay)(v)
    got = jtjv.TrajectoryProduct(lay).emulated(tile)(x, data, w)(v)
    _close(got, want, 1e-10)


def test_emulated_products_over_a_tangent_axis_match_autograd():
    """Three tangents in one call, the last a mask broadcast over the
    sequences (stride 0), as ``banded_jtj`` hands them."""
    F = 5
    data, x = _batch(2, F, seed=3)
    lay = residuals.Layout(PARENTS, "cpu", F64)
    w = _weights(traj_lib.STAGE2)
    rng = np.random.default_rng(7)
    vs = torch.from_numpy(rng.normal(size=(2,) + tuple(x.shape)))
    mask = banded.coloring_masks(F, D, dtype=F64, device="cpu")[4]
    vs = torch.cat([vs, mask.expand(1, *x.shape)])
    want = torch.func.vmap(_autograd(data, x, w, lay))(vs)
    lin = jtjv.TrajectoryProduct(lay).emulated(2)(x, data, w)
    got = lin.many(vs)
    _close(got, want, 1e-10)
    bcast = lin.many(mask.expand(1, *x.shape))
    _close(bcast[0], want[2], 1e-10)


@pytest.mark.parametrize("B,F", [(1, 1), (2, 3), (3, 7)])
def test_emulated_diagonal_is_the_coloring_diagonal(B, F):
    data, x = _batch(B, F, seed=F, padded=2)
    lay = residuals.Layout(PARENTS, "cpu", F64)
    w = _weights(traj_lib.STAGE2)
    masks = lm.frame_coloring_masks(F, D, dtype=F64, device="cpu")
    jtjv_fn = _autograd(data, x, w, lay)
    m = masks.unsqueeze(1).expand((masks.shape[0],) + x.shape)
    want = torch.func.vmap(lambda mk: mk * jtjv_fn(mk))(m).sum(0)
    lin = jtjv.TrajectoryProduct(lay).emulated()(x, data, w)
    _close(lin.diag(masks), want, 1e-10)
    with pytest.raises(ValueError, match="frame_coloring_masks"):
        lin.diag(masks[:-1])


@pytest.mark.parametrize("solver", ["pcg", "banded", "lambda"])
def test_lm_step_with_the_emulation_follows_the_autograd_step(solver):
    F = 6
    data, x = _batch(2, F, seed=21, padded=2)
    lay = residuals.Layout(PARENTS, "cpu", F64)
    w = _weights(traj_lib.STAGE2)
    cfg = lm.LMConfig(max_iters=1, cg_iters=12)
    kw = {"pcg": dict(diag_masks=lm.frame_coloring_masks(F, D, dtype=F64, device="cpu")),
          "banded": dict(banded_masks=banded.coloring_masks(F, D, dtype=F64, device="cpu")),
          "lambda": {}}[solver]
    res = lambda z: lay.residual(z, data, w)  # noqa: E731
    lam = torch.full((2, 1), 1e-3, dtype=F64)
    c = 0.5 * (res(x) ** 2).sum(-1, keepdim=True)
    want = lm.lm_step(res, x, lam, c, cfg, **kw)
    prod = jtjv.TrajectoryProduct(lay).emulated(4)
    got = lm.lm_step(res, x, lam, c, cfg, **kw, product=lambda z: prod(z, data, w))
    assert not torch.equal(got[0], x)  # the step moved
    _close(got[0] - x, want[0] - x, 1e-9)
    _close(got[2], want[2], 1e-9)
    assert torch.equal(got[1], want[1])


def test_each_solve_counts_its_path(monkeypatch):
    F = 4
    data, x = _batch(2, F, seed=5)
    lay = residuals.Layout(PARENTS, "cpu", F64)
    masks = lm.frame_coloring_masks(F, D, dtype=F64, device="cpu")
    cfg = lm.LMConfig(max_iters=1, cg_iters=2)
    profiling.reset()
    lm.lm_solve(lay.residual, x, (data, traj_lib.STAGE1), cfg, masks)
    emulate(monkeypatch)
    lm.lm_solve(lay.residual, x, (data, traj_lib.STAGE1), cfg, masks)
    assert profiling.snapshot()["counters"] == {"lm.jtjv.autograd": 1, "lm.jtjv.emulation": 1}


def test_a_cpu_kinematic_call_and_a_physics_solve_take_autograd():
    g = GOLDEN
    skel = Animation(g["skel_rotations"], g["skel_positions"], g["skel_orients"],
                     g["skel_offsets"], list(PARENTS))
    rng = np.random.default_rng(2)
    problems = [kin_problem(rng, skel, 6, 0.3), kin_problem(rng, skel, 5, 0.3)]
    profiling.reset()
    batch.optimize_trajectory_batch(problems, skel, ik_iterations=2,
                                    lm_cfg=lm.LMConfig(max_iters=1, cg_iters=2),
                                    device="cpu", ik_solver="lu")
    assert profiling.snapshot()["counters"] == {"lm.jtjv.autograd": 2}
    consts = batch.batch_consts(PARENTS, 6, batch.IKConfig(), "cpu", F64)
    assert consts.layout.residual.product_for(consts.smooth) is None

    profiling.reset()
    pb, _ = phys_batch.pad_phys_inputs([synth.walking_input(8, seed=0)], device="cpu",
                                       dtype=F64)
    phys_batch.solve_physics_batch(pb, cfg=co.SolveConfig(1, 1, 1, 1,
                                                          lm=lm.LMConfig(1, 2, 1e-2)))
    counters = profiling.snapshot()["counters"]
    assert set(counters) == {"lm.jtjv.autograd"} and counters["lm.jtjv.autograd"] >= 2


def test_the_product_goes_into_the_graph_key(monkeypatch):
    F = 3
    data, x = _batch(1, F, seed=8)
    lay = residuals.Layout(PARENTS, "cpu", F64)
    masks = lm.frame_coloring_masks(F, D, dtype=F64, device="cpu")
    cfg = lm.LMConfig(max_iters=1, cg_iters=2)
    graphs = RecordingGraphs()
    lm.lm_solve(lay.residual, x, (data, traj_lib.STAGE1), cfg, masks, graphs)
    made = emulate(monkeypatch)
    for _ in range(2):
        lm.lm_solve(lay.residual, x, (data, traj_lib.STAGE1), cfg, masks, graphs)
    k0, k1, k2 = graphs.keys
    (prod,) = made.values()
    assert lay.residual.product_for(x) is prod and prod.path == "emulation"
    assert k0 != k1 and k1 == k2 and prod in k1 and None in k0


def test_a_call_takes_its_layouts_product_and_a_later_stage_finds_its_key(monkeypatch):
    """With the emulation put in the kernel's place, a kinematic call's two
    LM solves take its layout's one product and count it, and an
    ``lm_stage`` that passes no product of its own (as the benchmark's
    traced stages do) finds the call's graph key."""
    g = GOLDEN
    skel = Animation(g["skel_rotations"], g["skel_positions"], g["skel_orients"],
                     g["skel_offsets"], list(PARENTS))
    rng = np.random.default_rng(4)
    problems = [kin_problem(rng, skel, 6, 0.3), kin_problem(rng, skel, 5, 0.3)]
    made = emulate(monkeypatch)
    graphs = RecordingGraphs()
    cfg = lm.LMConfig(max_iters=1, cg_iters=2)
    profiling.reset()
    batch.optimize_trajectory_batch(problems, skel, ik_iterations=2, lm_cfg=cfg, device="cpu",
                                    dtype=F64, ik_solver="lu", graphs=graphs)
    assert profiling.snapshot()["counters"] == {"lm.jtjv.emulation": 2}
    lm_keys = [k for k in graphs.keys if k[0] == "lm_step"]
    assert len(lm_keys) == 2 and lm_keys[0] == lm_keys[1]
    (prod,) = made.values()
    assert prod in lm_keys[0] and prod.path == "emulation"
    arrs, F = batch.prepare_batch_arrays(problems, skel, device="cpu", dtype=F64)
    ik_cfg = batch.IKConfig(iterations=2, damping=7.0, solver="lu")
    consts = batch.batch_consts(PARENTS, F, ik_cfg, "cpu", F64, graphs)
    x0 = batch.initial_x(arrs["rot0"], arrs["pos0"])
    zero3 = torch.zeros((2, 3), dtype=F64)
    batch.lm_stage(x0, batch.make_data(arrs, consts, arrs["vc"], zero3, zero3),
                   traj_lib.STAGE1, consts, cfg, graphs)
    assert graphs.keys[-1] == lm_keys[0] and len(made) == 1


def test_the_kernel_wrapper_refuses_cpu_tensors():
    data, x = _batch(1, 2, seed=1)
    lay = residuals.Layout(PARENTS, "cpu", F64)
    prod = jtjv.TrajectoryProduct(lay)
    assert prod.path == "kernel" and prod.max_depth == 6 and prod.max_children == 5
    lin = prod(x, data, _weights(traj_lib.STAGE1))
    with pytest.raises(ValueError, match="CUDA"):
        lin(torch.ones_like(x))
    with pytest.raises(ValueError, match="mode"):
        jtjv.traj_jtjv("jvp", lin)


@pytest.mark.parametrize("parents,match", [
    ((-1, 0, 2), "topologically"),
    ((-1,) + (0,) * 30 + (0,), "topologically"),
    ((-1,) + (0,) * 27, "children"),
])
def test_tree_tables_refuse_what_the_kernel_does_not_take(parents, match):
    with pytest.raises(ValueError, match=match):
        jtjv.tree_tables(parents, data_to_skel=np.arange(28) % len(parents))


def test_tree_tables_of_the_combined_skeleton():
    tab, max_depth, max_children = jtjv.tree_tables(PARENTS)
    assert tab.shape == (jtjv.LANES, 4 + jtjv.MAX_CHILDREN) and tab.dtype == np.int32
    assert max_depth == 6 and max_children == 5
    for j, p in enumerate(PARENTS):
        assert tab[j, 0] == max(p, 0) and (j == 0 or j in tab[p, 4:])
    np.testing.assert_array_equal(tab[:28, 3], defs.COMBINED_DATA_TO_SKEL)
    np.testing.assert_array_equal(tab[defs.COMBINED_DATA_TO_SKEL, 2], np.arange(28))
    assert (tab[J:, 1] == -1).all() and (tab[J:, 0] == np.arange(J, jtjv.LANES)).all()
