"""chd_tpu_torch's skinning, secondary IK solvers and ICP
(``core/skinning.py``, ``kinematics/basic_ik.py``, ``kinematics/icp.py``)
against chd_tpu, in float64 on the same seeded inputs: the cases of
tests/test_ik_variants.py and tests/test_icp.py, and, in place of their
reference-oracle tests (which need the unmounted reference checkout),
chd_tpu itself on the in-repo 28-joint combined skeleton
(tests/fixtures/prepare_input/combined/motion.bvh).

Tolerances (float64): eulers and unit quaternions atol 1e-9, positions and
skinned vertices atol 1e-9 (in the skeleton's units, cm for the combined
one): the same arithmetic in another order, over a few damped iterations.
``wrap_angles``: atol 1e-12. ``solve_basic_ik``: atol 1e-7. Its angles are
chd_tpu's arccos(clip(a·b)) computed as atan2(|a×b|, a·b): arccos loses
about 2**-53/θ of an angle θ near 0, and the second iteration's corrections
reach θ ~ 1e-8, so chd_tpu's own float64 result is that far from the exact
one (read: 3.3e-8 on the random tree, 1.6e-9 on the combined skeleton).
Behavioral checks keep tests/test_ik_variants.py's and tests/test_icp.py's
own bounds.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chd_tpu.core import bvh as jax_bvh
from chd_tpu.core import quat as jax_quat
from chd_tpu.core import skinning as jax_skinning
from chd_tpu.core.animation import Animation as JaxAnimation
from chd_tpu.kinematics import basic_ik as jax_basic_ik
from chd_tpu.kinematics import icp as jax_icp
from chd_tpu.kinematics.ik import IKConfig as JaxIKConfig
from chd_tpu_torch.core import fk, quat, skinning
from chd_tpu_torch.core.animation import Animation
from chd_tpu_torch.kinematics import basic_ik, icp
from chd_tpu_torch.kinematics.ik import IKConfig

COMBINED = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                        "prepare_input", "combined", "motion.bvh")
ATOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: many small solver ops, which stall when the other
    test workers hold the cores.
    Not raised again after the module: in one process, a count raised back
    makes MKL's next batched LU (``torch.linalg.solve_ex``) hang."""
    torch.set_num_threads(1)


def _random_anim(rng, F, J):
    """tests/test_ik.py's random tree animation, as chd_tpu's Animation with
    numpy leaves."""
    parents = [-1] + [int(rng.integers(0, j)) for j in range(1, J)]
    offsets = rng.normal(size=(J, 3))
    offsets[0] = 0
    es = rng.uniform(-0.5, 0.5, size=(F, J, 3))
    rot = np.asarray(jax_quat.from_euler(jnp.asarray(es), "xyz", world=True))
    pos = np.broadcast_to(offsets[None], (F, J, 3)).copy()
    pos[:, 0] = rng.normal(size=(F, 3))
    orients = np.zeros((J, 4))
    orients[:, 0] = 1
    return JaxAnimation(rot, pos, orients, offsets, parents)


def _combined_anim(rng, F):
    """F frames of the combined skeleton, its rest pose moved by seeded
    eulers and root translations."""
    skel, _, _ = jax_bvh.load(COMBINED)
    J = skel.num_joints
    es = rng.uniform(-0.3, 0.3, size=(F, J, 3))
    rot = np.asarray(jax_quat.from_euler(jnp.asarray(es), "xyz", world=True))
    pos = np.broadcast_to(np.asarray(skel.offsets)[None], (F, J, 3)).copy()
    pos[:, 0] = rng.normal(0, 10, size=(F, 3)) + [0, 90, 300]
    return JaxAnimation(rot, pos, np.asarray(skel.orients), np.asarray(skel.offsets),
                        skel.parents), skel


def _port(anim):
    return Animation.from_numpy(anim, dtype=torch.float64)


def _gp(anim):
    return fk.positions_global(torch.as_tensor(np.array(anim.rotations)),
                               torch.as_tensor(np.array(anim.positions)),
                               anim.parents).numpy()


def _assert_anim_close(got, want, atol=ATOL):
    np.testing.assert_allclose(quat.to_euler(got.rotations, "xyz").numpy(),
                               np.asarray(jax_quat.to_euler(jnp.asarray(want.rotations), "xyz")),
                               atol=atol, rtol=0)
    np.testing.assert_allclose(got.positions.numpy(), np.asarray(want.positions),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("case", ["random", "combined"])
def test_basic_ik_matches_chd_tpu(case):
    rng = np.random.default_rng(20)
    anim = _random_anim(rng, 4, 8) if case == "random" else _combined_anim(rng, 3)[0]
    gp = _gp(anim)
    tgt = gp + (0.1 if case == "random" else 3.0) * rng.normal(size=gp.shape)
    got = basic_ik.solve_basic_ik(_port(anim), tgt, iterations=2)
    want = jax_basic_ik.solve_basic_ik(anim, tgt, iterations=2)
    assert got.rotations.dtype == torch.float64
    _assert_anim_close(got, want, atol=1e-7)


@pytest.mark.parametrize("case,translate", [("random", False), ("combined", False),
                                            ("combined", True)])
def test_jacobian_ik_matches_chd_tpu(case, translate):
    rng = np.random.default_rng(21)
    if case == "random":
        anim = _random_anim(rng, 4, 8)
        gp = _gp(anim)
        targets = {3: gp[:, 3] + 0.05, 7: gp[:, 7] - 0.05}
    else:
        anim = _combined_anim(rng, 3)[0]
        gp = _gp(anim)
        targets = {j: gp[:, j] + rng.normal(0, 2.0, size=(3, 3)) for j in (4, 7, 11, 14, 22)}
    kw = dict(iterations=3, damping=5.0, translate=translate)
    got = basic_ik.solve_jacobian_ik(_port(anim), targets, IKConfig(**kw))
    want = jax_basic_ik.solve_jacobian_ik(anim, targets, JaxIKConfig(**kw))
    _assert_anim_close(got, want)


def test_jacobian_ik_secondary_task_matches_chd_tpu():
    """The positional secondary task (the nullspace pull toward reference
    positions), with per-joint weights, on the combined skeleton."""
    rng = np.random.default_rng(22)
    anim, _ = _combined_anim(rng, 2)
    gp = _gp(anim)
    J = anim.num_joints
    targets = {J - 1: gp[:, J - 1] + 1.0, 11: gp[:, 11] - 1.0}
    refs = gp + 2.0 * rng.normal(size=gp.shape)
    weights = rng.uniform(0.5, 1.5, size=J)
    cfg = dict(iterations=4, damping=3.0)
    got = basic_ik.solve_jacobian_ik(_port(anim), targets, IKConfig(**cfg),
                                     reference_positions=refs, weights=weights)
    want = jax_basic_ik.solve_jacobian_ik(anim, targets, JaxIKConfig(**cfg),
                                          reference_positions=refs, weights=weights)
    _assert_anim_close(got, want)


def test_jacobian_ik_secondary_task_biases_pose():
    """tests/test_ik_variants.py's behavioral check on the port: with the
    secondary task, the untargeted joints end closer to the references."""
    rng = np.random.default_rng(22)
    parents = (-1, 0, 1, 2, 3, 4, 5, 6)
    J, F = 8, 3
    offsets = np.zeros((J, 3))
    offsets[1:, 0] = 1.0
    es = torch.from_numpy(rng.uniform(-0.2, 0.2, size=(F, J, 3)))
    rot = quat.from_euler(es, "xyz", world=True)
    pos = torch.from_numpy(np.broadcast_to(offsets[None], (F, J, 3)).copy())
    anim = Animation(rot, pos, torch.tensor([[1.0, 0, 0, 0]] * J, dtype=torch.float64),
                     torch.from_numpy(offsets), parents)
    gp = _gp(anim)
    targets = {J - 1: gp[:, J - 1] + 0.1}
    refs = gp + 0.3 * rng.normal(size=gp.shape)
    plain = basic_ik.solve_jacobian_ik(anim, targets, IKConfig(iterations=10, damping=3.0))
    biased = basic_ik.solve_jacobian_ik(anim, targets, IKConfig(iterations=10, damping=3.0),
                                        reference_positions=refs)
    mid = list(range(1, J - 1))
    d_plain = np.linalg.norm(_gp(plain)[:, mid] - refs[:, mid], axis=-1).mean()
    d_biased = np.linalg.norm(_gp(biased)[:, mid] - refs[:, mid], axis=-1).mean()
    assert d_biased < d_plain


def _weights_with_ties(rng, V, J, k=3):
    """(V, J) skinning weights, k joints per vertex, zeros elsewhere (so
    every row ties), some rows all zero and some with equal nonzero
    weights."""
    w = np.zeros((V, J))
    for v in range(V):
        js = rng.choice(J, size=k, replace=False)
        w[v, js] = rng.uniform(0.1, 1.0, size=k)
    w[::7] = 0.0
    w[3::11, :2] = 0.5
    return w


@pytest.mark.parametrize("maxjoints", [1, 4])
def test_skin_matches_chd_tpu(maxjoints):
    rng = np.random.default_rng(23)
    anim, skel = _combined_anim(rng, 3)
    rest = JaxAnimation(np.asarray(skel.rotations), np.asarray(skel.positions),
                        np.asarray(skel.orients), np.asarray(skel.offsets), skel.parents)
    V = 60
    w = _weights_with_ties(rng, V, anim.num_joints)
    mesh = rng.normal(0, 30, size=(V, 3)) + [0, 90, 300]
    got = skinning.skin(_port(anim), rest, w, mesh, maxjoints=maxjoints)
    want = np.asarray(jax_skinning.skin(anim, rest, w, mesh, maxjoints=maxjoints))
    assert got.shape == (3, V, 3) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_topk_keeps_joint_order_on_ties():
    w = np.array([[0.0, 0.5, 0.0, 0.5, 0.2], [0.0, 0.0, 0.0, 0.0, 0.0]])
    vals, idx = skinning._topk(torch.from_numpy(w), 4)
    wv, wi = jax_skinning._topk(jnp.asarray(w), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(wv))
    assert idx.tolist() == [[1, 3, 4, 0], [0, 1, 2, 3]]


def test_skinning_rigid_motion():
    """tests/test_ik_variants.py's check on the port: skinned vertices
    follow a rigid rotation of their owning joint."""
    parents = (-1, 0)
    offsets = torch.tensor([[0.0, 0, 0], [1.0, 0, 0]], dtype=torch.float64)
    orients = torch.tensor([[1.0, 0, 0, 0]] * 2, dtype=torch.float64)
    rest = Animation(torch.tensor([[[1.0, 0, 0, 0]] * 2], dtype=torch.float64), offsets[None],
                     orients, offsets, parents)
    es = torch.zeros((1, 2, 3), dtype=torch.float64)
    es[0, 0, 2] = np.pi / 2
    posed = rest.replace(rotations=quat.from_euler(es, "xyz", world=True))
    mesh = np.array([[0.5, 0.0, 0.0], [1.5, 0.0, 0.0]])
    out = skinning.skin(posed, rest, np.eye(2), mesh, maxjoints=1).numpy()
    np.testing.assert_allclose(out[0, 0], [0.0, 0.5, 0.0], atol=1e-6)
    np.testing.assert_allclose(out[0, 1], [0.0, 1.5, 0.0], atol=1e-6)


def test_wrap_angles_matches_chd_tpu():
    a = np.array([0.0, np.pi, -np.pi, 3 * np.pi, -2.5 * np.pi, 7.0, -7.0, 1e-3, -1e-3])
    got = skinning.wrap_angles(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_skinning.wrap_angles(jnp.asarray(a))),
                               atol=1e-12, rtol=0)
    assert (got > -np.pi - 1e-9).all() and (got <= np.pi + 1e-9).all()
    np.testing.assert_allclose(np.cos(got), np.cos(a), atol=1e-9)
    np.testing.assert_allclose(np.sin(got), np.sin(a), atol=1e-9)


def _icp_case(rng, F=2):
    """tests/test_icp.py's chain: 4 joints, 12 mesh points each owned by its
    nearest joint, and the skinned cloud of a seeded pose as the goal."""
    parents = (-1, 0, 1, 2)
    J, V = 4, 12
    offsets = np.zeros((J, 3))
    offsets[1:, 0] = 1.0
    orients = np.zeros((J, 4))
    orients[:, 0] = 1
    rest = JaxAnimation(np.tile([1.0, 0, 0, 0], (F, J, 1)),
                        np.broadcast_to(offsets[None], (F, J, 3)).copy(), orients, offsets,
                        parents)
    mesh = np.zeros((V, 3))
    mesh[:, 0] = np.linspace(0.2, 3.2, V)
    mesh[:, 1] = 0.05
    weights = np.zeros((V, J))
    weights[np.arange(V), np.clip(mesh[:, 0].astype(int), 0, J - 1)] = 1.0
    es = rng.uniform(-0.25, 0.25, size=(F, J, 3))
    posed = rest.replace(rotations=np.asarray(jax_quat.from_euler(jnp.asarray(es), "xyz",
                                                                  world=True)))
    goal = np.asarray(jax_skinning.skin(posed, rest, weights, mesh, maxjoints=1))
    return rest, weights, mesh, goal


@pytest.mark.parametrize("find_closest,translate", [(False, False), (True, True)])
def test_icp_matches_chd_tpu(find_closest, translate):
    rng = np.random.default_rng(0)
    rest, weights, mesh, goal = _icp_case(rng)
    kw = dict(iterations=5, damping=3.0, translate=translate)
    got = icp.solve_icp(_port(rest), rest, weights, mesh, goal, cfg=IKConfig(**kw),
                        maxjoints=1, find_closest=find_closest)
    want = jax_icp.solve_icp(rest, rest, weights, mesh, goal, cfg=JaxIKConfig(**kw),
                             maxjoints=1, find_closest=find_closest)
    _assert_anim_close(got, want)


def test_icp_matches_chd_tpu_on_the_combined_skeleton():
    """Two frames of the 28-joint skeleton fitted to the skinned cloud of
    another pose, weights over up to 4 joints, nearest-point association."""
    rng = np.random.default_rng(24)
    anim, skel = _combined_anim(rng, 2)
    rest = JaxAnimation(np.repeat(np.asarray(skel.rotations)[:1], 2, 0),
                        np.repeat(np.asarray(skel.positions)[:1], 2, 0),
                        np.asarray(skel.orients), np.asarray(skel.offsets), skel.parents)
    V = 40
    w = _weights_with_ties(rng, V, anim.num_joints)
    w[::7, 0] = 1.0  # no all-zero rows: ICP normalizes without a guard
    mesh = rng.normal(0, 30, size=(V, 3)) + [0, 90, 300]
    goal = np.asarray(jax_skinning.skin(anim, rest, w, mesh))
    kw = dict(iterations=3, damping=10.0, translate=True)
    got = icp.solve_icp(_port(rest), rest, w, mesh, goal, cfg=IKConfig(**kw))
    want = jax_icp.solve_icp(rest, rest, w, mesh, goal, cfg=JaxIKConfig(**kw))
    _assert_anim_close(got, want, atol=1e-8)


def test_icp_recovers_pose():
    """tests/test_icp.py's check on the port: 25 iterations bring the
    skinned mesh within 0.05 of the goal on average."""
    rng = np.random.default_rng(0)
    rest, weights, mesh, goal = _icp_case(rng)
    fitted = icp.solve_icp(_port(rest), rest, weights, mesh, goal,
                           cfg=IKConfig(iterations=25, damping=3.0, translate=False),
                           maxjoints=1, find_closest=False)
    got = skinning.skin(fitted, rest, weights, mesh, maxjoints=1).numpy()
    assert np.linalg.norm(got - goal, axis=-1).mean() < 0.05


def test_float32_animation_stays_float32():
    rng = np.random.default_rng(25)
    anim = Animation.from_numpy(_random_anim(rng, 2, 5), dtype=torch.float32)
    gp = _gp(anim)
    assert basic_ik.solve_basic_ik(anim, gp).rotations.dtype == torch.float32
    out = basic_ik.solve_jacobian_ik(anim, {4: gp[:, 4]}, IKConfig(iterations=1))
    assert out.rotations.dtype == torch.float32


def test_array_animations_default_to_cuda():
    """An animation of numpy arrays (chd_tpu's input type) goes to the card
    unless the caller asks for the CPU, so every entry point raises where
    CUDA is absent; with ``device="cpu"`` it runs there, in float64 for
    float64 arrays."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the test is of a machine without it")
    rng = np.random.default_rng(26)
    anim = _random_anim(rng, 2, 5)
    gp = _gp(anim)
    mesh, w = rng.normal(size=(6, 3)), rng.uniform(size=(6, 5))
    goal = np.repeat(mesh[None], 2, axis=0)
    calls = {
        "skin": lambda **d: skinning.skin(anim, anim, w, mesh, **d),
        "wrap_angles": lambda **d: skinning.wrap_angles(np.array([7.0]), **d),
        "solve_basic_ik": lambda **d: basic_ik.solve_basic_ik(anim, gp, **d).rotations,
        "solve_jacobian_ik": lambda **d: basic_ik.solve_jacobian_ik(
            anim, {4: gp[:, 4]}, IKConfig(iterations=1), **d).rotations,
        "solve_icp": lambda **d: icp.solve_icp(anim, anim, w, mesh, goal,
                                               cfg=IKConfig(iterations=1), **d).rotations,
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
        out = call(device="cpu")
        assert out.device.type == "cpu" and out.dtype == torch.float64, name
