"""chd_tpu_torch.core (quat, skeleton, animation, fk, bvh) and the port's own
copies (characters.defs, utils.config, utils.native) against chd_tpu.

Inputs are made with numpy from a seed and handed to both packages. The
port's quaternion product and euler composition sum the same terms in
another order, so results agree to a rounding: float64 within atol 1e-10,
float32 within 1e-5 (unit quaternions, angles, matrices). FK positions are
in cm on a ~190 cm skeleton: float64 within 1e-9, float32 within 1e-3.
Tables, masks, loaded BVHs and saved BVH text are equal.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chd_tpu.characters import defs as jax_defs
from chd_tpu.characters import registry as jax_registry
from chd_tpu.core import bvh as jax_bvh
from chd_tpu.core import fk as jax_fk
from chd_tpu.core import quat as jax_quat
from chd_tpu.core import skeleton as jax_skeleton
from chd_tpu.utils import config as jax_config
from chd_tpu_torch.characters import defs, get_character, registry
from chd_tpu_torch.core import bvh, fk, quat, skeleton
from chd_tpu_torch.core.animation import Animation
from chd_tpu_torch.ingest import openpose
from chd_tpu_torch.utils import config, native

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
BVHS = [os.path.join(FIXTURES, "prepare_input", c, "motion.bvh") for c in ("combined", "ybot")]
ATOL = {np.float64: 1e-10, np.float32: 1e-5}
FK_ATOL = {np.float64: 1e-9, np.float32: 1e-3}


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_executables():
    yield
    jax.clear_caches()


def _golden_parents():
    return [int(p) for p in np.load(os.path.join(FIXTURES, "trajectory_golden.npz"))["skel_parents"]]


@pytest.mark.parametrize("name", [
    "BODY_25_ROOT_IDX", "BODY_25_ADJ_LIST", "SMPL_ROOT_IDX", "SMPL_SPINE_JOINTS", "COMBINED_NUM_JOINTS",
    "COMBINED_ROOT_IDX", "COMBINED_PROJ_WEIGHTS", "COMBINED_DATA_WEIGHTS",
    "COMBINED_SMOOTH_WEIGHTS", "COMBINED_SKEL_TO_DATA", "COMBINED_DATA_TO_SKEL",
    "COMBINED_SKEL_ROOT_IDX", "COMBINED_SKEL_SPINE_JOINTS", "COMBINED_SKEL_FEET_IDX",
    "CONTACT_TO_DATA_JOINTS", "OP_ROOT_JOINT", "OP_JOINT_SUBSETS", "SMPL_FOR_COMBINED_SKEL",
    "COMBINED_SKEL_FOR_SMPL", "COMBINED_FOOT_INDS", "COMBINED_TOE_INDS", "COMBINED_ANKLE_INDS",
    "COMBINED_EYE_INDS", "MTC_WIDTH", "MTC_HEIGHT", "MTC_FOCAL", "MTC_PP",
    "BODY_25_NUM_JOINTS", "BODY_25_PROJ_WEIGHTS", "BODY_25_SMOOTH_WEIGHTS", "COMBINED_ADJ_LIST",
    "COMBINED_SKEL_NECK_JOINT", "CONTACT_LABEL_NAMES", "OP_LOWER_JOINTS",
    "OP_LOWER_JOINT_NAMES", "OP_LOWER_PARENTS", "SMPL_ADJ_LIST", "SMPL_NUM_JOINTS",
])
def test_defs_table_equals_chd_tpu(name):
    got, want = getattr(defs, name), getattr(jax_defs, name)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(jax_registry.CHARACTERS))
def test_registry_tables_equal_chd_tpu(name):
    got, want = get_character(name), jax_registry.get_character(name)
    assert sorted(registry.CHARACTERS) == sorted(jax_registry.CHARACTERS)
    for field in want.__dataclass_fields__:
        g, w = getattr(got, field), getattr(want, field)
        if isinstance(w, dict):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
        elif w is None:
            assert g is None, field
        else:
            np.testing.assert_array_equal(g, w, err_msg=field)
    for g, w in zip(got.segment_matrices(), want.segment_matrices()):
        np.testing.assert_array_equal(g, w)
    assert (got.toe_inds, got.ankle_inds, got.hip_inds, got.foot_inds, got.has_heel) == \
        (want.toe_inds, want.ankle_inds, want.hip_inds, want.foot_inds, want.has_heel)
    for table in ("SEGMENT_NAMES", "MASS_PERC_MALE", "MASS_PERC_FEMALE", "MALE_MASS",
                  "FEMALE_MASS", "HEELED_CHARACTERS"):
        assert getattr(registry, table) == getattr(jax_registry, table)


def test_config_equals_chd_tpu():
    cfg = config.PipelineConfig().override(**{"kinematic.lm_iters": 7, "physics.w_ee": 0.5})
    want = jax_config.PipelineConfig().override(**{"kinematic.lm_iters": 7, "physics.w_ee": 0.5})
    assert cfg.to_json() == want.to_json()
    assert dataclasses.asdict(config.PipelineConfig.from_json(want.to_json())) == \
        dataclasses.asdict(want)


def test_native_keypoint_loader_matches_json(tmp_path):
    """The port's own build of native/chd_native.cpp (into build/chd_native/)
    parses OpenPose files as the json module does, empty frames included."""
    rng = np.random.default_rng(3)
    want = []
    for t in range(6):
        kp = np.zeros((25, 3)) if t == 2 else rng.normal(size=(25, 3)) * 100
        people = [] if t == 2 else [{"pose_keypoints_2d": kp.reshape(-1).tolist()},
                                    {"pose_keypoints_2d": (2 * kp).reshape(-1).tolist()}]
        (tmp_path / f"{t:06d}_keypoints.json").write_text(json.dumps({"people": people}))
        want.append(kp)
    assert native.available(), "the C++ loader should build with this machine's compiler"
    assert os.path.join("build", "chd_native") in native._lib_path()
    files = openpose.keypoint_files(str(tmp_path))
    np.testing.assert_allclose(native.load_keypoint_dir(files), np.stack(want), rtol=1e-12)
    np.testing.assert_allclose(openpose.load_keypoint_dir(str(tmp_path)), np.stack(want),
                               rtol=1e-12)


def _unit_quats(rng, n, dtype):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(dtype)


def _cases(rng, dtype):
    """name → (port call, chd_tpu call) on the same seeded numpy inputs."""
    n = 64
    a, b = _unit_quats(rng, n, dtype), _unit_quats(rng, n, dtype)
    v = rng.normal(size=(n, 3)).astype(dtype)
    w = (rng.normal(size=(n, 3)) * 0.8).astype(dtype)
    w[0] = 0.0  # the exp guard
    eul = rng.uniform(-1.4, 1.4, size=(n, 3)).astype(dtype)
    ang = rng.uniform(-3, 3, size=(n,)).astype(dtype)
    t = rng.uniform(size=(n,)).astype(dtype)
    near = (b + 1e-3 * a).astype(dtype)  # the slerp linear fallback
    t_, j_ = torch.from_numpy, jnp.asarray
    mats = np.array(jax_quat.to_matrix(j_(a)))
    cases = {
        "mul": (lambda: quat.mul(t_(a), t_(b)), lambda: jax_quat.mul(j_(a), j_(b))),
        "rotate": (lambda: quat.rotate(t_(a), t_(v)), lambda: jax_quat.rotate(j_(a), j_(v))),
        "conjugate": (lambda: quat.conjugate(t_(a)), lambda: jax_quat.conjugate(j_(a))),
        "normalize": (lambda: quat.normalize(t_(3 * a)), lambda: jax_quat.normalize(j_(3 * a))),
        "abs_pole": (lambda: quat.abs_pole(t_(a)), lambda: jax_quat.abs_pole(j_(a))),
        "dot": (lambda: quat.dot(t_(a), t_(b)), lambda: jax_quat.dot(j_(a), j_(b))),
        "from_angle_axis": (lambda: quat.from_angle_axis(t_(ang), t_(v)),
                            lambda: jax_quat.from_angle_axis(j_(ang), j_(v))),
        "to_angle_axis": (lambda: torch.cat([x.reshape(n, -1) for x in
                                             quat.to_angle_axis(t_(a))], -1),
                          lambda: jnp.concatenate([x.reshape(n, -1) for x in
                                                   jax_quat.to_angle_axis(j_(a))], -1)),
        "to_matrix": (lambda: quat.to_matrix(t_(a)), lambda: jax_quat.to_matrix(j_(a))),
        "from_matrix": (lambda: quat.from_matrix(t_(mats)),
                        lambda: jax_quat.from_matrix(j_(mats))),
        "between": (lambda: quat.between(t_(v), t_(w)), lambda: jax_quat.between(j_(v), j_(w))),
        "exp": (lambda: quat.exp(t_(w)), lambda: jax_quat.exp(j_(w))),
        "log": (lambda: quat.log(t_(a)), lambda: jax_quat.log(j_(a))),
        "slerp": (lambda: quat.slerp(t_(a), t_(b), t_(t)),
                  lambda: jax_quat.slerp(j_(a), j_(b), j_(t))),
        "slerp_near": (lambda: quat.slerp(t_(b), t_(near), t_(t)),
                       lambda: jax_quat.slerp(j_(b), j_(near), j_(t))),
        "identity": (lambda: quat.identity((5, 2), dtype=torch.float64),
                     lambda: jax_quat.identity((5, 2), dtype=jnp.float64)),
    }
    for order in ("xyz", "yzx", "zyx"):
        for world in (False, True):
            cases[f"from_euler_{order}_{world}"] = (
                lambda o=order, wd=world: quat.from_euler(t_(eul), o, wd),
                lambda o=order, wd=world: jax_quat.from_euler(j_(eul), o, wd))
    for order in ("xyz", "yzx"):
        cases[f"to_euler_{order}"] = (lambda o=order: quat.to_euler(t_(a), o),
                                      lambda o=order: jax_quat.to_euler(j_(a), o))
    return cases


QUAT_CASES = sorted(_cases(np.random.default_rng(0), np.float64))


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", QUAT_CASES)
def test_quat_matches_chd_tpu(name, dtype):
    port, ref = _cases(np.random.default_rng(0), dtype)[name]
    got, want = port().numpy(), np.asarray(ref())
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL[dtype], rtol=0)


def test_quat_euler_roundtrip_and_jvp():
    """to_euler inverts from_euler(world=True); forward-mode AD runs through
    the functions the residual uses and agrees with finite differences."""
    rng = np.random.default_rng(1)
    e = torch.from_numpy(rng.uniform(-1.2, 1.2, size=(32, 3)))
    np.testing.assert_allclose(quat.to_euler(quat.from_euler(e, "xyz", True), "xyz").numpy(),
                               e.numpy(), atol=1e-10)
    v = torch.from_numpy(rng.normal(size=(32, 3)))
    u = torch.from_numpy(rng.normal(size=(32, 3)))

    def f(x):
        q = quat.from_euler(x, "xyz", True)
        return quat.rotate(quat.mul(q, quat.conjugate(q.flip(-1))), v)

    _, tangent = torch.func.jvp(f, (e,), (u,))
    h = 1e-6
    fd = (f(e + h * u) - f(e - h * u)) / (2 * h)
    np.testing.assert_allclose(tangent.numpy(), fd.numpy(), atol=1e-7)


def _fk_inputs(rng, parents, F, dtype):
    J = len(parents)
    rot = _unit_quats(rng, F * J, dtype).reshape(F, J, 4)
    pos = rng.normal(0, 20, size=(F, J, 3)).astype(dtype)
    return rot, pos


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("source", ["golden", "combined", "ybot"])
def test_fk_matches_chd_tpu(source, dtype):
    if source == "golden":
        parents = _golden_parents()
        rot, pos = _fk_inputs(np.random.default_rng(2), parents, 9, dtype)
    else:
        anim, _, _ = jax_bvh.load(BVHS[["combined", "ybot"].index(source)])
        parents = anim.parents
        rot = np.asarray(anim.rotations, dtype)
        pos = np.asarray(anim.positions, dtype)
    gq, gp = fk.fk(torch.from_numpy(rot), torch.from_numpy(pos), parents)
    jq, jp = jax_fk.fk(jnp.asarray(rot), jnp.asarray(pos), tuple(parents))
    np.testing.assert_allclose(gq.numpy(), np.asarray(jq), atol=ATOL[dtype], rtol=0)
    np.testing.assert_allclose(gp.numpy(), np.asarray(jp), atol=FK_ATOL[dtype], rtol=0)
    tg = fk.transforms_global(torch.from_numpy(rot), torch.from_numpy(pos), parents)
    np.testing.assert_allclose(
        tg.numpy(), np.asarray(jax_fk.transforms_global(jnp.asarray(rot), jnp.asarray(pos),
                                                        tuple(parents))),
        atol=FK_ATOL[dtype], rtol=0)


def test_fk_tree_levels_of_the_combined_skeleton():
    """7 levels of 1/3/3/3/9/7/2 joints; levels 2 and 3 need no gather."""
    tree = fk.Tree(_golden_parents())
    assert tree.sizes == [1, 3, 3, 3, 9, 7, 2]
    assert [m for m, _ in tree.links] == [3, 1, 1, 3, 5, 1]
    assert [s is None for _, s in tree.links] == [False, True, True, False, False, False]


@pytest.mark.parametrize("source", ["golden", "combined", "ybot"])
def test_skeleton_helpers_match_chd_tpu(source):
    parents = (_golden_parents() if source == "golden"
               else jax_bvh.load(BVHS[["combined", "ybot"].index(source)])[0].parents)
    np.testing.assert_array_equal(skeleton.descendants_mask(parents),
                                  jax_skeleton.descendants_mask(parents))
    np.testing.assert_array_equal(skeleton.ancestors_mask(parents),
                                  jax_skeleton.ancestors_mask(parents))
    for got, want in zip(skeleton.children_list(parents), jax_skeleton.children_list(parents)):
        np.testing.assert_array_equal(got, want)
    leaf = len(parents) - 1
    np.testing.assert_array_equal(skeleton.joint_chain_ascend(parents, leaf, 0),
                                  jax_skeleton.joint_chain_ascend(parents, leaf, 0))
    levels = skeleton.depth_levels(parents)
    assert sorted(np.concatenate(levels).tolist()) == list(range(len(parents)))
    for d, level in enumerate(levels[1:], start=1):
        assert set(np.asarray(parents)[level]) <= set(levels[d - 1])


@pytest.mark.parametrize("path", BVHS, ids=["combined", "ybot"])
def test_bvh_load_matches_chd_tpu(path):
    got, names, ft = bvh.load(path)
    want, jnames, jft = jax_bvh.load(path)
    assert names == jnames and ft == jft and got.parents == want.parents
    np.testing.assert_allclose(got.rotations, want.rotations, atol=1e-12, rtol=0)
    for k in ("positions", "orients", "offsets"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))


@pytest.mark.parametrize("path", BVHS, ids=["combined", "ybot"])
def test_bvh_save_text_equals_chd_tpu_and_round_trips(path, tmp_path):
    anim, names, ft = bvh.load(path)
    bvh.save(str(tmp_path / "port.bvh"), anim, names, frametime=ft)
    jax_bvh.save(str(tmp_path / "jax.bvh"), jax_bvh.load(path)[0], names, frametime=ft)
    assert (tmp_path / "port.bvh").read_text() == (tmp_path / "jax.bvh").read_text()
    # a tensor animation saves the same text
    bvh.save(str(tmp_path / "tensor.bvh"), Animation.from_numpy(anim, dtype=torch.float64),
             names, frametime=ft)
    assert (tmp_path / "tensor.bvh").read_text() == (tmp_path / "port.bvh").read_text()
    back, bnames, bft = bvh.load(str(tmp_path / "port.bvh"))
    assert bnames == names and back.parents == anim.parents
    gp0 = fk.positions_global(torch.from_numpy(anim.rotations), torch.from_numpy(anim.positions),
                              anim.parents)
    gp1 = fk.positions_global(torch.from_numpy(back.rotations), torch.from_numpy(back.positions),
                              back.parents)
    np.testing.assert_allclose(gp1.numpy(), gp0.numpy(), atol=1e-3)  # "%f" text: 1e-6 deg


def test_animation_numpy_round_trip():
    anim, _, _ = bvh.load(BVHS[0])
    t = Animation.from_numpy(anim, dtype=torch.float64)
    assert isinstance(t.rotations, torch.Tensor) and t.rotations.dtype == torch.float64
    back = t.to_numpy()
    for k in ("rotations", "positions", "orients", "offsets"):
        np.testing.assert_array_equal(getattr(back, k), getattr(anim, k))
    assert back.parents == anim.parents and t.num_frames == anim.num_frames
    assert t.slice_frames(1, 3).num_frames == 2 and t.num_joints == anim.num_joints
