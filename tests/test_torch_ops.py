"""chd_tpu_torch.ops (gap-fill, windows, voting) against chd_tpu.ops and the
loop oracles of tests/test_contact_ops.py.

Inputs are made with numpy from a seed. Gap-fill and featurization are the
same float32 operations in the same order on both sides, so they agree to
the last bit or within one rounding (1e-6 relative); against the float64
loop oracle the port runs in float64 (atol 1e-9). Votes are small integers:
exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chd_tpu.characters.defs import OP_JOINT_SUBSETS, OP_ROOT_JOINT
from chd_tpu.ops import gapfill as jax_gapfill
from chd_tpu.ops import voting as jax_voting
from chd_tpu.ops import windows as jax_windows
from chd_tpu_torch.ops import gapfill, voting, windows
from test_contact_ops import ref_gapfill, ref_votes

NORM = 200.4160302695367


def _keypoints(rng, V, F, J):
    kp = np.empty((V, F, J, 3), np.float32)
    kp[..., 0] = rng.uniform(0, 1280, size=(V, F, J))
    kp[..., 1] = rng.uniform(0, 720, size=(V, F, J))
    kp[..., 2] = rng.uniform(0, 1, size=(V, F, J))
    # leading, trailing, interior and whole-track gaps
    kp[:, :5, 0, 2] = 0.0
    kp[:, -6:, 1, 2] = 0.05
    kp[:, 10:20, 2, 2] = 0.1
    kp[:, :, 3, 2] = 0.0
    kp[0, 0, 4, 2] = 0.0
    kp[0, -1, 4, 2] = 0.0
    return kp


def test_preprocess_keypoints_matches_jax():
    kp = _keypoints(np.random.default_rng(0), 3, 40, 13)
    want = np.asarray(jax_gapfill.preprocess_keypoints(jnp.asarray(kp), 0.2, NORM))
    got = gapfill.preprocess_keypoints(torch.from_numpy(kp), 0.2, NORM).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    valid = kp[..., 2] >= 0.2
    # valid detections and the confidence channel pass through untouched
    np.testing.assert_array_equal(got[valid][:, :2], kp[valid][:, :2] / np.float32(NORM))
    np.testing.assert_array_equal(got[..., 2], kp[..., 2])
    np.testing.assert_array_equal(got[:, :, 3], np.concatenate(
        [kp[:, :, 3, :2] / np.float32(NORM), kp[:, :, 3, 2:]], axis=-1))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_fill_low_confidence_matches_reference_loop():
    rng = np.random.default_rng(1)
    kp = _keypoints(rng, 2, 40, 7).astype(np.float64)
    seq, conf = kp[..., :2] * 0.1, kp[..., 2]
    got = gapfill.fill_low_confidence(torch.from_numpy(seq), torch.from_numpy(conf)).numpy()
    for v in range(seq.shape[0]):
        np.testing.assert_allclose(got[v], ref_gapfill(seq[v], conf[v]), atol=1e-9)
    # single-frame gaps at the first frame and in the middle
    seq = rng.normal(size=(10, 2, 2))
    conf = np.ones((10, 2))
    conf[3, 0] = 0.0
    conf[0, 1] = 0.0
    got = gapfill.fill_low_confidence(torch.from_numpy(seq), torch.from_numpy(conf)).numpy()
    np.testing.assert_allclose(got, ref_gapfill(seq, conf), atol=1e-9)


@pytest.mark.parametrize("use_confidence", [True, False])
def test_featurize_batch_matches_jax(use_confidence):
    subset = list(OP_JOINT_SUBSETS["lower"])
    root = subset.index(OP_ROOT_JOINT)
    x = np.random.default_rng(2).normal(size=(3, 30, len(subset), 3)).astype(np.float32)
    want = np.asarray(jax_windows.featurize_batch(jnp.asarray(x), 9, root, use_confidence))
    got = windows.featurize_batch(torch.from_numpy(x), 9, root, use_confidence).numpy()
    assert got.shape == (3, 30 - 8, 9, len(subset), 3 if use_confidence else 2)
    np.testing.assert_array_equal(got, want)
    assert windows.num_windows(100, 9) == jax_windows.num_windows(100, 9) == 92


@pytest.mark.parametrize("joint_set,use_confidence", [
    ("lower", True), ("lower", False), ("lower_ankles", True)])
def test_layer1_conv_kernel_matches_jax(joint_set, use_confidence):
    joints = list(OP_JOINT_SUBSETS[joint_set])
    Jm = len(joints)
    if OP_ROOT_JOINT not in joints:
        joints.append(OP_ROOT_JOINT)
    J, root = len(joints), joints.index(OP_ROOT_JOINT)
    Cm = 3 if use_confidence else 2
    w1 = np.random.default_rng(3).normal(size=(64, 9 * Jm * Cm)).astype(np.float32)
    want = np.asarray(jax_windows.layer1_conv_kernel(
        jnp.asarray(w1), 9, J, root, Jm, use_confidence))
    got = windows.layer1_conv_kernel(torch.from_numpy(w1), 9, J, root, Jm,
                                     use_confidence).numpy()
    assert got.shape == (9, J * 3, 64)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_vote_thresholds_match_jax():
    for n, p in [(30, 5), (12, 3), (7, 1)]:
        np.testing.assert_array_equal(voting.vote_thresholds(n, p).numpy(),
                                      np.asarray(jax_voting.vote_thresholds(n, p)))


@pytest.mark.parametrize("W,P", [(9, 5), (9, 3), (7, 5), (5, 1)])
def test_merge_votes_batch_matches_jax_and_loop(W, P):
    rng = np.random.default_rng(4)
    V, N = 3, 30
    preds = (rng.uniform(size=(V, N, P, 4)) > 0.6).astype(np.float32)
    got = voting.merge_votes_batch(torch.from_numpy(preds), W).numpy()
    want = np.asarray(jax_voting.merge_votes_batch(jnp.asarray(preds), W))
    assert got.dtype == np.int32 and got.shape == (V, N + W - 1, 4)
    np.testing.assert_array_equal(got, want)
    for v in range(V):
        np.testing.assert_array_equal(got[v], ref_votes(preds[v], W))


def test_merge_votes_batch_rejects_parity_mismatch():
    with pytest.raises(ValueError, match="parity"):
        voting.merge_votes_batch(torch.zeros((1, 10, 4, 4)), 9)
