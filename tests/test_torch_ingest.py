"""chd_tpu_torch.ingest (one_euro, totalcap, openpose) and utils.native
against chd_tpu on the same seeded inputs.

Tolerances:
- ``one_euro_filter`` and ``filter_poses`` in float64: atol 1e-12 (read:
  4e-16; the same recurrence in the same order); in float32, on tracks of
  values up to ~60: atol 2e-5, four float32 ulps at that scale (read:
  5.7e-6; XLA fuses the float32 arithmetic otherwise). Each of
  chd_tpu's three parity rules (the first sample passes through, the
  derivative at t=0 is 0, integer timestamps update the frequency only
  from the third sample) is checked against the filter's formula by hand
  at atol 1e-12.
- the totalcap functions: equal arrays, and the re-saved MTC text files
  token for token;
- ``parse_floats`` and ``load_keypoint_dir`` in both modes: equal arrays
  (the same C++ parser, or the same json module).
"""
import json
import math
import os

import numpy as np
import pytest
import torch

from chd_tpu.ingest import one_euro as jax_one_euro
from chd_tpu.ingest import openpose as jax_openpose
from chd_tpu.ingest import totalcap as jax_totalcap
from chd_tpu.utils import native as jax_native
from chd_tpu_torch.ingest import one_euro, openpose, totalcap
from chd_tpu_torch.utils import native
from test_totalcap import make_results_json

CFG = dict(freq=30.0, mincutoff=0.05, beta=0.005, dcutoff=1.0)


def _alpha(cutoff, freq):
    return 1.0 / (1.0 + freq / (2.0 * math.pi * cutoff))


@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-12), (np.float32, 2e-5)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("timestamps", ["none", "frames", "with_zeros"])
def test_one_euro_matches_chd_tpu(timestamps, dtype, atol):
    """A (F, 25, 2) track set, without timestamps, with the frame numbers,
    and with seconds that contain zeros (the truthiness guard skips them)."""
    rng = np.random.default_rng(4)
    F = 50
    x = rng.normal(size=(F, 25, 2)).astype(dtype) * 20
    ts = {"none": None, "frames": np.arange(F, dtype=float),
          "with_zeros": np.where(rng.uniform(size=F) < 0.2, 0.0, np.arange(F) / 30.0)}[timestamps]
    want = np.asarray(jax_one_euro.one_euro_filter(x, timestamps=ts, **CFG))
    got = one_euro.one_euro_filter(x, timestamps=ts, device="cpu", **CFG)
    assert got.dtype == torch.from_numpy(x).dtype and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


def test_filter_poses_matches_chd_tpu():
    poses = np.random.default_rng(5).normal(size=(40, 25, 3)) * 50
    want = np.asarray(jax_one_euro.filter_poses(poses))
    got = one_euro.filter_poses(poses, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12, rtol=0)
    # a tensor stays on its device and in its dtype
    t = torch.from_numpy(poses.astype(np.float32))
    assert one_euro.filter_poses(t).dtype == torch.float32


def test_one_euro_first_sample_passes_through():
    x = np.random.default_rng(6).normal(size=(5, 7))
    for ts in (None, np.arange(5.0)):
        got = one_euro.one_euro_filter(x, timestamps=ts, device="cpu", **CFG)
        assert np.array_equal(got[0].numpy(), x[0])


def test_one_euro_derivative_at_t0_is_zero():
    """out[1] from the formula with the derivative state of t=0 set to 0:
    s_dx(1) = a_d * (x1 - x0) * f, s_x(1) = a_x * x1 + (1 - a_x) * x0."""
    x = np.array([[1.0, -2.0], [3.0, 0.5], [2.0, 1.0]])
    f = CFG["freq"]
    a_d = _alpha(CFG["dcutoff"], f)
    edx = a_d * (x[1] - x[0]) * f
    a_x = _alpha(CFG["mincutoff"] + CFG["beta"] * np.abs(edx), f)
    want = a_x * x[1] + (1 - a_x) * x[0]
    got = one_euro.one_euro_filter(x, device="cpu", **CFG)
    np.testing.assert_allclose(got[1].numpy(), want, atol=1e-12, rtol=0)


def test_one_euro_integer_timestamps_update_from_the_third_sample():
    """With timestamps 0, 1, 2, ...: t=1 still runs at ``freq`` (its last
    timestamp, 0, is falsy), and from t=2 the frequency is 1 / (2 - 1)."""
    x = np.random.default_rng(7).normal(size=(4, 3))
    got = one_euro.one_euro_filter(x, timestamps=np.arange(4), device="cpu", **CFG).numpy()
    fixed = one_euro.one_euro_filter(x, device="cpu", **CFG).numpy()
    np.testing.assert_array_equal(got[:2], fixed[:2])
    assert not np.allclose(got[2], fixed[2])
    # t=2 by hand at f = 1, from the state that t=1 left at freq
    f0 = CFG["freq"]
    edx1 = _alpha(CFG["dcutoff"], f0) * (x[1] - x[0]) * f0
    a_d = _alpha(CFG["dcutoff"], 1.0)
    edx2 = a_d * (x[2] - x[1]) * 1.0 + (1 - a_d) * edx1
    a_x = _alpha(CFG["mincutoff"] + CFG["beta"] * np.abs(edx2), 1.0)
    np.testing.assert_allclose(got[2], a_x * x[2] + (1 - a_x) * got[1], atol=1e-12, rtol=0)


def test_one_euro_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the test is of a machine without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        one_euro.one_euro_filter(np.zeros((3, 2)))


def test_save_totalcap_results_matches_chd_tpu(tmp_path):
    path = make_results_json(tmp_path, F=4, seed=3)
    res = totalcap.load_totalcap_results(path)
    totalcap.save_totalcap_results(res, str(tmp_path / "ours"))
    jax_totalcap.save_totalcap_results(jax_totalcap.load_totalcap_results(path),
                                       str(tmp_path / "theirs"))
    names = sorted(os.listdir(tmp_path / "theirs"))
    assert names == sorted(os.listdir(tmp_path / "ours")) and len(names) == 4
    for name in names:
        assert ((tmp_path / "ours" / name).read_text().split()
                == (tmp_path / "theirs" / name).read_text().split())


def test_angle_remaps_match_chd_tpu():
    rng = np.random.default_rng(2)
    smpl = rng.normal(size=(4, 22, 3))
    comb = rng.normal(size=(4, 28, 3))
    np.testing.assert_array_equal(totalcap.combined_angles_from_smpl(smpl),
                                  jax_totalcap.combined_angles_from_smpl(smpl))
    np.testing.assert_array_equal(totalcap.smpl_from_combined_angles(comb),
                                  jax_totalcap.smpl_from_combined_angles(comb))
    for char in ["ybot", "ty", "skeletonzombie"]:
        np.testing.assert_array_equal(totalcap.mixamo_angles_from_smpl(smpl, char),
                                      jax_totalcap.mixamo_angles_from_smpl(smpl, char))


@pytest.fixture(scope="module")
def kp_dir(tmp_path_factory):
    """25 OpenPose frames, one without a person and each with a second
    person that the loaders ignore (tests/test_native.py's case)."""
    d = tmp_path_factory.mktemp("kp")
    rng = np.random.default_rng(0)
    for t in range(25):
        kp = rng.normal(size=(25, 3)) * 100
        people = [] if t == 7 else [{"pose_keypoints_2d": kp.reshape(-1).tolist()},
                                    {"pose_keypoints_2d": (kp * 2).reshape(-1).tolist()}]
        (d / f"{t:06d}_keypoints.json").write_text(json.dumps({"version": 1.3,
                                                               "people": people}))
    return str(d)


def test_load_keypoint_dir_both_modes_match_chd_tpu(kp_dir):
    assert native.available(), "the C++ loader should build with this machine's compiler"
    fast = openpose.load_keypoint_dir(kp_dir, use_native=True)
    slow = openpose.load_keypoint_dir(kp_dir, use_native=False)
    np.testing.assert_array_equal(fast, slow)
    assert fast.shape == (25, 25, 3) and not fast[7].any()
    np.testing.assert_array_equal(fast, jax_openpose.load_keypoint_dir(kp_dir, use_native=True))
    np.testing.assert_array_equal(slow, jax_openpose.load_keypoint_dir(kp_dir, use_native=False))
    assert openpose.load_keypoint_dir(os.path.join(kp_dir, "missing")) is None


def test_parse_floats_matches_chd_tpu(tmp_path):
    p = tmp_path / "sol.txt"
    p.write_text("base_lin\n1.5 2.5e-3 -7\nnum_frames\n3\nfootpos\n0.1 0.2\n")
    got = native.parse_floats(str(p), 100)
    np.testing.assert_array_equal(got, [1.5, 2.5e-3, -7, 3, 0.1, 0.2])
    np.testing.assert_array_equal(got, jax_native.parse_floats(str(p), 100))
    np.testing.assert_array_equal(native.parse_floats(str(p), 4), [1.5, 2.5e-3, -7, 3])
    with pytest.raises(IOError):
        native.parse_floats(str(tmp_path / "missing.txt"), 10)
