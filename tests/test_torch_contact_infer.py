"""chd_tpu_torch.contact.infer against chd_tpu.contact.infer and the golden.

The port's whole batch (gap-fill → MLP → votes) is held against
``chd_tpu.contact.infer._infer_batch`` on identical batches and weights:
window probabilities within 1e-5 (float32 sums in different orders), and
contacts equal on every frame whose label survives a ±1e-3 move of the 0.5
threshold, the mask of tests/test_contact_infer.py.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chd_tpu.characters.defs import OP_JOINT_SUBSETS
from chd_tpu.contact import infer as jax_infer
from chd_tpu.models import contact_mlp as jax_mlp
from chd_tpu_torch.contact import infer
from chd_tpu_torch.models import torch_convert
from chd_tpu_torch.ops import voting
from test_torch_contact_mlp import golden_state_dict, random_params

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
W, P = 9, 5


def _keypoints(rng, V, F):
    kp = np.empty((V, F, 25, 3), np.float32)
    kp[..., 0] = rng.uniform(0, 1280, size=(V, F, 25))
    kp[..., 1] = rng.uniform(0, 720, size=(V, F, 25))
    kp[..., 2] = rng.uniform(0, 1, size=(V, F, 25))
    return kp


def _stable(probs):
    """Frames whose contacts do not move under a ±1e-3 threshold shift."""
    lo = voting.merge_votes_batch((probs > 0.5 + 1e-3).float(), W)
    hi = voting.merge_votes_batch((probs > 0.5 - 1e-3).float(), W)
    return (lo == hi).numpy()


@pytest.mark.parametrize("use_conv", [True, False])
@pytest.mark.parametrize("joint_set", ["lower", "lower_ankles"])
def test_infer_batch_matches_jax(joint_set, use_conv):
    subset = tuple(OP_JOINT_SUBSETS[joint_set])
    params, state = random_params(np.random.default_rng(0), in_dim=W * len(subset) * 3)
    kp = _keypoints(np.random.default_rng(1), 3, 50)
    kw = dict(window_size=W, pred_size=P, joint_subset=subset, use_confidence=True,
              conf_thresh=0.2, normalization=jax_infer.TRAIN_NORMALIZATION,
              classify_thresh=0.5, use_conv=use_conv)

    jf = jax_mlp.fold_batchnorm(params, state)
    c_want, p_want = jax.jit(functools.partial(jax_infer._infer_batch, **kw))(
        jnp.asarray(kp), jf)

    det = infer.ContactDetector(torch_convert.from_jax_params(params, state),
                                device="cpu", joint_set=joint_set, use_conv=use_conv)
    c_got, p_got = det.infer(torch.from_numpy(kp))
    assert c_got.shape == (3, 50, 4) and c_got.dtype == torch.int32
    assert p_got.shape == (3, 50 - W + 1, P, 4)
    np.testing.assert_allclose(p_got.numpy(), np.asarray(p_want), atol=1e-5)
    stable = _stable(p_got)
    assert stable.mean() > 0.95
    np.testing.assert_array_equal(np.where(stable, c_got.numpy(), 0),
                                  np.where(stable, np.asarray(c_want), 0))


def _write_video_dirs(root, videos):
    dirs = []
    for i, kp in enumerate(videos):
        opd = root / f"vid{i}" / "openpose_result"
        opd.mkdir(parents=True)
        for f in range(kp.shape[0]):
            doc = {"people": [{"pose_keypoints_2d": kp[f].reshape(-1).tolist()}]}
            (opd / f"frame_{f:06d}_keypoints.json").write_text(json.dumps(doc))
        dirs.append(str(root / f"vid{i}"))
    return dirs


@pytest.mark.parametrize("use_conv", [True, False])
def test_golden_contacts(tmp_path, use_conv):
    data = np.load(os.path.join(FIXTURES, "contact_golden.npz"))
    vids = sorted(k for k in data.files if k.startswith("keypoints_"))
    dirs = _write_video_dirs(tmp_path, [data[k] for k in vids])
    model = torch_convert.from_state_dict(golden_state_dict())
    results = infer.detect_contacts(dirs, model, device="cpu", image_dims=(1920, 1080),
                                    save=True, use_conv=use_conv)
    for i, got in enumerate(results):
        want = data[f"contacts_{i}"]
        assert got.shape == want.shape
        agree = (got.astype(int) == want.astype(int)).mean()
        assert agree >= 0.999, f"video {i}: agreement {agree}"
        saved = np.load(os.path.join(dirs[i], "foot_contacts.npy"))
        np.testing.assert_array_equal(saved, got)


def test_detect_contacts_rejects_other_aspect_ratios(tmp_path):
    model = torch_convert.from_state_dict(golden_state_dict())
    with pytest.raises(ValueError, match="aspect"):
        infer.detect_contacts([], model, device="cpu", image_dims=(1920, 1920))


def test_single_video_rows_equal_batched_rows():
    """Each video's rows are the same alone (V=1) as inside a V=21 batch: the
    port runs one flat batch where chd_tpu chunks the video axis. Contacts
    must be equal. Probabilities on the CPU agree to one float32 rounding,
    because the CPU matmul blocks its sums by batch size; the CUDA kernel
    gives bitwise equal rows (tests/test_torch_fused_mlp.py, chip_smoke.py)."""
    rng = np.random.default_rng(3)
    V, F = 21, 40
    kp = np.zeros((V, F, 25, 3), np.float32)
    kp[..., 0] = rng.uniform(0.5, 6.0, size=(V, F, 25))
    kp[..., 1] = rng.uniform(0.5, 4.0, size=(V, F, 25))
    kp[..., 2] = rng.uniform(0.0, 1.0, size=(V, F, 25))
    params, state = random_params(np.random.default_rng(4))
    model = torch_convert.from_jax_params(params, state)
    for use_conv in (True, False):
        det = infer.ContactDetector(model, device="cpu", use_conv=use_conv)
        c_all, p_all = det.infer(torch.from_numpy(kp))
        for v in range(V):
            c1, p1 = det.infer(torch.from_numpy(kp[v:v + 1]))
            assert torch.equal(c1[0], c_all[v])
            torch.testing.assert_close(p1[0], p_all[v], atol=1e-6, rtol=0)
            np.testing.assert_array_equal(det.detect(kp[v]), c_all[v].numpy())
        got = det.detect_batch(kp, [F - v for v in range(V)])
        for v in range(V):
            np.testing.assert_array_equal(got[v], c_all[v, :F - v].numpy())


def test_pad_to_length():
    a = np.arange(6, dtype=np.float32).reshape(3, 2)
    b = np.arange(10, dtype=np.float32).reshape(5, 2)
    batch, n = infer.pad_to_length([a, b])
    assert n == 5 and batch.shape == (2, 5, 2)
    np.testing.assert_array_equal(batch[0], np.concatenate([a, a[-1:], a[-1:]]))
    np.testing.assert_array_equal(batch[1], b)
    batch, n = infer.pad_to_length([a, b], length=4)
    np.testing.assert_array_equal(batch[1], b[:4])
    want, _ = jax_infer.pad_to_length([a, b])
    np.testing.assert_array_equal(infer.pad_to_length([a, b])[0], want)


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        infer.resolve_device("cuda")
