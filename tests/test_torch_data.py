"""chd_tpu_torch.contact.data, ops.windows' per-window form and
utils.metrics against chd_tpu on the same numpy inputs.

Sampling draws come from different generators in the two packages, so the
port's sampler is held against chd_tpu's given chd_tpu's own draws, and
separately for what its draws must satisfy. Tolerance 1e-6 on keypoints:
the same float32 operations, in the same order, on values of order 1-10.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chd_tpu.characters.defs import OP_JOINT_SUBSETS
from chd_tpu.contact import data as jax_data
from chd_tpu.ops import windows as jax_windows
from chd_tpu.utils import metrics as jax_metrics
from chd_tpu_torch.contact import data, synth
from chd_tpu_torch.ops import windows
from chd_tpu_torch.utils import metrics
from test_eval_ckpt import make_dataset

W, P = 9, 5


def _preprocessed(rng, B, F):
    op = np.empty((B, F, 25, 3), np.float32)
    op[..., :2] = rng.uniform(0, 5, size=(B, F, 25, 2))
    op[..., 2] = rng.uniform(0, 1, size=(B, F, 25))
    contacts = (rng.uniform(size=(B, F, 4)) > 0.5).astype(np.float32)
    return op, contacts


@pytest.mark.parametrize("chars,motions,views,frac", [(2, 5, 1, 0.8), (3, 11, 2, 0.8),
                                                      (1, 20, 3, 0.6)])
def test_reference_split_matches_jax(chars, motions, views, frac):
    np.random.seed(123)
    before = np.random.get_state()[1].copy()
    got = data.reference_split(chars, motions, views, frac)
    assert np.array_equal(np.random.get_state()[1], before)  # global state restored
    assert got == jax_data.reference_split(chars, motions, views, frac)
    assert sorted(sum(got, [])) == list(range(chars * motions * views))


def test_dataset_load_matches_jax(tmp_path):
    want = make_dataset(tmp_path, np.random.default_rng(0))
    got = data.ContactDataset.load(str(tmp_path / "synth"), device="cpu")
    assert got.normalization == want.normalization
    assert got.splits == want.splits and got.names == want.names
    assert got.num_frames == want.num_frames == 30
    assert got.op_data.dtype == torch.float32 and got.op_data.shape == want.op_data.shape
    np.testing.assert_allclose(got.op_data.numpy(), want.op_data, atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(got.contacts.numpy(), want.contacts)
    for split in ("train", "val", "test"):
        op, ct = got.split_arrays(split)
        op_w, ct_w = want.split_arrays(split)
        np.testing.assert_allclose(op.numpy(), op_w, atol=1e-6, rtol=1e-6)
        np.testing.assert_array_equal(ct.numpy(), ct_w)


def test_dataset_load_rejects_a_ragged_grid(tmp_path):
    make_dataset(tmp_path, np.random.default_rng(0))
    motion = tmp_path / "synth" / "B" / "004"  # one motion with a second view
    (motion / "view2").mkdir()
    shutil.copytree(motion / "keypoints_view1", motion / "keypoints_view2")
    with pytest.raises(ValueError, match="ragged"):
        data.ContactDataset.load(str(tmp_path / "synth"), device="cpu")


def test_dataset_entry_points_default_to_cuda(tmp_path):
    """ContactDataset.load and synth.learnable_dataset run on the card
    unless asked for the CPU, so they raise where CUDA is absent."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the test is of a machine without it")
    make_dataset(tmp_path, np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        data.ContactDataset.load(str(tmp_path / "synth"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        synth.learnable_dataset(n_seq=4, frames=20)


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("joint_set,use_conf", [("lower", True), ("lower_ankles", False)])
def test_eval_windows_match_jax(overlap, joint_set, use_conf):
    op, ct = _preprocessed(np.random.default_rng(1), 3, 40)
    subset = OP_JOINT_SUBSETS[joint_set]
    want = jax_data.eval_windows(jnp.asarray(op), jnp.asarray(ct), W, P, subset, overlap, use_conf)
    got = data.eval_windows(torch.from_numpy(op), torch.from_numpy(ct), W, P, subset, overlap,
                            use_conf)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("use_conf", [True, False])
def test_sample_train_windows_match_jax_given_its_draws(use_conf):
    """The port's gather, root normalization, subset, noise and labels equal
    chd_tpu's when handed the target frames and unit normals that chd_tpu
    draws from its key."""
    B, F = 6, 30
    op, ct = _preprocessed(np.random.default_rng(2), B, F)
    subset = OP_JOINT_SUBSETS["lower"]
    rng = jax.random.PRNGKey(5)
    want = jax_data.sample_train_windows(rng, jnp.asarray(op), jnp.asarray(ct), W, P, subset,
                                         0.005, use_conf)
    k_tgt, k_noise = jax.random.split(rng)
    tgt = np.array(jax.random.randint(k_tgt, (B,), W // 2, F - W // 2))
    z = np.array(jax.random.normal(k_noise, (B, W, len(subset), 2), jnp.float32))
    got = data.sample_train_windows(None, torch.from_numpy(op), torch.from_numpy(ct), W, P,
                                    subset, 0.005, use_conf, targets=torch.from_numpy(tgt),
                                    noise=torch.from_numpy(z))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)


def test_sample_train_windows_own_draws():
    """Targets in [W//2, F - W//2), N(0, 0.005) noise on x/y only, labels the
    P middle frames, and the draws (targets, then noise) all from the given
    generator."""
    B, F = 4000, 30
    op, ct = _preprocessed(np.random.default_rng(3), B, F)
    op_t, ct_t = torch.from_numpy(op), torch.from_numpy(ct)
    subset = OP_JOINT_SUBSETS["lower"]
    feats, labels = data.sample_train_windows(torch.Generator().manual_seed(7), op_t, ct_t, W, P,
                                              subset)
    assert feats.shape == (B, W, len(subset), 3) and labels.shape == (B, P, 4)
    gen = torch.Generator().manual_seed(7)
    tgt = torch.randint(W // 2, F - W // 2, (B,), generator=gen)
    z = torch.randn((B, W, len(subset), 2), generator=gen)
    again = data.sample_train_windows(None, op_t, ct_t, W, P, subset, targets=tgt, noise=z)
    assert torch.equal(again[0], feats) and torch.equal(again[1], labels)
    assert int(tgt.min()) == W // 2 and int(tgt.max()) == F - W // 2 - 1
    clean, _ = data.sample_train_windows(None, op_t, ct_t, W, P, subset, noise_dev=0.0,
                                         targets=tgt, noise=z)
    noise = (feats - clean).numpy()
    assert np.all(noise[..., 2] == 0)
    assert abs(noise[..., :2].std() - 0.005) < 1e-4 and abs(noise[..., :2].mean()) < 1e-4
    for b in (0, 1, B - 1):
        t = int(tgt[b])
        np.testing.assert_array_equal(labels[b].numpy(), ct[b, t - P // 2:t + P // 2 + 1])
        win = op[b, t - W // 2:t + W // 2 + 1][:, subset]
        np.testing.assert_allclose(clean[b, :, :, 2].numpy(), win[..., 2])


def test_window_ops_match_jax():
    win, _ = _preprocessed(np.random.default_rng(5), 7, W)
    for root in (0, 8, 24):
        got = windows.root_normalize_windows(torch.from_numpy(win), root)
        want = jax_windows.root_normalize_windows(jnp.asarray(win), root)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_metrics_match_jax():
    rng = np.random.default_rng(6)
    pred = rng.uniform(size=(50, 4)) > 0.4
    lab = rng.uniform(size=(50, 4)) > 0.6
    got = metrics.confusion_counts(torch.from_numpy(pred), torch.from_numpy(lab))
    want = jax_metrics.confusion_counts(jnp.asarray(pred), jnp.asarray(lab))
    assert [int(v) for v in got] == [int(v) for v in want]
    assert [int(v) for v in got + got] == [2 * int(v) for v in want]
    cases = [tuple(int(v) for v in want), (0, 0, 0, 0), (0, 0, 5, 7), (3, 0, 0, 0), (0, 4, 0, 9)]
    for c in cases:
        g = metrics.metrics_from_confusion(metrics.Confusion(*map(torch.tensor, c)))
        w = jax_metrics.metrics_from_confusion(jax_metrics.Confusion(*c))
        for k in ("accuracy", "precision", "recall", "f1"):
            assert g[k].dtype == torch.float32
            assert float(g[k]) == float(w[k]), (c, k)
        assert metrics.format_metrics(g) == jax_metrics.format_metrics(w)
