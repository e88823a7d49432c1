"""chd_tpu_torch.contact.train.eval_step, contact.evaluate and the
train-contacts / eval-contacts commands against chd_tpu on the tiny
synthetic Mixamo tree of tests/test_eval_ckpt.py and the same weights.

The port evaluates through the BN-folded MLP (the fused-MLP kernel's plain
version on the CPU) where chd_tpu's eval_step runs the unfolded eval
forward: float32 sums in other orders. Metrics must be equal, losses within
1e-5.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chd_tpu.characters.defs import OP_JOINT_SUBSETS
from chd_tpu.contact import evaluate as jax_evaluate
from chd_tpu.contact import train as jax_train
from chd_tpu.models import torch_convert as jax_convert
from chd_tpu_torch.contact import evaluate, train
from chd_tpu_torch.contact.data import ContactDataset
from chd_tpu_torch.models import torch_convert
from chd_tpu_torch.ops.fused_mlp import fused_mlp
from chd_tpu_torch.pipeline import cli
from test_eval_ckpt import make_dataset
from test_torch_contact_mlp import random_params

W, P = 9, 5


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    path = tmp_path_factory.mktemp("tree")
    want = make_dataset(path, np.random.default_rng(0))
    return str(path / "synth"), want, ContactDataset.load(str(path / "synth"))


def _weights(joint_set, seed=0):
    n = len(OP_JOINT_SUBSETS[joint_set])
    params, state = random_params(np.random.default_rng(seed), in_dim=W * n * 3)
    return params, state, torch_convert.from_jax_params(params, state)


def _assert_same_results(got, want):
    np.testing.assert_allclose(got["loss"], want["loss"], atol=1e-5)
    assert got["per_frame"] == want["per_frame"]
    if "merged" in want:
        assert got["merged"] == want["merged"]
        np.testing.assert_array_equal(got["merged_predictions"], want["merged_predictions"])


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("joint_set", ["lower", "lower_ankles"])
def test_eval_step_matches_jax(tree, overlap, joint_set):
    _, ds_w, ds = tree
    params, state, model = _weights(joint_set)
    op, ct = ds_w.split_arrays("train")
    loss_w, confs_w = jax_train.eval_step(params, state, jnp.asarray(op), jnp.asarray(ct),
                                          cfg=jax_train.TrainConfig(joint_set=joint_set),
                                          overlap=overlap)
    launches = fused_mlp.launches
    loss, confs = train.eval_step(model, *ds.split_arrays("train"),
                                  train.TrainConfig(joint_set=joint_set), overlap=overlap)
    assert fused_mlp.launches == launches  # the CPU runs the plain version
    assert confs.shape == (P, 4)
    np.testing.assert_array_equal(confs.numpy(), np.asarray(confs_w))
    np.testing.assert_allclose(float(loss), float(loss_w), atol=1e-5)


@pytest.mark.parametrize("joint_set", ["lower", "upper"])
def test_evaluate_windows_and_full_video_match_jax(tree, joint_set):
    _, ds_w, ds = tree
    params, state, model = _weights(joint_set, seed=1)
    cfg_w, cfg = jax_train.TrainConfig(joint_set=joint_set), train.TrainConfig(joint_set=joint_set)
    for split in ("val", "train"):  # this tree's test split is empty
        _assert_same_results(evaluate.evaluate_windows(model, ds, split, cfg),
                             jax_evaluate.evaluate_windows(params, state, ds_w, split, cfg_w))
        got = evaluate.evaluate_full_video(model, ds, split, cfg)
        want = jax_evaluate.evaluate_full_video(params, state, ds_w, split, cfg_w)
        assert got["merged_predictions"].shape == (len(ds.splits[split]), 30, 4)
        _assert_same_results(got, want)


def test_cli_train_and_eval_contacts(tree, tmp_path):
    """train-contacts writes chd_tpu's three weight files, which chd_tpu
    reads; eval-contacts writes eval_results.json and the merged
    predictions, equal to chd_tpu's evaluation of the same weights."""
    root, ds_w, _ = tree
    out = tmp_path / "run"
    assert cli.main(["train-contacts", "--data", root, "--out", str(out), "--epochs", "2",
                     "--batch-size", "4", "--device", "cpu"]) == 0
    for name in ("contact_weights.npz", "contact_weights_BEST.npz", "contact_weights_FINAL.npz"):
        params, state = jax_convert.load_npz(str(out / name))
        assert params["linear0"]["w"].shape == (1024, W * 13 * 3)
    weights = str(out / "contact_weights_FINAL.npz")
    ev = tmp_path / "eval"
    assert cli.main(["eval-contacts", "--data", root, "--weights", weights, "--out", str(ev),
                     "--split", "val", "--full-video", "--device", "cpu"]) == 0
    with open(ev / "eval_results.json") as f:
        got = json.load(f)
    got["merged_predictions"] = np.load(ev / "merged_predictions.npy")
    params, state = jax_convert.load_npz(weights)
    _assert_same_results(got, jax_evaluate.evaluate_full_video(params, state, ds_w, "val",
                                                               jax_train.TrainConfig()))

    assert cli.main(["eval-contacts", "--data", root, "--weights", weights, "--out",
                     str(tmp_path / "win"), "--split", "train", "--device", "cpu"]) == 0
    with open(tmp_path / "win" / "eval_results.json") as f:
        res = json.load(f)
    assert set(res) == {"loss", "per_frame"} and len(res["per_frame"]) == P
    assert not os.path.exists(tmp_path / "win" / "merged_predictions.npy")


def test_cli_cuda_device_raises_without_cuda(tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["train-contacts", "--data", tree[0], "--out", str(tmp_path), "--epochs", "1"])
