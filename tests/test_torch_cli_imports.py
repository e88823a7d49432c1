"""The port imports no JAX, and its CLI writes what chd_tpu's detector
computes: equal contacts on every frame whose label survives a ±1e-3 move of
the 0.5 threshold (float32 sums run in different orders)."""
import json
import os
import pkgutil
import subprocess
import sys

import jax
import numpy as np
import torch

import chd_tpu_torch
from chd_tpu.contact import infer as jax_infer
from chd_tpu.models import contact_mlp as jax_mlp
from chd_tpu.models import torch_convert as jax_convert
from chd_tpu_torch.contact import infer
from chd_tpu_torch.models import torch_convert
from chd_tpu_torch.pipeline import cli
from test_torch_contact_infer import _stable

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    """Every module of the port loads without jax or optax."""
    modules = sorted(m.name for m in pkgutil.walk_packages(chd_tpu_torch.__path__, "chd_tpu_torch.")
                     if not m.name.endswith(".__main__"))
    assert "chd_tpu_torch.contact.train" in modules and "chd_tpu_torch.utils.checkpoint" in modules
    code = (f"import sys; import {', '.join(modules)}; print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'optax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_cli_detect_contacts_matches_jax(tmp_path):
    rng = np.random.default_rng(7)
    data = tmp_path / "data"
    videos = {}
    for name, F in (("vidA", 50), ("vidB", 37)):
        kp = np.empty((F, 25, 3))
        kp[..., 0] = rng.uniform(300, 1600, size=(F, 25))
        kp[..., 1] = rng.uniform(100, 1000, size=(F, 25))
        kp[..., 2] = rng.uniform(0.3, 1.0, size=(F, 25))
        kp[rng.uniform(size=(F, 25)) < 0.08, 2] = 0.05
        opd = data / name / "openpose_result"
        opd.mkdir(parents=True)
        for t in range(F):
            doc = {"people": [{"pose_keypoints_2d": kp[t].reshape(-1).tolist()}]}
            (opd / f"{name}_{t:06d}_keypoints.json").write_text(json.dumps(doc))
        videos[name] = kp

    params, state = jax_mlp.init(jax.random.PRNGKey(3), jax_mlp.ModelConfig())
    weights = str(tmp_path / "w.npz")
    jax_convert.save_npz(weights, params, state)
    params, state = jax_convert.load_npz(weights)

    assert cli.main(["detect-contacts", "--data", str(data), "--weights", weights,
                     "--device", "cpu"]) == 0
    dirs = [str(data / name) for name in sorted(videos)]
    want = jax_infer.detect_contacts(dirs, params, state, image_dims=(1920, 1080),
                                     save=False)
    kps = [videos[name] * np.array([1280 / 1920, 1280 / 1920, 1.0]) for name in sorted(videos)]
    batch, _ = infer.pad_to_length(kps)
    det = infer.ContactDetector(torch_convert.load_npz(weights), device="cpu")
    stable = _stable(det.infer(torch.from_numpy(batch))[1])
    assert stable.mean() > 0.95
    for d, w, m in zip(dirs, want, stable):
        got = np.load(os.path.join(d, "foot_contacts.npy"))
        assert got.shape == (videos[os.path.basename(d)].shape[0], 4)
        m = m[:got.shape[0]]
        np.testing.assert_array_equal(np.where(m, got, 0), np.where(m, np.asarray(w), 0))
