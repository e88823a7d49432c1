"""chd_tpu_torch.models (ContactMLP, BN folding, weight loading) against
chd_tpu.models on the same weights and inputs.

Weights and inputs are made with numpy from a seed and handed to both
packages as float32. Tolerances: both sides sum in float32 in different
orders, so logits of magnitude ~1 agree to ~1e-6; 1e-5 leaves room.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chd_tpu.models import contact_mlp as jax_mlp
from chd_tpu.models import torch_convert as jax_convert
from chd_tpu_torch.models import contact_mlp, torch_convert

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
W, J, P, C = 9, 13, 5, 3
IN_DIM = W * J * C


def random_params(rng, in_dim=IN_DIM, out_dim=4 * P):
    """chd_tpu (params, state) pytrees of float32 numpy arrays, with
    non-trivial BatchNorm affine parameters and running statistics."""
    dims = [in_dim, *contact_mlp.HIDDEN, out_dim]
    params, state = {}, {}
    for i in range(len(dims) - 1):
        a = np.sqrt(6.0 / (dims[i] + dims[i + 1]))
        n = dims[i + 1]
        params[f"linear{i}"] = {
            "w": rng.uniform(-a, a, (n, dims[i])).astype(np.float32),
            "b": rng.normal(0, 0.05, n).astype(np.float32),
        }
        if i < len(contact_mlp.HIDDEN):
            params[f"bn{i}"] = {
                "scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
                "bias": rng.normal(0, 0.1, n).astype(np.float32),
            }
            state[f"bn{i}"] = {
                "mean": rng.normal(0, 0.1, n).astype(np.float32),
                "var": rng.uniform(0.5, 2.0, n).astype(np.float32),
            }
    return params, state


def golden_state_dict():
    data = np.load(os.path.join(FIXTURES, "contact_golden.npz"))
    return {k[3:]: data[k] for k in data.files if k.startswith("sd.")}


@pytest.fixture(scope="module")
def weights():
    params, state = random_params(np.random.default_rng(0))
    return params, state, torch_convert.from_jax_params(params, state)


def _jnp_tree(tree):
    return {k: {leaf: jnp.asarray(v) for leaf, v in d.items()} for k, d in tree.items()}


def test_state_dict_keys_are_the_reference_indices():
    model = contact_mlp.ContactMLP(IN_DIM, 4 * P)
    prefixes = sorted({k.rsplit(".", 1)[0] for k in model.state_dict()},
                      key=lambda s: int(s.split(".")[1]))
    assert prefixes == [f"model.{i}" for i in (0, 1, 3, 4, 6, 7, 10, 11, 13)]
    assert isinstance(model.model[9], torch.nn.Dropout)


def test_eval_forward_matches_jax_apply(weights):
    params, state, model = weights
    x = np.random.default_rng(1).normal(size=(17, W, J, C)).astype(np.float32)
    ref, _ = jax_mlp.apply(_jnp_tree(params), _jnp_tree(state), jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_fold_batchnorm_and_folded_forward_match_jax(weights):
    params, state, model = weights
    jf = jax_mlp.fold_batchnorm(_jnp_tree(params), _jnp_tree(state))
    tf = contact_mlp.fold_batchnorm(model)
    for key in ("w", "b"):
        assert len(tf[key]) == len(jf[key]) == 5
        for got, want in zip(tf[key], jf[key]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)

    x = np.random.default_rng(2).normal(size=(8, W, J, C)).astype(np.float32)
    want = np.asarray(jax_mlp.apply_folded(jf, jnp.asarray(x), P))
    got = contact_mlp.apply_folded(tf, torch.from_numpy(x), P).numpy()
    assert got.shape == (8, P, 4)
    np.testing.assert_allclose(1 / (1 + np.exp(-got)), 1 / (1 + np.exp(-want)), atol=1e-5)

    h = np.random.default_rng(3).uniform(0, 1, size=(8, 1024)).astype(np.float32)
    want = np.asarray(jax_mlp.apply_folded_tail(jf, jnp.asarray(h), P))
    got = contact_mlp.apply_folded_tail(tf, torch.from_numpy(h), P).numpy()
    np.testing.assert_allclose(1 / (1 + np.exp(-got)), 1 / (1 + np.exp(-want)), atol=1e-5)

    # eval-mode module and folded chain are the same function
    with torch.no_grad():
        ref = model(torch.from_numpy(x)).numpy().reshape(8, P, 4)
    np.testing.assert_allclose(contact_mlp.apply_folded(tf, torch.from_numpy(x), P).numpy(),
                               ref, atol=1e-5)


def test_bce_with_logits_matches_jax_and_torch():
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(6, P, 4)) * 5).astype(np.float32)
    labels = (rng.uniform(size=(6, P, 4)) > 0.5).astype(np.float32)
    got = contact_mlp.bce_with_logits(torch.from_numpy(logits), torch.from_numpy(labels))
    want = jax_mlp.bce_with_logits(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    ref = torch.nn.BCEWithLogitsLoss(reduction="none")(
        torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6)


def test_init_is_seeded_xavier_uniform():
    cfg = contact_mlp.ModelConfig()
    a = contact_mlp.init(cfg, torch.Generator().manual_seed(5))
    b = contact_mlp.init(cfg, torch.Generator().manual_seed(5))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    for lin in a.linears():
        fan_out, fan_in = lin.weight.shape
        bound = np.sqrt(6.0 / (fan_in + fan_out))
        top = float(lin.weight.detach().abs().max())
        assert 0.9 * bound < top <= bound
        assert torch.all(lin.bias == 0.01)
    assert a.linears()[0].in_features == cfg.in_dim == IN_DIM
    assert a.linears()[-1].out_features == cfg.out_dim == 4 * P


def test_golden_weights_load_every_way_alike(tmp_path):
    """The golden ``sd.*`` reach the same module through a state_dict, a
    ``.pth``, chd_tpu's pytrees and chd_tpu's ``.npz``."""
    sd = golden_state_dict()
    direct = torch_convert.from_state_dict(sd)

    pth = str(tmp_path / "w.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
    params, state = jax_convert.from_state_dict(sd)
    jax_npz = str(tmp_path / "jax.npz")
    jax_convert.save_npz(jax_npz, params, state)

    want = direct.state_dict()
    for other in (torch_convert.load_pth(pth),
                  torch_convert.from_jax_params(params, state),
                  torch_convert.load_npz(jax_npz)):
        got = other.state_dict()
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
    for k, v in sd.items():
        np.testing.assert_array_equal(want[k].numpy(), v)
