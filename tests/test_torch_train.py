"""chd_tpu_torch.contact.train, the training forward of models.contact_mlp,
the npz writer and utils.checkpoint against chd_tpu on the same numpy
weights, windows and dropout masks.

chd_tpu draws its dropout mask as ``jax.random.bernoulli(k_drop, 0.7,
(B, 128))`` inside ``contact_mlp.apply``; the tests draw the same mask from
the same key and hand it to the port. Tolerances: loss, logits and
gradients rtol 1e-4, atol 1e-5 (float32 sums in different orders; train-mode
BN divides by each batch's standard deviation, which scales their rounding
up: 1.8e-6 measured on logits of order 1); Adam updates on identical
gradients atol 1e-7.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chd_tpu.contact import data as jax_data
from chd_tpu.contact import train as jax_train
from chd_tpu.models import torch_convert as jax_convert
from chd_tpu_torch.contact import synth, train
from chd_tpu_torch.contact.evaluate import evaluate_full_video
from chd_tpu_torch.models import contact_mlp, torch_convert
from chd_tpu_torch.utils import checkpoint
from test_torch_contact_mlp import random_params

W, J, P = 9, 13, 5
TOL = dict(rtol=1e-4, atol=1e-5)
KEEP = 1.0 - contact_mlp.DROPOUT_RATE


def _jnp(tree):
    return {k: {leaf: jnp.asarray(v) for leaf, v in d.items()} for k, d in tree.items()}


def _batch(B, seed=1):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, W, J, 3)).astype(np.float32)
    labels = (rng.uniform(size=(B, P, 4)) > 0.5).astype(np.float32)
    return feats, labels


def _module_pairs(model):
    """(chd_tpu scope, leaf, port tensor) for every parameter and BN statistic."""
    for i, lin in enumerate(model.linears()):
        yield "params", f"linear{i}", "w", lin.weight
        yield "params", f"linear{i}", "b", lin.bias
    for i, bn in enumerate(model.batchnorms()):
        yield "params", f"bn{i}", "scale", bn.weight
        yield "params", f"bn{i}", "bias", bn.bias
        yield "state", f"bn{i}", "mean", bn.running_mean
        yield "state", f"bn{i}", "var", bn.running_var


@pytest.mark.parametrize("B", [16, 1])  # 1: an epoch's ragged tail of one sequence
def test_train_forward_loss_grads_and_bn_stats_match_jax(B):
    params, state = random_params(np.random.default_rng(0))
    feats, labels = _batch(B)
    k_drop = jax.random.PRNGKey(2)
    mask = np.array(jax.random.bernoulli(k_drop, KEEP, (B, 128)))
    (loss_w, (state_w, logits_w)), grads_w = jax.value_and_grad(
        jax_train.loss_and_logits, has_aux=True)(
        _jnp(params), _jnp(state), jnp.asarray(feats), jnp.asarray(labels), k_drop, P)

    model = torch_convert.from_jax_params(params, state).train()
    loss, logits = train.loss_and_logits(model, torch.from_numpy(feats), torch.from_numpy(labels),
                                         P, dropout_mask=torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_w), rtol=1e-5)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_w), **TOL)
    for scope, mod, leaf, t in _module_pairs(model):
        if scope == "params":
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(grads_w[mod][leaf]), **TOL,
                                       err_msg=f"grad {mod}.{leaf}")
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(state_w[mod][leaf]), **TOL,
                                       err_msg=f"{mod}.{leaf}")
    assert all(int(bn.num_batches_tracked) == 1 for bn in model.batchnorms())
    assert set(model.state_dict()) == set(contact_mlp.ContactMLP(W * J * 3, 4 * P).state_dict())
    if B == 1:  # what the port replaces: torch's own train-mode BN refuses one row
        with pytest.raises(ValueError):
            torch.nn.BatchNorm1d(4).train()(torch.zeros(1, 4))


def test_train_mode_needs_a_mask_or_a_generator():
    model = contact_mlp.init(contact_mlp.ModelConfig(), torch.Generator().manual_seed(0)).train()
    x = torch.zeros((3, W * J * 3))
    with pytest.raises(ValueError, match="dropout_mask or a generator"):
        model(x)
    a = model(x, generator=torch.Generator().manual_seed(1))
    b = model(x, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)


def test_adam_matches_optax_on_jax_gradients():
    """Five steps of the port's Adam and of chd_tpu's make_optimizer, both
    fed chd_tpu's gradients at chd_tpu's parameters."""
    params, state = random_params(np.random.default_rng(3))
    cfg_w, cfg = jax_train.TrainConfig(), train.TrainConfig()
    tx = jax_train.make_optimizer(cfg_w)
    jp, js = _jnp(params), _jnp(state)
    opt_state = tx.init(jp)
    model = torch_convert.from_jax_params(params, state)
    opt = train.make_optimizer(model, cfg)
    assert len(opt.param_groups[0]["params"]) == 18  # 5 linears and 4 BNs, 2 each; no buffers
    grad_fn = jax.jit(jax.value_and_grad(jax_train.loss_and_logits, has_aux=True),
                      static_argnums=5)
    for step in range(5):
        feats, labels = _batch(16, seed=10 + step)
        (_, (js, _)), grads = grad_fn(jp, js, jnp.asarray(feats), jnp.asarray(labels),
                                      jax.random.PRNGKey(step), P)
        updates, opt_state = tx.update(grads, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for scope, mod, leaf, t in _module_pairs(model):
            if scope == "params":
                t.grad = torch.from_numpy(np.array(grads[mod][leaf]))
        opt.step()
    for scope, mod, leaf, t in _module_pairs(model):
        if scope == "params":
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp[mod][leaf]), rtol=0,
                                       atol=1e-7, err_msg=f"{mod}.{leaf}")


def test_train_step_matches_a_jax_step():
    """One whole step (window sampling wired to the model, forward, backward,
    L2, Adam, BN statistics, loss and the middle frame's confusion) on
    chd_tpu's sampled windows and mask. Adam's first step moves a parameter
    by lr * g / (|g| + eps), g the gradient plus the L2 term: where g is
    near 0 (the biases feeding a BN, and here the constant confidence
    inputs, have a zero gradient in exact arithmetic) float32 noise decides
    it, so elements with |g| < 1e-6 are held to 2 * lr, the rest to 1e-6."""
    params, state = random_params(np.random.default_rng(4))
    cfg_w, cfg = jax_train.TrainConfig(), train.TrainConfig()
    ds = synth.learnable_dataset(n_seq=16, frames=40)
    op, ct = (jnp.asarray(t.numpy()) for t in ds.split_arrays("train"))
    tx = jax_train.make_optimizer(cfg_w)
    rng = jax.random.PRNGKey(9)
    jp, js, _, loss_w, conf_w = jax_train.train_step(
        _jnp(params), _jnp(state), tx.init(_jnp(params)), op, ct, rng, cfg=cfg_w, tx=tx)

    k_win, k_drop = jax.random.split(rng)
    feats, labels = jax_data.sample_train_windows(k_win, op, ct, W, P, cfg.joint_subset,
                                                  cfg.noise_dev, cfg.use_confidence)
    _, grads = jax.value_and_grad(jax_train.loss_and_logits, has_aux=True)(
        _jnp(params), _jnp(state), feats, labels, k_drop, P)
    mask = np.array(jax.random.bernoulli(k_drop, KEEP, (op.shape[0], 128)))
    model = torch_convert.from_jax_params(params, state)
    opt = train.make_optimizer(model, cfg)
    loss, conf = train.train_step(
        model, opt, None, None, cfg, None,
        windows=(torch.from_numpy(np.array(feats)), torch.from_numpy(np.array(labels))),
        dropout_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(float(loss), float(loss_w), rtol=1e-5)
    assert [int(v) for v in conf] == [int(v) for v in conf_w]
    for scope, mod, leaf, t in _module_pairs(model):
        got = t.detach().numpy()
        if scope == "state":
            np.testing.assert_allclose(got, np.asarray(js[mod][leaf]), **TOL, err_msg=mod)
            continue
        g = np.asarray(grads[mod][leaf]) + cfg.weight_decay * params[mod][leaf]
        d = np.abs(got - np.asarray(jp[mod][leaf]))
        assert np.all(d <= np.where(np.abs(g) < 1e-6, 2 * cfg.lr, 1e-6)), f"{mod}.{leaf}"


def test_full_f32_is_scoped():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        with train.full_f32():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)


def test_npz_moves_both_ways(tmp_path):
    params, state = random_params(np.random.default_rng(5))
    model = torch_convert.from_jax_params(params, state)
    got_params, got_state = torch_convert.to_jax_params(model)
    port_npz, jax_npz = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    torch_convert.save_npz(port_npz, model)
    jax_convert.save_npz(jax_npz, params, state)
    assert sorted(np.load(port_npz).files) == sorted(np.load(jax_npz).files)
    for want, got in ((params, got_params), (state, got_state),
                      *zip((params, state), jax_convert.load_npz(port_npz))):
        assert want.keys() == got.keys()
        for mod in want:
            for leaf, v in want[mod].items():
                assert got[mod][leaf].dtype == np.float32
                np.testing.assert_array_equal(got[mod][leaf], v)
    back = torch_convert.load_npz(jax_npz).state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k


def test_checkpoint_round_trip_and_resume(tmp_path):
    """A run resumed from a checkpoint takes the same next step, bitwise, as
    the run that never stopped."""
    cfg = train.TrainConfig(batch_size=4)
    ds = synth.learnable_dataset(n_seq=16, frames=40)
    op, ct = ds.split_arrays("train")

    def fresh(seed):
        model = contact_mlp.init(cfg.model_config(), torch.Generator().manual_seed(seed))
        return model, train.make_optimizer(model, cfg), torch.Generator().manual_seed(seed)

    model, opt, gen = fresh(0)
    for s in range(3):
        train.train_step(model, opt, op[4 * s:4 * s + 4], ct[4 * s:4 * s + 4], cfg, gen)
    path = str(tmp_path / "state.pt")
    checkpoint.save_train_state(path, 3, model, opt, gen)
    loss_a, conf_a = train.train_step(model, opt, op[:4], ct[:4], cfg, gen)

    model2, opt2, gen2 = fresh(1)
    assert checkpoint.restore_train_state(checkpoint.load_train_state(path), model2, opt2,
                                          gen2) == 3
    loss_b, conf_b = train.train_step(model2, opt2, op[:4], ct[:4], cfg, gen2)
    assert torch.equal(loss_a, loss_b)
    assert [int(v) for v in conf_a] == [int(v) for v in conf_b]
    sd_a, sd_b = model.state_dict(), model2.state_dict()
    assert sd_a.keys() == sd_b.keys() and all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a)
    st_a, st_b = opt.state_dict()["state"], opt2.state_dict()["state"]
    for i in st_a:
        for k in st_a[i]:
            assert torch.equal(st_a[i][k], st_b[i][k])
    assert torch.equal(gen.get_state(), gen2.get_state())
    assert checkpoint.load_train_state(str(tmp_path / "missing.pt")) is None


def test_train_takes_a_tail_batch_of_one(tmp_path):
    """18 training sequences in batches of 17 leave a batch of one each
    epoch; train() runs it and writes the three weight files."""
    ds = synth.learnable_dataset(n_seq=22, frames=30)
    cfg = train.TrainConfig(epochs=3, batch_size=17, val_every=1)
    model, hist = train.train(ds, cfg, out_dir=str(tmp_path), log_every=1, verbose=False)
    assert not model.training
    assert len(hist["train_loss"]) == 3 and len(hist["val_f1"]) == 3
    assert all(np.isfinite(hist["train_loss"])) and len(hist["val_metrics"][0]) == P
    assert all(int(bn.num_batches_tracked) == 6 for bn in model.batchnorms())
    for name in ("contact_weights.npz", "contact_weights_BEST.npz", "contact_weights_FINAL.npz"):
        params, _ = jax_convert.load_npz(str(tmp_path / name))
        assert params["linear0"]["w"].shape == (1024, W * J * 3)


def test_training_learns_contacts():
    """The port of tests/test_train_learns.py (no JAX): on a dataset whose
    contacts are a simple function of the pose, merged full-video F1 and
    accuracy pass 0.8."""
    ds = synth.learnable_dataset()
    cfg = train.TrainConfig(epochs=150, batch_size=16, val_every=50, lr=3e-4)
    model, _ = train.train(ds, cfg, verbose=False)
    res = evaluate_full_video(model, ds, split="test", cfg=cfg)
    f1, acc = res["merged"]["f1"], res["merged"]["accuracy"]
    assert f1 > 0.8 and acc > 0.8, (f1, acc)


def test_train_state_dict_round_trips_through_copy():
    """BN buffers update in place under training; a deepcopy of the module
    taken before a step keeps the old statistics."""
    model = contact_mlp.init(contact_mlp.ModelConfig(), torch.Generator().manual_seed(0))
    before = copy.deepcopy(model)
    feats, labels = _batch(8)
    train.loss_and_logits(model.train(), torch.from_numpy(feats), torch.from_numpy(labels), P,
                          generator=torch.Generator().manual_seed(0))
    assert not torch.equal(before.batchnorms()[0].running_mean, model.batchnorms()[0].running_mean)
