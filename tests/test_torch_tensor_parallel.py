"""Tensor parallelism of the contact MLP (chd_tpu_torch.parallel.tensor and
mesh.contact_model_shardings / named) against chd_tpu (parallel/mesh.py and
its dp x tp training step, contact/train.py).

Four forms of a ("data", "model") mesh with "model" 2: gloo groups of 2
(data 1) and 4 (data 2) spawned ranks (one module-scoped spawn each, every
check in the ranks) and the single-process forms of 2 and 4 shards:
- ``contact_model_shardings`` equals chd_tpu's specs on its virtual meshes
  of (data, model) = (4, 2), (2, 2) and (1, 2), and ``named`` places each
  leaf on the axis its spec names;
- a model sharded and gathered back is bitwise the original, and its
  folded layers are bitwise the gathered model's, for ``lower`` (351 wide)
  and ``full`` (675 wide); each shard is its slice of the whole;
- the adjoints of ``Mesh.gather_model`` (a reduce-scatter) and
  ``Mesh.sum_model`` (the identity, the loss being the same on every
  "model" rank) by dot-product identities, float64, within 1e-12 relative;
- 3 training steps of the sharded model on the global batch's windows and
  dropout masks, against the port's unsharded steps and against chd_tpu's
  ``train_step`` with its params, BN state and Adam moments placed by its
  own ``contact_model_shardings`` on ``make_mesh(n_devices=4, model=2)`` of
  the 8 virtual CPU devices, within chip_smoke.py [9]'s bounds as
  tests/test_torch_distributed.py applies them. [9]'s batch of 64
  learnable sequences, the port's initial weights of seed 3, lr 3e-4: Adam's
  first steps move a parameter by ~lr whatever its gradient, and at a batch
  of 8 the sign flips of gradients near 0 carry the third step's gradients
  past [9]'s gradient bound, where [9]'s batch keeps them inside it. Every
  rank holds the same weights, and linear4's replicated bias the same
  gradient and Adam moments on every "model" rank;
- ``eval_step`` of the sharded model (its gathered folded layers through the
  plain MLP on this CPU) equals the unsharded one: loss within 1e-6,
  confusion counts equal;
- ``train`` refuses a "model" axis over 1, as chd_tpu's ``train`` has no
  tensor-parallel form, and the weights carry across both ways
  (``torch_convert.from_jax_params`` then ``shard_contact_model``;
  ``gather_contact_model`` then ``to_jax_params``).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding

from chd_tpu.contact import data as jax_data
from chd_tpu.contact import train as jax_train
from chd_tpu.parallel import mesh as jax_mesh
from chd_tpu_torch.contact import synth, train
from chd_tpu_torch.models import contact_mlp, torch_convert
from chd_tpu_torch.parallel import mesh as mesh_lib
from chd_tpu_torch.parallel import tensor
from chd_tpu_torch.parallel.dryrun import run_ranks
from chip_smoke import G_MIN

import torch_rank_workers as workers
from test_torch_distributed import _one_rank_steps, _within_phase9_bounds

B, STEPS, LR = 64, 3, 3e-4
FORMS = {"gloo2": 2, "gloo4": 4, "local2": 2, "local4": 4}  # ranks or shards; model 2
KEEP = 1.0 - contact_mlp.DROPOUT_RATE
RANK_TIMEOUT = 300.0


def _placed(mesh, tree, specs):
    return jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), tree, specs,
                        is_leaf=lambda x: isinstance(x, (jnp.ndarray, np.ndarray)))


@pytest.fixture(scope="module")
def jax_ref():
    """chd_tpu's 3 dp x tp steps on B learnable sequences (data 2 x model 2:
    params, state and Adam moments placed by its contact_model_shardings,
    the batch over "data"), the windows and dropout masks its step draws
    (from the same keys, unsharded), its last step's gradients and each
    parameter's smallest |gradient + L2|; the initial state dicts of
    ``lower`` and ``full``; and a held-out split."""
    cfg_t = train.TrainConfig(lr=LR)
    initial = contact_mlp.init(cfg_t.model_config(), torch.Generator().manual_seed(3))
    full = contact_mlp.init(train.TrainConfig(joint_set="full").model_config(),
                            torch.Generator().manual_seed(4))
    params, state = torch_convert.to_jax_params(initial)
    cfg = jax_train.TrainConfig(lr=LR)
    tx = jax_train.make_optimizer(cfg)
    ds = synth.learnable_dataset(n_seq=B + 20, frames=40, n_holdout=16, device="cpu")
    op_np, ct_np = (t.numpy()[:B] for t in ds.split_arrays("train"))
    op, ct = jnp.asarray(op_np), jnp.asarray(ct_np)
    mesh = jax_mesh.make_mesh(n_devices=4, model=2)
    p_specs, s_specs = jax_mesh.contact_model_shardings(mesh)
    p, s = _placed(mesh, params, p_specs), _placed(mesh, state, s_specs)
    o = tx.init(p)  # the moments inherit the parameters' shardings
    op_s, ct_s = (jax_mesh.shard_batch(mesh, a) for a in (op, ct))
    grad_fn = jax.jit(jax.value_and_grad(jax_train.loss_and_logits, has_aux=True),
                      static_argnums=5)
    steps, g_min = [], None
    for step in range(STEPS):
        rng = jax.random.PRNGKey(20 + step)
        k_win, k_drop = jax.random.split(rng)
        feats, labels = jax_data.sample_train_windows(
            k_win, op, ct, cfg.window_size, cfg.pred_size, tuple(cfg_t.joint_subset),
            cfg.noise_dev, cfg.use_confidence)
        mask = np.array(jax.random.bernoulli(k_drop, KEEP, (B, contact_mlp.HIDDEN[2])))
        steps.append((np.array(feats), np.array(labels), mask))
        _, grads = grad_fn(p, s, feats, labels, k_drop, cfg.pred_size)
        g_l2 = jax.tree.map(lambda g, w: np.abs(np.asarray(g) + cfg.weight_decay
                                                * np.asarray(w)), grads, p)
        g_min = g_l2 if g_min is None else jax.tree.map(np.minimum, g_min, g_l2)
        p, s, o, _, _ = jax_train.train_step(p, s, o, op_s, ct_s, rng, cfg=cfg, tx=tx)
    for mod in ("linear0", "linear4"):  # the step kept chd_tpu's placement
        assert p[mod]["w"].sharding.is_equivalent_to(NamedSharding(mesh, p_specs[mod]["w"]), 2)
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    model = torch_convert.from_jax_params(as_np(p), as_np(s))
    gmodel = torch_convert.from_jax_params(as_np(grads), as_np(s))
    fmodel = torch_convert.from_jax_params(g_min, as_np(s))
    ref = dict(
        steps=steps,
        params={k: v.detach().numpy() for k, v in model.named_parameters()},
        buffers={k: v.numpy() for k, v in model.named_buffers() if "num_batches" not in k},
        grads={k: v.detach().numpy() for k, v in gmodel.named_parameters()},
        firm={k: v.detach().numpy() >= G_MIN for k, v in fmodel.named_parameters()})
    models = {name: {k: v.numpy() for k, v in m.state_dict().items()}
              for name, m in (("lower", initial), ("full", full))}
    val = tuple(t.numpy() for t in ds.split_arrays("val"))
    return ref, models, val


@pytest.fixture(scope="module")
def runs(jax_ref, tmp_path_factory):
    ref, models, val = jax_ref
    args = (models, ref["steps"], train.TrainConfig(lr=LR), val)
    out = {}
    for form, n in FORMS.items():
        if form.startswith("gloo"):
            out[form] = run_ranks(workers.tensor_parallel_checks, n, "cpu", args=(n, *args),
                                  timeout=RANK_TIMEOUT,
                                  workdir=str(tmp_path_factory.mktemp(form)))
        else:
            out[form] = [workers.tensor_parallel_checks(n, *args)]
    return out


@pytest.mark.parametrize("data, model", [(4, 2), (2, 2), (1, 2)])
def test_shardings_match_chd_tpu(data, model):
    want = jax_mesh.contact_model_shardings(jax_mesh.make_mesh(n_devices=data * model,
                                                               model=model))
    mesh = mesh_lib.local_mesh(data * model, model=model, device="cpu")
    got = mesh_lib.contact_model_shardings(mesh)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for mod in w:
            assert g[mod].keys() == w[mod].keys()
            for leaf, spec in w[mod].items():
                assert g[mod][leaf] == tuple(spec), (mod, leaf)
                placement = mesh_lib.named(mesh, g[mod])[leaf]
                split = [i for i, name in enumerate(spec) if name == "model"]
                assert placement.axis == (split[0] if split else None), (mod, leaf)


def test_named_refuses_other_axes():
    mesh = mesh_lib.local_mesh(4, model=2, device="cpu")
    for spec in (("data",), ("model", "model")):
        with pytest.raises(ValueError, match="one axis over 'model'"):
            mesh_lib.named(mesh, {"w": spec})


@pytest.mark.parametrize("form", FORMS)
def test_shard_then_gather_is_bitwise(runs, jax_ref, form):
    _, models, _ = jax_ref
    ranks = runs[form]
    for out in ranks:
        assert out["shape"] == {"data": FORMS[form] // 2, "model": 2}
        for name, sd in models.items():
            assert out["bitwise"][name] == dict(gather=True, fold=True), name
            shards = out["shards"][name]
            for k, part in zip(out["model_shards"], shards["linear0.w"]):
                np.testing.assert_array_equal(part, np.split(sd["model.0.weight"], 2)[k])
            for k, part in zip(out["model_shards"], shards["linear4.w"]):
                np.testing.assert_array_equal(part, np.split(sd["model.13.weight"], 2, 1)[k])
            for k, part in zip(out["model_shards"], shards["bn3.var"]):
                np.testing.assert_array_equal(part, np.split(sd["model.11.running_var"], 2)[k])
            np.testing.assert_array_equal(shards["linear4.b"][0], sd["model.13.bias"])
    held = sorted(k for out in ranks for k in out["model_shards"])
    assert held == sorted([0, 1] * max(1, len(ranks) // 2))


@pytest.mark.parametrize("form", FORMS)
def test_collective_adjoints(runs, form):
    for out in runs[form]:
        for name, (lhs, rhs) in out["adjoint"].items():
            assert abs(lhs - rhs) <= 1e-12 * abs(lhs), (name, lhs, rhs)


@pytest.mark.parametrize("form", FORMS)
def test_steps_match_unsharded_and_chd_tpu(runs, jax_ref, form):
    ref, models, _ = jax_ref
    ranks = runs[form]
    one = _one_rank_steps(ref["steps"], models["lower"])
    for out in ranks:
        _within_phase9_bounds(out, one, ref["firm"], LR)
        _within_phase9_bounds(out, ref, ref["firm"], LR)
        for k, v in out["params"].items():
            assert np.array_equal(v, ranks[0]["params"][k]), k
        for k, v in out["bias4"].items():
            assert np.array_equal(v, ranks[0]["bias4"][k]), k
        assert np.isfinite(out["losses"]).all()


@pytest.mark.parametrize("form", FORMS)
def test_eval_step_matches_unsharded(runs, form):
    for out in runs[form]:
        (loss, confs), (loss_one, confs_one) = out["eval"]
        assert abs(float(loss) - float(loss_one)) <= 1e-6
        np.testing.assert_array_equal(confs, confs_one)


def test_train_refuses_a_model_axis():
    ds = synth.learnable_dataset(24, 40, seed=0, n_holdout=4, device="cpu")
    mesh = mesh_lib.local_mesh(4, model=2, device="cpu")
    with pytest.raises(ValueError, match="data-parallel only"):
        train.train(ds, train.TrainConfig(epochs=1, batch_size=8), verbose=False, mesh=mesh)
    cfg = train.TrainConfig()
    tp = tensor.shard_contact_model(
        contact_mlp.init(cfg.model_config(), torch.Generator().manual_seed(0)), mesh)
    opt = train.make_optimizer(tp, cfg)
    feats = torch.zeros((8, cfg.model_config().in_dim))
    labels = torch.zeros((8, cfg.pred_size, 4))
    with pytest.raises(ValueError, match="the mesh it is sharded over"):
        train.train_step(tp, opt, None, None, cfg, torch.Generator().manual_seed(0),
                         windows=(feats, labels))
    with pytest.raises(ValueError, match="does not divide the hidden widths"):
        tensor.shard_contact_model(contact_mlp.init(cfg.model_config(),
                                                    torch.Generator().manual_seed(0)),
                                   mesh_lib.local_mesh(3, model=3, device="cpu"))


def test_weights_carry_across_sharded(jax_ref):
    _, models, _ = jax_ref
    mesh = mesh_lib.local_mesh(4, model=2, device="cpu")
    whole = torch_convert.from_state_dict(models["full"])
    params, state = torch_convert.to_jax_params(whole)
    tp = tensor.shard_contact_model(torch_convert.from_jax_params(params, state), mesh)
    assert tp.mesh is mesh and len(tp.shards) == 2
    for (k, a), (_, b) in zip(tp.state_dict().items(),
                              tensor.shard_contact_model(whole, mesh).state_dict().items()):
        assert torch.equal(a, b), k
    back = torch_convert.to_jax_params(tensor.gather_contact_model(tp))
    for got, ref in zip(back, (params, state)):
        for mod in ref:
            for leaf in ref[mod]:
                np.testing.assert_array_equal(got[mod][leaf], ref[mod][leaf])
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(7, 675)), dtype=torch.float32)
    np.testing.assert_allclose(tp.eval()(x).detach(), whole.eval()(x).detach(), atol=1e-5)
