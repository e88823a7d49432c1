"""chd_tpu_torch.parallel.distributed and sync-BN data-parallel training,
against chd_tpu (parallel/distributed.py, contact/train.py).

- ``initialize`` without torchrun's environment does nothing and says so;
- the ("slice", "data", "model") layout and its errors against chd_tpu's
  ``make_global_mesh`` on its virtual 8-device mesh, without starting ranks;
- ``process_local_slice``'s ceil split for 1 and 3 processes against
  chd_tpu's;
- 3 data-parallel training steps (sync-BN, summed gradients, Adam) at 2
  gloo ranks over ("data", "model") and at 4 ranks over 2 slices, in
  chip_smoke.py [9]'s setting (a batch of 64 learnable sequences, the
  port's initial weights of seed 3, lr 3e-4), on the global batch's windows
  and dropout masks that chd_tpu's sharded ``train_step`` draws (one
  module-scoped spawn per group): the last step's
  gradients, the BN running statistics and the parameters against the
  port's 1-rank steps on the global batch and against chd_tpu's steps on
  its virtual mesh, within chip_smoke.py [9]'s bounds (gradients
  ``GRAD_MAX_D``, BN statistics ``BN_MAX_D``, parameters ``PARAM_MAX_D``
  where |gradient + L2| stayed >= ``G_MIN`` at every step, 3 x 2 lr on the
  others: Adam moves a parameter by ~lr whatever its gradient's size, so a
  gradient near 0 flips on a rounding); every rank holds the same weights.
  (At a batch of 8 those flips move the third step's gradients between one
  rank and two past [9]'s gradient bound: the bounds hold [9]'s batch.)
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from chd_tpu.contact import data as jax_data
from chd_tpu.contact import train as jax_train
from chd_tpu.parallel import distributed as jax_distributed
from chd_tpu.parallel import mesh as jax_mesh
from chd_tpu_torch.contact import synth, train
from chd_tpu_torch.models import contact_mlp, torch_convert
from chd_tpu_torch.parallel import distributed
from chd_tpu_torch.parallel import mesh as mesh_lib
from chd_tpu_torch.parallel.dryrun import run_ranks
from chip_smoke import BN_MAX_D, G_MIN, GRAD_MAX_D, PARAM_MAX_D

import torch_rank_workers as workers

B, STEPS, LR = 64, 3, 3e-4
GROUPS = {"2 ranks": (2, 1), "4 ranks, 2 slices": (4, 2)}  # (ranks, slices)
KEEP = 1.0 - contact_mlp.DROPOUT_RATE
ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def test_initialize_is_a_noop_without_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    assert distributed.initialize() is False
    assert distributed.initialize("cpu") is False
    assert not dist.is_initialized()
    assert distributed.process_local_slice(7) == slice(0, 7)
    assert distributed.default_slices() == 1


@pytest.mark.parametrize("model, n_slices", [(1, 1), (1, 2), (2, 2), (4, 1), (2, 4),
                                             (1, 3), (3, 2)])
def test_global_mesh_layout_matches_chd_tpu(model, n_slices):
    try:
        want = jax_distributed.make_global_mesh(model=model, n_slices=n_slices)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            distributed.global_grid(8, model, n_slices)
        assert str(got.value) == str(e)
        return
    got = distributed.global_grid(8, model, n_slices)
    np.testing.assert_array_equal(got, np.vectorize(lambda d: d.id)(want.devices))
    assert dict(want.shape) == dict(zip(("slice", "data", "model"), got.shape))
    assert distributed.batch_spec() == ("slice", "data")


@pytest.mark.parametrize("world", [1, 3])
def test_process_local_slice_matches_chd_tpu(world, monkeypatch):
    monkeypatch.setattr(jax, "process_count", lambda: world)
    for n in (0, 1, 2, 3, 5, 7, 9, 17):
        for rank in range(world):
            monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
            want = jax_distributed.process_local_slice(n)
            got = mesh_lib.ceil_slice(n, rank, world)
            assert list(range(n)[got]) == list(range(n)[want]), (n, rank)


@pytest.fixture(scope="module")
def jax_steps():
    """chd_tpu's 3 sharded steps on a batch of B learnable sequences, the
    windows and dropout masks its sharded ``train_step`` draws (from the
    same keys, unsharded: jax's draws do not depend on the sharding), its
    last step's gradients and each parameter's smallest |gradient + L2|."""
    initial = contact_mlp.init(train.TrainConfig().model_config(),
                               torch.Generator().manual_seed(3))
    params, state = torch_convert.to_jax_params(initial)
    cfg = jax_train.TrainConfig(lr=LR)
    tx = jax_train.make_optimizer(cfg)
    ds = synth.learnable_dataset(n_seq=B + 4, frames=40, device="cpu")
    op, ct = (jnp.asarray(t.numpy()[:B]) for t in ds.split_arrays("train"))
    out = {}
    for name, (n, n_slices) in GROUPS.items():
        if n_slices > 1:
            mesh = jax_distributed.make_global_mesh(model=1, n_slices=n_slices,
                                                    devices=jax.devices()[:n])
            op_s, ct_s = (jax_distributed.shard_global_batch(mesh, a) for a in (op, ct))
        else:
            mesh = jax_mesh.make_mesh(n_devices=n, model=1)
            op_s, ct_s = (jax_mesh.shard_batch(mesh, a) for a in (op, ct))
        p = jax.tree.map(jnp.asarray, params)
        s = jax.tree.map(jnp.asarray, state)
        o = tx.init(p)
        steps, g_min = [], None
        for step in range(STEPS):
            rng = jax.random.PRNGKey(20 + step)
            k_win, k_drop = jax.random.split(rng)
            feats, labels = jax_data.sample_train_windows(
                k_win, op, ct, cfg.window_size, cfg.pred_size,
                tuple(train.TrainConfig().joint_subset), cfg.noise_dev, cfg.use_confidence)
            mask = np.array(jax.random.bernoulli(k_drop, KEEP, (B, contact_mlp.HIDDEN[2])))
            steps.append((np.array(feats), np.array(labels), mask))
            _, grads = jax.value_and_grad(jax_train.loss_and_logits, has_aux=True)(
                p, s, feats, labels, k_drop, cfg.pred_size)
            g_l2 = jax.tree.map(lambda g, w: np.abs(np.asarray(g) + cfg.weight_decay
                                                    * np.asarray(w)), grads, p)
            g_min = g_l2 if g_min is None else jax.tree.map(np.minimum, g_min, g_l2)
            p, s, o, _, _ = jax_train.train_step(p, s, o, op_s, ct_s, rng, cfg=cfg, tx=tx)
        model = torch_convert.from_jax_params(jax.tree.map(np.asarray, p),
                                              jax.tree.map(np.asarray, s))
        gmodel = torch_convert.from_jax_params(jax.tree.map(np.asarray, grads),
                                               jax.tree.map(np.asarray, s))
        fmodel = torch_convert.from_jax_params(g_min, jax.tree.map(np.asarray, s))
        out[name] = dict(
            steps=steps,
            params={k: v.detach().numpy() for k, v in model.named_parameters()},
            buffers={k: v.numpy() for k, v in model.named_buffers()
                     if "num_batches" not in k},
            grads={k: v.detach().numpy() for k, v in gmodel.named_parameters()},
            firm={k: v.detach().numpy() >= G_MIN for k, v in fmodel.named_parameters()})
    return out, {k: v.numpy() for k, v in initial.state_dict().items()}


@pytest.fixture(scope="module")
def rank_steps(jax_steps, tmp_path_factory):
    refs, sd = jax_steps
    out = {}
    for name, (n, n_slices) in GROUPS.items():
        out[name] = run_ranks(workers.sync_bn_steps, n, "cpu",
                              args=(refs[name]["steps"], sd, train.TrainConfig(lr=LR), n_slices),
                              timeout=300.0, workdir=str(tmp_path_factory.mktemp("steps")))
    return out


def _one_rank_steps(steps, sd):
    model = torch_convert.from_state_dict(sd)
    cfg = train.TrainConfig(lr=LR)
    opt = train.make_optimizer(model, cfg)
    for feats, labels, mask in steps:
        train.train_step(model, opt, None, None, cfg, None,
                         windows=(torch.from_numpy(feats), torch.from_numpy(labels)),
                         dropout_mask=torch.from_numpy(mask))
    return dict(grads={k: p.grad.numpy() for k, p in model.named_parameters()},
                params={k: p.detach().numpy() for k, p in model.named_parameters()},
                buffers={k: b.numpy() for k, b in model.named_buffers()})


def _within_phase9_bounds(got, want, firm, lr):
    for k, g in want["grads"].items():
        assert np.abs(got["grads"][k] - g).max() <= GRAD_MAX_D, k
    for k, v in want["buffers"].items():
        if "num_batches" not in k:
            assert np.abs(got["buffers"][k] - v).max() <= BN_MAX_D, k
    for k, v in want["params"].items():
        d = np.abs(got["params"][k] - v)
        assert np.all(d <= np.where(firm[k], PARAM_MAX_D, 3 * 2 * lr)), k


@pytest.mark.parametrize("group", GROUPS)
def test_sync_bn_steps_match_one_rank_and_chd_tpu(rank_steps, jax_steps, group):
    refs, sd = jax_steps
    ref = refs[group]
    ranks = rank_steps[group]
    n, n_slices = GROUPS[group]
    lr = LR
    one = _one_rank_steps(ref["steps"], sd)
    for out in ranks:
        dims = ("slice", "data", "model") if n_slices > 1 else ("data", "model")
        assert list(out["shape"]) == list(dims) and np.prod(list(out["shape"].values())) == n
        _within_phase9_bounds(out, one, ref["firm"], lr)
        _within_phase9_bounds(out, ref, ref["firm"], lr)
        for k, v in out["params"].items():
            assert np.array_equal(v, ranks[0]["params"][k]), k


@pytest.mark.parametrize("batch_size, shards", [(6, 4), (8, 3), (8, 4)])
def test_train_refuses_batches_that_do_not_divide(batch_size, shards):
    """``train`` with a mesh checks every batch it will take (the full ones
    and the ragged tail: 20 training sequences) against the mesh's batch
    shards before its first step, so a run over the ranks does not fail an
    epoch in."""
    ds = synth.learnable_dataset(24, 40, seed=0, n_holdout=4, device="cpu")
    mesh = mesh_lib.local_mesh(shards, device="cpu")
    cfg = train.TrainConfig(epochs=1, batch_size=batch_size)
    bad = sorted(r for r in {batch_size, 20 % batch_size} - {0} if r % shards)
    if bad:
        with pytest.raises(ValueError, match=f"a training batch of {bad[0]} does not divide"):
            train.train(ds, cfg, verbose=False, mesh=mesh)
    else:
        model, history = train.train(ds, cfg, verbose=False, mesh=mesh)
        assert np.isfinite(history["train_loss"]).all()
