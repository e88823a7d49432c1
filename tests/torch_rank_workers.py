"""What the port's multi-rank tests run in each rank of a process group
(``chd_tpu_torch.parallel.dryrun.run_ranks``), and in one process for the
single-process form of a mesh. Imports no jax: the spawned ranks start with
torch alone. Every function returns host values for the test to hold.
"""
import numpy as np
import torch
import torch.distributed as dist

from chd_tpu_torch.kinematics.residuals import TermWeights, TrajectoryData
from chd_tpu_torch.parallel import distributed
from chd_tpu_torch.parallel import mesh as mesh_lib


FRAME_KEYS = ("x0", "pose3d", "root", "p2d", "pw", "dw", "vc")


def _mesh(n: int, model: int = 1) -> mesh_lib.Mesh:
    """The process group's ("data", "model") mesh, or the single-process
    form of ``n`` shards on the CPU where no group is initialized."""
    return mesh_lib.make_mesh(None if dist.is_initialized() else n, model=model, device="cpu")


def _data(p: dict) -> TrajectoryData:
    return TrajectoryData(*(torch.as_tensor(p[k])[None] for k in (
        "pose3d", "root", "p2d", "pw", "dw", "sw", "vc", "normal", "point", "offsets")))


def longseq_checks(n: int, problems: dict, w: TermWeights, solve_cfg, refine: dict) -> dict:
    """The frame-sharded LM over ``n`` shards: for each problem (float64) the
    probe and the damped solve; the halo exchange's adjoint identity; the
    whole refinement; and the error where a shard holds fewer frames than
    the halo."""
    from chd_tpu_torch.parallel import longseq

    mesh = _mesh(n)
    out = {}
    for F, p in problems.items():
        c, g, d = longseq.probe_grad_diag(p["x0"], _data(p), w, p["parents"], mesh,
                                          dtype=torch.float64)
        x, cost = longseq.lm_solve_frame_sharded(p["x0"], _data(p), w, p["parents"], mesh,
                                                 cfg=solve_cfg, dtype=torch.float64)
        out[F] = dict(cost=float(c), grad=g.numpy(), diag=d.numpy(), x=x.numpy(),
                      solve_cost=float(cost))

    ring = longseq.Ring(mesh)
    rng = np.random.default_rng(0)
    F_loc, D, M = 5, 4, 3
    xs = torch.as_tensor(rng.normal(size=(M, n, F_loc, D)))
    ys = torch.as_tensor(rng.normal(size=(M, n, F_loc + 2 * longseq.HALO, D)))
    mine = slice(ring.first, ring.first + ring.k)
    ex = ring.exchange(xs[:, mine], dim=1)
    back = ring.return_halos(ys[:, mine], dim=1)
    out["adjoint"] = (float(ring.sum(ex * ys[:, mine])), float(ring.sum(xs[:, mine] * back)))

    res = longseq.optimize_trajectory_frame_sharded(
        refine["pose2d"], refine["conf2d"], refine["pose3d"], refine["root_pos"],
        refine["smpl_angles"], refine["skeleton"], refine["vel_constraints"], mesh,
        ik_iterations=refine["ik_iterations"], lm_cfg=refine["lm_cfg"], dtype=torch.float64)
    out["refine"] = dict(pose3d=res.pose3d, floor_normal=res.floor_normal,
                         refined_contacts=res.refined_contacts)

    p = next(iter(problems.values()))
    short = {k: (v[:n] if k in FRAME_KEYS else v) for k, v in p.items()}
    try:
        longseq.probe_grad_diag(short["x0"], _data(short), w, p["parents"], mesh,
                                dtype=torch.float64)
        out["short"] = None
    except ValueError as e:
        out["short"] = str(e)
    return out


def parallel_checks(kp: np.ndarray, state_dict: dict, phys: list, phys_cfg, kin: dict) -> dict:
    """Over the group's ranks: the mesh's layout, data-parallel detection,
    the physics and kinematic batches sharded, and an indivisible batch."""
    from chd_tpu_torch.contact.infer import ContactDetector
    from chd_tpu_torch.kinematics import batch as kin_batch
    from chd_tpu_torch.models import torch_convert
    from chd_tpu_torch.parallel import batch as phys_batch_lib
    from chd_tpu_torch.physics.types import PhysWeights

    mesh = mesh_lib.make_mesh()
    out = dict(shape=mesh.shape, coordinate=mesh.coordinate(), batch_index=mesh.batch_index(),
               rank=dist.get_rank())
    mine = torch.full((2, 3), float(dist.get_rank()))
    out["replicated"] = mesh_lib.replicate(mesh, {"a": mine})["a"].numpy()
    rows = np.arange(5 * 3, dtype=np.float32).reshape(5, 3)
    local = rows[distributed.process_local_slice(len(rows))]
    out["local_rows"] = len(local)
    out["global_rows"] = distributed.global_batch_from_local(mesh, local, len(rows)).numpy()
    det = ContactDetector(torch_convert.from_state_dict(state_dict), device="cpu")
    contacts, probs = det.infer(torch.from_numpy(kp), mesh=mesh)
    out["contacts"], out["probs"] = contacts.numpy(), probs.numpy()
    try:
        det.infer(torch.from_numpy(kp[:3]), mesh=mesh)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)

    batched, _ = phys_batch_lib.pad_phys_inputs(phys, device="cpu", dtype=torch.float64)
    res_fit, res_dyn, res, stats, ok = phys_batch_lib.solve_physics_full_batch(
        batched, PhysWeights(), phys_cfg, mesh=mesh)
    out["physics"] = dict(fit=res_fit.base_lin.numpy(), dyn=res_dyn.base_lin.numpy(),
                          base_lin=res.base_lin.numpy(), ee_force=res.ee_force.numpy(),
                          contact=res.contact.numpy(), dyn_stat=stats["dyn"].numpy(), ok=ok)
    _, rd = phys_batch_lib.solve_physics_batch(batched, PhysWeights(), phys_cfg, mesh=mesh)
    _, _, ok_d = phys_batch_lib.solve_physics_durations_batch(batched, rd, PhysWeights(),
                                                              phys_cfg, mesh=mesh)
    out["physics"]["staged_dyn"], out["physics"]["staged_ok"] = rd.base_lin.numpy(), ok_d

    results = kin_batch.optimize_trajectory_batch(
        kin["problems"], kin["skeleton"], ik_iterations=kin["ik_iterations"],
        lm_cfg=kin["lm_cfg"], device="cpu", dtype=torch.float64, ik_solver="lu", mesh=mesh)
    out["kinematic"] = [(r.pose3d, r.floor_normal, r.refined_contacts, r.vel_constraints)
                        for r in results]
    return out


def cli_run(argv: list, video_dir: str) -> dict:
    """``python -m chd_tpu_torch.pipeline`` with ``argv`` in this rank, then
    what the rank reads back of the video dir's kinematic and physics
    files; and ``distributed.on_primary``'s calls and result here."""
    import os

    from chd_tpu_torch.pipeline import cli

    calls = []
    got = distributed.on_primary(lambda: calls.append(dist.get_rank()) or "from rank 0")
    rc = cli.main(argv)
    kin = os.path.join(video_dir, "kinematic_results")
    files = [os.path.join(kin, n) for n in ("final_test.bvh", "floor_out.txt",
                                            "foot_contacts.npy")]
    files += [os.path.join(video_dir, "phys_optim_out_combined", "sol_out_durations.txt")]
    return dict(rc=rc, calls=calls, primary_result=got,
                files={os.path.relpath(f, video_dir): open(f, "rb").read() for f in files})


def sync_bn_steps(steps: list, state_dict: dict, cfg, n_slices: int) -> dict:
    """3 data-parallel training steps on the given windows and dropout masks
    (each the global batch's), over the ("data", "model") mesh or, with
    ``n_slices`` > 1, the ("slice", "data", "model") one. Returns the last
    step's summed gradients, the parameters and the BN statistics."""
    from chd_tpu_torch.contact import train
    from chd_tpu_torch.models import torch_convert

    if n_slices > 1:
        mesh = distributed.make_global_mesh(model=1, n_slices=n_slices)
    else:
        mesh = mesh_lib.make_mesh()
    model = torch_convert.from_state_dict(state_dict)
    opt = train.make_optimizer(model, cfg)
    losses = []
    for feats, labels, mask in steps:
        loss, _ = train.train_step(model, opt, None, None, cfg, None,
                                   windows=(torch.from_numpy(feats), torch.from_numpy(labels)),
                                   dropout_mask=torch.from_numpy(mask), mesh=mesh)
        losses.append(float(loss))
    return dict(losses=losses, shape=mesh.shape,
                grads={k: p.grad.numpy().copy() for k, p in model.named_parameters()},
                params={k: p.detach().numpy().copy() for k, p in model.named_parameters()},
                buffers={k: b.numpy().copy() for k, b in model.named_buffers()})


def tensor_parallel_checks(n: int, models: dict, steps: list, cfg, val: tuple) -> dict:
    """Over a ("data", "model") mesh of ``n`` with "model" 2: for each state
    dict of ``models`` the model sharded and gathered back and its folded
    layers against the gathered model's (bitwise), and this process's
    shards; the adjoint identities of ``Mesh.gather_model`` and
    ``Mesh.sum_model`` (float64); 3 tensor-parallel training steps of
    ``models["lower"]`` on the given global windows and dropout masks
    (gathered gradients, parameters, BN statistics, and linear4's bias,
    its gradient and Adam moments on this rank); and ``eval_step`` of the
    stepped sharded model on ``val`` against the unsharded one."""
    from chd_tpu_torch.contact import train
    from chd_tpu_torch.models import contact_mlp, torch_convert
    from chd_tpu_torch.parallel import tensor

    mesh = _mesh(n, model=2)
    out = dict(shape=mesh.shape, model_shards=mesh.model_shards(), bitwise={}, shards={})
    for name, sd in models.items():
        whole = torch_convert.from_state_dict(sd)
        tp = tensor.shard_contact_model(whole, mesh)
        back = tensor.gather_contact_model(tp)
        f_tp, f_back = tensor.fold_batchnorm(tp), contact_mlp.fold_batchnorm(back)
        out["bitwise"][name] = dict(
            gather=all(torch.equal(a, b) for a, b in zip(back.state_dict().values(),
                                                        whole.state_dict().values())),
            fold=all(torch.equal(a, b) for k in "wb" for a, b in zip(f_tp[k], f_back[k])))
        params, state = tp.trees()
        out["shards"][name] = {f"{mod}.{leaf}": [t.detach().numpy().copy() for t in parts]
                               for tree in (params, state)
                               for mod, leaves in tree.items() for leaf, parts in leaves.items()}

    rng = np.random.default_rng(0)
    m, mine = mesh.n_model, list(mesh.model_shards())
    xs = torch.as_tensor(rng.normal(size=(m, 3, 4)))
    ybars = torch.as_tensor(rng.normal(size=(m, 3, 4 * m)))
    zbar = torch.as_tensor(rng.normal(size=(3, 5)))
    x = xs[mine].clone().requires_grad_()
    y = mesh.gather_model(list(x.unbind(0)))
    ybar = ybars[mine].sum(0)  # each model rank's cotangent of the whole
    y.backward(ybar)
    gather_lhs = mesh.sum_model([(y.detach() * ybar).sum()])
    gather_rhs = mesh.sum_model([(x.detach() * x.grad).sum()])
    p = torch.as_tensor(rng.normal(size=(m, 3, 5)))[mine].clone().requires_grad_()
    z = mesh.sum_model(list(p.unbind(0)))
    z.backward(zbar)  # the same on every model rank, as the loss is
    out["adjoint"] = dict(gather=(float(gather_lhs), float(gather_rhs)),
                          sum=(float((z.detach() * zbar).sum()),
                               float(mesh.sum_model([(p.detach() * p.grad).sum()]))))

    tp = tensor.shard_contact_model(torch_convert.from_state_dict(models["lower"]), mesh)
    opt = train.make_optimizer(tp, cfg)
    losses = []
    for feats, labels, mask in steps:
        loss, _ = train.train_step(tp, opt, None, None, cfg, None,
                                   windows=(torch.from_numpy(feats), torch.from_numpy(labels)),
                                   dropout_mask=torch.from_numpy(mask), mesh=mesh)
        losses.append(float(loss))
    adam = opt.state[tp.bias4]
    out["bias4"] = dict(grad=tp.bias4.grad.numpy().copy(), exp_avg=adam["exp_avg"].numpy().copy(),
                        exp_avg_sq=adam["exp_avg_sq"].numpy().copy())
    model = tensor.gather_contact_model(tp)
    out.update(losses=losses,
               grads={k: q.grad.numpy().copy() for k, q in model.named_parameters()},
               params={k: q.detach().numpy().copy() for k, q in model.named_parameters()},
               buffers={k: b.numpy().copy() for k, b in model.named_buffers()})
    val_op, val_ct = (torch.from_numpy(a) for a in val)
    out["eval"] = [tuple(t.numpy() for t in train.eval_step(tp, val_op, val_ct, cfg, mesh=mesh)),
                   tuple(t.numpy() for t in train.eval_step(model.eval(), val_op, val_ct, cfg))]
    return out


def fail_on_rank_one() -> int:
    """Rank 1 raises; rank 0 waits for it in a collective."""
    if dist.get_rank() == 1:
        raise RuntimeError("rank one fails on purpose")
    dist.barrier()
    return dist.get_rank()


def hang_on_rank_one() -> int:
    """Rank 1 never returns; rank 0 waits for it in a collective."""
    if dist.get_rank() == 1:
        import time

        time.sleep(3600)
    dist.barrier()
    return dist.get_rank()
