"""Multi-rank dry run of the port's parallel layer (the counterpart of
``__graft_entry__.dryrun_multichip``), and the helper that starts ranks.

``dryrun_multichip(n, device)`` starts ``n`` ranks of a process group (gloo on
``"cpu"``; NCCL on ``"cuda"``, one card a rank, so it needs ``n`` cards) and
runs in them:

1. a dp x tp contact-training step over a ("data", "model") mesh with
   "model" 2 where ``n`` is even (as ``chd_tpu``'s dry run lays it), else 1:
   the model sharded by ``contact_model_shardings``
   (``parallel.tensor``), sync-BN over "data", summed gradients, against
   the unsharded step on the global batch in one process;
2. the same step over a ("slice", "data", "model") mesh of 2 slices and
   "model" 1, where ``n >= 4`` and even;
3. the sharded physics batch (``solve_physics_full_batch(mesh=...)``, one
   sequence a "data" shard), its outputs permuted alike when its inputs
   are: per-sequence solves share no state, so moving a sequence to another
   rank may only move its row;
4. the frame-sharded LM's probe (``longseq.probe_grad_diag``: cost, Jᵀr,
   diag(JᵀJ)) on an n-way frame shard (a mesh of its own, "model" 1)
   against the unsharded computation.

It prints one ``dryrun_multichip OK`` line. ``device`` is the caller's choice
and defaults to ``"cuda"``, like every entry point of the port: with fewer
cards than ranks it raises, and the CPU's gloo group runs only when the
caller names ``"cpu"``.

``run_ranks`` starts the ranks with the ``spawn`` method from a module that
imports no jax, so each child starts with torch alone; the group meets
through a ``FileStore`` in a directory of its own, every child runs torch on
one intra-op thread, the group's timeout bounds every collective, and the
ranks are joined against a deadline and terminated where they miss it.
"""
from __future__ import annotations

import multiprocessing
import multiprocessing.connection
import os
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import distributed
from . import mesh as mesh_lib

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
COMBINED_BVH = os.path.join(REPO, "tests", "fixtures", "prepare_input", "combined", "motion.bvh")


def _rank_main(fn: Callable, rank: int, n: int, device: str, workdir: str, args: tuple,
               group_timeout: float) -> None:
    torch.set_num_threads(1)
    out = os.path.join(workdir, f"rank{rank}.pt")
    try:
        distributed.initialize(device, world_size=n, rank=rank, local_rank=rank,
                               store=dist.FileStore(os.path.join(workdir, "store"), n),
                               timeout=group_timeout)
        torch.save({"result": fn(*args)}, out)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out)
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, n: int, device: str = "cuda", args: Sequence = (),
              timeout: float = 300.0, group_timeout: float = 60.0,
              workdir: Optional[str] = None) -> List[Any]:
    """``fn(*args)`` in each of ``n`` new ranks of a process group on
    ``device`` ("cpu": gloo; "cuda": NCCL, rank r on card r). Returns each
    rank's result, in rank order. ``fn`` must be importable by name (a
    module-level function); results come back through ``torch.save``.

    Raises where a rank fails (with its traceback), or where the ranks have
    not ended ``timeout`` seconds after their start (they are terminated);
    ``group_timeout`` bounds each collective, so the peers of a rank that
    died fail too. ``workdir`` holds the store and the results (a temporary
    directory by default)."""
    if device not in distributed.BACKENDS:
        raise ValueError(f"device must be one of {tuple(distributed.BACKENDS)}, not {device!r}")
    if device == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"{n} ranks on cuda need {n} cards; "
                           f"torch sees {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, n, device, tmp, tuple(args), group_timeout))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            pending = list(procs)
            while pending and time.monotonic() < deadline:
                multiprocessing.connection.wait([p.sentinel for p in pending],
                                                timeout=deadline - time.monotonic())
                pending = [p for p in pending if p.exitcode is None]
                if any(p.exitcode for p in procs):
                    break  # one rank failed: its peers would only wait for it
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        outs = []
        for r in range(n):
            path = os.path.join(tmp, f"rank{r}.pt")
            outs.append(torch.load(path, weights_only=False) if os.path.exists(path) else {})
    errors = [f"rank {r}:\n{o['error']}" for r, o in enumerate(outs) if "error" in o]
    if errors:
        raise RuntimeError("ranks failed:\n" + "\n".join(errors))
    missing = [r for r, o in enumerate(outs) if "result" not in o]
    if missing:
        raise TimeoutError(f"ranks {missing} of {n} gave no result within {timeout} s "
                           f"(exit codes {[p.exitcode for p in procs]})")
    return [o["result"] for o in outs]


def dryrun_multichip(n_devices: int, device: str = "cuda", timeout: float = 600.0) -> str:
    """Run the checks above in ``n_devices`` new ranks on ``device``; prints
    and returns the ``OK`` line, raises where a check fails."""
    results = run_ranks(_dryrun_rank, n_devices, device, args=(n_devices,), timeout=timeout)
    line = results[0]
    print(line, flush=True)
    return line


# -- what each rank runs -------------------------------------------------------

def _dryrun_rank(n: int) -> str:
    t0 = time.perf_counter()

    def mark(label):
        print(f"dryrun [{label}] rank {dist.get_rank()} t={time.perf_counter() - t0:.1f}s",
              file=sys.stderr, flush=True)

    mesh = mesh_lib.make_mesh(model=2 if n % 2 == 0 and n >= 2 else 1)
    loss, d_grads = _train_check(mesh)
    mark("train dp x tp")
    slice_msg = ""
    if n % 2 == 0 and n >= 4:
        gmesh = distributed.make_global_mesh(model=1, n_slices=2)
        s_loss, s_grads = _train_check(gmesh)
        slice_msg = (f"; slice mesh (slice=2, data={n // 2}) loss={s_loss:.4f} "
                     f"grads {s_grads:.1e}")
    mark("train multi-slice")
    phys_msg = _dryrun_physics(mesh)
    mark("physics dp")
    longseq_msg = _dryrun_longseq(mesh_lib.make_mesh())
    mark("longseq probe")
    return (f"dryrun_multichip OK: {n} ranks on {mesh.device.type} "
            f"({dist.get_backend()}; data={mesh.shape['data']}, model={mesh.shape['model']}), "
            f"train dp x tp loss={loss:.4f} grads {d_grads:.1e}{slice_msg}; {phys_msg}; "
            f"{longseq_msg}")


def _train_check(mesh: mesh_lib.Mesh):
    """One training step over ``mesh``, the model sharded by
    ``contact_model_shardings`` (whole at "model" 1), against the unsharded
    step on the global batch in this process alone: the loss, the summed
    gradients (relative to the largest) and the BN running statistics,
    gathered. Returns (loss, gradients' relative max |d|). (Parameters are
    not compared: Adam's first step moves each by ±lr whatever its
    gradient's size, so a gradient near 0 flips on a rounding.)"""
    from ..contact import train as train_lib
    from ..models import contact_mlp
    from . import tensor

    cfg = train_lib.TrainConfig(batch_size=8)
    B, F = mesh.n_batch * max(1, 8 // mesh.n_batch), 32
    rng = np.random.default_rng(0)
    op = torch.as_tensor(rng.uniform(0, 5, size=(B, F, 25, 3)), dtype=torch.float32,
                         device=mesh.device)
    contacts = torch.as_tensor(rng.uniform(size=(B, F, 4)) > 0.5, dtype=torch.float32,
                               device=mesh.device)

    def step(m):
        model = contact_mlp.init(cfg.model_config(), torch.Generator().manual_seed(0))
        model = model.to(mesh.device)
        if m is not None:
            model = tensor.shard_contact_model(model, m)
        opt = train_lib.make_optimizer(model, cfg)
        gen = torch.Generator(device=mesh.device).manual_seed(1)
        loss, _ = train_lib.train_step(model, opt, op, contacts, cfg, gen, mesh=m)
        if m is not None:
            model = tensor.gather_contact_model(model)
        return (float(loss), torch.cat([p.grad.reshape(-1) for p in model.parameters()]),
                torch.cat([b.reshape(-1).float() for b in model.buffers()]))

    loss, grads, bufs = step(mesh)
    plain_loss, plain_grads, plain_bufs = step(None)
    d_g = float((grads - plain_grads).abs().max() / plain_grads.abs().max())
    d_b = float((bufs - plain_bufs).abs().max())
    if not np.isfinite(loss) or abs(loss - plain_loss) > 1e-5 * max(1.0, abs(plain_loss)):
        raise AssertionError(f"sharded loss {loss} against {plain_loss} on one process")
    if d_g > 1e-5 or d_b > 1e-5:
        raise AssertionError(f"sharded step against one process's: gradients {d_g} "
                             f"(relative), BN statistics {d_b}")
    return loss, d_g


def _dryrun_physics(mesh: mesh_lib.Mesh) -> str:
    """The sharded physics batch, B = one sequence a batch shard (the "model"
    ranks of one share it), run on its inputs and on them rolled by one: the
    outputs must roll alike."""
    from ..kinematics.lm import LMConfig
    from ..parallel import batch as batch_lib
    from ..physics import collocation
    from ..physics.synth import walking_input
    from ..physics.types import PhysWeights

    B, F = mesh.n_batch, 12
    inputs = [walking_input(F, seed=i) for i in range(B)]
    cfg = collocation.SolveConfig(
        al_iters_fit=1, al_iters_dyn=1, al_iters_height=1, al_iters_durations=1,
        lm=LMConfig(max_iters=2, cg_iters=4, init_lambda=1e1))

    def run(seqs):
        batched, _ = batch_lib.pad_phys_inputs(seqs, device=mesh.device)
        _, _, res, _, ok = batch_lib.solve_physics_full_batch(batched, PhysWeights(), cfg,
                                                              mesh=mesh)
        return res.base_lin.cpu().numpy(), ok

    base_a, ok_a = run(inputs)
    perm = np.roll(np.arange(B), 1)
    base_b, ok_b = run([inputs[i] for i in perm])
    if not np.all(np.isfinite(base_b)):
        raise AssertionError("sharded physics produced non-finite output")
    dmax = float(np.abs(base_a[perm] - base_b).max())
    if dmax >= 1e-4 or list(ok_a[perm]) != list(ok_b):
        raise AssertionError(f"batch-permuted sharded physics not equivariant: max|d| {dmax}")
    return f"physics dp(B={B}) OK perm-equivariant max|d|={dmax:.1e}"


def _dryrun_longseq(mesh: mesh_lib.Mesh) -> str:
    """The frame-sharded probe (cost, Jᵀr, diag(JᵀJ)) over the mesh's
    "data" ranks against the unsharded computation, float32, on the combined
    skeleton of the repo's fixtures (offsets in cm)."""
    from ..characters import defs
    from ..core import bvh
    from ..kinematics.lm import frame_coloring_masks
    from ..kinematics.residuals import Layout, TermWeights, TrajectoryData
    from . import longseq

    n = mesh.shape["data"]
    F = 2 * longseq.HALO * max(n, 2)
    rng = np.random.default_rng(5)
    skel, _, _ = bvh.load(COMBINED_BVH)
    J = len(skel.parents)
    D = 3 + 3 * J
    conf = np.ones((F, 28))
    conf[:, 25:] = 0

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=mesh.device)[None]

    data = TrajectoryData(
        t(rng.normal(size=(F, 28, 3)) * 0.3), t(rng.normal(size=(F, 3)) + [0, 0, 4.0]),
        t(rng.normal(size=(F, 28, 2)) * 0.1), t(conf), t(conf), t(defs.COMBINED_SMOOTH_WEIGHTS),
        t((rng.uniform(size=(F, 28)) > 0.8).astype(np.float32)), t([0.0, -1.0, 0.0]),
        t([0.0, 0.9, 0.0]), t(np.asarray(skel.offsets) * 0.01))
    x0 = rng.normal(size=(F, D)) * 0.05
    w = TermWeights(floor=10.0)
    c_sh, g_sh, d_sh = longseq.probe_grad_diag(x0, data, w, skel.parents, mesh)

    layout = Layout(tuple(skel.parents), mesh.device, torch.float32)
    xf = t(x0.reshape(-1))
    r, vjp_fn = torch.func.vjp(lambda x: layout.residual(x, data, w), xf)
    g_ref = vjp_fn(r)[0].reshape(F, D)
    _, lin = torch.func.vjp(lambda cot: vjp_fn(cot)[0], torch.zeros_like(r))
    masks = frame_coloring_masks(F, D, device=mesh.device)
    d_ref = sum(m * vjp_fn(lin(m[None])[0])[0][0] for m in masks).reshape(F, D)
    c_ref = 0.5 * float((r * r).sum())
    # float32: the shards' partial sums round apart from the global sum; a
    # halo or ownership fault is O(1) relative
    d_c = abs(float(c_sh) - c_ref) / c_ref
    d_g = float((g_sh - g_ref).abs().max() / g_ref.abs().max())
    d_d = float((d_sh - d_ref).abs().max() / d_ref.abs().max())
    if d_c > 1e-3 or d_g > 1e-3 or d_d > 1e-3:
        raise AssertionError(f"frame-sharded probe against the unsharded one: cost {d_c:.1e}, "
                             f"grad {d_g:.1e}, diag {d_d:.1e} (relative)")
    return (f"longseq probe OK ({n}-way frame shard, F={F}: cost {d_c:.1e}, grad {d_g:.1e}, "
            f"diag {d_d:.1e})")
