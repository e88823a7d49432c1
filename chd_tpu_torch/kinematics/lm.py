"""Matrix-free Levenberg–Marquardt for batched nonlinear least squares
(port of chd_tpu/kinematics/lm.py).

LM with a Jacobi-preconditioned, matrix-free conjugate-gradient inner solve:
every CG iteration is one JᵀJ·v product through the residual function.
Everything runs a fixed number of iterations with no host sync, for a batch
of B independent problems in lockstep: the variables are (B, n), and the
damping λ, the cost and the CG scalars are per problem, (B, 1), with
``torch.where`` accepts. The residual of problem b must read only row b of
x, so J is block-diagonal across the batch and one tangent pass and one
transpose pass serve every problem (``chd_tpu`` vmaps one problem's solve).

Per LM step, ``torch.func.vjp`` linearizes the residual once; its ``vjp_fn``
is Jᵀ and is called again in every CG iteration. The tangent J·v is the
transpose of ``vjp_fn``, itself a vjp of that linear function (a double
vjp): like ``jax.linearize`` it reuses the linearization point and
re-evaluates no primal. ``torch.func.jvp`` at x, which re-evaluates the
primal with every tangent, was measured slower on the H100 both eager and
replayed (PERF.md).

Marquardt scaling needs diag(JᵀJ). The Jacobian is block-banded along the
frame axis (a residual row touches at most ``bandwidth+1`` consecutive
frames), so for a tangent active at one dof of every (bandwidth+1)-th frame
the cross terms of (JᵀJ v) ⊙ v vanish: ``dofs_per_frame × (bandwidth+1)``
products give the exact diagonal. They run as one ``torch.func.vmap`` pass,
the masks broadcast over the sequences, not copied.

Without masks the damping is λI, with unit scales and a unit
preconditioner. ``banded_masks`` (``banded.coloring_masks(num_frames,
dofs_per_frame)``, in place of chd_tpu's ``banded_spec``) replace the PCG
inner solve by ``kinematics/banded.py``'s exact block-pentadiagonal
factorization (one vmapped pass of 5 × D products and ~F/2 batched Cholesky
steps a step) for residuals that couple frames at most 2 apart, variables
laid out frame-major.

``graphs=`` (a ``utils.cuda_graph.GraphCache``) replays each LM step as a
captured CUDA graph: the same kernels as the eager step, launched by one
call, one capture per mode and shape.

A residual may name its own JᵀJ·v supplier, ``residual_fn.product_for(x0)``
(the trajectory and AL residuals name their kernels on CUDA,
``ops/jtjv.py``), which ``lm_solve`` takes in place of the double vjp and
keys the captured step by, so every solve of the residual, whoever calls
it, finds the same graph. ``supplier(x, *args)`` is the linearization at x,
``lm_step``'s ``product``: called on (B, n) tangents, with ``many`` for
(M, B, n) and ``diag(masks)`` for the coloring diagonal. The gradient and
the cost stay autograd's. Each solve counts its path, ``lm.jtjv.autograd``
or ``lm.jtjv.<supplier.path>`` (``utils.profiling``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..utils.cuda_graph import GraphCache
from ..utils.device import resolve_device
from ..utils.profiling import count
from . import banded as banded_lib


@dataclasses.dataclass(frozen=True)
class LMConfig:
    max_iters: int = 50
    cg_iters: int = 50
    init_lambda: float = 1e-3
    lambda_up: float = 4.0
    lambda_down: float = 0.5
    min_lambda: float = 1e-12
    max_lambda: float = 1e10
    diag_floor: float = 1e-8


def frame_coloring_masks(num_frames: int, dofs_per_frame: int, bandwidth: int = 2,
                         dtype=torch.float32, device="cuda") -> torch.Tensor:
    """(dofs_per_frame·(bandwidth+1), n) tangent masks for exact diag(JᵀJ),
    on ``device`` (default ``cuda``; raises where CUDA is absent).

    bandwidth = max |f−f'| such that some residual couples frames f and f'
    (2 for the trajectory objective: the acceleration term spans 3 frames).
    """
    C = bandwidth + 1
    n = num_frames * dofs_per_frame
    masks = np.zeros((dofs_per_frame * C, n), dtype=np.float32)
    for d in range(dofs_per_frame):
        for c in range(C):
            frames = np.arange(c, num_frames, C)
            masks[d * C + c, frames * dofs_per_frame + d] = 1.0
    return torch.as_tensor(masks, dtype=dtype, device=resolve_device(device))


def _row_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1, keepdim=True)


def _pcg(matvec: Callable, b: torch.Tensor, inv_diag: torch.Tensor, iters: int,
         dot: Callable = _row_dot) -> torch.Tensor:
    """Fixed-iteration Jacobi-preconditioned CG, one system per row of b
    (``dot``: per row; ``parallel.longseq`` passes a global one)."""
    x = torch.zeros_like(b)
    r = b
    z = inv_diag * b
    p = z
    rz = dot(b, z)
    for _ in range(iters):
        Ap = matvec(p)
        denom = dot(p, Ap)
        alpha = torch.where(denom > 0, rz / torch.clamp(denom, min=1e-30), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = inv_diag * r
        rz_new = dot(r, z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = z + beta * p
        rz = rz_new
    return x


def _half_sq(r: torch.Tensor) -> torch.Tensor:
    return 0.5 * (r * r).sum(-1, keepdim=True)


def lm_step(res: Callable, x, lam, c, cfg: LMConfig, diag_masks: Optional[torch.Tensor] = None,
            banded_masks: Optional[torch.Tensor] = None, product: Optional[Callable] = None):
    """One LM step for every problem: (x, λ, cost) → (x, λ, cost). The inner
    solve is PCG, with the coloring diagonal of ``diag_masks`` or λI
    damping, or, given ``banded_masks`` (``banded.coloring_masks(F, D)``,
    (5·D, F·D)), the banded direct solve on the blocks they extract.
    ``product(x)``, where given, is JᵀJ at x (a ``jtjv.Linearization``) in
    place of the double vjp."""
    r, vjp_fn = torch.func.vjp(res, x)
    g = vjp_fn(r)[0]
    if product is None:
        _, lin = torch.func.vjp(lambda cot: vjp_fn(cot)[0], torch.zeros_like(r))

        def jtjv(v):
            return vjp_fn(lin(v)[0])[0]

        many = torch.func.vmap(jtjv)

        def coloring_diag(masks):
            m = masks.unsqueeze(1).expand((masks.shape[0],) + x.shape)
            return torch.func.vmap(lambda mk: mk * jtjv(mk))(m).sum(0)
    else:
        jtjv = product(x)
        many, coloring_diag = jtjv.many, jtjv.diag

    if banded_masks is not None:
        D = banded_masks.shape[0] // 5  # (5·D, F·D): bandwidth 2, stride 5
        F, B = banded_masks.shape[1] // D, x.shape[0]
        U0, L1, L2 = banded_lib.banded_jtj(many, banded_masks, B, F, D)
        scale_f = torch.clamp(torch.diagonal(U0, dim1=-2, dim2=-1), min=cfg.diag_floor)
        A0 = U0 + lam.unsqueeze(-1).unsqueeze(-1) * torch.diag_embed(scale_f)
        delta = banded_lib.block_penta_solve(A0, L1, L2, (-g).reshape(B, F, D)).reshape(B, -1)
    else:
        if diag_masks is not None:
            diag = coloring_diag(diag_masks)
            scale = torch.clamp(diag, min=cfg.diag_floor)
            inv_diag = 1.0 / (scale * (1.0 + lam))
        else:
            scale = inv_diag = torch.ones_like(x)
        delta = _pcg(lambda v: jtjv(v) + lam * scale * v, -g, inv_diag, cfg.cg_iters)
    x_new = x + delta
    c_new = _half_sq(res(x_new))
    accept = c_new < c  # False where c_new is NaN (a failed factorization)
    lam = torch.clamp(torch.where(accept, lam * cfg.lambda_down, lam * cfg.lambda_up),
                      cfg.min_lambda, cfg.max_lambda)
    return torch.where(accept, x_new, x), lam, torch.where(accept, c_new, c)


# -- argument trees (tuples, NamedTuples, tensors, floats, None) ---------------

def _flatten(obj, leaves: list):
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return "T"
    if obj is None:
        return "N"
    if isinstance(obj, tuple):
        return (type(obj), tuple(_flatten(o, leaves) for o in obj))
    raise TypeError(f"lm_solve args hold tensors, floats, None and tuples, not {type(obj)}")


def _unflatten(spec, leaves):
    if spec == "T":
        return next(leaves)
    if spec == "N":
        return None
    typ, specs = spec
    vals = [_unflatten(s, leaves) for s in specs]
    return typ(*vals) if hasattr(typ, "_fields") else typ(vals)


def _tensor_floats(obj, like: torch.Tensor):
    """Python floats → 0-d tensors on ``like``'s device: a captured step then
    reads them as data, and eager and graph steps do the same arithmetic."""
    if isinstance(obj, float):
        return torch.full((), obj, dtype=like.dtype, device=like.device)
    if isinstance(obj, tuple):
        vals = [_tensor_floats(o, like) for o in obj]
        return type(obj)(*vals) if hasattr(type(obj), "_fields") else type(obj)(vals)
    return obj


def _bound(product: Optional[Callable], args) -> Optional[Callable]:
    """``product`` with the solve's arguments: x → JᵀJ at x."""
    return None if product is None else (lambda x: product(x, *args))


def lm_solve(residual_fn: Callable, x0: torch.Tensor, args, cfg: LMConfig,
             diag_masks: Optional[torch.Tensor] = None, graphs: Optional[GraphCache] = None,
             banded_masks: Optional[torch.Tensor] = None):
    """Minimize ½‖residual_fn(x, *args)[b]‖² from x0[b] for every problem b.

    x0: (B, n); ``residual_fn`` returns (B, R). ``diag_masks`` (from
    ``frame_coloring_masks``) give the exact Marquardt scaling and Jacobi
    preconditioner; without them the damping is λI. ``banded_masks``
    (``banded.coloring_masks(F, D)``) switch the inner solve to the banded
    direct solve (``diag_masks`` is then ignored). The JᵀJ·v products are
    ``residual_fn.product_for(x0)``'s where it names one (see the module's
    docstring), autograd's otherwise. Returns (x (B, n), final cost (B,)).
    """
    product = getattr(residual_fn, "product_for", lambda x0: None)(x0)
    count("lm.jtjv.autograd" if product is None else f"lm.jtjv.{product.path}")
    if banded_masks is not None:
        diag_masks = None
    args = _tensor_floats(tuple(args), x0)
    B = x0.shape[0]
    lam = torch.full((B, 1), cfg.init_lambda, dtype=x0.dtype, device=x0.device)
    c = _half_sq(residual_fn(x0, *args))
    if graphs is None:
        x = x0
        for _ in range(cfg.max_iters):
            x, lam, c = lm_step(lambda v: residual_fn(v, *args), x, lam, c, cfg, diag_masks,
                                banded_masks, _bound(product, args))
        return x, c.squeeze(-1)

    leaves: list = []
    spec = _flatten((args, diag_masks, banded_masks), leaves)

    def step(state, static):
        a, masks, bmasks = _unflatten(spec, iter(static))
        return lm_step(lambda v: residual_fn(v, *a), *state, cfg, masks, bmasks,
                       _bound(product, a))

    # the step's kernels do not depend on the step count: one capture
    # serves every max_iters
    mode = "banded" if banded_masks is not None else "pcg" if diag_masks is not None else "lambda"
    key = ("lm_step", mode, residual_fn, product, dataclasses.replace(cfg, max_iters=0),
           repr(spec), tuple(x0.shape),
           tuple((t.shape, t.dtype, t.device) for t in leaves))
    x, lam, c = graphs.run(key, step, (x0, lam, c), leaves, cfg.max_iters)
    return x, c.squeeze(-1)
