"""Exact block-banded normal-equation solve for frame-structured nonlinear
least squares (port of chd_tpu/kinematics/banded.py).

The trajectory objective couples frames only through velocity and
acceleration differences, so JᵀJ is block-pentadiagonal along the frame
axis: block (f, f') vanishes for |f − f'| > bandwidth (= 2, the acceleration
stencil). Instead of iterating CG against matrix-free JᵀJ·v products, the
LM step (``lm.lm_solve(banded_masks=coloring_masks(F, D))``)

1. extracts the exact banded blocks with ``2·bandwidth+1`` frame colorings:
   for a tangent active at one dof of every 5th frame, each output row of
   JᵀJ·v receives a contribution from exactly one colored frame, so one
   ``torch.func.vmap`` pass of ``dofs_per_frame × 5`` products recovers every
   block; then
2. folds frame pairs into 2×2 superblocks, which makes the system block
   tridiagonal, and runs the SPD block-Thomas recurrence: a Cholesky
   factorization per superblock, ~F/2 small batched steps.

The port runs B problems in lockstep on (B, n) variables, as ``lm.py``
does: the blocks are (B, F, D, D) and the superblock system (B, G, 2D, 2D),
G = ceil(F/2). Nothing syncs with the host, so a step can be captured as a
CUDA graph: ``torch.linalg.cholesky_ex`` does not check its result, and a
failed factorization (a non-positive pivot, possible in float32) becomes
NaN, as ``chd_tpu``'s Cholesky returns it, so that the LM step's cost
comparison rejects the step. The recurrence over the superblocks is a
Python loop of batched ops.
"""
from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from ..utils.device import resolve_device


def coloring_masks(num_frames: int, dofs_per_frame: int, bandwidth: int = 2,
                   dtype=torch.float32, device="cuda") -> torch.Tensor:
    """(dofs_per_frame·(2·bandwidth+1), F·D) tangent masks, on ``device``
    (default ``cuda``; raises where CUDA is absent).

    Stride 2·bandwidth+1 guarantees each JᵀJ row window (±bandwidth frames)
    contains at most one colored frame, so products recover exact block
    columns (the diagonal-only masks of ``lm.frame_coloring_masks`` use
    stride bandwidth+1, enough for the diagonal but not for off-bands).
    """
    stride = 2 * bandwidth + 1
    n = num_frames * dofs_per_frame
    masks = np.zeros((dofs_per_frame * stride, n), dtype=np.float32)
    for d in range(dofs_per_frame):
        for c in range(stride):
            frames = np.arange(c, num_frames, stride)
            masks[d * stride + c, frames * dofs_per_frame + d] = 1.0
    return torch.as_tensor(masks, dtype=dtype, device=resolve_device(device))


def banded_jtj(many: Callable, masks: torch.Tensor, batch: int, num_frames: int,
               dofs_per_frame: int, bandwidth: int = 2) -> List[torch.Tensor]:
    """The lower block bands of A = JᵀJ of every problem, from matrix-free
    products: ``many`` maps (M, B, n) tangents to their (M, B, n) products
    (``torch.func.vmap`` of a (B, n) product, or a product kernel's launch
    over a tangent axis), and the masks (M, n) go in broadcast over the B
    problems in one call.

    Returns blocks[k] of shape (B, F, D, D) with blocks[k][:, f] = A[f+k, f]
    (rows f+k, cols f; the last k entries are zero). blocks[0] is the
    symmetric diagonal band.
    """
    stride = 2 * bandwidth + 1
    F, D = num_frames, dofs_per_frame
    m = masks.unsqueeze(1).expand(masks.shape[0], batch, masks.shape[1])
    P = many(m).reshape(D, stride, batch, F, D)  # [d, c, b, f_row, d_row]
    P = P.permute(1, 2, 3, 4, 0)  # [c, b, f_row, d_row, d_col]
    blocks = []
    for k in range(bandwidth + 1):
        # rows f+k of the product of frame f's color: one color a frame
        f = torch.arange(F - k, device=masks.device)
        Uk = P[f % stride, :, f + k].transpose(0, 1)  # (B, F-k, D, D)
        if k:
            Uk = torch.cat([Uk, Uk.new_zeros((batch, k, D, D))], dim=1)
        blocks.append(Uk)
    return blocks


def _cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A⁻¹ b for A = L Lᵀ (L lower), b (..., n, k): two triangular solves."""
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)


def _cholesky(C: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each SPD matrix of C, NaN where the
    factorization fails, with no host sync."""
    L, info = torch.linalg.cholesky_ex(C, check_errors=False)
    return torch.where((info > 0)[..., None, None], torch.nan, L)


def block_penta_solve(diag: torch.Tensor, lo1: torch.Tensor, lo2: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for every problem, A SPD block-pentadiagonal.

    diag: (B, F, D, D) A[f, f]; lo1: (B, F, D, D) with lo1[:, f] = A[f+1, f]
    (last entry ignored); lo2: (B, F, D, D) with lo2[:, f] = A[f+2, f] (last
    two ignored); b: (B, F, D). Returns x: (B, F, D).

    Frames are folded pairwise into 2D×2D superblocks so the system is block
    tridiagonal, then solved by the SPD block-Thomas recurrence: forward
    Cholesky elimination, then backward substitution.
    """
    B, F, D = b.shape
    G = (F + 1) // 2
    pad = 2 * G - F
    if pad:
        eye = torch.eye(D, dtype=b.dtype, device=b.device).expand(B, pad, D, D)
        diag = torch.cat([diag, eye], dim=1)
        # the couplings into the padded frame are dead
        lo1, lo2 = (torch.cat([lo[:, :max(F - k, 0)],
                               lo.new_zeros((B, 2 * G - max(F - k, 0), D, D))], dim=1)
                    for k, lo in ((1, lo1), (2, lo2)))
        b = torch.cat([b, b.new_zeros((B, pad, D))], dim=1)

    d0, d1 = diag[:, 0::2], diag[:, 1::2]  # (B, G, D, D)
    u1 = lo1[:, 0::2].transpose(-1, -2)  # A[2g, 2g+1]
    S = torch.cat([torch.cat([d0, u1], dim=-1),
                   torch.cat([u1.transpose(-1, -2), d1], dim=-1)], dim=-2)  # (B, G, 2D, 2D)

    # E[:, g] = A[2g+2:2g+4, 2g:2g+2] for g = 0..G-2; E[:, G-1] is zero
    e00 = lo2[:, 0::2]  # A[2g+2, 2g]
    e01 = lo1[:, 1::2]  # A[2g+2, 2g+1]
    e11 = lo2[:, 1::2]  # A[2g+3, 2g+1]
    E = torch.cat([torch.cat([e00, e01], dim=-1),
                   torch.cat([torch.zeros_like(e00), e11], dim=-1)], dim=-2)
    E = torch.cat([E[:, :G - 1], torch.zeros_like(E[:, :1])], dim=1)
    bs = b.reshape(B, G, 2 * D, 1)

    # forward elimination; E[:, g-1] feeds superblock g
    Ls, ys = [], []
    L = y = None
    for g in range(G):
        if g == 0:
            C, rhs = S[:, 0], bs[:, 0]
        else:
            Ep = E[:, g - 1]
            C = S[:, g] - Ep @ _cho_solve(L, Ep.transpose(-1, -2))
            rhs = bs[:, g] - Ep @ y
        L = _cholesky(C)
        y = _cho_solve(L, rhs)
        Ls.append(L)
        ys.append(y)

    # backward substitution
    xs: List[torch.Tensor] = [ys[-1]] * G
    for g in range(G - 2, -1, -1):
        xs[g] = ys[g] - _cho_solve(Ls[g], E[:, g].transpose(-1, -2) @ xs[g + 1])
    return torch.stack(xs, dim=1).reshape(B, 2 * G, D)[:, :F]
