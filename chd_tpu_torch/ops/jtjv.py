"""The half the hand-written JᵀJ·v kernels share (the trajectory residual's,
``kinematics/jtjv.py``, and the physics AL residual's, ``physics/jtjv.py``).

A residual names its product supplier, ``residual_fn.product_for(x0)``,
which ``lm.lm_solve`` takes; it asks ``supplier``, the one rule of who gets
a kernel (tests patch it to put the emulation in the kernel's place). A
``Supplier`` is one object per residual structure, so a captured LM step is
found again; ``supplier(x, *args)`` is the ``Linearization`` at x.
``launch`` calls a kernel through the C ABI both share,
``chd_<name>(dtype, mode, ptrs, ints, stream)``.
"""
from __future__ import annotations

import copy
import ctypes
from typing import Callable, Optional, Sequence

import torch

from ..utils import build

MODES = ("product", "diag")
DTYPES = (torch.float32, torch.float64)
COLORS = 3  # lm.frame_coloring_masks' bandwidth 2 + 1


def supplier(x0: torch.Tensor, make: Callable[[], "Supplier"]) -> Optional["Supplier"]:
    """The supplier a solve from x0 takes: the kernel's, ``make()``, on
    CUDA; None (autograd's double vjp) elsewhere."""
    return make() if x0.device.type == "cuda" else None


class Supplier:
    """A kernel's product supplier. A subclass sets ``path`` and
    ``emulation_path`` (its ``lm.jtjv.<path>`` counter names), ``TILE``,
    ``linearization``, ``kernel(mode, lin, vs)`` (its launcher) and
    ``plain(mode, lin, vs, tile)`` (its emulation)."""

    path: str
    emulation_path: str
    TILE: int
    linearization: type
    tile: Optional[int] = None  # None: the kernel; else the emulation's tile

    def __call__(self, x, *args) -> "Linearization":
        return self.linearization(self, x, *args)

    def emulated(self, tile: Optional[int] = None) -> "Supplier":
        """This supplier with the emulation in the kernel's place, on any
        device, in tiles of ``tile`` frames (default the kernel's)."""
        em = copy.copy(self)
        em.tile, em.path = self.TILE if tile is None else tile, self.emulation_path
        return em

    def compute(self, mode: str, lin, vs=None) -> torch.Tensor:
        if self.tile is None:
            return self.kernel(mode, lin, vs)
        check_mode(mode)
        return self.plain(mode, lin, vs, self.tile)


class Linearization:
    """JᵀJ at x: ``self(v)`` for tangents (B, n), ``many(vs)`` for tangents
    (M, B, n) in one launch, and ``diag(masks)``, the coloring diagonal
    Σₖ mₖ ⊙ JᵀJ mₖ of ``lm.frame_coloring_masks(frames, dofs)``. A subclass
    keeps what its kernel reads and sets ``frames`` and ``dofs``."""

    frames: int
    dofs: int

    def __init__(self, product: Supplier, x: torch.Tensor):
        self.product, self.x = product, x

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return self.many(v.unsqueeze(0))[0]

    def many(self, vs: torch.Tensor) -> torch.Tensor:
        return self.product.compute("product", self, vs)

    def diag(self, masks: torch.Tensor) -> torch.Tensor:
        F, D = self.frames, self.dofs
        if tuple(masks.shape) != (COLORS * D, F * D):
            raise ValueError(f"the diagonal is the one of frame_coloring_masks({F}, {D}) "
                             f"(({COLORS * D}, {F * D})), not of masks {tuple(masks.shape)}")
        return self.product.compute("diag", self)


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, not {mode!r}")


def check_x(kernel: Callable, mode: str, x, shape) -> None:
    """What a launch checks first: the mode, and x a contiguous CUDA tensor
    of ``shape`` in a dtype the kernels take."""
    check_mode(mode)
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError(f"{kernel.__name__} runs on CUDA tensors; on the CPU the product is "
                         "autograd's")
    if x.dtype not in DTYPES:
        raise TypeError(f"{kernel.__name__} takes {DTYPES}, not {x.dtype}")
    if tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(f"x must be contiguous {tuple(shape)}, not {tuple(x.shape)} with "
                         f"strides {x.stride()}")


def check_like(name: str, t, shape, like: torch.Tensor) -> torch.Tensor:
    """``t``, or raise unless it is a tensor of ``like``'s device and dtype,
    of ``shape``, contiguous past its first axis (read by its stride)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, not {type(t).__name__}")
    if t.device != like.device or t.dtype != like.dtype:
        raise TypeError(f"{name} is {t.dtype} on {t.device}; the solve is {like.dtype} on "
                        f"{like.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, not {tuple(shape)}")
    want = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size > 1 and stride != want:
            raise ValueError(f"{name} must be contiguous past its first axis (strides "
                             f"{t.stride()})")
        want *= size
    return t


def launch(kernel: Callable, mode: str, x: torch.Tensor, vs: Optional[torch.Tensor],
           head: Sequence[int], ptrs: Sequence[int], tail: Sequence[int],
           diag_tangents: int = 1, diag_v: int = 0) -> torch.Tensor:
    """Launch ``chd_<kernel's name>`` on x's current stream and count it in
    ``kernel.launches[mode]``. "product": JᵀJ·v (M, B, n) of tangents ``vs``
    (M, B, n), any strides over M and B, each row contiguous; "diag": the
    diagonal (B, n) over ``diag_tangents`` tangents, ``diag_v`` for v. x
    (B, n) has passed ``check_x``. The pointers are [x, v, out, *ptrs], the
    ints [M, B, *head, v's strides over M and B, *tail]."""
    B, n = x.shape
    if mode == "product":
        if not isinstance(vs, torch.Tensor) or vs.device != x.device or vs.dtype != x.dtype:
            raise TypeError("the tangents must be a tensor of x's device and dtype")
        if vs.dim() != 3 or tuple(vs.shape[1:]) != (B, n) or vs.shape[0] < 1 \
                or vs.stride(-1) != 1:
            raise ValueError(f"the tangents must be (M, {B}, {n}) with contiguous rows, not "
                             f"{tuple(vs.shape)} with strides {vs.stride()}")
        M, out = vs.shape[0], torch.empty((vs.shape[0], B, n), dtype=x.dtype, device=x.device)
        v_ptr, v_sm, v_sb = vs.data_ptr(), vs.stride(0), vs.stride(1)
    else:
        M, out = diag_tangents, torch.empty((B, n), dtype=x.dtype, device=x.device)
        v_ptr, v_sm, v_sb = diag_v, 0, 0
    ptrs = [x.data_ptr(), v_ptr, out.data_ptr(), *ptrs]
    ints = [M, B, *head, v_sm, v_sb, *tail]
    k = build.kernels()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(k.lib, f"chd_{kernel.__name__}")(
            DTYPES.index(x.dtype), MODES.index(mode), (ctypes.c_longlong * len(ptrs))(*ptrs),
            (ctypes.c_longlong * len(ints))(*ints), stream)
    build.check(k.lib, err, f"{kernel.__name__} launch")
    kernel.launches[mode] += 1
    return out
