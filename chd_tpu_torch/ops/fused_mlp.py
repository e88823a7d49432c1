"""The BN-folded contact MLP as one hand-written CUDA kernel.

Replaces ``chd_tpu/ops/pallas_mlp.py::_kernel`` (``fused_mlp``), the Pallas
kernel that runs the whole folded MLP per 256-row batch tile with every weight
resident in VMEM. On an H100 the 3.8 MB of f32 weights do not fit in a
block's 227 KB of shared memory, so ``csrc/fused_mlp.cu`` keeps only a
32-row tile's activations in shared memory and streams each weight from L2
once per tile: L2 weight traffic per row tile, and the FP32 FMAs each weight
read feeds, bound it (see the source).

The kernel reads its first-layer rows through strides: row (g, n) of the
batch is ``x[g, n * row_stride : n * row_stride + width]`` of a contiguous
(G, L) input. With ``row_stride == width`` (or G rows of length width) that
is a plain (B, in) batch; with x the preprocessed frames (V, F * J * 3),
``width = W * J * 3`` and ``row_stride = J * 3`` it is every window of every
video, and with ``windows.layer1_conv_kernel`` as the first weight the kernel
computes the conv-fused path without materializing the windows.

``layers`` is a sequence of five (w (in, out), b (out,)) float32 tensors.
On a CPU tensor ``fused_mlp`` runs ``fused_mlp_plain``; on a CUDA tensor it
launches the kernel or raises. ``fused_mlp.launches`` counts the launches.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..utils import build

N_LAYERS = 5
MAX_SMEM_BYTES = 232448  # dynamic shared memory one block may use on sm_90

Layers = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def fused_mlp_plain(layers: Layers, x: torch.Tensor, width: int,
                    row_stride: int) -> torch.Tensor:
    """The kernel's math in plain torch: (G * N, out) logits."""
    h = x.unfold(1, width, row_stride).reshape(-1, width)
    for i, (w, b) in enumerate(layers):
        h = torch.addmm(b, h, w)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


def _check(layers: Layers, x: torch.Tensor, width: int, row_stride: int) -> None:
    if len(layers) != N_LAYERS:
        raise ValueError(f"expected {N_LAYERS} layers, got {len(layers)}")
    tensors = [x] + [t for wb in layers for t in wb]
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"fused_mlp takes float32 tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("fused_mlp takes contiguous tensors")
        if t.device != x.device:
            raise ValueError(f"tensors on {t.device} and {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be (groups, length), got shape {tuple(x.shape)}")
    if row_stride < 1 or not 1 <= width <= x.shape[1]:
        raise ValueError(f"width {width} / row_stride {row_stride} do not fit "
                         f"rows of length {x.shape[1]}")
    d_in = width
    for i, (w, b) in enumerate(layers):
        if w.dim() != 2 or w.shape[0] != d_in or tuple(b.shape) != (w.shape[1],):
            raise ValueError(f"layer {i}: w {tuple(w.shape)}, b {tuple(b.shape)} "
                             f"do not take a {d_in}-wide input")
        d_in = w.shape[1]


def fused_mlp(layers: Layers, x: torch.Tensor, width: int,
              row_stride: int) -> torch.Tensor:
    """Logits (G * N, out) of the folded MLP on the strided rows of x (G, L),
    N = (L - width) // row_stride + 1 rows per group."""
    _check(layers, x, width, row_stride)
    if x.device.type == "cpu":
        return fused_mlp_plain(layers, x, width, row_stride)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp runs on cpu or cuda, not {x.device}")
    k = build.kernels()
    dims = [width] + [w.shape[1] for w, _ in layers]
    smem = k.lib.chd_fused_mlp_smem_bytes(*dims)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"widths {dims} need {smem} B of shared memory per block")
    n = (x.shape[1] - width) // row_stride + 1  # rows per group
    rows = x.shape[0] * n
    out = torch.empty((rows, dims[-1]), dtype=torch.float32, device=x.device)
    if rows == 0:
        return out
    ptrs = [t.data_ptr() for wb in layers for t in wb]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = k.lib.chd_fused_mlp_forward(
            x.data_ptr(), rows, n, x.shape[1], row_stride, *ptrs, *dims,
            out.data_ptr(), stream)
    build.check(k.lib, err, "fused_mlp launch")
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0
