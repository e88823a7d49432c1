"""The BN-folded contact MLP as one hand-written CUDA kernel.

Replaces ``chd_tpu/ops/pallas_mlp.py::_kernel`` (``fused_mlp``), the Pallas
kernel that runs the whole folded MLP per 256-row batch tile with every weight
resident in VMEM. ``csrc/fused_mlp.cu`` runs layers 0-2 on the H100's tensor
cores in chd_tpu's ``precision="high"``: a 3-pass bf16 split with f32 sums
(``fused_mlp_split_plain`` is the same arithmetic in plain torch), and layers
3-4 in f32. A block keeps 64 rows' split activations in shared memory (a
first layer wider than 432, the ``full`` joint set, a 128-input slab at a
time) and streams the split weights from L2 through a ring of asynchronous
copies in the layout of ``pack_weights``, which ``MlpLayers`` builds once
(see the source).

The kernel reads its first-layer rows through strides: row (g, n) of the
batch is ``x[g, n * row_stride : n * row_stride + width]`` of a contiguous
(G, L) input. With ``row_stride == width`` (or G rows of length width) that
is a plain (B, in) batch; with x the preprocessed frames (V, F * J * 3),
``width = W * J * 3`` and ``row_stride = J * 3`` it is every window of every
video, and with ``windows.layer1_conv_kernel`` as the first weight the kernel
computes the conv-fused path without materializing the windows.

``layers`` is a sequence of five (w (in, out), b (out,)) float32 tensors.
On a CPU tensor ``fused_mlp`` runs ``fused_mlp_plain`` (full f32); on a CUDA
tensor it launches the kernel, which takes ``MlpLayers``, or raises.
``fused_mlp.launches`` counts the launches.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..models.contact_mlp import HIDDEN
from ..utils import build

N_LAYERS = 5
SPLIT_LAYERS = 3  # layers 0-2 run in the 3-pass bf16 split, 3-4 in f32
CHUNK = 64        # h1 columns per chunk of the fused layers 0 and 1
D0_MAX = 768      # six layer-0 tiles; the widest joint set, ``full``, is 675
D5_MAX = 32

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


def split_bf16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 x -> bf16 (hi, lo), each rounded to nearest even, with
    hi + lo == x to within 2**-16 relative."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def _split_addmm(b: torch.Tensor, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """b + h @ w as three bf16 passes (lo*hi, hi*lo, hi*hi): each product of
    two bf16 values is exact in float32, the sums are float32."""
    hh, hl = split_bf16(h)
    wh, wl = split_bf16(w)
    out = torch.addmm(b, hl.float(), wh.float())
    out.addmm_(hh.float(), wl.float())
    return out.addmm_(hh.float(), wh.float())


def fused_mlp_split_plain(layers: Layers, x: torch.Tensor, width: int,
                          row_stride: int) -> torch.Tensor:
    """The kernel's arithmetic in plain torch, roundings included: layers 0-2
    in the 3-pass bf16 split, 3-4 in float32. For tests; the main path does
    not call it."""
    h = x.unfold(1, width, row_stride).reshape(-1, width)
    for i, (w, b) in enumerate(layers):
        h = _split_addmm(b, h, w) if i < SPLIT_LAYERS else torch.addmm(b, h, w)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


def _split_tiles(w: torch.Tensor, n_tile: int, k_tile: int) -> torch.Tensor:
    """(K, N) float32 -> (N / n_tile, ceil(K / k_tile), 2, n_tile, k_tile / 8,
    8) bf16: tiles of w.T split hi then lo, (out, in) rows in 16-byte chunks,
    inputs past K zero."""
    K, N = w.shape
    wt = torch.zeros((N, -(-K // k_tile) * k_tile), dtype=w.dtype, device=w.device)
    wt[:, :K] = w.T
    hl = torch.stack(split_bf16(wt))  # (2, N, Kp)
    return hl.reshape(2, N // n_tile, n_tile, -1, k_tile // 8, 8).permute(1, 3, 0, 2, 4, 5)


def _swizzle(t: torch.Tensor, row_bits) -> torch.Tensor:
    """Chunk c of row r of each tile moved to chunk c ^ row_bits(r), the
    kernel's conflict-free shared-memory layout."""
    r = torch.arange(t.shape[-3], device=t.device)[:, None]
    c = torch.arange(t.shape[-2], device=t.device)[None, :]
    return t[..., r, c ^ row_bits(r), :]


def pack_weights(layers: Layers) -> torch.Tensor:
    """Layers 0-2 as the kernel's stream of (2, 8192) bf16 tiles (hi, lo), in
    the order a block consumes them and in its shared-memory layout: for each
    chunk of CHUNK h1 columns, layer 0's (64 outputs, 128 inputs) tiles of
    those outputs, inputs ascending, then layer 1's (512 outputs, 16 inputs)
    tiles of those inputs, ascending; then layer 2's (64, 128) tiles, inputs
    outer. Rows are (out, in), their 16-byte chunks XOR-swizzled by row."""
    (w0, _), (w1, _), (w2, _) = layers[:SPLIT_LAYERS]
    t0 = _swizzle(_split_tiles(w0, 64, 128), lambda r: r & 7)
    t1 = _swizzle(_split_tiles(w1, w1.shape[1], 16), lambda r: (r >> 2) & 1)
    t2 = _swizzle(_split_tiles(w2, 64, 128), lambda r: r & 7)
    n_chunks = w0.shape[1] // CHUNK
    chunks = torch.cat([t0.reshape(n_chunks, -1, 2, 8192),
                        t1.reshape(n_chunks, -1, 2, 8192)], dim=1)
    return torch.cat([chunks.reshape(-1, 2, 8192),
                      t2.transpose(0, 1).reshape(-1, 2, 8192)]).contiguous()


class MlpLayers(list):
    """The five (w, b) layers, and the kernel's ``pack_weights`` of them,
    built at the first ``packed()`` and kept, so that a detector packs once
    and its calls only launch. The tensors must not change after that."""

    _packed: Optional[torch.Tensor] = None

    def packed(self) -> torch.Tensor:
        if self._packed is None:
            self._packed = pack_weights(self)
        return self._packed


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
    dims = [width] + [w.shape[1] for w, _ in layers]
    if tuple(dims[1:-1]) != HIDDEN or width > D0_MAX or dims[-1] > D5_MAX:
        raise ValueError(f"the kernel takes widths (<= {D0_MAX}, {', '.join(map(str, HIDDEN))}, "
                         f"<= {D5_MAX}), got {dims}")
    if not isinstance(layers, MlpLayers):
        raise TypeError("on CUDA fused_mlp takes MlpLayers, which keep the packed weights")
    k = build.kernels()
    pack = layers.packed()
    if pack.shape[0] != k.lib.chd_fused_mlp_tiles(width):
        raise RuntimeError(f"{pack.shape[0]} packed weight tiles, the kernel "
                           f"reads {k.lib.chd_fused_mlp_tiles(width)}")
    n = (x.shape[1] - width) // row_stride + 1  # rows per group
    rows = x.shape[0] * n
    out = torch.empty((rows, dims[-1]), dtype=torch.float32, device=x.device)
    if rows == 0:
        return out
    (_, b0), (_, b1), (_, b2), (w3, b3), (w4, b4) = layers
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = k.lib.chd_fused_mlp_forward(
            x.data_ptr(), rows, n, x.shape[1], row_stride, width, pack.data_ptr(),
            *(t.data_ptr() for t in (b0, b1, b2, w3, b3, w4, b4)), dims[-1],
            out.data_ptr(), stream)
    build.check(k.lib, err, "fused_mlp launch")
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0
