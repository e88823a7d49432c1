"""The BN-folded contact MLP as one hand-written CUDA kernel.

Replaces ``chd_tpu/ops/pallas_mlp.py::_kernel`` (``fused_mlp``), the Pallas
kernel that runs the whole folded MLP per 256-row batch tile with every weight
resident in VMEM. ``csrc/fused_mlp.cu`` runs layers 0-2 on the H100's tensor
cores in one of chd_tpu's matmul precisions, a ``mode`` of ``MlpLayers``
(``mlp_mode`` maps the detector's ``precision`` and ``mlp_dtype`` to it):

- ``"default"`` (``precision=None`` or ``"default"``): one bf16 pass;
- ``"high"``: the 3-pass bf16 split (hi, lo) with f32 sums;
- ``"highest"``: the 6-pass split into three bf16 parts;
- ``"bf16"`` (``mlp_dtype=torch.bfloat16``): bf16 storage, one pass, each
  layer's sum and its bias-added value rounded to bf16.

Layers 3-4 run in f32 (with bf16 roundings in ``"bf16"``).
``fused_mlp_split_plain`` (by pass count) and ``fused_mlp_bf16_plain`` are
the same arithmetic in plain torch (``emulation(mode)``), and
``single_pass_gate`` tells the single-pass modes apart by them. A block
keeps 64 rows' activations in shared memory (a first layer wider than 432,
the ``full`` joint set, a 128-input slab at a time) and streams the split
weights from L2 through a ring of asynchronous copies in the layout of
``pack_weights``, which ``MlpLayers`` builds once (see the source).

The kernel reads its first-layer rows through strides: row (g, n) of the
batch is ``x[g, n * row_stride : n * row_stride + width]`` of a contiguous
(G, L) input. With ``row_stride == width`` (or G rows of length width) that
is a plain (B, in) batch; with x the preprocessed frames (V, F * J * 3),
``width = W * J * 3`` and ``row_stride = J * 3`` it is every window of every
video, and with ``windows.layer1_conv_kernel`` as the first weight the kernel
computes the conv-fused path without materializing the windows.

``layers`` is a sequence of five (w (in, out), b (out,)) float32 tensors.
On a CPU tensor ``fused_mlp`` runs the plain version: full f32 in every
precision, as chd_tpu's matmuls are on the CPU, and the bf16 roundings in
``"bf16"``. On a CUDA tensor it launches the kernel, which takes
``MlpLayers``, or raises. ``fused_mlp.launches`` counts the launches, and
``fused_mlp.mode_launches`` counts them by mode.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..models.contact_mlp import HIDDEN
from ..utils import build

N_LAYERS = 5
SPLIT_LAYERS = 3  # layers 0-2 run in bf16 passes, 3-4 in f32
CHUNK = 64        # h1 columns per chunk of the fused layers 0 and 1
D0_MAX = 768      # six layer-0 tiles; the widest joint set, ``full``, is 675
D5_MAX = 32

# The kernel's modes, in the order of its ``mode`` argument; the bf16 parts
# of each operand a mode reads, and its passes: (activation part, weight
# part) products, smallest first, as the kernel sums them.
MODES = ("default", "high", "highest", "bf16")
PARTS = {"default": 1, "high": 2, "highest": 3, "bf16": 1}
PASS_ORDER = {1: ((0, 0),),
              3: ((1, 0), (0, 1), (0, 0)),
              6: ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))}
PASSES = {"default": 1, "high": 3, "highest": 6, "bf16": 1}
PRECISIONS = (None, "default", "high", "highest")
# single_pass_gate: a single-pass kernel's mean distance to its emulation, at
# most 1/GATE_SHARE of that emulation's mean distance to the nearest other
# mode's
GATE_SHARE = 8

Layers = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def mlp_mode(precision: Optional[str] = "high", mlp_dtype=None) -> str:
    """The kernel mode of chd_tpu's detector arguments: ``precision`` None,
    "default", "high" or "highest", and ``mlp_dtype`` None or
    ``torch.bfloat16`` (bf16 storage, whatever the precision). Raises for
    anything else."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, not {precision!r}")
    if mlp_dtype is None:
        return "default" if precision is None else precision
    if mlp_dtype == torch.bfloat16:
        return "bf16"
    raise ValueError(f"mlp_dtype must be None or torch.bfloat16, not {mlp_dtype!r}")


def fused_mlp_plain(layers: Layers, x: torch.Tensor, width: int,
                    row_stride: int) -> torch.Tensor:
    """The kernel's math in plain torch: (G * N, out) logits."""
    h = x.unfold(1, width, row_stride).reshape(-1, width)
    for i, (w, b) in enumerate(layers):
        h = torch.addmm(b, h, w)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def fused_mlp_bf16_plain(layers: Layers, x: torch.Tensor, width: int,
                         row_stride: int) -> torch.Tensor:
    """The ``"bf16"`` mode in plain torch: inputs, weights and biases
    rounded to bf16; each layer's float32 sum rounded to bf16, the bias
    added and the sum rounded again, then the ReLU (chd_tpu's bf16 dot and
    add)."""
    h = _bf16(x.unfold(1, width, row_stride).reshape(-1, width))
    for i, (w, b) in enumerate(layers):
        h = _bf16(_bf16(h @ _bf16(w)) + _bf16(b))
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


def split_bf16(x: torch.Tensor, parts: int = 2) -> Tuple[torch.Tensor, ...]:
    """float32 x -> ``parts`` bf16 parts a1 = bf16(x), a2 = bf16(x - a1),
    a3 = bf16(x - a1 - a2), each rounded to nearest even (each difference is
    exact in float32); two parts give x to within 2**-16 relative."""
    out, r = [], x
    for _ in range(parts):
        out.append(r.to(torch.bfloat16))
        r = r - out[-1].float()
    return tuple(out)


def _split_addmm(b: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                 passes: int) -> torch.Tensor:
    """b + h @ w as ``passes`` bf16 passes in the kernel's order: each
    product of two bf16 values is exact in float32, the sums are float32."""
    order = PASS_ORDER[passes]
    n = 1 + max(max(q) for q in order)
    hs = [t.float() for t in split_bf16(h, n)]
    ws = [t.float() for t in split_bf16(w, n)]
    out = b
    for pa, pb in order:
        out = torch.addmm(out, hs[pa], ws[pb])
    return out


def fused_mlp_split_plain(layers: Layers, x: torch.Tensor, width: int, row_stride: int,
                          passes: Optional[int] = None) -> torch.Tensor:
    """The kernel's arithmetic in plain torch, roundings included: layers 0-2
    in ``passes`` bf16 passes (1, 3 or 6; by default those of the layers'
    mode, or 3), 3-4 in float32. For tests; the main path does not call
    it."""
    if passes is None:
        passes = PASSES[getattr(layers, "mode", "high")]
    if passes not in PASS_ORDER:
        raise ValueError(f"passes must be one of {sorted(PASS_ORDER)}, not {passes}")
    h = x.unfold(1, width, row_stride).reshape(-1, width)
    for i, (w, b) in enumerate(layers):
        h = _split_addmm(b, h, w, passes) if i < SPLIT_LAYERS else torch.addmm(b, h, w)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


def emulation(mode: str) -> Callable:
    """The kernel's arithmetic in ``mode`` in plain torch, with
    ``fused_mlp``'s arguments: ``fused_mlp_split_plain`` at the mode's
    passes, or ``fused_mlp_bf16_plain``. For tests."""
    if mode == "bf16":
        return fused_mlp_bf16_plain
    return functools.partial(fused_mlp_split_plain, passes=PASSES[mode])


def single_pass_gate(got: torch.Tensor, layers: Layers, x: torch.Tensor, width: int,
                     row_stride: int, mode: str) -> dict:
    """Whether ``got``, the kernel's logits in a single-pass ``mode``
    ("default" or "bf16") on these arguments, are that mode's and no other's.

    One pass sums in another order than its emulation, so a hidden value can
    round to the neighbouring bf16 and a few logits move by a few bf16
    roundings; their largest difference is then as large as the distance to
    another mode, their mean stays far below it. ``limit[m]`` is
    1/GATE_SHARE of the mean |difference| between mode m's emulation and the
    nearest other mode's on the same rows. The gate (``ok``): mean |got -
    emulation(mode)| <= limit[mode]. The controls (``controls_fail``): the
    same gate with any other mode n's emulation and limit[n] fails. Returns
    those two and ``mean`` and ``limit``, by mode. For tests."""
    emus = {m: emulation(m)(layers, x, width, row_stride) for m in MODES}
    limit = {a: min((emus[a] - emus[b]).abs().mean().item() for b in MODES if b != a)
             / GATE_SHARE for a in MODES}
    mean = {m: (got - emus[m]).abs().mean().item() for m in MODES}
    return {"mean": mean, "limit": limit, "ok": mean[mode] <= limit[mode],
            "controls_fail": all(mean[n] > limit[n] for n in MODES if n != mode)}


def _split_tiles(w: torch.Tensor, n_tile: int, k_tile: int, parts: int) -> torch.Tensor:
    """(K, N) float32 -> (N / n_tile, ceil(K / k_tile), parts, n_tile,
    k_tile / 8, 8) bf16: tiles of w.T split into parts, (out, in) rows in
    16-byte chunks, inputs past K zero."""
    K, N = w.shape
    wt = torch.zeros((N, -(-K // k_tile) * k_tile), dtype=w.dtype, device=w.device)
    wt[:, :K] = w.T
    ps = torch.stack(split_bf16(wt, parts))  # (parts, N, Kp)
    return ps.reshape(parts, N // n_tile, n_tile, -1, k_tile // 8, 8).permute(1, 3, 0, 2, 4, 5)


def _swizzle(t: torch.Tensor, row_bits) -> torch.Tensor:
    """Chunk c of row r of each tile moved to chunk c ^ row_bits(r), the
    kernel's conflict-free shared-memory layout."""
    r = torch.arange(t.shape[-3], device=t.device)[:, None]
    c = torch.arange(t.shape[-2], device=t.device)[None, :]
    return t[..., r, c ^ row_bits(r), :]


def pack_weights(layers: Layers, parts: int = 2) -> torch.Tensor:
    """Layers 0-2 as the kernel's stream of (parts, 8192) bf16 tiles (the
    split parts, largest first), in the order a block consumes them and in
    its shared-memory layout: for each chunk of CHUNK h1 columns, layer 0's
    (64 outputs, 128 inputs) tiles of those outputs, inputs ascending, then
    layer 1's (512 outputs, 16 inputs) tiles of those inputs, ascending; then
    layer 2's (64, 128) tiles, inputs outer. Rows are (out, in), their
    16-byte chunks XOR-swizzled by row."""
    (w0, _), (w1, _), (w2, _) = layers[:SPLIT_LAYERS]
    t0 = _swizzle(_split_tiles(w0, 64, 128, parts), lambda r: r & 7)
    t1 = _swizzle(_split_tiles(w1, w1.shape[1], 16, parts), lambda r: (r >> 2) & 1)
    t2 = _swizzle(_split_tiles(w2, 64, 128, parts), lambda r: r & 7)
    n_chunks = w0.shape[1] // CHUNK
    chunks = torch.cat([t0.reshape(n_chunks, -1, parts, 8192),
                        t1.reshape(n_chunks, -1, parts, 8192)], dim=1)
    return torch.cat([chunks.reshape(-1, parts, 8192),
                      t2.transpose(0, 1).reshape(-1, parts, 8192)]).contiguous()


class MlpLayers(list):
    """The five (w, b) layers in one of the kernel's ``MODES``, and the
    kernel's ``pack_weights`` of them, built at the first ``packed()`` and
    kept, so that a detector packs once and its calls only launch. In
    ``"bf16"`` the layers are kept rounded to bf16. The tensors must not
    change after that."""

    _packed: Optional[torch.Tensor] = None

    def __init__(self, layers: Layers = (), mode: str = "high"):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
        layers = list(layers)
        if mode == "bf16":
            layers = [(_bf16(w), _bf16(b)) for w, b in layers]
        super().__init__(layers)
        self.mode = mode

    def packed(self) -> torch.Tensor:
        if self._packed is None:
            self._packed = pack_weights(self, PARTS[self.mode])
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
    N = (L - width) // row_stride + 1 rows per group, in the mode of
    ``layers`` ("high" for a plain sequence)."""
    _check(layers, x, width, row_stride)
    mode = getattr(layers, "mode", "high")
    if x.device.type == "cpu":
        plain = fused_mlp_bf16_plain if mode == "bf16" else fused_mlp_plain
        return plain(layers, x, width, row_stride)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp runs on cpu or cuda, not {x.device}")
    dims = [width] + [w.shape[1] for w, _ in layers]
    if tuple(dims[1:-1]) != HIDDEN or width > D0_MAX or dims[-1] > D5_MAX:
        raise ValueError(f"the kernel takes widths (<= {D0_MAX}, {', '.join(map(str, HIDDEN))}, "
                         f"<= {D5_MAX}), got {dims}")
    if not isinstance(layers, MlpLayers):
        raise TypeError("on CUDA fused_mlp takes MlpLayers, which keep the packed weights")
    k = build.kernels()
    mode_id = MODES.index(mode)
    pack = layers.packed()
    want = (k.lib.chd_fused_mlp_tiles(width), k.lib.chd_fused_mlp_parts(mode_id))
    if tuple(pack.shape[:2]) != want:
        raise RuntimeError(f"packed weights of {tuple(pack.shape[:2])} (tiles, parts), the "
                           f"kernel reads {want} in mode {mode!r}")
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
            *(t.data_ptr() for t in (b0, b1, b2, w3, b3, w4, b4)), dims[-1], mode_id,
            out.data_ptr(), stream)
    build.check(k.lib, err, "fused_mlp launch")
    fused_mlp.launches += 1
    fused_mlp.mode_launches[mode] += 1
    return out


fused_mlp.launches = 0
fused_mlp.mode_launches = dict.fromkeys(MODES, 0)
