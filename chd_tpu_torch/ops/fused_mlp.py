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
``single_pass_gate`` tells the single-pass modes apart by them. The kernel
runs ``wgmma`` on 64-row tiles in persistent clusters of blocks that share
each stage of the split weights by a multicast bulk copy; the weights are a
stream of stages in the layout of ``pack_weights``, which ``MlpLayers``
builds once (``stream_index`` is its address function; see the source).

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
from ..utils.profiling import span

N_LAYERS = 5
SPLIT_LAYERS = 3  # layers 0-2 run in bf16 passes, 3-4 in f32
CHUNK = 128       # h1 columns per chunk of the fused layers 0 and 1
K0 = 64           # layer-0 inputs per stage of the weight stream
STAGE = 8192      # bf16 values of one part of a stage
D0_MAX = 768      # the widest joint set, ``full``, is 675
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


def _core_matrices(t: torch.Tensor) -> torch.Tensor:
    """(..., R, K) -> (..., R * K): each k16 slab of the (R, K) matrices
    after the last, in wgmma's no-swizzle K-major layout: 8-row groups, in
    each the two 8-wide k halves, in each 8 rows of 8 values."""
    *lead, rows, cols = t.shape
    n = len(lead)
    t = t.reshape(*lead, rows // 8, 8, cols // 16, 2, 8)
    return t.permute(*range(n), n + 2, n, n + 3, n + 1, n + 4).reshape(*lead, -1)


def stream_index(d0: int) -> torch.Tensor:
    """The kernel's weight stream as positions: (stages, STAGE) indices into
    ``cat(W0.T (1024, K0p), W1.T (512, 1024), W2.T (128, 512))`` flattened,
    K0p = d0 rounded up to K0 (W0's inputs past d0 are zeros), in the order a
    tile consumes the stages: for each CHUNK of h1 columns, layer 0's (CHUNK
    outputs, K0 inputs) stages, inputs ascending, then layer 1's (512
    outputs, 16 inputs) stages of the chunk's inputs; then layer 2's 8
    stages, for each half of its 128 outputs four of (the first consumer
    warpgroup's 64 inputs, the second's), each warpgroup's 256 inputs
    ascending. Each element of the three matrices appears exactly once."""
    h1, h2, h3 = HIDDEN[:SPLIT_LAYERS]
    k0p = -(-d0 // K0) * K0
    i0 = torch.arange(h1 * k0p).reshape(h1, k0p)
    i1 = i0.numel() + torch.arange(h2 * h1).reshape(h2, h1)
    i2 = i0.numel() + i1.numel() + torch.arange(h3 * h2).reshape(h3, h2)
    n_chunks = h1 // CHUNK
    t0 = _core_matrices(i0.reshape(n_chunks, CHUNK, k0p // K0, K0).transpose(1, 2))
    t1 = _core_matrices(i1.reshape(h2, n_chunks, CHUNK // 16, 16).permute(1, 2, 0, 3))
    t2 = _core_matrices(i2.reshape(2, h3 // 2, 2, 4, h2 // 8).permute(0, 3, 2, 1, 4))
    chunks = torch.cat([t0, t1], dim=1).reshape(-1, STAGE)
    return torch.cat([chunks, t2.reshape(-1, STAGE)])


def _tail_blocks(layers: Layers) -> torch.Tensor:
    """Layers 3 and 4 in float32 as the stream's last two STAGE-sized
    blocks, each viewed as bf16: w3 (in, out); then w4, b3 and b4, each
    padded with zeros to D5_MAX outputs."""
    (w3, b3), (w4, b4) = layers[SPLIT_LAYERS:]
    rest = torch.zeros(STAGE // 2, dtype=torch.float32, device=w3.device)
    w4p = torch.zeros((w4.shape[0], D5_MAX), dtype=torch.float32, device=w4.device)
    w4p[:, :w4.shape[1]] = w4
    n = w4p.numel()
    rest[:n] = w4p.flatten()
    rest[n:n + b3.numel()] = b3
    rest[n + D5_MAX:n + D5_MAX + b4.numel()] = b4
    return torch.stack([w3.contiguous().flatten(), rest]).view(torch.bfloat16)


def pack_weights(layers: Layers, parts: int = 2) -> torch.Tensor:
    """The kernel's stream of (parts, STAGE) bf16 stages: layers 0-2 in their
    split parts (largest first), laid out by ``stream_index``, in the order a
    tile consumes them and in their shared-memory layout; then
    ``_tail_blocks``, in one stage (parts 0 and 1, zeros after) or, at one
    part, in two."""
    (w0, _), (w1, _), (w2, _) = layers[:SPLIT_LAYERS]
    d0 = w0.shape[0]
    w0t = torch.zeros((w0.shape[1], -(-d0 // K0) * K0), dtype=w0.dtype, device=w0.device)
    w0t[:, :d0] = w0.T
    src = torch.cat([w0t.flatten(), w1.T.flatten(), w2.T.flatten()])
    idx = stream_index(d0).to(src.device)
    split = torch.stack([part[idx] for part in split_bf16(src, parts)], dim=1)
    tail = _tail_blocks(layers)
    if parts == 1:
        tail = tail[:, None]
    else:
        tail = torch.cat([tail, tail.new_zeros((parts - 2, STAGE))])[None]
    return torch.cat([split, tail]).contiguous()


class MlpLayers(list):
    """The five (w, b) layers in one of the kernel's ``MODES``, and the
    kernel's ``pack_weights`` of them, built at the first ``packed()`` and
    kept, so that a detector packs once and its calls only launch (the
    packing is the span ``fused_mlp.pack``). In ``"bf16"`` the layers are
    kept rounded to bf16. The tensors must not change after that."""

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
            with span("fused_mlp.pack"):
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
    want = (k.lib.chd_fused_mlp_tiles(width, mode_id), k.lib.chd_fused_mlp_parts(mode_id))
    if tuple(pack.shape[:2]) != want:
        raise RuntimeError(f"packed weights of {tuple(pack.shape[:2])} (tiles, parts), the "
                           f"kernel reads {want} in mode {mode!r}")
    n = (x.shape[1] - width) // row_stride + 1  # rows per group
    rows = x.shape[0] * n
    out = torch.empty((rows, dims[-1]), dtype=torch.float32, device=x.device)
    if rows == 0:
        return out
    (_, b0), (_, b1), (_, b2) = layers[:SPLIT_LAYERS]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = k.lib.chd_fused_mlp_forward(
            x.data_ptr(), rows, n, x.shape[1], row_stride, width, pack.data_ptr(),
            *(t.data_ptr() for t in (b0, b1, b2)), dims[-1], mode_id, out.data_ptr(), stream)
    build.check(k.lib, err, "fused_mlp launch")
    fused_mlp.launches += 1
    fused_mlp.mode_launches[mode] += 1
    return out


fused_mlp.launches = 0
fused_mlp.mode_launches = dict.fromkeys(MODES, 0)
