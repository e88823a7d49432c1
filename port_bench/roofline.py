"""Operations and bytes of the work a cell asks for, counted once from its
shapes whatever implements it, and the least time the card could take.

The contact MLP: 2 x the multiply-adds of its five layers a window row; a
call of the detector has V x (F - W + 1) rows. Its bytes: the kernel's
input (the preprocessed frames), the model's weights in float32 and the
logits, each moved once. No implementation of any precision mode does less
work, so neither share can pass 100 % while the count and the time are
right.
"""
from __future__ import annotations

from typing import Sequence

from harness import BF16_PEAK, HBM_RATE


def mlp_dims(cfg: dict) -> list:
    m = cfg["model"]
    return [m["in_dim"], *m["hidden"], m["out_dim"]]


def mlp_flop_per_row(dims: Sequence[int]) -> int:
    return 2 * sum(a * b for a, b in zip(dims, dims[1:]))


def detect_rows(videos: int, frames: int, window: int) -> int:
    return videos * (frames - window + 1)


def detect_flop(cfg: dict, videos: int, frames: int) -> int:
    """FLOP of one detection call's MLP."""
    return mlp_flop_per_row(mlp_dims(cfg)) * detect_rows(videos, frames,
                                                          cfg["model"]["window_size"])


def mlp_kernel_bytes(cfg: dict, videos: int, frames: int) -> int:
    """Bytes the MLP kernel has to move at least: its input (the
    preprocessed frames of the joint set, x, y, confidence), the weights
    and biases in float32, and the float32 logits."""
    dims = mlp_dims(cfg)
    m = cfg["model"]
    x = videos * frames * len(m["joints"]) * 3
    w = sum(a * b + b for a, b in zip(dims, dims[1:]))
    out = detect_rows(videos, frames, m["window_size"]) * dims[-1]
    return 4 * (x + w + out)


def mlp_bound_s(cfg: dict, videos: int, frames: int) -> float:
    """The larger of the FLOP at the bf16 dense peak and the bytes at HBM's
    rate."""
    return max(detect_flop(cfg, videos, frames) / BF16_PEAK,
               mlp_kernel_bytes(cfg, videos, frames) / HBM_RATE)
