"""Vectorized One-Euro filter (port of chd_tpu/ingest/one_euro.py).

Speed-adaptive low-pass filter (Casiez/Roussel) over the leading time axis,
for every track at once. ``chd_tpu`` carries the filter state of all tracks
through a ``lax.scan``; here it is a loop over frames of batched tensor ops,
on the input's device (a numpy input goes to ``device``, which defaults to
``cuda`` and raises where CUDA is absent).

Parity rules, as in ``chd_tpu``: the first sample passes through unfiltered;
the derivative estimate at t=0 is 0; and with timestamps the sampling
frequency updates only when the last and the current timestamp are both
nonzero and a sample came before (the reference's truthiness guard
``if lasttime and timestamp``), so with integer timestamps it first updates
at the third sample.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.device import resolve_device


def _alpha(cutoff, freq):
    te = 1.0 / freq
    tau = 1.0 / (2.0 * math.pi * cutoff)
    return 1.0 / (1.0 + tau / te)


def one_euro_filter(x, freq=1.0, mincutoff=0.05, beta=0.4, dcutoff=1.0, timestamps=None,
                    device="cuda") -> torch.Tensor:
    """Filter ``x`` (F, ...) along the leading time axis.

    With ``timestamps`` (F,) given, reproduces the reference's per-call
    frequency update; otherwise uses the fixed ``freq``. A tensor ``x``
    stays on its device and in its dtype; an array goes to ``device``, as
    float64 if it is float64, else float32.
    """
    if isinstance(x, torch.Tensor):
        dtype = x.dtype if x.is_floating_point() else torch.float32
        x = x.to(dtype)
    else:
        x = np.asarray(x)
        dtype = torch.float64 if x.dtype == np.float64 else torch.float32
        x = torch.as_tensor(x, dtype=dtype, device=resolve_device(device))
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    # the frequency and the timestamps are host scalars in x's dtype (0-d
    # CPU tensors, which device ops take as scalars): no host sync
    f = torch.tensor(float(freq), dtype=dtype)
    ts = None if timestamps is None else torch.as_tensor(np.asarray(timestamps), dtype=dtype)
    out[0] = x[0]
    prev_x, s_x, s_dx = x[0], x[0], torch.zeros_like(x[0])
    for t in range(1, x.shape[0]):
        if ts is not None and ts[t - 1] != 0 and ts[t] != 0:
            f = 1.0 / (ts[t] - ts[t - 1])
        dx = (x[t] - prev_x) * f
        a_d = _alpha(dcutoff, f)
        s_dx = a_d * dx + (1.0 - a_d) * s_dx
        a_x = _alpha(mincutoff + beta * s_dx.abs(), f)
        s_x = a_x * x[t] + (1.0 - a_x) * s_x
        out[t] = s_x
        prev_x = x[t]
    return out


def filter_poses(poses, fcmin=0.05, beta=0.4, freq=1.0, device="cuda") -> torch.Tensor:
    """The reference's ``openpose_utils.filter_poses``: integer timestamps."""
    return one_euro_filter(poses, freq=freq, mincutoff=fcmin, beta=beta, dcutoff=1.0,
                           timestamps=np.arange(len(poses)), device=device)
