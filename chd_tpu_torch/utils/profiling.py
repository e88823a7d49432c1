"""Profiling and timing utilities (port of chd_tpu/utils/profiling.py).

A ``torch.profiler`` trace context that writes a Chrome trace (viewable in
Perfetto or TensorBoard's profiler plugin), and a timing harness that
forces materialization: a torch launch returns before the device has done
its work, so a harness that does not read a result back on the host times
the launches, not the work.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Device trace of the block: ``with trace('/tmp/tb'): f()``.

    Records CPU activity, and CUDA activity where CUDA is available; on
    exit writes ``<host>_<pid>.<ns>.pt.trace.json`` (a Chrome trace) under
    ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        torch.profiler.tensorboard_trace_handler(log_dir)(prof)


def _leaves(tree) -> Iterator[torch.Tensor]:
    """The tensors of a tree of tuples, lists, dicts, NamedTuples and
    dataclasses."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))


def _sync(tree):
    """Force full materialization via a scalar host read per device."""
    sums: Dict[torch.device, list] = {}
    for leaf in _leaves(tree):
        sums.setdefault(leaf.device, []).append(leaf.detach().to(torch.float32).abs().sum())
    for per_device in sums.values():
        float(torch.stack(per_device).sum())


def benchmark(fn: Callable, *args, warmup: int = 1, iters: int = 10) -> Dict[str, float]:
    """Wall-time a callable with its first call excluded and a hard sync."""
    out = fn(*args)
    for _ in range(max(warmup - 1, 0)):
        out = fn(*args)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync(out)
    dt = (time.perf_counter() - t0) / iters
    return {"mean_s": dt, "iters_per_s": 1.0 / dt}
