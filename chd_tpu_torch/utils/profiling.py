"""Profiling and timing utilities (port of chd_tpu/utils/profiling.py).

A ``torch.profiler`` trace context that writes a Chrome trace (viewable in
Perfetto or TensorBoard's profiler plugin), and a timing harness that
forces materialization: a torch launch returns before the device has done
its work, so a harness that does not read a result back on the host times
the launches, not the work.

The program's own spans and counters live here too, always on:
``with span("kin.ik"): ...`` records one reading per entry (its parent
span, the id of the call it belongs to, its host time, and on sampled
entries the CUDA stream time between its entry and its exit), kept in
memory and read by ``snapshot()``. Device timing never syncs the host: the
event pairs are resolved when the readings are read. While a
``torch.profiler`` is active each span is also a ``record_function``
range, so ``trace``'s Chrome trace shows the program's stages over its
kernels.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Callable, Dict, Iterator, Optional

import torch

SAMPLE_NS = 50_000_000  # a span name times the device at most once in this much host time
KEEP = 256              # readings kept a span name


class _Stat:
    """Count, total host time and the last ``KEEP`` readings of one name."""

    __slots__ = ("count", "host_ns", "readings", "sampled_ns")

    def __init__(self):
        self.count = 0
        self.host_ns = 0
        self.readings = collections.deque(maxlen=KEEP)
        self.sampled_ns = None  # host time of the last entry that could time the device


class _Open(threading.local):
    def __init__(self):
        self.stack = []  # the spans open on this thread, outermost first


class Registry:
    """Spans' readings and counters of a process. ``clock`` gives host
    nanoseconds (``time.perf_counter_ns``)."""

    def __init__(self, clock: Callable[[], int] = time.perf_counter_ns):
        self.clock = clock
        self.spans: Dict[str, _Stat] = {}
        self.counters: Dict[str, float] = {}
        self.open = _Open()
        self._calls = itertools.count(1)
        self._lock = threading.Lock()

    def stat(self, name: str) -> _Stat:
        st = self.spans.get(name)
        if st is None:
            with self._lock:
                st = self.spans.setdefault(name, _Stat())
        return st

    def count(self, name: str, n: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        self.counters[name] = value

    def snapshot(self) -> dict:
        """``{"spans": {name: {"count", "host_s", "readings": [...]}},
        "counters": {...}}``, each reading a dict (``span.reading``) with
        its device times resolved: this waits for the events it reads."""
        with self._lock:
            stats = list(self.spans.items())
            counters = dict(self.counters)
        return {"spans": {name: {"count": st.count, "host_s": st.host_ns * 1e-9,
                                 "readings": [s.reading() for s in list(st.readings)]}
                          for name, st in stats},
                "counters": counters}

    def reset(self) -> None:
        with self._lock:
            self.spans.clear()
            self.counters.clear()
            self._calls = itertools.count(1)


REGISTRY = Registry()


def _can_time_device() -> bool:
    """CUDA events can be recorded: CUDA is initialised and the current
    stream is not being captured into a graph."""
    return torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing()


class span:
    """``with span("kin.ik", steps=40) as s: ...``: one reading of ``name``
    per entry, kept in ``REGISTRY``. ``s.attrs`` may gain keys inside the
    block; ``s.host_s`` is the block's host seconds after it.

    The reading's ``call`` is the sequence number of the outermost span
    open at its entry, so every span of one call shares it. A name times
    the device, a pair of CUDA events on the current stream, on its first
    entry and after that at most once every ``SAMPLE_NS`` of host time,
    never where CUDA is not initialised and never while the stream is
    being captured: ``device_s`` is the stream time between its entry and
    its exit, ``device_at_s`` the stream time from the call's outermost
    span's entry (where that span timed the device too) to its own. While a
    ``torch.profiler`` is active the block is also a ``record_function``
    range, and the reading is marked ``profiled``."""

    __slots__ = ("name", "attrs", "parent", "call", "start_ns", "end_ns", "profiled",
                 "device_s", "device_at_s", "_events", "_ev0", "_root", "_range", "_stat")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self.end_ns = None

    def __enter__(self) -> "span":
        reg = REGISTRY
        stack = reg.open.stack
        if stack:
            outer = stack[-1]
            self.parent, self.call, self._root = outer.name, outer.call, stack[0]._ev0
        else:
            self.parent, self.call, self._root = None, next(reg._calls), None
        self.profiled = torch.autograd._profiler_enabled()
        self._range = None
        if self.profiled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._ev0 = self._events = self.device_s = self.device_at_s = None
        st = self._stat = reg.stat(self.name)
        now = reg.clock()
        if st.sampled_ns is None or now - st.sampled_ns >= SAMPLE_NS:
            st.sampled_ns = now
            if _can_time_device():
                self._ev0 = torch.cuda.Event(enable_timing=True)
                self._ev0.record()
                if not stack:
                    self._root = self._ev0
        stack.append(self)
        self.start_ns = reg.clock()
        return self

    def __exit__(self, *exc) -> None:
        reg = REGISTRY
        self.end_ns = reg.clock()
        if self._ev0 is not None and _can_time_device():
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record()
            self._events = (self._ev0, ev1, self._root)
        self._ev0 = self._root = None
        reg.open.stack.pop()
        st = self._stat
        st.count += 1
        st.host_ns += self.end_ns - self.start_ns
        st.readings.append(self)
        if self._range is not None:
            self._range.__exit__(None, None, None)

    @property
    def host_s(self) -> Optional[float]:
        return None if self.end_ns is None else (self.end_ns - self.start_ns) * 1e-9

    def reading(self) -> dict:
        """The reading as a dict, its event pair resolved into
        ``device_s`` and ``device_at_s`` (waiting for the exit event)."""
        if self._events is not None:
            ev0, ev1, root = self._events
            ev1.synchronize()
            self.device_s = ev0.elapsed_time(ev1) * 1e-3
            self.device_at_s = root.elapsed_time(ev0) * 1e-3 if root is not None else None
            self._events = None
        return {"name": self.name, "parent": self.parent, "call": self.call,
                "start_ns": self.start_ns, "end_ns": self.end_ns, "host_s": self.host_s,
                "attrs": dict(self.attrs), "device_s": self.device_s,
                "device_at_s": self.device_at_s, "profiled": self.profiled}


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    REGISTRY.count(name, n)


def gauge(name: str, value: float) -> None:
    """Set the counter ``name`` to ``value``."""
    REGISTRY.gauge(name, value)


def snapshot() -> dict:
    """Every span's count, host seconds and last readings, and the
    counters (``Registry.snapshot``)."""
    return REGISTRY.snapshot()


def reset() -> None:
    """Forget every reading and counter."""
    REGISTRY.reset()


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
