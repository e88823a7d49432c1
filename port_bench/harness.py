"""The harness's shared parts: finding a cell's files by name, the guard
against JAX, the card's description, and the reduction of a
``torch.profiler`` slice to busy time, idle share and a breakdown.

Everything that belongs to one configuration, cell, driver, traffic mix,
per-layer metric or reference sits in a file of its own under this folder,
found by its name:

- ``configs/<config>.json``: the configuration as it is run;
- ``workloads/<cell>.json``: its config, driver, traffic parameters;
- ``drivers/<driver>.py``: set-up, the timed window, the trace, the check;
- ``traffic/<generator>.py``: inputs made from the seed;
- ``metrics/<metric>.py``: ``read(record)``, one per-layer metric;
- ``reference/<name>.py``: the plain reference a check compares with.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Iterable, List, Optional, Sequence, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "chd_tpu")

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense).
BF16_PEAK = 989e12   # FLOP/s
HBM_RATE = 3.35e12   # B/s


def read_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def workload(name: str) -> dict:
    return read_json(os.path.join(HERE, "workloads", f"{name}.json"))


def config(name: str) -> dict:
    return read_json(os.path.join(HERE, "configs", f"{name}.json"))


def manifest() -> dict:
    return read_json(os.path.join(ROOT, "BENCHMARK.json"))


def load(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of this folder, loaded by its path
    under a name of its own (``port_bench.<kind>.<name>``)."""
    mod_name = f"port_bench.{kind}.{name}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The module names among ``names`` whose top-level name (the part
    before the first dot) is, whole, one of ``FORBIDDEN``: ``chd_tpu_torch``
    passes, ``chd_tpu`` and ``jax.numpy`` do not."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def correct(compared: Sequence[dict]) -> bool:
    """Whether every number a check compared lies within its limit."""
    return all(c["value"] <= c["limit"] for c in compared)


def per_layer_for(cell: str, man: dict) -> List[dict]:
    """The manifest's per-layer metrics that this cell reports."""
    return [m for m in man["per_layer"] if "workloads" not in m or cell in m["workloads"]]


def end_to_end_for(cell: str, man: dict) -> List[dict]:
    return [m for m in man["end_to_end"] if "workloads" not in m or cell in m["workloads"]]


def read_metrics(cell: str, man: dict, record: dict) -> dict:
    """Each per-layer metric of the cell read from the traced run's
    ``record`` by its own reader; a reader that finds nothing returns None
    and the metric is left out."""
    out = {}
    for m in per_layer_for(cell, man):
        value = load("metrics", m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def smi() -> dict:
    """The card as ``nvidia-smi`` reads it: name, SM clock, power draw and
    power limit (empty where it is missing)."""
    fields = "name,clocks.sm,power.draw,power.limit"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    line = out.strip().splitlines()[0] if out.strip() else ""
    return dict(zip(fields.split(","), (v.strip() for v in line.split(",")))) if line else {}


class Clock:
    """Seconds since the process began (the interpreter's start is taken
    as the harness's first line, before torch is imported)."""

    def __init__(self, t0: Optional[float] = None):
        self.t0 = time.perf_counter() if t0 is None else t0

    def __call__(self) -> float:
        return time.perf_counter() - self.t0


def sync(torch, device) -> None:
    """Wait for the device's work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# -- a torch.profiler slice ---------------------------------------------------

def union_s(intervals: Sequence[Tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Sequence[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


NAME_CHARS = 160  # a kernel's templated name cut to this many characters


def device_slice(events: Sequence[dict], host: Sequence[dict], wall_s: float) -> dict:
    """Busy seconds, idle share and breakdown of a profiled slice.

    ``events``: device work (kernels and copies) as dicts with ``name``,
    ``start`` and ``end`` in seconds; ``host``: host operations alike;
    ``wall_s``: the slice's length on the host clock. Busy is the union of
    the device intervals, and more than the slice's length fails; the idle
    gaps are named by the innermost host operation running at their
    middle. Names are cut to ``NAME_CHARS``."""
    iv = [(e["start"], e["end"]) for e in events]
    busy = union_s(iv)
    if busy > wall_s:
        raise RuntimeError(f"the device was busy {busy:.6f} s of a {wall_s:.6f} s slice: "
                           "the trace's events are miscounted")
    by_name: dict = {}
    for e in events:
        name = e["name"][:NAME_CHARS]
        by_name[name] = by_name.get(name, 0.0) + e["end"] - e["start"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    named = []
    if iv:
        lo, hi = min(s for s, _ in iv), max(e for _, e in iv)
        for s, e in sorted(gaps(iv, lo, hi), key=lambda g: g[0] - g[1])[:10]:
            mid = 0.5 * (s + e)
            over = [h for h in host if h["start"] <= mid <= h["end"]]
            label = min(over, key=lambda h: h["end"] - h["start"])["name"] if over else "(none)"
            named.append([label[:NAME_CHARS], e - s])
    return {"busy_s": busy, "window_s": wall_s,
            "idle_share": 1.0 - busy / wall_s,
            "device_ops": [[n, s] for n, s in top], "idle_gaps": named}


def profile(torch, fn) -> dict:
    """``fn()`` between two syncs under ``torch.profiler`` (host and
    device): its wall time, the device work and host operations it saw,
    its kernel launches, and ``device_slice``'s reduction of them."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    dev, host, launches = [], [], 0
    for e in prof.events():
        item = {"name": e.name, "start": e.time_range.start * 1e-6,
                "end": e.time_range.end * 1e-6}
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev.append(item)
        else:
            host.append(item)
            if e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                          "cudaGraphLaunch"):
                launches += 1
    out = device_slice(dev, host, wall)
    out.update(events=dev, launches=launches, kernels=len(dev))
    return out
