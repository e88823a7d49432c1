"""The program's own spans, as the per-layer metrics of this folder read
them: ``chd_tpu_torch.utils.profiling.snapshot()``, taken after the traced
slice. A program without spans gives None, and so does every reader.

A cell's window is the last ``record["calls"]`` readings of its call's
outermost span that no ``torch.profiler`` was watching: the set-up's calls
come before them and the traced slice's are profiled (or, for the
kinematic stages, replayed from outside the call and recorded by no span).
"""
from __future__ import annotations

import statistics


def snapshot():
    """The program's spans and counters, or None where it has none."""
    try:
        from chd_tpu_torch.utils import profiling
    except ImportError:
        return None
    snap = getattr(profiling, "snapshot", None)
    return snap() if snap is not None else None


def readings(snap, name: str) -> list:
    return snap["spans"].get(name, {}).get("readings", [])


def window(snap, rec: dict, root: str) -> list:
    """The readings of ``root`` (a call's outermost span) in the window."""
    calls = rec.get("calls")
    if not calls:
        return []
    return [r for r in readings(snap, root) if not r["profiled"]][-calls:]


def by_call(snap, name: str, calls) -> dict:
    """``name``'s readings of the calls ``calls`` (ids), by call id."""
    ids = set(calls)
    return {r["call"]: r for r in readings(snap, name) if r["call"] in ids}


def median(values):
    values = [v for v in values if v is not None]
    return statistics.median(values) if values else None


def device_ms(rec: dict, root: str, name: str):
    """The median device time of ``name`` in the window's calls, in ms."""
    snap = snapshot()
    if snap is None:
        return None
    calls = [r["call"] for r in window(snap, rec, root)]
    v = median(r["device_s"] for r in by_call(snap, name, calls).values())
    return None if v is None else 1e3 * v
