"""The host seconds of every CUDA graph capture inside the run's physics
calls (the program's ``graphs.capture`` spans of a ``phys.call``): all of
them fall in set-up, since a capture in the window fails the run."""
import harness


def read(rec: dict):
    sp = harness.load("metrics", "_spans")
    snap = sp.snapshot()
    if snap is None:
        return None
    calls = {r["call"] for r in sp.readings(snap, "phys.call")}
    caps = [r["host_s"] for r in sp.readings(snap, "graphs.capture") if r["call"] in calls]
    return sum(caps) if caps else None
