"""The host's time to launch one detection call, in ms: the median host
time of the program's ``detect.infer`` span over the window's calls (no
profiler watching)."""
import harness


def read(rec: dict):
    sp = harness.load("metrics", "_spans")
    snap = sp.snapshot()
    if snap is None:
        return None
    v = sp.median(r["host_s"] for r in sp.window(snap, rec, "detect.infer"))
    return None if v is None else 1e3 * v
