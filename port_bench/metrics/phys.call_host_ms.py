"""The part of a physics call that its device stages do not cover, in ms:
the median over the window's calls of ``phys.call``'s host time less the
stream time from ``phys.fit``'s entry to ``phys.stage4``'s exit (the
duration specs' host work and copy, the rasterisation and flags between
the stages, and the flags' copy back)."""
import harness


def read(rec: dict):
    sp = harness.load("metrics", "_spans")
    snap = sp.snapshot()
    if snap is None:
        return None
    window = sp.window(snap, rec, "phys.call")
    calls = [r["call"] for r in window]
    fit, last = (sp.by_call(snap, n, calls) for n in ("phys.fit", "phys.stage4"))
    rest = []
    for r in window:
        a, b = fit.get(r["call"]), last.get(r["call"])
        if a and b and a["device_at_s"] is not None and b["device_at_s"] is not None:
            rest.append(r["host_s"] - (b["device_at_s"] + b["device_s"] - a["device_at_s"]))
    v = sp.median(rest)
    return None if v is None else 1e3 * v
