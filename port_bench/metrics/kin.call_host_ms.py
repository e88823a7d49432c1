"""The part of a kinematic call that its device stages do not cover, in
ms: the median over the window's calls of ``kin.call``'s host time less
the stream time from ``kin.ik``'s entry to ``kin.lm2``'s exit (host prep,
the copies both ways, the results' numpy work, and the device work after
the last stage)."""
import harness


def read(rec: dict):
    sp = harness.load("metrics", "_spans")
    snap = sp.snapshot()
    if snap is None:
        return None
    window = sp.window(snap, rec, "kin.call")
    calls = [r["call"] for r in window]
    ik, lm2 = (sp.by_call(snap, n, calls) for n in ("kin.ik", "kin.lm2"))
    rest = []
    for r in window:
        a, b = ik.get(r["call"]), lm2.get(r["call"])
        if a and b and a["device_at_s"] is not None and b["device_at_s"] is not None:
            rest.append(r["host_s"] - (b["device_at_s"] + b["device_s"] - a["device_at_s"]))
    v = sp.median(rest)
    return None if v is None else 1e3 * v
