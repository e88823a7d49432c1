"""The two LM stages inside the window's kinematic calls, in ms a step:
the median over calls of the stream time of ``kin.lm1`` and ``kin.lm2``
over their ``steps``."""
import harness


def read(rec: dict):
    sp = harness.load("metrics", "_spans")
    snap = sp.snapshot()
    if snap is None:
        return None
    calls = [r["call"] for r in sp.window(snap, rec, "kin.call")]
    lm1, lm2 = (sp.by_call(snap, n, calls) for n in ("kin.lm1", "kin.lm2"))
    per_step = []
    for c in calls:
        a, b = lm1.get(c), lm2.get(c)
        if a and b and a["device_s"] is not None and b["device_s"] is not None:
            per_step.append((a["device_s"] + b["device_s"])
                            / (a["attrs"]["steps"] + b["attrs"]["steps"]))
    v = sp.median(per_step)
    return None if v is None else 1e3 * v
