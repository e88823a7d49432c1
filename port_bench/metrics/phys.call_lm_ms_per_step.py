"""The five LM stages inside the window's physics calls, in ms a step: the
median over calls of the stream time of ``phys.fit``, ``phys.dyn``,
``phys.height``, ``phys.stage3`` and ``phys.stage4`` over their
``steps``."""
import harness

STAGES = ("phys.fit", "phys.dyn", "phys.height", "phys.stage3", "phys.stage4")


def read(rec: dict):
    sp = harness.load("metrics", "_spans")
    snap = sp.snapshot()
    if snap is None:
        return None
    calls = [r["call"] for r in sp.window(snap, rec, "phys.call")]
    stages = [sp.by_call(snap, n, calls) for n in STAGES]
    per_step = []
    for c in calls:
        got = [s.get(c) for s in stages]
        if all(g and g["device_s"] is not None for g in got):
            per_step.append(sum(g["device_s"] for g in got) / sum(g["attrs"]["steps"] for g in got))
    v = sp.median(per_step)
    return None if v is None else 1e3 * v
