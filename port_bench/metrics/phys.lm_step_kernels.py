"""The kernels of one DYN LM step: the ``kernel_nodes`` of the program's
last graph capture inside ``phys.dyn`` (the step's CUDA graph; a replay
also runs its ``copy_nodes`` as copy kernels of the driver's)."""
import harness


def read(rec: dict):
    sp = harness.load("metrics", "_spans")
    snap = sp.snapshot()
    if snap is None:
        return None
    caps = [r for r in sp.readings(snap, "graphs.capture") if r["parent"] == "phys.dyn"]
    return caps[-1]["attrs"].get("kernel_nodes") if caps else None
