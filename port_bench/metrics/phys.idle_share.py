"""Share of one replayed DYN LM step's wall time in which nothing ran on the
device, in %: the graph's replay from the profiled step's first launch to
its last kernel's end."""


def read(rec: dict):
    v = rec.get("idle_share")
    return None if v is None or "step_kernels" not in rec else 100.0 * v
