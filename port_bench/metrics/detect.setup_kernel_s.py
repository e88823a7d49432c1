"""The fused-MLP kernel's part of set-up, in s: the host seconds of the
program's ``fused_mlp.build`` (finding or compiling the library and
loading it) and ``fused_mlp.pack`` (packing the weights) spans."""
import harness


def read(rec: dict):
    snap = harness.load("metrics", "_spans").snapshot()
    if snap is None:
        return None
    found = [snap["spans"][n]["host_s"] for n in ("fused_mlp.build", "fused_mlp.pack")
             if n in snap["spans"]]
    return sum(found) if found else None
