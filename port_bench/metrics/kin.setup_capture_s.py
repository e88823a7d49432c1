"""The host seconds of every CUDA graph capture of the run (the program's
``graphs.capture`` spans): all of them fall in set-up, since a capture in
the window fails the run."""
import harness


def read(rec: dict):
    snap = harness.load("metrics", "_spans").snapshot()
    if snap is None or "graphs.capture" not in snap["spans"]:
        return None
    return snap["spans"]["graphs.capture"]["host_s"]
