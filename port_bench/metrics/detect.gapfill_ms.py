"""The gap-fill and normalization of a detection call on the device, in
ms: the median stream time of the program's ``detect.gapfill`` span over
the window's calls that timed it (no profiler watching)."""
import harness


def read(rec: dict):
    return harness.load("metrics", "_spans").device_ms(rec, "detect.infer", "detect.gapfill")
