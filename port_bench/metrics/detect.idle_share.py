"""Share of a detection call's time in which no kernel or copy runs on the
device, in %: the device's busy time a call (the union of its intervals
over the traced calls) against the untraced window's time a call. The
traced slice's own length would count the profiler's host time as idle
(``drivers/detect.py`` ``trace``); a call busier than the window's call
fails the run there."""


def read(rec: dict):
    if not rec.get("calls_traced") or rec.get("idle_share") is None:
        return None
    return 100.0 * rec["idle_share"]
