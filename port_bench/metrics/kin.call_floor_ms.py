"""The floor fit and contact pruning inside the window's kinematic calls:
the median stream time of the program's ``kin.floor`` span, in ms."""
import harness


def read(rec: dict):
    return harness.load("metrics", "_spans").device_ms(rec, "kin.call", "kin.floor")
