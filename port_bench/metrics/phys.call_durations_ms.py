"""The duration solve (stage 3) inside the window's physics calls: the
median stream time of the program's ``phys.stage3`` span, in ms."""
import harness


def read(rec: dict):
    return harness.load("metrics", "_spans").device_ms(rec, "phys.call", "phys.stage3")
