"""The floor fit and contact pruning of a kinematic call, replayed from
outside between CUDA events, in ms."""


def read(rec: dict):
    return rec.get("floor_ms")
