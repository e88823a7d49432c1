"""The IK stage of a kinematic call, replayed from outside with a CUDA
event on each side, in ms."""


def read(rec: dict):
    return rec.get("ik_ms")
