"""The two LM stages of a kinematic call, replayed from outside between
CUDA events, over their steps, in ms a step."""


def read(rec: dict):
    if not rec.get("lm_steps") or rec.get("lm_ms") is None:
        return None
    return rec["lm_ms"] / rec["lm_steps"]
