"""Share of one replayed LM step's wall time in which nothing ran on the
device, in %."""


def read(rec: dict):
    v = rec.get("idle_share")
    return None if v is None or "lm_steps" not in rec else 100.0 * v
