"""Device time of the copies from the card to the host (the contacts) a
traced detection call, in ms."""


def read(rec: dict):
    if not rec.get("calls_traced") or not rec.get("d2h_s"):
        return None
    return 1e3 * rec["d2h_s"] / rec["calls_traced"]
