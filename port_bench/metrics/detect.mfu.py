"""The detection call's share of the card's bf16 peak: the model's FLOP
(counted once from its shapes, ``roofline.detect_flop``) of every call in
the window over the window's seconds, against 989 TFLOP/s, in %."""
from harness import BF16_PEAK


def read(rec: dict):
    if not rec.get("flop_per_call") or not rec.get("elapsed_s"):
        return None
    return 100.0 * rec["flop_per_call"] * rec["calls"] / rec["elapsed_s"] / BF16_PEAK
