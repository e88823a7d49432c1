"""The fused-MLP kernel's share of its roofline, in %: the least time the
card could take for a call's MLP (``roofline.mlp_bound_s``: the model's
FLOP at the bf16 peak, or its bytes at HBM's rate) over the device time of
the ``fused_mlp_kernel`` events a traced call."""


def read(rec: dict):
    if not rec.get("mlp_kernel_s") or not rec.get("calls_traced"):
        return None
    return 100.0 * rec["mlp_bound_s"] / (rec["mlp_kernel_s"] / rec["calls_traced"])
