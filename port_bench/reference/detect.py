"""Plain reference of full-video contact detection (plain torch, float64):
what ``ContactDetector.infer`` computes, written from the model's
definition and not from the program.

1. gap-fill: each (frame, joint) below the confidence threshold takes x, y
   linearly interpolated between the nearest valid frames of its track,
   copied from the one valid side at an edge, untouched when the track has
   none; x and y then divided by the normalization;
2. windows of ``window_size`` frames, x and y relative to the root of the
   middle frame, whose own root slot holds that root;
3. the MLP in eval mode with its BatchNorm layers as they are (not folded):
   Linear, BN, ReLU four times, then Linear; sigmoid;
4. the vote merge: a window's prediction above the threshold votes for its
   ``pred_size`` middle frames; a frame is in contact with (P+1)/2 votes,
   near the ends with fewer (its offset // 2 + 1); the ``(W - P) / 2``
   frames at each end copy their neighbour.

``matmul="bf16"`` is the control: every layer's inputs and weights rounded
to bfloat16 and the products summed in float32 (one bf16 pass), the
precision below the configuration's.
"""
from __future__ import annotations

import torch

ROWS = 16384  # window rows a block, so that float64 fits beside the program


def gap_fill(kp: torch.Tensor, thresh: float) -> torch.Tensor:
    """(V, F, J, 3) → the same with x, y of sub-threshold detections filled."""
    V, F, J, _ = kp.shape
    valid = kp[..., 2] >= thresh
    t = torch.arange(F, device=kp.device)
    prev = torch.full((V, F, J), -1, dtype=torch.long, device=kp.device)
    nxt = torch.full((V, F, J), F, dtype=torch.long, device=kp.device)
    last = torch.full((V, J), -1, dtype=torch.long, device=kp.device)
    for f in range(F):
        last = torch.where(valid[:, f], t[f], last)
        prev[:, f] = last
    last = torch.full((V, J), F, dtype=torch.long, device=kp.device)
    for f in range(F - 1, -1, -1):
        last = torch.where(valid[:, f], t[f], last)
        nxt[:, f] = last
    xy = kp[..., :2]
    at_prev = torch.gather(xy, 1, prev.clamp(0, F - 1)[..., None].expand_as(xy))
    at_next = torch.gather(xy, 1, nxt.clamp(0, F - 1)[..., None].expand_as(xy))
    w = ((t[None, :, None] - prev) / (nxt - prev).clamp(min=1)).to(xy.dtype)[..., None]
    both = (prev >= 0) & (nxt < F)
    filled = torch.where(both[..., None], (1 - w) * at_prev + w * at_next,
                         torch.where((prev >= 0)[..., None], at_prev,
                                     torch.where((nxt < F)[..., None], at_next, xy)))
    return torch.cat([torch.where(valid[..., None], xy, filled), kp[..., 2:]], dim=-1)


def windows(x: torch.Tensor, W: int, root: int) -> torch.Tensor:
    """(V, F, J, 3) → (V, F - W + 1, W·J·3) window features."""
    V, F, J, C = x.shape
    N, mid = F - W + 1, W // 2
    win = torch.stack([x[:, w:w + N] for w in range(W)], dim=2)  # (V, N, W, J, 3)
    r = win[:, :, mid, root, :2]
    xy = win[..., :2] - r[:, :, None, None, :]
    xy[:, :, mid, root] = r
    return torch.cat([xy, win[..., 2:]], dim=-1).reshape(V, N, W * J * C)


def mlp(params: dict, h: torch.Tensor, eps: float, matmul: str) -> torch.Tensor:
    """Eval-mode logits of rows ``h`` (R, in) from the raw parameters:
    ``w{i}`` (out, in), ``b{i}``, and for i < 4 ``gamma{i}``, ``beta{i}``,
    ``mean{i}``, ``var{i}``."""
    for i in range(5):
        w, b = params[f"w{i}"].to(h.dtype), params[f"b{i}"].to(h.dtype)
        if matmul == "bf16":
            h = (h.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float().T).to(h.dtype) + b
        else:
            h = h @ w.T + b
        if i < 4:
            g, be, m, v = (params[f"{k}{i}"].to(h.dtype) for k in ("gamma", "beta", "mean", "var"))
            h = torch.relu((h - m) / torch.sqrt(v + eps) * g + be)
    return h


def vote(preds: torch.Tensor, W: int) -> torch.Tensor:
    """(V, N, P, 4) 0/1 window predictions → (V, N + W - 1, 4) contacts."""
    V, N, P, C = preds.shape
    votes = torch.zeros((V, N + P - 1, C), dtype=preds.dtype, device=preds.device)
    for p in range(P):
        votes[:, p:p + N] += preds[:, :, p]
    need = torch.full((N + P - 1,), (P + 1) / 2.0, dtype=preds.dtype, device=preds.device)
    for e in range(P - 1):
        need[e] = need[N + P - 2 - e] = e // 2 + 1
    c = (votes >= need[None, :, None]).to(torch.int32)
    pad = (W - P) // 2
    return torch.cat([c[:, :1].expand(V, pad, C), c, c[:, -1:].expand(V, pad, C)], dim=1)


@torch.no_grad()
def detect(kp: torch.Tensor, params: dict, cfg: dict, matmul: str = "float64"):
    """(V, F, 25, 3) keypoints → ((V, F, 4) int32 contacts, (V, N, P, 4)
    window probabilities), float64 (or the bf16 control's)."""
    m, d = cfg["model"], cfg["detector"]
    W, P = m["window_size"], m["pred_size"]
    joints = m["joints"]
    x = kp[:, :, joints].double()
    x = gap_fill(x, d["conf_thresh"])
    x = torch.cat([x[..., :2] / d["normalization"], x[..., 2:]], dim=-1)
    feats = windows(x, W, joints.index(m["root_joint"]))
    V, N, _ = feats.shape
    rows = feats.reshape(V * N, -1)
    logits = torch.cat([mlp(params, rows[i:i + ROWS], m["bn_eps"], matmul)
                        for i in range(0, rows.shape[0], ROWS)])
    probs = torch.sigmoid(logits.double()).reshape(V, N, P, 4)
    return vote((probs > d["classify_thresh"]).double(), W), probs
