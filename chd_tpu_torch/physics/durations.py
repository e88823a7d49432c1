"""Contact-phase duration optimization, physics stage 3 (port of
chd_tpu/physics/durations.py, over a batch of sequences).

The reference makes phase durations decision variables of the TOWR NLP
(phys_optim.cpp:663-711: PhaseDurations variable sets + TotalTime
constraint + DurationCost, with a stage-4 frozen-duration fallback on
failure :713-749). Here the frame-grid contact masks are a SMOOTH function
of the duration vector: each contact phase [a_k, b_k] (boundaries =
cumulative durations) contributes a soft window σ((t−a_k)/τ)·σ((b_k−t)/τ);
the per-frame contact value is the sum over contact phases. Everything the
mask touches (dynamics force masking, terrain, no-slip, friction) is then
differentiable w.r.t. durations, so they join the LM/AL variable vector
directly. Constraints follow the reference:

- duration cost ½·w_dur·Σ(d_init − d)² over the first N−1 phases of each EE
  (duration_cost.cpp:25-49);
- total time Σd = T per EE (TOWR TotalDurationConstraint semantics,
  parameters.cpp:140-151: all EEs' sums equal);
- d_k ≥ min duration (phase-duration bounds, parameters.cpp:66-70).

Ragged phase counts pad to a common P_max with zero-length phases whose
windows are hard-masked out. ``build_duration_spec`` runs on the host, on a
concrete schedule; the functions after it take a batch: durations (B, 4, P),
a batched spec, and per-sequence dt (B,).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .prepare import contact_durations


class DurationSpec(NamedTuple):
    durations: torch.Tensor      # (4, P_max) padded phase durations (s)
    phase_mask: torch.Tensor     # (4, P_max) 1 for real phases
    contact_phase: torch.Tensor  # (4, P_max) 1 if the phase is a contact phase
    total_time: torch.Tensor     # () seconds


def build_duration_spec(contact: np.ndarray, dt: float) -> DurationSpec:
    """From binary (4, F) schedules → padded duration arrays, float32 as in
    ``chd_tpu``."""
    durs = [contact_durations(np.asarray(contact[e]), dt) for e in range(contact.shape[0])]
    P = max(len(d) for d in durs)
    d = np.zeros((contact.shape[0], P))
    m = np.zeros((contact.shape[0], P))
    cp = np.zeros((contact.shape[0], P))
    for e, dd in enumerate(durs):
        d[e, : len(dd)] = dd
        m[e, : len(dd)] = 1.0
        start = bool(contact[e, 0])
        for k in range(len(dd)):
            cp[e, k] = 1.0 if (k % 2 == 0) == start else 0.0
    total = float(np.sum(d[0]))
    return DurationSpec(*(torch.as_tensor(np.asarray(a, np.float32)) for a in (d, m, cp, total)))


def _sqrt(v):
    return torch.sqrt(v) if isinstance(v, torch.Tensor) else math.sqrt(v)


def _last_phase(phase_mask: torch.Tensor) -> torch.Tensor:
    """(B, 4, P) true at each EE's last real phase."""
    last_idx = (phase_mask.sum(dim=-1) - 1).long()
    P = phase_mask.shape[-1]
    return torch.arange(P, device=phase_mask.device) == last_idx.unsqueeze(-1)


def soft_contact(spec_durations, spec: DurationSpec, F: int, dt, tau=None) -> torch.Tensor:
    """(B, 4, F) smooth contact values from (possibly updated) durations.

    tau: sigmoid sharpness, (B,) (default dt/2 — transitions resolve within a
    frame at convergence)."""
    if tau is None:
        tau = dt * 0.5
    # evaluate at frame CENTERS so a frame sitting exactly on a phase
    # boundary belongs to the phase that starts there (matches the binary
    # schedule from find_contact_durations, which sums to (F−1)·dt)
    t = (torch.arange(F, dtype=spec_durations.dtype, device=spec_durations.device) + 0.5)
    t = (t * dt.unsqueeze(-1))[:, None, None, :]   # (B, 1, 1, F)
    tau = tau[:, None, None, None]
    d = spec_durations * spec.phase_mask
    ends = torch.cumsum(d, dim=-1)                 # (B, 4, P)
    starts = ends - d
    # the last real phase is open-ended (it absorbs the final frame, which
    # lies past the (F−1)·dt duration total)
    ends = torch.where(_last_phase(spec.phase_mask), 1e6, ends)
    up = torch.sigmoid((t - starts.unsqueeze(-1)) / tau)
    down = torch.sigmoid((ends.unsqueeze(-1) - t) / tau)
    windows = up * down                            # (B, 4, P, F)
    live = (spec.contact_phase * spec.phase_mask * (d > 1e-6)).unsqueeze(-1)
    # jnp.clip's maximum-then-minimum: a derivative of 1/2 at the bounds
    zero = windows.new_zeros(())
    return torch.minimum(torch.maximum((windows * live).sum(dim=2), zero), zero + 1.0)


def duration_residuals(durations, spec: DurationSpec, w_dur, rho_total: float = 100.0,
                       min_duration: float = 0.05) -> torch.Tensor:
    """(B, 4P + 4 + 4P) cost + constraint residuals on the duration
    variables themselves; w_dur a float or a 0-d tensor."""
    m = spec.phase_mask
    # keep close to initialization, excluding each EE's last real phase
    # (duration_cost.cpp counts the first N−1)
    not_last = m * ~_last_phase(m)
    r_cost = _sqrt(w_dur) * not_last * (durations - spec.durations)
    # total time equality per EE
    r_total = _sqrt(rho_total) * ((durations * m).sum(dim=-1) - spec.total_time.unsqueeze(-1))
    # minimum duration hinge on real phases (a derivative of 1/2 at a tie,
    # as jnp.maximum's)
    r_min = _sqrt(rho_total) * m * torch.maximum(min_duration - durations,
                                                 durations.new_zeros(()))
    return torch.cat([r_cost.flatten(1), r_total.flatten(1), r_min.flatten(1)], dim=-1)


def rasterize(durations, spec: DurationSpec, F: int, dt) -> torch.Tensor:
    """Durations → hard binary (B, 4, F) schedule (midpoint rule)."""
    soft = soft_contact(durations, spec, F, dt, tau=dt * 0.05)
    return (soft > 0.5).to(durations.dtype)
