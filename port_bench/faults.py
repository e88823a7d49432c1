"""Faults planted in the program underneath a run, to show that the check
catches them: each breaks the timed path in one of the ways a later change
could, where the answer is produced.

- ``detect.half``: detection runs on the first half of the videos and
  returns zeros for the rest;
- ``detect.altered``: one window probability moved by 0.1 and one video's
  first five frames' contacts flipped;
- ``kin.unchanged``: each LM stage returns its start unchanged;
- ``kin.half``: the second half of the batch is not solved (it gets the
  first half's results);
- ``kin.altered``: one sequence's joints moved 1 cm.
"""
from __future__ import annotations

import contextlib
from unittest import mock

FAULTS = ("detect.half", "detect.altered", "kin.unchanged", "kin.half", "kin.altered")


@contextlib.contextmanager
def planted(fault: str):
    if fault == "none":
        yield
        return
    import torch

    from chd_tpu_torch.contact import infer
    from chd_tpu_torch.kinematics import batch as batch_lib

    if fault == "detect.half":
        orig = infer._infer_batch

        def half(op_batch, *a, **kw):
            h = op_batch.shape[0] // 2
            c, p = orig(op_batch[:h], *a, **kw)
            pad = op_batch.shape[0] - h
            return (torch.cat([c, c.new_zeros((pad,) + c.shape[1:])]),
                    torch.cat([p, p.new_zeros((pad,) + p.shape[1:])]))
        patch = mock.patch.object(infer, "_infer_batch", half)
    elif fault == "detect.altered":
        orig = infer._infer_batch

        def altered(*a, **kw):
            c, p = orig(*a, **kw)
            c, p = c.clone(), p.clone()
            c[0, :5] = 1 - c[0, :5]
            p[0, 0, 0, 0] += 0.1
            return c, p
        patch = mock.patch.object(infer, "_infer_batch", altered)
    elif fault == "kin.unchanged":
        patch = mock.patch.object(batch_lib, "lm_stage", lambda x0, *a, **kw: x0)
    elif fault == "kin.half":
        orig = batch_lib.optimize_trajectory_batch

        def half(problems, *a, **kw):
            h = len(problems) // 2
            res = orig(problems[:h], *a, **kw)
            return res + res[:len(problems) - h]
        patch = mock.patch.object(batch_lib, "optimize_trajectory_batch", half)
    elif fault == "kin.altered":
        orig = batch_lib.optimize_trajectory_batch

        def altered(*a, **kw):
            res = orig(*a, **kw)
            res[0].pose3d = res[0].pose3d + 1.0
            return res
        patch = mock.patch.object(batch_lib, "optimize_trajectory_batch", altered)
    else:
        raise ValueError(f"no fault {fault!r}; one of {FAULTS}")
    with patch:
        yield
