"""The physics benchmark's plain reference (``port_bench/reference/physics.py``)
and traffic (``port_bench/traffic/walking.py``) against the port, on the CPU
at a small size: 3 walking clips of 24 frames drawn from the seed, AL 1/1/1/1
and LM 3 steps of 10 CG iterations.

- ``solve_physics_full_batch`` in float64 follows the reference stage by
  stage and end to end (to rounding: the two sum in other orders);
- in float32 it stays within a stated distance of the float64 reference,
  and the reference with its iterates held in bfloat16 does not;
- the traffic at ``walking_input``'s gait is ``walking_input``'s clip;
- a call's spans nest under ``phys.call`` with their ``steps``, the
  counters count, and the results are bitwise those of a call whose spans
  are no-ops.
"""
from __future__ import annotations

import contextlib
import copy
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from chd_tpu_torch.kinematics.lm import LMConfig
from chd_tpu_torch.parallel import batch as batch_lib
from chd_tpu_torch.physics import collocation as co
from chd_tpu_torch.physics.synth import walking_input
from chd_tpu_torch.physics.types import PhysInput, PhysWeights
from chd_tpu_torch.utils import profiling

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "port_bench")
STAGES = ("fit", "dyn", "height", "stage3", "stage4")
SEED = 2**31 + 71


def _load(kind, name):
    spec = importlib.util.spec_from_file_location(f"_bench_{kind}_{name}",
                                                  os.path.join(BENCH, kind, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref_mod = _load("reference", "physics")
walking = _load("traffic", "walking")


def _json(*parts):
    with open(os.path.join(BENCH, *parts)) as fh:
        return json.load(fh)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # never raised again: a process that goes back up can hang in MKL
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def small():
    cfg = copy.deepcopy(_json("configs", "physics_default.json"))
    cfg["solve"].update(al_iters_fit=1, al_iters_dyn=1, al_iters_height=1, al_iters_durations=1)
    cfg["solve"]["lm"].update(max_iters=3, cg_iters=10)
    traffic = dict(_json("workloads", "phys.walk.b32x100.json")["traffic"], sequences=3,
                   frames=24)
    clips = walking.clips(SEED, cfg, traffic)
    sv = {k: v for k, v in cfg["solve"].items() if k != "lm"}
    scfg = co.SolveConfig(**sv, lm=LMConfig(**cfg["solve"]["lm"]))
    return cfg, clips, scfg


def _batch(clips, dtype):
    inputs = [PhysInput(**{k: torch.from_numpy(v) for k, v in c.items()}) for c in clips]
    return batch_lib.pad_phys_inputs(inputs, device="cpu", dtype=dtype)[0]


def _solve(small, dtype):
    cfg, clips, scfg = small
    return batch_lib.solve_physics_full_batch(_batch(clips, dtype), PhysWeights(**cfg["weights"]),
                                              scfg)


def _reference(small, **kw):
    cfg, clips, _ = small
    return ref_mod.solve(clips, cfg, torch.device("cpu"), phases=ref_mod.phase_count(clips), **kw)


@pytest.fixture(scope="module")
def staged64(small):
    """The program's float64 solve, each stage's variables recorded where
    the solve hands them on."""
    got = []
    run_stage, stage3 = co.run_stage, batch_lib.stage3_solve

    def rec_stage(*a, **kw):
        x, lams = run_stage(*a, **kw)
        got.append(x)
        return x, lams

    def rec_stage3(*a, **kw):
        x, d = stage3(*a, **kw)
        got.append(torch.cat([x, d.reshape(x.shape[0], -1)], -1))
        return x, d

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(co, "run_stage", rec_stage)
        mp.setattr(batch_lib, "stage3_solve", rec_stage3)
        out = _solve(small, torch.float64)
    return dict(zip(STAGES, got)), out


@pytest.fixture(scope="module")
def ref64(small):
    return _reference(small)


def _gaps(out, ref) -> dict:
    """COM (cm, largest mean), the final objective's excess over the
    reference's as a share of the polish's decrease, the dynamics
    violation's excess (both in float64), flags."""
    got = {k: getattr(out[2], k).double().numpy() for k in ("base_lin", "base_ang", "ee_pos",
                                                            "ee_force", "contact")}
    return _gaps_of(got, np.asarray(out[4]), ref)


def _gaps_of(got, ok, ref) -> dict:
    fin = ref["final"]
    com = (torch.as_tensor(got["base_lin"]) - fin["base_lin"]).norm(dim=-1).mean(-1).max() * 100
    c_got, c_ref, c_start = (ref_mod.final_objective(ref, r) for r in (got, fin, ref["start"]))
    v_got, v_ref = ref_mod.dynamics_violation(ref, got), ref_mod.dynamics_violation(ref, fin)
    return {"com_cm": float(com),
            "cost": float(((c_got - c_ref) / (c_start - c_ref)).abs().max()),
            "dyn": float((v_got / v_ref - 1).abs().max()),
            "flags": bool(np.array_equal(ok, ref["ok"].numpy()))}


def test_float64_follows_the_reference_stage_by_stage(staged64, ref64):
    """Each stage's variables (stage 3 with its durations) to rounding: the
    program and the reference sum their residuals and CG dots in other
    orders, and the polish's forces sit behind 1e3-weighted pins."""
    xs, _ = staged64
    for name in STAGES:
        a, b = xs[name], ref64["x"][name]
        assert a.shape == b.shape, name
        scale = max(1.0, float(b.abs().max()))
        assert float((a - b).abs().max()) <= 1e-9 * scale, name


def test_float64_follows_the_reference_end_to_end(staged64, ref64):
    _, out = staged64
    res_fit, res_dyn, res, stats, ok = out
    for got, want in ((res_fit, ref64["fit"]), (res_dyn, ref64["dyn"]), (res, ref64["final"])):
        for k in ("base_lin", "base_ang", "ee_pos"):
            assert float((getattr(got, k) - want[k]).abs().max()) < 1e-11, k
        assert float((got.ee_force - want["ee_force"]).abs().max()) < 1e-8
        assert torch.equal(got.contact, want["contact"])
    for k, v in stats.items():
        assert float((v - ref64["stats"][k]).abs().max()) <= 1e-9 * max(
            1.0, float(ref64["stats"][k].abs().max())), k
    assert np.array_equal(ok, ref64["ok"].numpy())
    g = _gaps(out, ref64)
    assert g["com_cm"] < 1e-10 and g["cost"] < 1e-12 and g["dyn"] < 1e-9


# float32 against float64: 15 LM steps of an unconverged PCG carry float32's
# roundings (~1e-7 relative) into the iterates; on these clips the COM parts
# by 2.2e-5 cm, the final objective by 1.0e-7 of the polish's decrease and
# the largest dynamics violation by 7.3e-3 (forces of ~700 N, accelerations
# from differences of positions over dt²). The tolerance leaves 7-100x room
# over those readings and lies 160-430x below what iterates held in
# bfloat16 give (0.16 cm, 2.8e-3, 21).
F32_TOL = {"com_cm": 1e-3, "cost": 1e-5, "dyn": 5e-2}


def _within(g: dict) -> bool:
    return all(g[k] <= v for k, v in F32_TOL.items()) and g["flags"]


def test_float32_is_within_the_stated_distance_of_the_float64_reference(small, ref64):
    g = _gaps(_solve(small, torch.float32), ref64)
    assert _within(g), g


def test_the_reference_with_bfloat16_iterates_is_caught(small, ref64):
    c = _reference(small, dtype=torch.float32, keep=ref_mod.bf16_state)
    got = {k: v.double().numpy() for k, v in c["final"].items()}
    g = _gaps_of(got, c["ok"].numpy(), ref64)
    assert not _within(g), g
    assert g["com_cm"] > 10 * F32_TOL["com_cm"] and g["dyn"] > 10 * F32_TOL["dyn"], g


@pytest.mark.parametrize("F, seed", [(100, 0), (37, 5)])
def test_the_traffic_at_walking_inputs_gait_is_walking_input(F, seed):
    cfg = _json("configs", "physics_default.json")
    got = walking.clip(F, 1.0 / cfg["fps"], 1.2, 1.0, 0.65, 0.0, np.random.default_rng(seed),
                       cfg["body"], cfg["floor"])
    want = walking_input(F, seed=seed)
    assert set(got) == {k for k in PhysInput._fields if k != "frame_mask"}
    for k, v in got.items():
        w = getattr(want, k).numpy()
        assert v.dtype == w.dtype and np.array_equal(v, w), k


def test_the_traffic_draws_a_gait_per_sequence_from_the_seed(small):
    cfg, clips, _ = small
    traffic = dict(_json("workloads", "phys.walk.b32x100.json")["traffic"], sequences=3,
                   frames=24)
    again = walking.clips(SEED, cfg, traffic)
    other = walking.clips(SEED + 1, cfg, traffic)
    assert all(np.array_equal(a[k], b[k]) for a, b in zip(clips, again) for k in a)
    assert not np.array_equal(clips[0]["base_lin"], other[0]["base_lin"])
    assert not np.array_equal(clips[0]["base_lin"], clips[1]["base_lin"])
    gaits = walking.gaits(np.random.default_rng(SEED), traffic, 50)
    for (speed, cycle, duty, phase) in gaits:
        assert 0.9 <= speed <= 1.5 and 0.9 <= cycle <= 1.2
        assert 0.6 <= duty <= 0.7 and 0.0 <= phase <= 1.0


def test_spans_nest_under_the_call_and_leave_the_results_bitwise(small):
    cfg, clips, scfg = small
    profiling.reset()
    try:
        out = _solve(small, torch.float32)
        snap = profiling.snapshot()
    finally:
        profiling.reset()
    spans = snap["spans"]
    call = spans["phys.call"]["readings"]
    assert len(call) == 1 and call[0]["attrs"] == {"B": 3, "F": 24}
    cid = call[0]["call"]
    al = {"fit": scfg.al_iters_fit, "dyn": scfg.al_iters_dyn, "height": scfg.al_iters_height,
          "stage3": scfg.al_iters_durations, "stage4": max(scfg.al_iters_height, 1)}
    for name in ("prepare", "unpack") + STAGES:
        (r,) = spans[f"phys.{name}"]["readings"]
        assert r["parent"] == "phys.call" and r["call"] == cid, name
        if name in al:
            assert r["attrs"] == {"steps": al[name] * scfg.lm.max_iters}, name
    assert snap["counters"]["lm.jtjv.autograd"] == sum(al.values())

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(batch_lib, "span", lambda *a, **kw: contextlib.nullcontext())
        plain = _solve(small, torch.float32)
    for a, b in zip(out[:3], plain[:3]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(out[3][k], plain[3][k]) for k in out[3])
    assert np.array_equal(out[4], plain[4])
