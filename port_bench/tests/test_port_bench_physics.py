"""The physics cell ``phys.walk.b32x100`` on the CPU at a tiny size: a run
through ``run.measure`` in a copy of the benchmark comes out correct; runs
with a fault planted in the program's timed path do not; and each of the
cell's per-layer readers reads a recorded snapshot of the program's spans,
and gives None for a program without them."""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)

import harness  # noqa: E402
from chd_tpu_torch.utils import profiling  # noqa: E402

CELL = "phys.walk.b32x100"
# 8 of 10 sequences sampled, 4 of each half, and enough budget that the
# duration solve moves a few contact flags (at LM 3:10 it moves none, and
# leaving the durations at their start changes nothing)
TINY_TRAFFIC = {"sequences": 10, "frames": 30}
TINY_SOLVE = {"al_iters_fit": 1, "al_iters_dyn": 1, "al_iters_height": 1,
              "al_iters_durations": 2}
TINY_LM = {"max_iters": 8, "cg_iters": 10}
FAULTS = ("phys.unchanged", "phys.durations", "phys.half", "phys.moved", "phys.flags")
READERS = ["phys.call_lm_ms_per_step", "phys.call_durations_ms", "phys.call_host_ms",
           "phys.lm_step_kernels", "phys.setup_capture_s"]

# Runs the cell in the copy on the CPU with a fault planted in the program:
# ``phys.unchanged``, every AL stage returns its start; ``phys.durations``,
# the duration solve hands back the durations it started from;
# ``phys.half``, the second half of the batch gets the first half's results;
# ``phys.moved``, every final COM moved 1 cm; ``phys.flags``, the
# ``durations_ok`` flags inverted (the results as they were). Prints the
# result's JSON last.
RUNNER = r"""
import json, sys
from unittest import mock
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
torch.set_num_threads(2)
import run
from chd_tpu_torch.parallel import batch as batch_lib
from chd_tpu_torch.physics import collocation as co

fault = sys.argv[4]
patches = []
if fault == "phys.unchanged":
    patches.append(mock.patch.object(co, "run_stage", lambda x, phys, lams, *a, **kw: (x, lams)))
elif fault == "phys.durations":
    orig = batch_lib.stage3_solve

    def unmoved(phys, x2, spec, *a, **kw):
        return orig(phys, x2, spec, *a, **kw)[0], spec.durations
    patches.append(mock.patch.object(batch_lib, "stage3_solve", unmoved))
elif fault == "phys.half":
    orig = batch_lib.solve_physics_full_batch

    def half(pb, *a, **kw):
        out = orig(pb, *a, **kw)
        B = pb.base_lin.shape[0]
        h = B // 2
        rows = torch.arange(B) % h
        pick = lambda t: t.index_select(0, rows.to(t.device))
        res = [type(r)(*(pick(v) for v in r)) for r in out[:3]]
        return (*res, {k: pick(v) for k, v in out[3].items()}, out[4][rows.numpy()])
    patches.append(mock.patch.object(batch_lib, "solve_physics_full_batch", half))
elif fault == "phys.moved":
    orig = batch_lib.solve_physics_full_batch

    def moved(*a, **kw):
        out = list(orig(*a, **kw))
        out[2] = out[2]._replace(base_lin=out[2].base_lin + 0.01)
        return tuple(out)
    patches.append(mock.patch.object(batch_lib, "solve_physics_full_batch", moved))
elif fault == "phys.flags":
    orig = batch_lib.solve_physics_full_batch

    def flipped(*a, **kw):
        out = orig(*a, **kw)
        return (*out[:4], ~out[4])
    patches.append(mock.patch.object(batch_lib, "solve_physics_full_batch", flipped))
for p in patches:
    p.start()
res = run.measure(sys.argv[3], 2**31 + 5, 0.2, False, torch.device("cpu"))
print(json.dumps(res))
"""


def _tiny(bench) -> None:
    path = bench / "workloads" / f"{CELL}.json"
    wl = json.loads(path.read_text())
    wl["traffic"].update(TINY_TRAFFIC)
    path.write_text(json.dumps(wl))
    path = bench / "configs" / "physics_default.json"
    cfg = json.loads(path.read_text())
    cfg["solve"].update(TINY_SOLVE)
    cfg["solve"]["lm"].update(TINY_LM)
    path.write_text(json.dumps(cfg))


def run_cell(bench, fault: str = "none") -> dict:
    proc = subprocess.run([sys.executable, "-c", RUNNER, str(bench), REPO, CELL, fault],
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture
def tiny_bench(bench_copy):
    _tiny(bench_copy)
    return bench_copy


def test_a_run_of_the_cell_is_correct(tiny_bench):
    res = run_cell(tiny_bench)
    assert res["correct"], res["compared"]
    assert list(res)[-1] == "compared" and res["attempted"] == 10 and res["failed"] == 0
    assert set(res["compared"]) == {"com_gap_cm", "cost_excess", "dyn_excess", "ok_flips",
                                    "contact_flips"}
    assert set(res["metrics"]) == {"kinematic_seq_per_hour", "setup_s"}


@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_in_the_timed_path_is_not_correct(tiny_bench, fault):
    res = run_cell(tiny_bench, fault)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("B", [1, 3, 10, 32])
def test_the_sample_holds_sequences_of_both_halves(B):
    drv = harness.load("drivers", "physics")
    for seed in (0, 7, 2**31 + 5, 2**32 + 11):
        got = drv.draw_sample(seed, B)
        assert got == drv.draw_sample(seed, B) == sorted(set(got))
        assert len(got) == min(drv.SAMPLE, B) and all(0 <= i < B for i in got)
        lo = sum(i < B // 2 for i in got)
        assert lo == min(drv.SAMPLE // 2, B // 2) and len(got) - lo == min(
            drv.SAMPLE - lo, B - B // 2)
    assert len({tuple(drv.draw_sample(s, 32)) for s in range(20)}) > 1


# -- the per-layer readers ------------------------------------------------------

STEPS = {"phys.fit": 50, "phys.dyn": 75, "phys.height": 75, "phys.stage3": 50,
         "phys.stage4": 75}


def reading(name, call, parent=None, host_s=0.0, device_s=None, device_at_s=None,
            profiled=False, **attrs):
    return {"name": name, "parent": parent, "call": call, "start_ns": 0,
            "end_ns": int(host_s * 1e9), "host_s": host_s, "attrs": attrs,
            "device_s": device_s, "device_at_s": device_at_s, "profiled": profiled}


def physics_snapshot():
    """A set-up call (id 1, capturing five graphs, slow) and two window
    calls (ids 2-3), then a profiled step outside any call (id 4)."""
    out, stage_s = [], {}
    for call, (scale, host) in enumerate([(1.6, 80.0), (1.0, 28.30), (1.01, 28.55)], start=1):
        stage_s[call] = {n: scale * s for n, s in zip(STEPS, (4.0, 6.4, 6.5, 4.3, 6.6))}
        out.append(reading("phys.call", call, host_s=host, device_s=host - 0.01,
                           device_at_s=0.0, B=32, F=100))
        out.append(reading("phys.prepare", call, "phys.call", host_s=0.004))
        at = 0.005
        for n, s in stage_s[call].items():
            out.append(reading(n, call, "phys.call", device_s=s, device_at_s=at, steps=STEPS[n]))
            at += s + 0.001
        out.append(reading("phys.unpack", call, "phys.call", host_s=0.2))
    for n, (host, nodes) in zip(STEPS, [(3.1, 48_000), (4.2, 55_321), (4.4, 55_900),
                                         (5.0, 60_111), (4.0, 54_000)]):
        out.append(reading("graphs.capture", 1, n, host_s=host, kernel_nodes=nodes))
    out.append(reading("graphs.capture", 4, None, host_s=9.0, kernel_nodes=1))
    spans = {}
    for r in out:
        s = spans.setdefault(r["name"], {"count": 0, "host_s": 0.0, "readings": []})
        s["count"] += 1
        s["host_s"] += r["host_s"]
        s["readings"].append(r)
    return {"spans": spans, "counters": {"phys.durations_ok": 90}}, stage_s


@pytest.fixture
def snapshot(monkeypatch):
    def use(snap):
        monkeypatch.setattr(profiling, "snapshot", lambda: snap)
    return use


def read(name, rec):
    return harness.load("metrics", name).read(rec)


def test_physics_readers_read_the_windows_calls(snapshot):
    snap, stage_s = physics_snapshot()
    snapshot(snap)
    rec = {"calls": 2}
    steps = sum(STEPS.values())
    assert read("phys.call_lm_ms_per_step", rec) == pytest.approx(
        1e3 * statistics.median(sum(stage_s[c].values()) / steps for c in (2, 3)))
    assert read("phys.call_durations_ms", rec) == pytest.approx(
        1e3 * statistics.median(stage_s[c]["phys.stage3"] for c in (2, 3)))
    covered = {c: sum(stage_s[c].values()) + 0.004 for c in (2, 3)}
    assert read("phys.call_host_ms", rec) == pytest.approx(
        1e3 * statistics.median([28.30 - covered[2], 28.55 - covered[3]]))
    assert read("phys.lm_step_kernels", rec) == 55_321
    assert read("phys.setup_capture_s", rec) == pytest.approx(3.1 + 4.2 + 4.4 + 5.0 + 4.0)


def test_a_call_with_an_untimed_stage_is_left_out(snapshot):
    snap, stage_s = physics_snapshot()
    r = snap["spans"]["phys.dyn"]["readings"][-1]
    r["device_s"] = r["device_at_s"] = None
    snapshot(snap)
    steps = sum(STEPS.values())
    assert read("phys.call_lm_ms_per_step", {"calls": 2}) == pytest.approx(
        1e3 * sum(stage_s[2].values()) / steps)


def test_the_idle_share_reads_the_traced_dyn_step():
    rec = {"idle_share": 0.4267, "busy_s": 0.093, "window_s": 0.163, "step_kernels": 54_394}
    assert read("phys.idle_share", rec) == pytest.approx(42.67)
    assert read("phys.idle_share", {"idle_share": 0.2, "lm_steps": 80}) is None
    assert read("phys.idle_share", {"calls": 2}) is None


@pytest.mark.parametrize("name", READERS)
def test_a_reader_gives_none_without_its_spans(snapshot, name):
    snapshot({"spans": {}, "counters": {}})
    assert read(name, {"calls": 2}) is None


@pytest.mark.parametrize("name", READERS)
def test_a_reader_gives_none_for_a_program_without_spans(monkeypatch, name):
    monkeypatch.delattr(profiling, "snapshot")
    assert read(name, {"calls": 2}) is None


@pytest.mark.parametrize("name", READERS)
def test_a_reader_gives_none_for_a_parent_without_physics_spans(snapshot, name):
    """The program before its physics spans: graph captures with no
    physics parent, and no ``phys.*`` span."""
    snapshot({"spans": {"graphs.capture": {"count": 1, "host_s": 3.0, "readings": [
        reading("graphs.capture", 1, None, host_s=3.0, kernel_nodes=55_000)]}},
        "counters": {}})
    assert read(name, {"calls": 2}) is None
