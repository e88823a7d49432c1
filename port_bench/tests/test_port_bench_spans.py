"""The per-layer metrics read from the program's spans, each on a synthetic
``chd_tpu_torch.utils.profiling.snapshot()``: the number it reads, None
where its span is missing or the program has no spans (as before they
existed), and the readings it leaves out: the set-up's calls, the
profiled calls of the traced slice, and the entries that did not time the
device."""
from __future__ import annotations

import os
import statistics
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)

import harness  # noqa: E402
from chd_tpu_torch.utils import profiling  # noqa: E402

READERS = ["kin.call_ik_ms", "kin.call_lm_ms_per_step", "kin.call_floor_ms",
           "kin.call_host_ms", "kin.lm_step_kernels", "kin.setup_capture_s",
           "detect.host_ms", "detect.gapfill_ms", "detect.setup_kernel_s"]


def reading(name, call, parent=None, host_s=0.0, device_s=None, device_at_s=None,
            profiled=False, **attrs):
    return {"name": name, "parent": parent, "call": call, "start_ns": 0,
            "end_ns": int(host_s * 1e9), "host_s": host_s, "attrs": attrs,
            "device_s": device_s, "device_at_s": device_at_s, "profiled": profiled}


def snap_of(readings, counters=None):
    spans = {}
    for r in readings:
        s = spans.setdefault(r["name"], {"count": 0, "host_s": 0.0, "readings": []})
        s["count"] += 1
        s["host_s"] += r["host_s"]
        s["readings"].append(r)
    return {"spans": spans, "counters": counters or {}}


def kinematic_snapshot():
    """A set-up call (id 1, capturing the graphs, slow) and four window
    calls (ids 2-5); the trace's replays record nothing."""
    out = []
    for call, (ik, lm1, fl, lm2, host) in enumerate(
            [(9.0, 30.0, 2.0, 30.0, 60.0),
             (0.70, 7.0, 0.20, 7.1, 15.10),
             (0.74, 7.2, 0.30, 7.0, 15.35),
             (0.72, 7.1, 0.25, 7.05, 15.22),
             (0.76, 7.3, 0.15, 7.2, 15.50)], start=1):
        at = 0.004
        out.append(reading("kin.call", call, host_s=host, device_s=host - 0.01, device_at_s=0.0,
                           B=16, F=100))
        out.append(reading("kin.prepare", call, "kin.call", host_s=0.003))
        out.append(reading("kin.ik", call, "kin.call", device_s=ik, device_at_s=at))
        out.append(reading("kin.lm1", call, "kin.call", device_s=lm1,
                           device_at_s=at + ik, steps=40))
        out.append(reading("kin.floor", call, "kin.call", device_s=fl,
                           device_at_s=at + ik + lm1))
        out.append(reading("kin.lm2", call, "kin.call", device_s=lm2,
                           device_at_s=at + ik + lm1 + fl, steps=40))
        out.append(reading("kin.unpack", call, "kin.call", host_s=lm2 + 0.02))
    out.append(reading("graphs.capture", 1, "kin.ik", host_s=0.4, kernel_nodes=312))
    out.append(reading("graphs.capture", 1, "kin.lm1", host_s=1.1, kernel_nodes=41_234))
    return snap_of(out)


def detection_snapshot():
    """Two set-up calls (ids 1-2: the build, the packing, slow), twelve
    window calls, every third timing the gap-fill, then four profiled
    calls of the traced slice (slow, every one timed)."""
    out = [reading("fused_mlp.build", 1, "detect.mlp", host_s=0.12, nvcc_s=0.0),
           reading("fused_mlp.pack", 1, "detect.mlp", host_s=0.03)]
    host = {}
    for call in range(1, 19):
        setup, traced = call <= 2, call > 14
        host[call] = 0.05 if setup else 0.002 if traced else 0.0004 + 1e-5 * call
        out.append(reading("detect.infer", call, host_s=host[call], profiled=traced,
                           V=512, F=240))
        gap = 0.01 if setup else 0.0009 if traced else 0.0003 + 1e-5 * call
        timed = setup or traced or call % 3 == 0
        out.append(reading("detect.gapfill", call, "detect.infer", profiled=traced,
                           device_s=gap if timed else None))
    return snap_of(out), host


@pytest.fixture
def snapshot(monkeypatch):
    def use(snap):
        monkeypatch.setattr(profiling, "snapshot", lambda: snap)
    return use


def read(name, rec):
    return harness.load("metrics", name).read(rec)


def test_kinematic_readers_read_the_windows_calls(snapshot):
    snapshot(kinematic_snapshot())
    rec = {"calls": 4}
    assert read("kin.call_ik_ms", rec) == pytest.approx(730.0)
    assert read("kin.call_floor_ms", rec) == pytest.approx(225.0)
    want = statistics.median([(7.0 + 7.1) / 80, (7.2 + 7.0) / 80, (7.1 + 7.05) / 80,
                              (7.3 + 7.2) / 80])
    assert read("kin.call_lm_ms_per_step", rec) == pytest.approx(1e3 * want)
    covered = [0.70 + 7.0 + 0.20 + 7.1, 0.74 + 7.2 + 0.30 + 7.0, 0.72 + 7.1 + 0.25 + 7.05,
               0.76 + 7.3 + 0.15 + 7.2]
    host = [15.10, 15.35, 15.22, 15.50]
    assert read("kin.call_host_ms", rec) == pytest.approx(
        1e3 * statistics.median(h - c for h, c in zip(host, covered)))
    assert read("kin.lm_step_kernels", rec) == 41_234
    assert read("kin.setup_capture_s", rec) == pytest.approx(1.5)


def test_kinematic_stages_of_a_call_without_device_times_are_left_out(snapshot):
    snap = kinematic_snapshot()
    for r in snap["spans"]["kin.ik"]["readings"][-2:]:
        r["device_s"] = r["device_at_s"] = None
    snapshot(snap)
    rec = {"calls": 4}
    assert read("kin.call_ik_ms", rec) == pytest.approx(720.0)
    assert read("kin.call_host_ms", rec) == pytest.approx(1e3 * statistics.median(
        [15.10 - (0.70 + 7.0 + 0.20 + 7.1), 15.35 - (0.74 + 7.2 + 0.30 + 7.0)]))


def test_detection_readers_leave_out_set_up_and_profiled_calls(snapshot):
    snap, host = detection_snapshot()
    snapshot(snap)
    rec = {"calls": 12}
    assert read("detect.host_ms", rec) == pytest.approx(
        1e3 * statistics.median(host[c] for c in range(3, 15)))
    assert read("detect.gapfill_ms", rec) == pytest.approx(
        1e3 * statistics.median(0.0003 + 1e-5 * c for c in (3, 6, 9, 12)))
    assert read("detect.setup_kernel_s", rec) == pytest.approx(0.15)
    # a window longer than the readings kept: every unprofiled one is read
    assert read("detect.host_ms", {"calls": 10_000}) == pytest.approx(
        1e3 * statistics.median(host[c] for c in range(1, 15)))


@pytest.mark.parametrize("name", READERS)
def test_a_reader_gives_none_without_its_span(snapshot, name):
    snapshot({"spans": {}, "counters": {}})
    assert read(name, {"calls": 4}) is None


@pytest.mark.parametrize("name", READERS)
def test_a_reader_gives_none_for_a_program_without_spans(monkeypatch, name):
    monkeypatch.delattr(profiling, "snapshot")
    assert read(name, {"calls": 4}) is None


@pytest.mark.parametrize("name", READERS)
def test_a_reader_of_the_programs_own_registry_without_device_times(monkeypatch, name):
    """Without device timing (as on the CPU) the real registry gives the
    readers nothing to read, and none raises."""
    monkeypatch.setattr(profiling, "_can_time_device", lambda: False)
    profiling.reset()
    try:
        with profiling.span("kin.call"):
            with profiling.span("kin.ik"):
                pass
        value = read(name, {"calls": 1})
    finally:
        profiling.reset()
    assert value is None
