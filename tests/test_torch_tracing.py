"""The spans and counters of ``chd_tpu_torch.utils.profiling`` and where the
program places them.

On the CPU: nesting gives each reading its parent and its call's id; host
seconds, counts and the bound on kept readings; the sampling rule of
device timing, on a fake clock with fake CUDA events; no device time where
CUDA is not initialised; a ``record_function`` range only while a
``torch.profiler`` is active; the spans of ``optimize_trajectory_batch``,
``ContactDetector.infer`` and ``run_pipeline`` (whose log lines now come
from them). On a card (marker ``cuda``; skipped without one): event pairs
resolve to stream times, a capture's kernel and copy nodes are what
``torch.profiler`` sees a replay of its graph run, and no event is
recorded while a stream is being captured. The file imports no JAX, so the
card's part runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py
"""
import logging
import os

import numpy as np
import pytest
import torch

from chd_tpu_torch.contact import infer
from chd_tpu_torch.core.animation import Animation
from chd_tpu_torch.kinematics import batch
from chd_tpu_torch.kinematics.lm import LMConfig
from chd_tpu_torch.models.contact_mlp import ContactMLP
from chd_tpu_torch.pipeline import run as pipeline_run
from chd_tpu_torch.utils import profiling
from chd_tpu_torch.utils.cuda_graph import GraphCache
from chd_tpu_torch.utils.log import get_logger
from chip_smoke import kin_problem

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                      "trajectory_golden.npz")
KIN_STAGES = ["kin.prepare", "kin.ik", "kin.lm1", "kin.floor", "kin.lm2", "kin.unpack"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as the port's other solver test files pin it."""
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_registry():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device timing and graph capture run only there")
    return torch.device("cuda")


class FakeClock:
    def __init__(self):
        self.ns = 0

    def __call__(self):
        return self.ns


class FakeEvent:
    """A CUDA event that records the fake clock's time."""

    made = []
    reads = 0

    def __init__(self, clock, enable_timing=False):
        self.clock, self.at = clock, None
        FakeEvent.made.append(self)

    def record(self, stream=None):
        self.at = self.clock.ns

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        FakeEvent.reads += 1
        return (end.at - self.at) * 1e-6  # ms


@pytest.fixture
def fake_device(monkeypatch):
    """A fake clock for the registry, and fake CUDA events on it that the
    spans may always record."""
    clock = FakeClock()
    FakeEvent.made, FakeEvent.reads = [], 0
    monkeypatch.setattr(profiling.REGISTRY, "clock", clock)
    monkeypatch.setattr(profiling, "_can_time_device", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda enable_timing=False: FakeEvent(clock, enable_timing))
    return clock


def _readings(snap, name):
    return snap["spans"][name]["readings"]


def test_nesting_gives_parents_and_call_ids():
    with profiling.span("call", V=3):
        with profiling.span("a"):
            with profiling.span("b"):
                pass
        with profiling.span("a"):
            pass
    with profiling.span("call"):
        pass
    with profiling.span("a"):
        pass
    snap = profiling.snapshot()
    calls = _readings(snap, "call")
    assert [(r["parent"], r["call"]) for r in calls] == [(None, 1), (None, 2)]
    assert calls[0]["attrs"] == {"V": 3} and calls[1]["attrs"] == {}
    assert [(r["parent"], r["call"]) for r in _readings(snap, "a")] == [
        ("call", 1), ("call", 1), (None, 3)]
    assert [(r["parent"], r["call"]) for r in _readings(snap, "b")] == [("a", 1)]
    assert profiling.REGISTRY.open.stack == []


def test_a_span_left_by_an_exception_is_recorded_and_closed():
    with pytest.raises(ValueError):
        with profiling.span("outer"):
            with profiling.span("inner"):
                raise ValueError("inside")
    snap = profiling.snapshot()
    assert snap["spans"]["outer"]["count"] == snap["spans"]["inner"]["count"] == 1
    assert profiling.REGISTRY.open.stack == []


def test_host_seconds_counts_and_the_bound_on_kept_readings(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(profiling.REGISTRY, "clock", clock)
    monkeypatch.setattr(profiling, "KEEP", 4)
    for i in range(10):
        sp = profiling.span("s", i=i)
        with sp:
            clock.ns += 1_000_000 * (i + 1)
        clock.ns += 7
        assert sp.host_s == pytest.approx(1e-3 * (i + 1))
    snap = profiling.snapshot()["spans"]["s"]
    assert snap["count"] == 10
    assert snap["host_s"] == pytest.approx(1e-3 * 55)
    assert [r["attrs"]["i"] for r in snap["readings"]] == [6, 7, 8, 9]
    assert [r["host_s"] for r in snap["readings"]] == pytest.approx([7e-3, 8e-3, 9e-3, 10e-3])
    assert all(r["device_s"] is None and not r["profiled"] for r in snap["readings"])


def test_counters_count_and_gauge():
    profiling.count("n")
    profiling.count("n", 4)
    profiling.gauge("g", 2.5)
    profiling.gauge("g", 1.5)
    assert profiling.snapshot()["counters"] == {"n": 5, "g": 1.5}
    profiling.reset()
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


def test_sampling_rule_times_the_first_entry_then_once_in_50_ms(fake_device):
    clock = fake_device
    starts = [0, 10, 49, 50, 60, 99, 100, 300, 301]  # ms
    for t in starts:
        clock.ns = t * 1_000_000
        with profiling.span("s"):
            clock.ns += 2_000_000
    timed = [r["device_s"] is not None for r in _readings(profiling.snapshot(), "s")]
    assert timed == [True, False, False, True, False, False, True, True, False]
    assert len(FakeEvent.made) == 2 * sum(timed)
    assert all(r["device_s"] == pytest.approx(2e-3)
               for r in _readings(profiling.snapshot(), "s") if r["device_s"] is not None)


def test_device_times_resolve_lazily_from_the_calls_first_event(fake_device):
    clock = fake_device
    with profiling.span("call"):
        clock.ns += 1_000_000
        with profiling.span("stage1"):
            clock.ns += 3_000_000
        clock.ns += 2_000_000
        with profiling.span("stage2"):
            clock.ns += 5_000_000
    # events are recorded, not resolved, until the readings are read
    assert all(ev.at is not None for ev in FakeEvent.made) and len(FakeEvent.made) == 6
    assert FakeEvent.reads == 0
    snap = profiling.snapshot()
    assert FakeEvent.reads > 0
    got = {n: (_readings(snap, n)[0]["device_at_s"], _readings(snap, n)[0]["device_s"])
           for n in ("call", "stage1", "stage2")}
    assert got["call"] == pytest.approx((0.0, 11e-3))
    assert got["stage1"] == pytest.approx((1e-3, 3e-3))
    assert got["stage2"] == pytest.approx((6e-3, 5e-3))


def test_a_child_of_an_untimed_call_has_no_offset(fake_device):
    clock = fake_device
    with profiling.span("call"):
        pass
    clock.ns += 10_000_000  # the call's name is not due again; the child's first entry is
    with profiling.span("call"):
        with profiling.span("child"):
            clock.ns += 1_000_000
    snap = profiling.snapshot()
    child = _readings(snap, "child")[0]
    assert _readings(snap, "call")[1]["device_s"] is None
    assert child["device_s"] == pytest.approx(1e-3) and child["device_at_s"] is None


def test_no_device_time_where_cuda_is_not_initialised(monkeypatch):
    def no_event(*a, **k):
        raise AssertionError("a CUDA event was made")

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    for _ in range(3):
        with profiling.span("s"):
            torch.ones(4).sum()
    assert [r["device_s"] for r in _readings(profiling.snapshot(), "s")] == [None] * 3


def test_record_function_only_while_a_profiler_is_active(monkeypatch, tmp_path):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with profiling.span("quiet"):
        torch.ones(8).mul(2.0).sum()
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("seen"):
            with profiling.span("inner"):
                torch.ones(8).mul(2.0).sum()
    assert entered == ["seen", "inner"]
    names = [e.name for e in prof.events()]
    assert "seen" in names and "inner" in names
    snap = profiling.snapshot()
    assert not _readings(snap, "quiet")[0]["profiled"]
    assert _readings(snap, "seen")[0]["profiled"] and _readings(snap, "inner")[0]["profiled"]
    with profiling.trace(str(tmp_path)):  # the operator's trace shows them over the ops
        with profiling.span("traced"):
            torch.ones(8).mul(3.0).sum()
    import glob
    import json

    (path,) = glob.glob(os.path.join(str(tmp_path), "*.pt.trace.json"))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    (rng,) = [e for e in events if e.get("name") == "traced"]
    mul = [e for e in events if e.get("name", "").startswith("aten::mul")]
    assert mul and all(rng["ts"] <= e["ts"] <= rng["ts"] + rng["dur"] for e in mul)


@pytest.fixture(scope="module")
def skel():
    g = np.load(GOLDEN)
    return Animation(g["skel_rotations"], g["skel_positions"], g["skel_orients"],
                     g["skel_offsets"], [int(p) for p in g["skel_parents"]])


@pytest.fixture(scope="module")
def problems(skel):
    rng = np.random.default_rng(5)
    return [kin_problem(rng, skel, 10, 0.3), kin_problem(rng, skel, 8, 0.3)]


def _kin_call(problems, skel, device="cpu", **kw):
    return batch.optimize_trajectory_batch(problems, skel, ik_iterations=3,
                                           lm_cfg=LMConfig(max_iters=2, cg_iters=4),
                                           device=device, ik_solver="lu", **kw)


def test_optimize_trajectory_batch_records_its_stages(problems, skel):
    _kin_call(problems, skel)
    _kin_call(problems, skel, floor=(np.array([0.0, 1.0, 0.0]), np.array([0.0, -95.0, 0.0])))
    snap = profiling.snapshot()
    calls = _readings(snap, "kin.call")
    assert [r["attrs"] for r in calls] == [{"B": 2, "F": 10}] * 2
    assert calls[0]["call"] != calls[1]["call"]
    for i, (call, want) in enumerate(zip(calls, [KIN_STAGES,
                                                 [s for s in KIN_STAGES if s != "kin.floor"]])):
        mine = sorted((r for n, s in snap["spans"].items() if n != "kin.call"
                       for r in s["readings"] if r["call"] == call["call"]),
                      key=lambda r: r["start_ns"])
        assert [r["name"] for r in mine] == want
        assert all(r["parent"] == "kin.call" for r in mine)
        assert all(call["start_ns"] <= r["start_ns"] <= r["end_ns"] <= call["end_ns"]
                   for r in mine)
        assert [r["attrs"] for r in mine if r["name"].startswith("kin.lm")] == [{"steps": 2}] * 2
    assert snap["spans"]["kin.floor"]["count"] == 1


def test_contact_detector_records_its_steps():
    torch.manual_seed(0)
    det = infer.ContactDetector(ContactMLP(351, 20).eval(), device="cpu")
    kp = torch.rand(2, 20, 25, 3)
    for _ in range(2):
        det.infer(kp)
    snap = profiling.snapshot()
    calls = _readings(snap, "detect.infer")
    assert [r["attrs"] for r in calls] == [{"V": 2, "F": 20}] * 2
    for call in calls:
        mine = sorted((r for n in ("detect.gapfill", "detect.mlp", "detect.vote")
                       for r in _readings(snap, n) if r["call"] == call["call"]),
                      key=lambda r: r["start_ns"])
        assert [r["name"] for r in mine] == ["detect.gapfill", "detect.mlp", "detect.vote"]
        assert all(r["parent"] == "detect.infer" for r in mine)


def test_run_pipeline_stages_are_spans_and_log_their_time(monkeypatch):
    order = []
    for name in ("run_kinematic_stage", "run_retarget_stage", "run_physics_stage"):
        monkeypatch.setattr(pipeline_run, name,
                            lambda *a, _n=name, **k: order.append(_n) or {"stage": _n})
    lines = []
    handler = logging.Handler()
    handler.emit = lambda rec: lines.append(rec.getMessage())
    logger = get_logger("pipeline")
    logger.addHandler(handler)
    try:
        cfg = type("Cfg", (), {"character": "ybot"})()
        out = pipeline_run.run_pipeline("vid", cfg, device="cpu")
    finally:
        logger.removeHandler(handler)
    assert out == {"stage": "run_physics_stage"}
    assert order == ["run_kinematic_stage", "run_retarget_stage", "run_physics_stage"]
    snap = profiling.snapshot()
    assert [snap["spans"][n]["count"] for n in ("run.kinematic", "run.retarget",
                                                "run.physics")] == [1, 1, 1]
    assert lines[0::2] == ["kinematic [vid] ...", "retarget → ybot ...", "physics ..."]
    host = [_readings(snap, n)[0]["host_s"] for n in ("run.kinematic", "run.retarget",
                                                       "run.physics")]
    assert lines[1::2] == [f"{label} done in {s:.1f}s" for label, s in
                           zip(["kinematic [vid]", "retarget → ybot", "physics"], host)]


# -- on the card ---------------------------------------------------------------

@pytest.mark.cuda
def test_event_pairs_resolve_to_stream_times(card):
    a = torch.randn(2048, 2048, device=card)
    torch.cuda.synchronize()
    with profiling.span("call"):
        with profiling.span("work"):
            for _ in range(20):
                a = a @ a.T * 1e-3
    snap = profiling.snapshot()
    call, work = _readings(snap, "call")[0], _readings(snap, "work")[0]
    assert 0 < work["device_s"] <= call["device_s"]
    assert 0 <= work["device_at_s"] <= call["device_s"] - work["device_s"] + 1e-6
    assert call["device_at_s"] == 0.0


def _device_events(prof) -> int:
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False))


@pytest.mark.cuda
def test_capture_node_counts_are_the_kernels_of_a_replay(card, problems, skel):
    """A replay runs each kernel node, and each device-to-device copy node
    as a copy kernel of the driver's: ``torch.profiler`` sees their sum."""
    graphs = GraphCache()
    _kin_call(problems, skel, device=card, graphs=graphs)
    snap = profiling.snapshot()
    caps = _readings(snap, "graphs.capture")
    assert [r["parent"] for r in caps] == ["kin.lm1"]  # the LU IK is eager
    (key,) = [k for k in graphs.entries if k[0] == "lm_step"]
    graph = graphs.entries[key].graph
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    attrs = caps[0]["attrs"]
    assert attrs["kernel_nodes"] > 0
    assert attrs["kernel_nodes"] + attrs["copy_nodes"] == _device_events(prof)


@pytest.mark.cuda
def test_no_event_is_recorded_during_a_capture(card, monkeypatch):
    made = []
    real = torch.cuda.Event
    monkeypatch.setattr(torch.cuda, "Event", lambda **k: made.append(k) or real(**k))
    x = torch.ones(64, device=card)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x.mul(2.0)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        with profiling.span("captured"):  # a first entry: due for device timing
            y = x.mul(2.0)
    g.replay()
    torch.cuda.synchronize()
    assert made == [] and float(y.sum()) == 128.0
    assert _readings(profiling.snapshot(), "captured")[0]["device_s"] is None
