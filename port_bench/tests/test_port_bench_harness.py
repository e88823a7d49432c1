"""The harness's own arithmetic and rules on the CPU: the guard against
JAX by whole top-level names, the union of device intervals and the idle
gaps of a synthetic trace, the MLP's FLOP and bytes, and a cell, config
and metric added as files only."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)

import harness  # noqa: E402
import roofline  # noqa: E402


@pytest.mark.parametrize("name, bad", [
    ("chd_tpu_torch", False), ("chd_tpu_torch.ops.fused_mlp", False), ("jaxtyping", False),
    ("chd_tpu", True), ("chd_tpu.ops", True), ("jax", True), ("jax.numpy", True),
    ("jaxlib.xla_client", True), ("flax.linen", True)])
def test_import_guard_compares_whole_top_level_names(name, bad):
    assert harness.forbidden_modules([name, "numpy"]) == ([name] if bad else [])


def test_union_gaps_and_idle_share_of_a_synthetic_trace():
    events = [{"name": "a", "start": 0.0, "end": 1.0}, {"name": "b", "start": 0.5, "end": 2.0},
              {"name": "a", "start": 3.0, "end": 4.0}, {"name": "c", "start": 6.0, "end": 6.5}]
    host = [{"name": "outer", "start": 0.0, "end": 7.0},
            {"name": "sync", "start": 4.2, "end": 5.9}]
    assert harness.union_s([(e["start"], e["end"]) for e in events]) == pytest.approx(3.5)
    assert harness.gaps([(0, 1), (0.5, 2), (3, 4)], 0, 5) == [(2, 3), (4, 5)]
    s = harness.device_slice(events, host, wall_s=10.0)
    assert s["busy_s"] == pytest.approx(3.5) and s["idle_share"] == pytest.approx(0.65)
    assert s["device_ops"][0] == ["a", pytest.approx(2.0)]
    assert s["idle_gaps"] == [["sync", pytest.approx(2.0)], ["outer", pytest.approx(1.0)]]
    with pytest.raises(RuntimeError, match="miscounted"):  # busy past the slice: no clamp
        harness.device_slice(events, host, wall_s=3.0)


def test_mlp_flop_and_bytes_at_the_main_path_shape():
    cfg = harness.config("contact_lower")
    assert roofline.mlp_flop_per_row(roofline.mlp_dims(cfg)) == 1_907_968
    assert roofline.detect_rows(512, 240, 9) == 118_784
    assert roofline.detect_flop(cfg, 512, 240) == 1_907_968 * 118_784
    assert roofline.detect_flop(cfg, 512, 240) == pytest.approx(2.266e11, rel=1e-3)
    assert roofline.mlp_kernel_bytes(cfg, 512, 240) == pytest.approx(32.49e6, rel=1e-3)
    assert roofline.mlp_bound_s(cfg, 512, 240) == pytest.approx(0.2292e-3, rel=1e-3)


def test_a_cell_config_and_metric_added_as_files_are_found(bench_copy):
    """A later change adds a cell: a config file, a cell file, a metric
    reader and the manifest's entries, and edits no file."""
    root = bench_copy.parent
    with open(bench_copy / "configs" / "contact_lower.json") as fh:
        cfg = json.load(fh)
    cfg["name"] = "contact_dummy"
    (bench_copy / "configs" / "contact_dummy.json").write_text(json.dumps(cfg))
    with open(bench_copy / "workloads" / "detect.lower.v512x240.json") as fh:
        wl = json.load(fh)
    wl["config"] = "contact_dummy"
    (bench_copy / "workloads" / "detect.dummy.json").write_text(json.dumps(wl))
    (bench_copy / "metrics" / "dummy.calls.py").write_text(
        "def read(rec):\n    return rec.get('calls_traced')\n")
    with open(root / "BENCHMARK.json") as fh:
        man = json.load(fh)
    man["configs"].append({"name": "contact_dummy", "source": "x", "reduced": [], "why": "x",
                           "file": "port_bench/configs/contact_dummy.json"})
    man["workloads"].append({"name": "detect.dummy", "config": "contact_dummy",
                             "traffic": "keypoints", "chips": 1, "why": "x"})
    man["per_layer"].append({"name": "dummy.calls", "unit": "1", "better": "higher",
                             "source": "program_counter", "layer": "Detector",
                             "moves": "contact_frames_per_s", "workloads": ["detect.dummy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import harness, json; "
            "m = harness.manifest(); wl = harness.workload('detect.dummy'); "
            "print(json.dumps([harness.config(wl['config'])['name'], "
            "harness.load('drivers', wl['driver']).__name__, "
            "harness.read_metrics('detect.dummy', m, {'calls_traced': 20, 'idle_share': 0.5}), "
            "[x['name'] for x in harness.per_layer_for('detect.lower.v512x240', m)]]))")
    out = subprocess.run([sys.executable, "-c", code, str(bench_copy)], capture_output=True,
                         text=True, check=True).stdout
    name, driver, read, old = json.loads(out)
    assert name == "contact_dummy" and driver == "port_bench.drivers.detect"
    assert read["dummy.calls"] == {"value": 20.0, "unit": "1"}
    assert "dummy.calls" not in old
