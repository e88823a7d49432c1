"""The manifest keeps to the benchmark's format: names, units and
sentences of the allowed characters and lengths, and every cell, config
and metric found as files by its name."""
from __future__ import annotations

import json
import os
import re

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest():
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        return json.load(fh)


def line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_names_and_units():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    names = [c["name"] for c in m["configs"]] + [w["name"] for w in m["workloads"]]
    names += [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names))
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and line(w["why"])
        assert w["chips"] in (1, 4)
    assert any(x["name"] == "setup_s" for x in m["end_to_end"])
    for x in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"]) and x["better"] in ("lower",
                                                                                    "higher")
    for x in m["end_to_end"]:
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    for x in m["per_layer"]:
        assert set(x) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert line(x["layer"]) and x["source"] in ("device_trace", "program_span",
                                                    "program_counter", "host_clock")
    assert all(line(w) for w in m["command"]) and len(m["command"]) <= 32
    assert len(json.dumps(m)) <= 64 * 1024


def test_every_name_is_a_file_and_every_cell_reports_enough():
    m = manifest()
    e2e = {x["name"]: x for x in m["end_to_end"]}
    used = set()
    for c in m["configs"]:
        assert c["file"].startswith("port_bench/") and os.path.exists(os.path.join(REPO, c["file"]))
    for w in m["workloads"]:
        used.add(w["config"])
        with open(os.path.join(BENCH, "workloads", f"{w['name']}.json")) as fh:
            wl = json.load(fh)
        assert wl["config"] == w["config"] and wl["why"] == w["why"]
        assert wl["traffic"]["generator"] == w["traffic"]
        for kind, name in (("drivers", wl["driver"]), ("traffic", w["traffic"])):
            assert os.path.exists(os.path.join(BENCH, kind, f"{name}.py"))
        own = [x for x in e2e.values() if w["name"] in x.get("workloads", [w["name"]])]
        assert any(x["name"] == "setup_s" for x in own) and len(own) >= 2
        layer = [x for x in m["per_layer"] if w["name"] in x.get("workloads", [w["name"]])]
        assert layer and all(x["moves"] in {o["name"] for o in own} for x in layer)
    assert used == {c["name"] for c in m["configs"]}
    for x in m["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics", f"{x['name']}.py"))
        assert x["moves"] in e2e
