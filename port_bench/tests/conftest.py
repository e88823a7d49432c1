"""Fixtures of the benchmark's CPU tests: a copy of the benchmark at tiny
sizes, and a way to run one of its cells there on the CPU (the run's look
for a card skipped) in a fresh process."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)

TINY_TRAFFIC = {
    "detect.lower.v512x240": {"videos": 3, "frames": 40},
    "kin.combined28.b16x100": {"sequences": 2, "frames": 12},
}
# the LU IK at tiny sizes: 10 CG iterations from the SMPL angles leave the
# IK far from converged, and its answer parts on roundings
TINY_KINEMATIC = {"ik_iterations": 10, "ik_solver": "lu", "lm": {"max_iters": 3, "cg_iters": 10}}

# Runs one cell of the copy on the CPU; a fault named on the command line is
# planted in the program first. Prints the result's JSON last.
RUNNER = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
torch.set_num_threads(2)
import faults, run
cell, fault = sys.argv[3], sys.argv[4]
with faults.planted(fault):
    res = run.measure(cell, 2**31 + 5, 0.2, False, torch.device("cpu"))
print(json.dumps(res))
"""


def _tiny(dst: str) -> None:
    for cell, tr in TINY_TRAFFIC.items():
        path = os.path.join(dst, "workloads", f"{cell}.json")
        with open(path) as fh:
            wl = json.load(fh)
        wl["traffic"].update(tr)
        with open(path, "w") as fh:
            json.dump(wl, fh)
    path = os.path.join(dst, "configs", "refine_default.json")
    with open(path) as fh:
        cfg = json.load(fh)
    for k in ("ik_iterations", "ik_solver"):
        cfg["kinematic"][k] = TINY_KINEMATIC[k]
    cfg["kinematic"]["lm"].update(TINY_KINEMATIC["lm"])
    with open(path, "w") as fh:
        json.dump(cfg, fh)


@pytest.fixture
def bench_copy(tmp_path):
    """A checkout of the benchmark alone (``BENCHMARK.json`` and
    ``port_bench/``) at tiny sizes under ``tmp_path``; returns its
    ``port_bench`` directory."""
    dst = tmp_path / "port_bench"
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    _tiny(str(dst))
    return dst


def run_cell(bench: str, cell: str, fault: str = "none", timeout: float = 600) -> dict:
    """``run.measure`` of ``cell`` in the copy ``bench`` on the CPU, in a
    fresh process, with ``fault`` planted; the result's object."""
    proc = subprocess.run([sys.executable, "-c", RUNNER, str(bench), REPO, cell, fault],
                          capture_output=True, text=True, timeout=timeout,
                          env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])
