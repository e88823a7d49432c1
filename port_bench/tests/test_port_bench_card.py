"""The benchmark on a card: a short run of the detection cell, untraced
and traced, with every key of its result line. Skips without a
card."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["detect.lower.v512x240"])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(card, cell, trace):
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", cell, "--seed",
                          str(2**31 + 99), "--seconds", "2", "--trace", str(trace)],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res) >= {"correct", "attempted", "failed", "metrics", "device"}
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
