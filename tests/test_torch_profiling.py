"""chd_tpu_torch.utils.profiling against chd_tpu.utils.profiling.

- ``benchmark`` makes the same calls as chd_tpu's (a first call, warmup-1
  more, then iters timed ones) for each (warmup, iters) pair, and returns
  ``iters_per_s == 1 / mean_s`` exactly;
- ``_sync`` reads every tensor leaf of a tree of tuples, lists, dicts,
  NamedTuples and dataclasses back on the host;
- ``trace`` writes a Chrome trace under its directory that holds a
  ``record_function`` span of the block.
Host code: counts and spans compared exactly.
"""
import dataclasses
import glob
import json
import os
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chd_tpu.utils import profiling as jax_profiling
from chd_tpu_torch.utils import profiling


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as the port's other test files pin it."""
    torch.set_num_threads(1)


@pytest.mark.parametrize("warmup,iters", [(0, 1), (1, 10), (3, 2), (5, 0)])
def test_benchmark_calls_as_chd_tpu(warmup, iters):
    calls = {"jax": [], "torch": []}
    x = np.arange(6.0)

    def jax_fn(a):
        calls["jax"].append(a)
        return {"y": jnp.asarray(a) * 2.0}

    def torch_fn(a):
        calls["torch"].append(a)
        return {"y": torch.from_numpy(a) * 2.0}

    if iters == 0:  # chd_tpu divides by zero there, and so does the port
        for bench, fn in ((jax_profiling.benchmark, jax_fn), (profiling.benchmark, torch_fn)):
            with pytest.raises(ZeroDivisionError):
                bench(fn, x, warmup=warmup, iters=iters)
    else:
        want = jax_profiling.benchmark(jax_fn, x, warmup=warmup, iters=iters)
        got = profiling.benchmark(torch_fn, x, warmup=warmup, iters=iters)
        assert sorted(got) == sorted(want) == ["iters_per_s", "mean_s"]
        assert got["mean_s"] > 0 and got["iters_per_s"] == 1.0 / got["mean_s"]
    assert len(calls["torch"]) == len(calls["jax"]) == 1 + max(warmup - 1, 0) + iters
    assert all(a is x for a in calls["torch"])


class _Pair(NamedTuple):
    a: torch.Tensor
    b: list


@dataclasses.dataclass
class _State:
    w: torch.Tensor
    meta: dict
    name: str = "s"


def test_sync_reads_every_tensor_leaf(monkeypatch):
    """Each tensor of the tree enters the host read; numpy arrays, numbers
    and strings are passed over; a tree without tensors reads nothing."""
    tree = (_Pair(torch.ones(2), [torch.zeros(3, dtype=torch.bool), np.ones(4), 7]),
            {"s": _State(torch.full((2, 2), -3.0), {"k": [torch.arange(5)]})}, "text")
    leaves = list(profiling._leaves(tree))
    assert [tuple(t.shape) for t in leaves] == [(2,), (3,), (2, 2), (5,)]
    read = []
    monkeypatch.setattr(torch.Tensor, "__float__", lambda t: read.append(t.item()) or t.item())
    profiling._sync(tree)
    assert read == [2.0 + 0.0 + 12.0 + 10.0]
    read.clear()
    profiling._sync(({"a": np.ones(3)}, [1.0]))
    assert read == []


def test_trace_writes_a_chrome_trace_with_the_span(tmp_path):
    log_dir = str(tmp_path / "tb")
    with profiling.trace(log_dir):
        with torch.profiler.record_function("chd_span"):
            torch.ones(64).mul(3.0).sum()
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("name") == "chd_span"]
    assert len(spans) == 1 and spans[0]["dur"] >= 0
    assert any(e.get("name", "").startswith("aten::mul") for e in events)


def test_trace_writes_its_trace_when_the_block_raises(tmp_path):
    with pytest.raises(ValueError):
        with profiling.trace(str(tmp_path)):
            with torch.profiler.record_function("before_the_error"):
                torch.ones(3).sum()
            raise ValueError("inside the traced block")
    files = glob.glob(os.path.join(str(tmp_path), "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        assert any(e.get("name") == "before_the_error" for e in json.load(f)["traceEvents"])
