"""chd_tpu_torch.parallel.dryrun: the multi-rank dry run on 4 gloo ranks of
the CPU (the counterpart of ``__graft_entry__.dryrun_multichip``, which lays
4 devices as data=2 x model=2 and so solves one physics sequence a "data"
shard), and the
rank launcher's guarantees: a rank's failure fails the run with its
traceback, a rank that hangs is terminated at the deadline, and no process
is left behind.

Budgets: the dry run's ranks may spend at most ``DRYRUN_CPU_S`` seconds of
CPU time in all (a run alone on an 8-core x86 host reads ~45 s, in ~12 s of
wall time) and end within ``DRYRUN_WALL_S`` seconds; the hang ends within
its ``HANG_DEADLINE_S`` plus the launcher's 10 s of grace per rank.
"""
import multiprocessing
import resource
import time

import pytest
import torch

from chd_tpu_torch.parallel.dryrun import dryrun_multichip, run_ranks

import torch_rank_workers as workers

DRYRUN_CPU_S, DRYRUN_WALL_S = 200.0, 300.0
HANG_DEADLINE_S = 20.0


def _children_cpu_s() -> float:
    r = resource.getrusage(resource.RUSAGE_CHILDREN)
    return r.ru_utime + r.ru_stime


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    cpu0, t0 = _children_cpu_s(), time.monotonic()
    line = dryrun_multichip(4, "cpu", timeout=DRYRUN_WALL_S)
    cpu, wall = _children_cpu_s() - cpu0, time.monotonic() - t0
    assert line.startswith("dryrun_multichip OK: 4 ranks on cpu (gloo; data=2, model=2)")
    for part in ("train dp x tp", "slice mesh (slice=2, data=2)",
                 "physics dp(B=2) OK perm-equivariant",
                 "longseq probe OK (4-way frame shard"):
        assert part in line, line
    assert line in capsys.readouterr().out
    assert cpu <= DRYRUN_CPU_S and wall <= DRYRUN_WALL_S, (cpu, wall)
    assert multiprocessing.active_children() == []


def test_cuda_dryrun_needs_a_card_a_rank():
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match=f"{n} ranks on cuda need {n} cards"):
        dryrun_multichip(n, "cuda")
    with pytest.raises(ValueError, match="device must be one of"):
        run_ranks(workers.fail_on_rank_one, 2, "tpu")


def test_the_default_device_is_cuda():
    """Neither entry point falls back to gloo on the CPU: without a device
    named, the ranks go to the cards, and too few cards raise."""
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match=f"{n} ranks on cuda need {n} cards"):
        dryrun_multichip(n)
    with pytest.raises(RuntimeError, match=f"{n} ranks on cuda need {n} cards"):
        run_ranks(workers.fail_on_rank_one, n)
    assert multiprocessing.active_children() == []


def test_a_failing_rank_fails_the_run(tmp_path):
    with pytest.raises(RuntimeError, match="rank one fails on purpose"):
        run_ranks(workers.fail_on_rank_one, 2, "cpu", timeout=120.0, workdir=str(tmp_path))
    assert multiprocessing.active_children() == []


def test_a_hanging_rank_is_terminated_at_the_deadline(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="gave no result"):
        run_ranks(workers.hang_on_rank_one, 2, "cpu", timeout=HANG_DEADLINE_S,
                  group_timeout=120.0, workdir=str(tmp_path))
    assert time.monotonic() - t0 <= HANG_DEADLINE_S + 2 * 10.0
    assert multiprocessing.active_children() == []
