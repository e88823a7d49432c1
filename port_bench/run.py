"""The benchmark of chd_tpu_torch on NVIDIA cards: one cell, one run.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell's file (``workloads/<cell>.json``)
names its configuration and its driver; the driver builds the program's
objects from the seed and warms every shape the cell uses (set-up, timed
as ``setup_s`` from the process's start), then runs the program for
``--seconds`` without cutting a call (the window), then, with ``--trace
1``, a traced slice that the per-layer metrics' readers take their numbers
from. After the window the program's state is freed and the driver's
check compares what the window produced with the plain reference. The
last lines on standard error, and the result line's last key, are the
numbers compared, each with its limit.

The last line of standard output is the result, one JSON object. The run
fails, and prints no result, without a CUDA card (or with fewer than the
cell asks for), when the program takes a stale path, or when a module of
JAX or of ``chd_tpu`` is loaded. Compile caches live in fixed directories
of the checkout (``build/``).
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", sub)
sys.path[:0] = [HERE, ROOT]

import harness  # noqa: E402


def fail(msg: str, code: int = 1) -> None:
    print(f"port_bench: {msg}", file=sys.stderr)
    sys.exit(code)


def measure(cell: str, seed: int, seconds: float, trace: bool, device, clock=None) -> dict:
    """One run of ``cell`` on ``device``: set-up, the window, with ``trace``
    the traced slice, then the check. Returns the result line's object,
    its ``compared`` numbers last. The benchmark runs it on a card; the
    tests drive it on the CPU at small sizes."""
    import torch

    clock = clock or harness.Clock()
    man = harness.manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if cell not in cells:
        raise KeyError(f"no cell {cell!r} in BENCHMARK.json")
    wl = harness.workload(cell)
    cfg = harness.config(wl["config"])
    on_card = device.type == "cuda"
    driver = harness.load("drivers", wl["driver"])
    run = driver.setup(cfg, wl, seed, device)
    harness.sync(torch, device)
    setup_s = clock()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    done = driver.window(run, seconds)
    harness.sync(torch, device)
    print(f"window: {json.dumps(done['info'])}", file=sys.stderr)

    if trace:
        record = driver.trace(run)
        record.update(done)
        metrics = harness.read_metrics(cell, man, record)
        missing = [m["name"] for m in harness.per_layer_for(cell, man) if m["name"] not in metrics]
        if missing:
            print(f"per-layer metrics with nothing to read: {missing}", file=sys.stderr)
    else:
        metrics = {}
        for m in harness.end_to_end_for(cell, man):
            value = setup_s if m["name"] == "setup_s" else done["metrics"].get(m["name"])
            if value is None:
                raise RuntimeError(f"the cell's driver measured no {m['name']}")
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": cells[cell]["chips"],
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if on_card else 0}
    if trace:
        device_info.update(busy_s=record["busy_s"], window_s=record["window_s"])

    compared = driver.check(run)
    result = {"correct": harness.correct(compared),
              "attempted": done["attempted"], "failed": done["failed"],
              "metrics": metrics, "device": device_info}
    if trace and record.get("breakdown"):
        result["breakdown"] = record["breakdown"]
    result["card"] = harness.smi() if on_card else {}
    result["compared"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                          for c in compared}
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    clock = harness.Clock(T0)
    chips = {w["name"]: w["chips"] for w in harness.manifest()["workloads"]}.get(args.workload)
    if chips is None:
        fail(f"no cell {args.workload!r} in BENCHMARK.json")

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA card: this benchmark measures the card and never falls back to the CPU")
    if torch.cuda.device_count() < chips:
        fail(f"the cell asks for {chips} cards, the machine has {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {json.dumps(harness.smi())}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", file=sys.stderr)
    result = measure(args.workload, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda"), clock)
    loaded = harness.forbidden_modules(sys.modules)
    if loaded:
        fail(f"modules of JAX or chd_tpu are loaded: {loaded}")
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']!r} (limit {c['limit']!r}) "
              f"{'ok' if c['value'] <= c['limit'] else 'OVER'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
