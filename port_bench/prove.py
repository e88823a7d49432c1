"""Readings that a cell's limits are set from, on the card, in one process:
the numbers compared for the program on many seeds, for each of the
driver's controls (the reference in a precision below the
configuration's, put in the program's place) on a few, and for the
program with a fault of ``faults.py`` planted. Each comes from the
driver's own ``check`` and carries the verdict a run would print.

    python3 port_bench/prove.py --workload <cell> --seeds 11,12,... \
        --control-seeds 21,22,23 [--seconds 1] \
        [--faults kin.half,kin.altered --fault-seeds 31,32,33]

The benchmark's runs never run this. Each seed's line is printed as it
comes, one JSON object, and the last line sums them up. It exits with 1
when the first control comes out correct on a seed, or a fault does.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", sub)
sys.path[:0] = [HERE, ROOT]

import faults  # noqa: E402
import harness  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=0.5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    wl = harness.workload(args.workload)
    cfg = harness.config(wl["config"])
    d = harness.load("drivers", wl["driver"])
    print(json.dumps({"card": harness.smi(), "torch": torch.__version__}), flush=True)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    rows = []

    def one(seed, what, checks):
        t = time.perf_counter()
        run = d.setup(cfg, wl, seed, dev)
        t_setup = time.perf_counter() - t
        if what == "program" or what.startswith("fault:"):
            d.window(run, args.seconds)
        for name, control in checks:
            compared = d.check(run, control)
            row = {"seed": seed, "what": name, "setup_s": t_setup,
                   "s": time.perf_counter() - t, "correct": harness.correct(compared),
                   **{c["name"]: c["value"] for c in compared}}
            print(json.dumps(row), flush=True)
            rows.append(row)
        del run
        torch.cuda.empty_cache()

    for s in seeds:
        one(s, "program", [("program", None)])
    for s in cseeds:
        one(s, "control", [(f"control:{c}", c) for c in d.CONTROLS])
    for fault in [f for f in args.faults.split(",") if f]:
        for s in [int(x) for x in args.fault_seeds.split(",") if x]:
            with faults.planted(fault):
                one(s, f"fault:{fault}", [(f"fault:{fault}", None)])
    summary = {}
    for what in sorted({r["what"] for r in rows}):
        sel = [r for r in rows if r["what"] == what]
        keys = [k for k in sel[0] if k not in ("seed", "what", "setup_s", "s")
                and isinstance(sel[0][k], float)]
        summary[what] = {k: [min(r[k] for r in sel), max(r[k] for r in sel)] for k in keys}
        summary[what]["correct"] = sum(r["correct"] for r in sel)
        summary[what]["seeds"] = len(sel)
    print(json.dumps({"summary": summary}), flush=True)
    caught = [r for r in rows if r["what"] == f"control:{d.CONTROLS[0]}"
              or r["what"].startswith("fault:")]
    if any(r["correct"] for r in caught):
        sys.exit(1)


if __name__ == "__main__":
    main()
