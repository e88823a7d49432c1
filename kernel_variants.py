"""Variants of the fused-MLP kernel, built side by side and timed on one card.

    python3 kernel_variants.py [NAME ...]

Each variant is ``chd_tpu_torch/csrc/fused_mlp.cu`` with a few textual edits
(``VARIANTS``), built with ``nvcc`` and the port's flags into
``build/kernel_variants/``, all builds at once. For each, it prints ptxas'
notes on wgmma (serialization, injected waits) and spills, then times the
kernel by CUDA events (mean of 10 launches after one) at the main path's
shape, 512 videos x 240 frames of conv rows: ``lower``'s 118,784 x 351 in
every mode, and ``full``'s 118,784 x 675 in "high", with seeded random
weights, beside each mode's max |d| against its emulation. The controls
("no weight copies", "no wgmma") compute wrong logits on purpose: they show
what the rest of the kernel costs. With no names it runs every variant.
Needs a CUDA card and ``nvcc``; compare variants only within one run.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(REPO, "chd_tpu_torch", "csrc", "fused_mlp.cu")
OUT = os.path.join(REPO, "build", "kernel_variants")

# name -> (what it shows, [(text, replacement), ...])
VARIANTS = {
    "as built": ("the kernel as it is", []),
    "cluster 1": ("no cluster: each block copies every stage itself",
                  [("constexpr int kCluster = 2;", "constexpr int kCluster = 1;")]),
    "cluster 4": ("4-block clusters: each stage leaves L2 once for 4 blocks",
                  [("constexpr int kCluster = 2;", "constexpr int kCluster = 4;")]),
    "double-buffered A": ("every mode double-buffers its A fragments and waits for all "
                          "but the last k16 step's wgmmas",
                          [("constexpr bool kWait = P > 1;", "constexpr bool kWait = false;")]),
    "no weight copies": ("control: the producer marks each stage full without copying it",
                         [("""          mbar_expect_tx(full + 8 * r.slot, kStage);
          bulk_copy(ring + r.slot * kStage + rank * kSlice, src + (size_t)t * kStage, kSlice,
                    full + 8 * r.slot);""", """          mbar_arrive(full + 8 * r.slot);""")]),
    "no wgmma": ("control: the one-group modes issue no wgmma (\"highest\" keeps its own)",
                 [("""    wgmma_fence();
#pragma unroll
    for (int q = 0; q < passes(M); ++q)
      wgmma(acc, a[pass_a(M, q)], desc(b + pass_b(M, q) * kPartBytes), 1);""",
                   """    wgmma_fence();""")]),
}


def main(names) -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False; this needs one CUDA card")
    sys.path.insert(0, REPO)
    from chd_tpu_torch.models import contact_mlp
    from chd_tpu_torch.ops import fused_mlp as fm
    from chd_tpu_torch.utils import build

    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        sys.exit(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    src = open(SOURCE).read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for i, name in enumerate(names):
        text = src
        for old, new in VARIANTS[name][1]:
            if old not in text:
                sys.exit(f"variant {name!r}: its edit no longer matches {SOURCE}")
            text = text.replace(old, new)
        cu = os.path.join(OUT, f"v{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", cu[:-3] + ".so", cu]
        procs[name] = (cu[:-3] + ".so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    gen = torch.Generator().manual_seed(0)
    cases = []  # (width, rows' stride, frames, layers)
    for width, stride in ((351, 39), (675, 75)):
        frames = torch.randn(512, 240 * stride, generator=gen).cuda()
        dims = [width, *contact_mlp.HIDDEN, 20]
        layers = [(torch.randn(dims[i], dims[i + 1], generator=gen).mul_(dims[i] ** -0.5).cuda(),
                   torch.randn(dims[i + 1], generator=gen).mul_(0.1).cuda()) for i in range(5)]
        cases.append((width, stride, frames, layers))

    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        print(f"== {name}: {VARIANTS[name][0]} (nvcc rc {proc.returncode})", flush=True)
        if proc.returncode:
            print(log[-4000:])
            continue
        for line in log.splitlines():
            m = re.search(r"fused_mlp_kernelILb(\d)ELi(\d)E", line)
            if "C75" in line or ("spill" in line and " 0 bytes spill stores" not in line):
                what = re.sub(r"\s+in (the )?function.*", "", line.split("info    :")[-1]).strip()
                print(f"   ptxas{' ' + str(m.groups()) if m else ''}: {what[:140]}")
        lib = ctypes.CDLL(path)
        build._declare(lib)
        build._kernels = build.Kernels(lib, path, 0.0, log)
        for width, stride, frames, layers in cases:
            for mode in fm.MODES if width == 351 else ("high",):
                args = (fm.MlpLayers(layers, mode), frames, width, stride)
                got = fm.fused_mlp(*args)
                torch.cuda.synchronize()
                err = (got - fm.emulation(mode)(*args)).abs().max().item()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(10):
                    fm.fused_mlp(*args)
                end.record()
                torch.cuda.synchronize()
                print(f"   d0={width} {mode}: {start.elapsed_time(end) / 10:.3f} ms, "
                      f"max|d| vs emulation {err:.2e}", flush=True)
    print(smi)


if __name__ == "__main__":
    main(sys.argv[1:] or list(VARIANTS))
