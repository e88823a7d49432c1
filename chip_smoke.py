"""Smoke run of chd_tpu_torch's main path on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``chd_tpu_torch/csrc`` (into ``build/``),
then, on the card:

1. prints the card (``nvidia-smi``), the torch and CUDA versions, and pins
   float32 matmuls and convolutions to full precision (no TF32);
2. builds the kernel and prints the build seconds, ptxas' registers and
   spills, and the count of tensor-core ``HMMA`` instructions in the built
   library (``cuobjdump -sass``), and fails if there is none;
3. holds the fused-MLP kernel against its plain PyTorch version, dense rows
   at B in {1, 7, 31, 32, 33, 63, 64, 65, 256, 300} (the edges of the old
   32-row and the new 64-row tile) and strided (conv-mode) rows for the
   ``lower`` and rootless ``lower_ankles`` joint sets, with the golden and a
   seeded random model: logits within atol 2e-4, rtol 1e-4 (the kernel's
   3-pass bf16 split keeps ~2e-5, as chd_tpu's ``precision="high"`` does);
   it prints the kernel's and the float32 plain version's max |d| against a
   float64 chain, and fails if the kernel's exceeds 2e-4, and the kernel's
   against the split emulation ``fused_mlp_split_plain``;
4. runs ``detect_contacts`` on the two video dirs of
   ``tests/fixtures/contact_golden.npz`` (the main path, with every launch
   count set to 0 just before and read just after): agreement with the
   frozen reference contacts >= 0.999 per video, the saved ``.npy`` equal to
   the returned array, and the kernel launched;
5. runs a realistic batch (512 videos x 240 frames, synthesized from a seed)
   through the detector with the kernel and with the plain MLP, in both
   ``use_conv`` modes: binary agreement >= 0.999 and window-probability
   max |d| <= 1e-4, and frames/s of each (median of 3 synced runs); then the
   kernel alone at that batch's conv-mode rows, against its plain version
   (phase 3's tolerance), timed with CUDA events, and its TFLOP/s on the
   multiply-adds of the five layers;
6. profiles 3 calls of each of phase 5's four paths with ``torch.profiler``:
   wall and device-busy time per call, the device's idle share, and the
   largest device items;
7. bitwise batch invariance: each video's contacts and window
   probabilities on the card are the same alone (V=1) as in a V=21 batch,
   in both ``use_conv`` modes.

Then it prints one JSON line on the kernels, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before the last line, and so does a machine without CUDA.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "fixtures", "contact_golden.npz")
ATOL, RTOL = 2e-4, 1e-4          # kernel vs plain logits
F64_MAX_D = 2e-4                 # kernel logits vs a float64 chain
AGREE_MIN = 0.999                # binary contact agreement
PROB_MAX_D = 1e-4                # window-probability max |d|, kernel vs plain
BIG_V, BIG_F = 512, 240          # the realistic batch
PROF_CALLS = 3                   # profiled calls per path in phase 6


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def synth_videos(n: int, frames: int, seed: int = 0) -> np.ndarray:
    """Keypoints in the 1280x720 training frame with 5 % low-confidence
    dropouts (the recipe of bench.py's contact benchmark)."""
    rng = np.random.default_rng(seed)
    kp = np.zeros((n, frames, 25, 3), np.float32)
    kp[..., 0] = rng.uniform(200, 1100, size=(n, frames, 25))
    kp[..., 1] = rng.uniform(100, 650, size=(n, frames, 25))
    kp[..., 2] = rng.uniform(0.25, 1.0, size=(n, frames, 25))
    kp[rng.uniform(size=(n, frames, 25)) < 0.05, 2] = 0.05
    return kp


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this needs one CUDA card")

    from chd_tpu_torch.contact import infer
    from chd_tpu_torch.models import contact_mlp, torch_convert
    from chd_tpu_torch.ops import gapfill
    from chd_tpu_torch.ops.fused_mlp import (fused_mlp, fused_mlp_plain,
                                             fused_mlp_split_plain)
    from chd_tpu_torch.utils import build

    dev = torch.device("cuda")

    # -- 1. environment -----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()
    print(f"[1] card: {smi}")
    print(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"    matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    k = build.kernels()
    print(f"[2] build: {k.path}: nvcc {k.build_seconds:.2f} s "
          f"({time.perf_counter() - t0:.2f} s with loading; 0 nvcc s = an "
          "earlier build was loaded)")
    for line in k.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"    ptxas: {line.strip()}")
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", k.path], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    hmma = sum("HMMA" in line for line in sass.splitlines())
    print(f"    SASS: {hmma} HMMA instructions; "
          f"{k.lib.chd_fused_mlp_smem_bytes(351)} B of shared memory a block at d0=351")
    if hmma == 0:
        fail("the kernel's SASS has no HMMA (tensor-core) instruction")

    # -- 3. kernel against the plain version --------------------------------
    golden = np.load(GOLDEN)
    gmodel = torch_convert.from_state_dict(
        {key[3:]: golden[key] for key in golden.files if key.startswith("sd.")})

    def rand_model(num_joints: int) -> contact_mlp.ContactMLP:
        cfg = contact_mlp.ModelConfig(num_joints=num_joints)
        return contact_mlp.init(cfg, torch.Generator().manual_seed(0)).eval()

    max_err = 0.0

    def f64_plain(layers, x, width, row_stride):
        return fused_mlp_plain([(w.double(), b.double()) for w, b in layers],
                               x.double(), width, row_stride)

    def compare(what, run):
        nonlocal max_err
        got = run(fused_mlp)
        torch.cuda.synchronize()
        want = run(fused_mlp_plain)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        ok = got.shape == want.shape and torch.allclose(got, want, atol=ATOL, rtol=RTOL)
        exact = run(f64_plain)
        e_k = (got.double() - exact).abs().max().item()
        e_p = (want.double() - exact).abs().max().item()
        e_s = (got - run(fused_mlp_split_plain)).abs().max().item()
        print(f"    {what}: logits {tuple(got.shape)} max|d| {err:.3e} "
              f"{'ok' if ok else 'MISMATCH'}; vs f64: kernel {e_k:.3e}, plain {e_p:.3e}; "
              f"vs split emulation {e_s:.3e}")
        if not ok:
            fail(f"kernel disagrees with the plain version: {what}")
        if e_k > F64_MAX_D:
            fail(f"kernel max|d| {e_k} against float64 exceeds {F64_MAX_D}: {what}")

    rng = np.random.default_rng(0)
    print(f"[3] fused_mlp kernel vs plain (atol {ATOL}, rtol {RTOL}), "
          f"vs float64 (max|d| <= {F64_MAX_D})")
    for wname, model in (("golden", gmodel), ("random", rand_model(13))):
        layers = infer.ContactDetector(model, device=dev, use_conv=False).layers
        d0 = layers[0][0].shape[0]
        for B in (1, 7, 31, 32, 33, 63, 64, 65, 256, 300):
            x = torch.from_numpy(rng.normal(size=(B, d0)).astype(np.float32)).to(dev)
            compare(f"dense {wname} B={B}",
                    lambda mlp: mlp(layers, x, d0, d0))

    def conv_rows(det, kp):
        """(layers, rows, width, row_stride) exactly as ``det`` hands them to
        the MLP in conv mode, for (V, F, 25, 3) keypoints ``kp``."""
        joints, root, appended = infer.subset_joints(det.kw["joint_subset"])
        x = gapfill.preprocess_keypoints(kp[:, :, joints], det.kw["conf_thresh"],
                                         det.kw["normalization"])
        return infer.mlp_logits(x, det.layers, window_size=det.kw["window_size"],
                                root_in_subset=root, root_appended=appended,
                                use_confidence=det.kw["use_confidence"],
                                use_conv=True, mlp=lambda *a: a)

    V, F = 3, 60
    kp = torch.from_numpy(synth_videos(V, F, seed=1)).to(dev)
    for jset, wname, model in (("lower", "golden", gmodel),
                               ("lower", "random", rand_model(13)),
                               ("lower_ankles", "random", rand_model(8))):
        args = conv_rows(infer.ContactDetector(model, device=dev, joint_set=jset), kp)
        compare(f"conv {jset} {wname} V={V} F={F}", lambda mlp: mlp(*args))

    # -- 4. golden on the card: the main path -------------------------------
    vids = sorted(key for key in golden.files if key.startswith("keypoints_"))
    with tempfile.TemporaryDirectory() as tmp:
        dirs = []
        for key in vids:
            kpv = golden[key]
            opd = os.path.join(tmp, f"vid{key.split('_')[1]}", "openpose_result")
            os.makedirs(opd)
            for f in range(kpv.shape[0]):
                doc = {"people": [{"pose_keypoints_2d": kpv[f].reshape(-1).tolist()}]}
                with open(os.path.join(opd, f"frame_{f:06d}_keypoints.json"), "w") as fh:
                    json.dump(doc, fh)
            dirs.append(os.path.dirname(opd))
        fused_mlp.launches = 0
        results = infer.detect_contacts(dirs, gmodel, device="cuda",
                                        image_dims=(1920, 1080), save=True)
        torch.cuda.synchronize()
        launches = fused_mlp.launches
        print(f"[4] golden detect_contacts on cuda: fused_mlp launches {launches}")
        if launches < 1:
            fail("the main path never launched the fused_mlp kernel")
        for i, got in enumerate(results):
            want = golden[f"contacts_{i}"]
            if got.shape != want.shape:
                fail(f"golden video {i}: shape {got.shape} != {want.shape}")
            agree = float((got.astype(int) == want.astype(int)).mean())
            saved = np.load(os.path.join(dirs[i], "foot_contacts.npy"))
            same = saved.shape == got.shape and bool((saved == got).all())
            print(f"    video {i}: {got.shape[0]} frames, agreement {agree:.6f}, "
                  f"saved == returned: {same}")
            if agree < AGREE_MIN or not same:
                fail(f"golden video {i}: agreement {agree}, saved == returned {same}")

    # -- 5. realistic batch: kernel path vs plain path ----------------------
    big = torch.from_numpy(synth_videos(BIG_V, BIG_F, seed=0)).to(dev)
    frames = BIG_V * BIG_F
    print(f"[5] realistic batch V={BIG_V} F={BIG_F} ({frames} frames), "
          f"golden weights, {smi}")

    def wall(fn) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    dets = {use_conv: infer.ContactDetector(gmodel, device=dev, use_conv=use_conv)
            for use_conv in (True, False)}
    paths = {}  # (use_conv, "kernel" | "plain") -> one detector call
    for use_conv, det in dets.items():
        paths[use_conv, "kernel"] = lambda det=det: infer._infer_batch(
            big, det.layers, **det.kw)
        paths[use_conv, "plain"] = lambda det=det: infer._infer_batch(
            big, det.layers, mlp=fused_mlp_plain, **det.kw)
        ck, pk = paths[use_conv, "kernel"]()
        cp, pp = paths[use_conv, "plain"]()
        agree = float((ck == cp).float().mean())
        dmax = float((pk - pp).abs().max())
        t_p, t_k = [], []
        for _ in range(3):  # warmed up by the runs above
            t_p.append(wall(paths[use_conv, "plain"]))
            t_k.append(wall(paths[use_conv, "kernel"]))
        mk, mp = statistics.median(t_k), statistics.median(t_p)
        print(f"    use_conv={use_conv}: agreement {agree:.6f}, prob max|d| {dmax:.3e}; "
              f"kernel path {mk * 1e3:.3f} ms = {frames / mk:.0f} frames/s, "
              f"plain path {mp * 1e3:.3f} ms = {frames / mp:.0f} frames/s")
        if agree < AGREE_MIN or dmax > PROB_MAX_D:
            fail(f"use_conv={use_conv}: kernel path vs plain path: agreement "
                 f"{agree}, prob max|d| {dmax}")

    # the kernel alone at the main path's shape (conv mode): against its
    # plain version, then timed with CUDA events
    args = conv_rows(dets[True], big)
    compare(f"conv lower golden V={BIG_V} F={BIG_F}", lambda mlp: mlp(*args))

    def event_ms(mlp, reps: int = 10) -> float:
        mlp(*args)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            mlp(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    plain_ms = [event_ms(fused_mlp_plain)]
    kernel_ms = [event_ms(fused_mlp), event_ms(fused_mlp)]
    plain_ms.append(event_ms(fused_mlp_plain))
    ms, p_ms = statistics.mean(kernel_ms), statistics.mean(plain_ms)
    layers, frames2d, width, row_stride = args
    rows = frames2d.shape[0] * ((frames2d.shape[1] - width) // row_stride + 1)
    dims = [width] + [w.shape[1] for w, _ in layers]
    flop = 2 * rows * sum(a * b for a, b in zip(dims, dims[1:]))
    print(f"    fused_mlp alone, conv rows of V={BIG_V} F={BIG_F}: kernel {ms:.3f} ms, "
          f"plain (unfold + 5 addmm) {p_ms:.3f} ms; {rows} rows x widths {dims}: "
          f"{flop / 1e9:.1f} GFLOP, kernel {flop / ms / 1e9:.1f} TFLOP/s, "
          f"plain {flop / p_ms / 1e9:.1f} TFLOP/s")

    # -- 6. where the time goes: torch.profiler over the realistic batch ----
    print(f"[6] torch.profiler, {PROF_CALLS} calls of each path (after phase 5's "
          "warm-up); wall on the host clock, which includes the profiler's overhead")
    for (use_conv, mlp_name), run in paths.items():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t = wall(lambda: [run() for _ in range(PROF_CALLS)]) / PROF_CALLS
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
        busy = sum(e.self_device_time_total for e in kernels) / 1e3 / PROF_CALLS
        print(f"    use_conv={use_conv} {mlp_name}: wall {t * 1e3:.3f} ms/call, "
              f"device busy {busy:.3f} ms/call, idle share {1 - busy / (t * 1e3):.3f}")
        for e in kernels[:5]:
            print(f"      {e.self_device_time_total / 1e3 / PROF_CALLS:8.3f} ms/call "
                  f"x{e.count // PROF_CALLS:<3d} {e.key[:90]}")

    # -- 7. bitwise batch invariance on the card ----------------------------
    kp = synth_videos(21, 40, seed=3)
    for use_conv, det in dets.items():
        c_all, p_all = det.infer(torch.from_numpy(kp))
        same = True
        for v in range(kp.shape[0]):
            c1, p1 = det.infer(torch.from_numpy(kp[v:v + 1]))
            same &= torch.equal(c1[0], c_all[v]) and torch.equal(p1[0], p_all[v])
        print(f"[7] use_conv={use_conv}: each of 21 videos alone (V=1) == its rows "
              f"in the V=21 batch, bitwise: {same}")
        if not same:
            fail(f"use_conv={use_conv}: a video's rows depend on the batch")

    if "jax" in sys.modules:
        fail("jax was imported")
    print(json.dumps({"kernels": [{
        "name": "fused_mlp",
        "route": "cuda",
        "source": "chd_tpu_torch/csrc/fused_mlp.cu",
        "replaces": "chd_tpu/ops/pallas_mlp.py:26",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": p_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
