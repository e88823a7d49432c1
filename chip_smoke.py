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
   in both ``use_conv`` modes;
8. every joint set: for each ``OP_JOINT_SUBSETS`` key, in both
   ``use_conv`` modes, the kernel against its plain version (phase 3's
   tolerance), a float64 chain and bitwise batch invariance, with a seeded
   random model at V=16 x F=120; then ``full`` (first layer 675 wide,
   staged in slabs) at V=512 x F=240 in both modes, timed against plain
   with CUDA events;
9. one training step, card against CPU: the same initial weights, windows,
   labels and dropout masks for 3 steps of ``train_step`` on both; max |d|
   of the last gradients (bound 1e-6: float32 sums in other orders), of
   the BN running statistics (bound 5e-5), and of the parameters. A
   parameter whose gradient plus L2 term was under 1e-5 at some step is
   held to 3 steps x 2 lr = 1.8e-3 at phase 10's lr 3e-4 (Adam's first
   steps move it by ~lr * sign(gradient), and a gradient that is near 0
   has a noise sign); every other parameter to 1e-5. Then the same card
   steps with TF32 matmuls must break one of those bounds, which shows
   that they hold training to full float32;
10. training at full width on the card (the slice's main path; the kernel
    count set to 0 just before, read just after): ``train`` on a seeded
    learnable set (``contact.synth``: 1,024 sequences x 240 frames, 128
    held out) for 12 epochs of the default ``TrainConfig`` at lr 3e-4, then
    ``evaluate_full_video`` on the held-out split: merged F1 and accuracy
    must pass 0.8. Then, for a fresh model, train steps/s and sequences/s
    (median of 3 synced epochs after a warm-up), the host syncs of one
    epoch (``torch.cuda.set_sync_debug_mode``), and a ``torch.profiler``
    epoch's device idle share and its largest host and device items;
11. evaluation: ``evaluate_full_video`` and ``eval_step`` through the kernel
    against the same through the plain MLP on the card: merged-prediction
    agreement >= 0.999, window confusion counts and loss, and the kernel's
    launches in this comparison, counted apart from [10]'s; then
    ``train-contacts`` and ``eval-contacts --full-video`` of the CLI on the
    card on a small tree, checking the files they write;
12. checkpoint: ``save_train_state`` -> ``load_train_state`` on the card; the
    resumed step equals the uninterrupted one (max |d|, expected 0).

Then it prints one JSON line on the kernels, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before the last line, and so does a machine without CUDA.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "fixtures", "contact_golden.npz")
ATOL, RTOL = 2e-4, 1e-4          # kernel vs plain logits
F64_MAX_D = 2e-4                 # kernel logits vs a float64 chain
AGREE_MIN = 0.999                # binary contact agreement
PROB_MAX_D = 1e-4                # window-probability max |d|, kernel vs plain
BIG_V, BIG_F = 512, 240          # the realistic batch
PROF_CALLS = 3                   # profiled calls per path in phase 6
TRAIN_SEQ, TRAIN_F, HOLDOUT = 1024, 240, 128  # phase 10's learnable set
TRAIN_EPOCHS = 12
GRAD_MAX_D, BN_MAX_D = 1e-6, 5e-5  # phase 9, card vs CPU after 3 steps
PARAM_MAX_D, G_MIN = 1e-5, 1e-5  # phase 9, parameters whose |gradient| >= G_MIN
LEARNED_MIN = 0.8                # merged F1 and accuracy after training
JOINT_SETS = ("lower", "lower_knees", "lower_ankles", "lower_feet", "upper", "upper_hips",
              "upper_knees", "upper_ankles", "full")  # the keys of OP_JOINT_SUBSETS


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


def write_mixamo_tree(tmp: str, kp: np.ndarray, seed: int = 0) -> str:
    """The synthetic Mixamo layout (Character/Motion/{foot_contacts.npy,
    view1/, keypoints_view1/}) for 2 characters x 5 motions of keypoints kp
    (10, F, 25, 3), with seeded random contacts; returns its root."""
    rng = np.random.default_rng(seed)
    root = os.path.join(tmp, "mixamo")
    for i, (char, motion) in enumerate((c, m) for c in "AB" for m in range(5)):
        mdir = os.path.join(root, char, f"{motion:03d}")
        os.makedirs(os.path.join(mdir, "view1"))
        os.makedirs(os.path.join(mdir, "keypoints_view1"))
        np.save(os.path.join(mdir, "foot_contacts.npy"),
                (rng.uniform(size=(kp.shape[1], 4)) > 0.5).astype(int))
        for f in range(kp.shape[1]):
            doc = {"people": [{"pose_keypoints_2d": kp[i, f].reshape(-1).tolist()}]}
            with open(os.path.join(mdir, "keypoints_view1", f"{f:06d}_keypoints.json"), "w") as fh:
                json.dump(doc, fh)
    return root


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this needs one CUDA card")

    from chd_tpu_torch.contact import data as data_lib
    from chd_tpu_torch.contact import infer
    from chd_tpu_torch.contact import train as train_lib
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

    def rows_of(det, kp):
        """(layers, rows, width, row_stride) exactly as ``det`` hands them to
        the MLP in its mode, for (V, F, 25, 3) keypoints ``kp``."""
        joints, root, appended = infer.subset_joints(det.kw["joint_subset"])
        x = gapfill.preprocess_keypoints(kp[:, :, joints], det.kw["conf_thresh"],
                                         det.kw["normalization"])
        return infer.mlp_logits(x, det.layers, window_size=det.kw["window_size"],
                                root_in_subset=root, root_appended=appended,
                                use_confidence=det.kw["use_confidence"],
                                use_conv=det.kw["use_conv"], mlp=lambda *a: a)

    V, F = 3, 60
    kp = torch.from_numpy(synth_videos(V, F, seed=1)).to(dev)
    for jset, wname, model in (("lower", "golden", gmodel),
                               ("lower", "random", rand_model(13)),
                               ("lower_ankles", "random", rand_model(8))):
        args = rows_of(infer.ContactDetector(model, device=dev, joint_set=jset), kp)
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

    def is_device_work(e) -> bool:
        """A device item of a profile, not a user annotation's span (the
        optimizer's step is one), which would count its kernels twice."""
        return (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False))

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
    args = rows_of(dets[True], big)
    compare(f"conv lower golden V={BIG_V} F={BIG_F}", lambda mlp: mlp(*args))

    def event_ms(mlp, args, reps: int = 10) -> float:
        mlp(*args)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            mlp(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    plain_ms = [event_ms(fused_mlp_plain, args)]
    kernel_ms = [event_ms(fused_mlp, args), event_ms(fused_mlp, args)]
    plain_ms.append(event_ms(fused_mlp_plain, args))
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
        kernels = [e for e in prof.key_averages() if is_device_work(e)]
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

    # -- 8. every joint set through the kernel ------------------------------
    print(f"[8] every joint set, both modes, V=16 F=120, random model: kernel vs plain "
          f"(atol {ATOL}, rtol {RTOL}), vs float64, batch invariance")
    kp = torch.from_numpy(synth_videos(16, 120, seed=4)).to(dev)
    for jset in JOINT_SETS:
        for use_conv in (True, False):
            n_joints = len(train_lib.TrainConfig(joint_set=jset).joint_subset)
            det = infer.ContactDetector(rand_model(n_joints), device=dev, joint_set=jset,
                                        use_conv=use_conv)
            layers, x, width, stride = rows_of(det, kp)
            compare(f"{jset} use_conv={use_conv} d0={width}",
                    lambda mlp: mlp(layers, x, width, stride))
            one = fused_mlp(layers, x[:1].contiguous(), width, stride)
            if not torch.equal(one, fused_mlp(layers, x, width, stride)[:one.shape[0]]):
                fail(f"{jset} use_conv={use_conv}: rows depend on the batch")
    full_ms = {}
    for use_conv in (True, False):
        det = infer.ContactDetector(rand_model(25), device=dev, joint_set="full",
                                    use_conv=use_conv)
        fargs = rows_of(det, big)
        compare(f"full use_conv={use_conv} V={BIG_V} F={BIG_F}", lambda mlp: mlp(*fargs))
        p1 = event_ms(fused_mlp_plain, fargs)
        k1, k2 = event_ms(fused_mlp, fargs), event_ms(fused_mlp, fargs)
        p2 = event_ms(fused_mlp_plain, fargs)
        full_ms[use_conv] = (statistics.mean([k1, k2]), statistics.mean([p1, p2]))
        print(f"    full use_conv={use_conv} d0={fargs[2]}, V={BIG_V} F={BIG_F}: kernel "
              f"{full_ms[use_conv][0]:.3f} ms, plain {full_ms[use_conv][1]:.3f} ms")

    # -- 9. training steps, card vs CPU -------------------------------------
    from chd_tpu_torch.contact import evaluate as evaluate_lib
    from chd_tpu_torch.contact import synth
    from chd_tpu_torch.pipeline import cli
    from chd_tpu_torch.utils import checkpoint

    cfg = train_lib.TrainConfig(lr=3e-4, epochs=TRAIN_EPOCHS, val_every=4)
    ds = synth.learnable_dataset(TRAIN_SEQ, TRAIN_F, seed=0, n_holdout=HOLDOUT, device=dev)
    train_op, train_ct = ds.split_arrays("train")
    gen = torch.Generator(device=dev).manual_seed(9)
    steps = []
    for step in range(3):
        idx = torch.arange(step * cfg.batch_size, (step + 1) * cfg.batch_size, device=dev)
        feats, labels = data_lib.sample_train_windows(
            gen, train_op[idx], train_ct[idx], cfg.window_size, cfg.pred_size,
            cfg.joint_subset, cfg.noise_dev)
        steps.append((feats, labels, contact_mlp.dropout_keep_mask((cfg.batch_size, 128),
                                                                   gen, dev)))

    def run_steps(device):
        """Phase 9's 3 steps from its initial weights on ``device``: the
        parameters, the BN buffers, and each parameter's smallest
        |gradient + L2 term| over the steps (Adam's input), all on the CPU."""
        m = contact_mlp.init(cfg.model_config(), torch.Generator().manual_seed(3)).to(device)
        opt = train_lib.make_optimizer(m, cfg)
        g_min = {k: torch.full_like(p, float("inf")) for k, p in m.named_parameters()}
        for feats, labels, mask in steps:
            before = {k: p.detach().clone() for k, p in m.named_parameters()}
            train_lib.train_step(m, opt, None, None, cfg, None,
                                 windows=(feats.to(device), labels.to(device)),
                                 dropout_mask=mask.to(device))
            for k, p in m.named_parameters():
                g_min[k] = torch.minimum(g_min[k], (p.grad + cfg.weight_decay * before[k]).abs())
        return ({k: (p.detach().cpu(), p.grad.cpu()) for k, p in m.named_parameters()},
                {k: b.cpu().float() for k, b in m.named_buffers()},
                {k: g.cpu() for k, g in g_min.items()})

    @contextlib.contextmanager
    def tf32():
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("high")
        try:
            yield
        finally:
            torch.set_float32_matmul_precision(prev)

    ref_params, ref_bufs, g_min = run_steps("cpu")
    firm = {k: g >= G_MIN for k, g in g_min.items()}  # Adam's step follows the gradient
    param_noise_d = 3 * 2 * cfg.lr

    def against_cpu(params, bufs):
        """max |d| against the CPU's steps: gradients, parameters whose
        gradient stayed >= G_MIN, the other parameters, BN statistics."""
        d = {k: (p - ref_params[k][0]).abs() for k, (p, _) in params.items()}
        return (max((g - ref_params[k][1]).abs().max().item() for k, (_, g) in params.items()),
                max((d[k][firm[k]].max().item() if firm[k].any() else 0.0) for k in d),
                max((d[k][~firm[k]].max().item() if (~firm[k]).any() else 0.0) for k in d),
                max((b - ref_bufs[k]).abs().max().item() for k, b in bufs.items()))

    def over(d_grad, d_param, d_bn):
        return d_grad > GRAD_MAX_D or d_param > PARAM_MAX_D or d_bn > BN_MAX_D

    d_grad, d_param, d_noise, d_bn = against_cpu(*run_steps(dev)[:2])
    n_firm = sum(int(f.sum()) for f in firm.values())
    n_all = sum(f.numel() for f in firm.values())
    print(f"[9] 3 train steps, card vs CPU (batch {cfg.batch_size}, same weights, windows, "
          f"masks): max|d| grads {d_grad:.3e} (<= {GRAD_MAX_D}), params {d_param:.3e} on the "
          f"{n_firm} of {n_all} whose |grad + L2| >= {G_MIN} at every step (<= {PARAM_MAX_D}), "
          f"{d_noise:.3e} on the others (<= {param_noise_d:.1e}), BN stats {d_bn:.3e} "
          f"(<= {BN_MAX_D})")
    if over(d_grad, d_param, d_bn) or d_noise > param_noise_d:
        fail("the card's training steps disagree with the CPU's")
    with mock.patch.object(train_lib, "full_f32", tf32):
        t_grad, t_param, t_noise, t_bn = against_cpu(*run_steps(dev)[:2])
    print(f"    the same card steps with TF32 matmuls: max|d| grads {t_grad:.3e}, params "
          f"{t_param:.3e} (others {t_noise:.3e}), BN stats {t_bn:.3e}: outside the bounds "
          f"{over(t_grad, t_param, t_bn)}")
    if not over(t_grad, t_param, t_bn):
        fail("phase 9's bounds do not tell a TF32 training step from a full-float32 one")

    # -- 10. training at full width on the card (the slice's main path) -----
    fused_mlp.launches = 0
    t = time.perf_counter()
    model, hist = train_lib.train(ds, cfg, log_every=4, verbose=False)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t
    res = evaluate_lib.evaluate_full_video(model, ds, "test", cfg)
    torch.cuda.synchronize()
    train_launches = fused_mlp.launches
    f1, acc = res["merged"]["f1"], res["merged"]["accuracy"]
    print(f"[10] train() on {TRAIN_SEQ} x {TRAIN_F} learnable sequences ({HOLDOUT} held "
          f"out), {TRAIN_EPOCHS} epochs, batch {cfg.batch_size}, lr {cfg.lr}: {t_train:.2f} s; "
          f"loss {['%.4f' % v for v in hist['train_loss']]}, val F1 "
          f"{['%.4f' % v for v in hist['val_f1']]}; held-out merged F1 {f1:.4f}, "
          f"accuracy {acc:.4f}; fused_mlp launches in train() and evaluate_full_video: "
          f"{train_launches}")
    if not (f1 > LEARNED_MIN and acc > LEARNED_MIN):
        fail(f"training did not learn: merged F1 {f1}, accuracy {acc}")
    if train_launches < 1:
        fail("training and evaluation never launched the fused_mlp kernel")

    n_full = train_op.shape[0] // cfg.batch_size
    tmodel = contact_mlp.init(cfg.model_config(), torch.Generator().manual_seed(5)).to(dev)
    topt = train_lib.make_optimizer(tmodel, cfg)
    tgen = torch.Generator(device=dev).manual_seed(5)
    batch_idx = torch.randperm(train_op.shape[0], device=dev)[:n_full * cfg.batch_size]
    batch_idx = batch_idx.reshape(n_full, cfg.batch_size)

    def epoch():
        return train_lib.train_epoch(tmodel, topt, train_op, train_ct, batch_idx, cfg, tgen)

    epoch()  # warm-up
    t_epoch = statistics.median(wall(epoch) for _ in range(3))
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        losses, _ = epoch()
    torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t_prof = wall(epoch)
    events = prof.key_averages()
    device_items = sorted((e for e in events if is_device_work(e)),
                          key=lambda e: e.self_device_time_total, reverse=True)
    host_items = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CPU),
                        key=lambda e: e.self_cpu_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in device_items) / 1e6
    print(f"    train_epoch, {n_full} steps of {cfg.batch_size}: {t_epoch * 1e3:.2f} ms = "
          f"{n_full / t_epoch:.1f} steps/s, {n_full * cfg.batch_size / t_epoch:.0f} "
          f"sequences/s (median of 3 synced epochs); host syncs inside an epoch: {syncs} "
          f"(+1 to read its losses); profiled epoch: wall {t_prof * 1e3:.2f} ms, device busy "
          f"{busy * 1e3:.2f} ms, idle share {1 - busy / t_prof:.3f}")
    for what, items, key in (("host", host_items, "self_cpu_time_total"),
                             ("device", device_items, "self_device_time_total")):
        for e in items[:6]:
            print(f"      {what} {getattr(e, key) / 1e3 / n_full:7.3f} ms/step "
                  f"x{e.count / n_full:<5.1f} {e.key[:80]}")
    if not bool(torch.isfinite(losses).all()):
        fail("non-finite training loss")

    # -- 11. evaluation through the kernel against the plain MLP ------------
    fused_mlp.launches = 0
    plain_res = evaluate_lib.evaluate_full_video(model, ds, "test", cfg, mlp=fused_mlp_plain)
    agree = float((res["merged_predictions"] == plain_res["merged_predictions"]).mean())
    test_op, test_ct = ds.split_arrays("test")
    k_loss, k_conf = train_lib.eval_step(model, test_op, test_ct, cfg, overlap=True)
    p_loss, p_conf = train_lib.eval_step(model, test_op, test_ct, cfg, overlap=True,
                                         mlp=fused_mlp_plain)
    torch.cuda.synchronize()
    eval_launches = fused_mlp.launches
    n_windows = int(k_conf[0].sum())
    d_conf = int((k_conf - p_conf).abs().max())
    print(f"[11] evaluate_full_video kernel vs plain on {HOLDOUT} x {TRAIN_F}: merged "
          f"agreement {agree:.6f}, merged F1 {f1:.4f} vs {plain_res['merged']['f1']:.4f}; "
          f"eval_step (overlap, {n_windows} windows): loss {float(k_loss):.6f} vs "
          f"{float(p_loss):.6f}, confusion counts max|d| {d_conf}; fused_mlp launches in "
          f"this comparison: {eval_launches}")
    if agree < AGREE_MIN or abs(float(k_loss) - float(p_loss)) > 1e-4:
        fail(f"evaluation through the kernel disagrees with the plain MLP: agreement {agree}")
    if d_conf > max(1, n_windows // 1000):
        fail(f"eval_step confusion counts differ by {d_conf} of {n_windows} windows")
    if eval_launches < 1:
        fail("eval_step never launched the fused_mlp kernel")

    with tempfile.TemporaryDirectory() as tmp:
        root = write_mixamo_tree(tmp, synth_videos(2 * 5, 30, seed=6))
        out, ev = os.path.join(tmp, "run"), os.path.join(tmp, "eval")
        weights = os.path.join(out, "contact_weights_FINAL.npz")
        with contextlib.redirect_stdout(io.StringIO()):  # their own logs
            cli.main(["train-contacts", "--data", root, "--out", out, "--epochs", "2",
                      "--batch-size", "4", "--device", "cuda"])
            cli.main(["eval-contacts", "--data", root, "--weights", weights, "--out", ev,
                      "--split", "val", "--full-video", "--device", "cuda"])
        written = sorted(os.listdir(out)) + sorted(os.listdir(ev))
        with np.load(weights) as npz:
            keys = sorted(npz.files)
        want_keys = sorted([f"params.linear{i}.{k}" for i in range(5) for k in "wb"]
                           + [f"params.bn{i}.{k}" for i in range(4) for k in ("scale", "bias")]
                           + [f"state.bn{i}.{k}" for i in range(4) for k in ("mean", "var")])
        with open(os.path.join(ev, "eval_results.json")) as fh:
            merged = json.load(fh)["merged"]
        print(f"    CLI on the card: train-contacts and eval-contacts --full-video wrote "
              f"{written}; npz keys are chd_tpu's: {keys == want_keys}; merged {merged}")
        if keys != want_keys or len(written) != 5:
            fail(f"the CLI wrote {written}, npz keys {keys}")

    # -- 12. checkpoint round trip on the card ------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.pt")
        rows = torch.arange(cfg.batch_size, device=dev)

        def fresh(seed):
            m = contact_mlp.init(cfg.model_config(), torch.Generator().manual_seed(seed)).to(dev)
            return m, train_lib.make_optimizer(m, cfg), torch.Generator(device=dev).manual_seed(seed)

        m1, o1, g1 = fresh(7)
        for _ in range(2):
            train_lib.train_step(m1, o1, train_op[rows], train_ct[rows], cfg, g1)
        checkpoint.save_train_state(path, 2, m1, o1, g1)
        train_lib.train_step(m1, o1, train_op[rows], train_ct[rows], cfg, g1)
        m2, o2, g2 = fresh(8)
        step = checkpoint.restore_train_state(checkpoint.load_train_state(path), m2, o2, g2)
        train_lib.train_step(m2, o2, train_op[rows], train_ct[rows], cfg, g2)
        sd1, sd2 = m1.state_dict(), m2.state_dict()
        d_resume = max((sd1[k].float() - sd2[k].float()).abs().max().item() for k in sd1)
        print(f"[12] checkpoint on the card: resumed at step {step}, next step max|d| against "
              f"the uninterrupted run {d_resume:.3e}")
        if step != 2 or d_resume != 0.0:
            fail(f"the resumed run differs: step {step}, max|d| {d_resume}")

    if "jax" in sys.modules:
        fail("jax was imported")
    print(json.dumps({"kernels": [{
        "name": "fused_mlp",
        "route": "cuda",
        "source": "chd_tpu_torch/csrc/fused_mlp.cu",
        "replaces": "chd_tpu/ops/pallas_mlp.py:26",
        "launches": launches,
        "launches_by_path": {"detect_contacts": launches, "train_and_evaluate": train_launches},
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": p_ms,
        "full_ms": full_ms[True][0],
        "full_plain_ms": full_ms[True][1],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
