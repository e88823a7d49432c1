"""Smoke run of chd_tpu_torch's main path on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``chd_tpu_torch/csrc`` (into ``build/``),
then, on the card:

1. prints the card (``nvidia-smi``), the torch and CUDA versions, and pins
   float32 matmuls and convolutions to full precision (no TF32);
2. builds the kernel and prints the build seconds, ptxas' registers,
   spills and wgmma notes, and, for each of the kernel's 8 instantiations
   (resident or slab first-layer rows x 4 modes), its count of ``HGMMA``
   (wgmma), ``HMMA`` (mma.sync) and bulk-copy (``UBLKCP``, ``UTMALDG``)
   instructions and the highest register it uses (``cuobjdump -sass``); it
   fails if the "high" instantiations have no ``HGMMA`` or no bulk copy.
   Then the first launch of every instantiation, at a ragged 300 rows (5
   tiles: a cluster with a block that has no rows), runs in a child process
   with a time limit of ``FIRST_LAUNCH_S``, so that a barrier deadlock fails
   here, named, instead of hanging the call;
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
   multiply-adds of the five layers, its bound and share, and its weight
   stream: the bytes it reads from L2 (tile groups x stages x parts, once
   per cluster) and the L2 rate that implies;
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
   with CUDA events, with its bound and its weight stream;
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

The kinematic stage (no kernel of its own: its solver loops are plain
PyTorch, replayed as CUDA graphs):

13. core on the card: ``quat`` (``mul``, ``rotate``, ``from_angle_axis``,
    ``from_euler``/``to_euler`` in 'xyz' with ``world=True``) and ``fk`` on
    seeded inputs of the combined skeleton, card against the port on the
    CPU in float32: max |d| <= 1e-5 on unit quaternions and angles, 1e-3 cm
    on positions;
14. ``optimize_trajectory`` on ``tests/fixtures/trajectory_golden.npz`` at
    its pinned LM 50:100 with CUDA graphs, held to the gates of
    ``tests/test_goldens.py`` (floor normal cos > 0.9994, plane offset
    < 2 cm, pruned contacts equal, mean and median joint error < 2 cm,
    median reprojection under its px bound, stage-2 objective <= 1.001 x
    the golden's, each scored by the port's residual);
15. the realistic batch (the slice's main path): 16 sequences x 100 frames
    of bench.py's recipe on the golden's skeleton at the default budget
    (IK 200 with 64 CG iterations, LM 40:80 twice). Seconds per
    ``optimize_trajectory_batch`` call with CUDA graphs, the first (which
    captures) and the second, and sequences/hour; the JᵀJ·v kernel's
    launches by its wrapper's counter, zeroed before each call (the
    capturing call 2 x 80 products and 2 diagonals, the replayed call none
    from the host), and 2 kernel solves each by ``lm.jtjv.kernel``; the
    same graphs stage by stage (IK, LM 1, floor, LM 2) inside
    ``torch.cuda.set_sync_debug_mode("error")`` (no host sync), timed by
    CUDA events, equal to the call's results; the IK stage and 3 LM steps
    eager and replayed, bitwise equal, no host sync; one eager LM step on
    the kernel under ``torch.profiler`` (launches, kernels, 80
    ``product_kernel`` and one ``diag_kernel`` events, device busy, idle
    share, largest items, peak memory). Then a small ragged batch (16 and 12
    frames), card against CPU: float64 with IK 10 LU and LM 5:15 end to
    end (joints within 1e-5 cm, pruned contacts equal, floor normals cos
    >= 0.9999); float32 with IK 200 LU and LM 5:15 stage by stage, each
    stage from the card's input (IK joints within 1e-3 cm, each LM stage
    within 5e-2 cm, floor normals within 1e-9 of cos 1, pruned contacts
    equal), and the card's IK with its matmul inputs rounded to TF32 must
    exceed the IK bound;
    float32 with IK 10 CG end to end, within 3 x the CPU's own spread
    under one-ulp changes of the 3D inputs (CG steps amplify roundings);
16. the ``kinematic`` CLI on the card on a synthetic 12-frame video dir,
    against the port's CPU run of the same dir: the three files written,
    the same contacts, floor normals cos >= 0.9999, BVH joints within
    the larger of 0.05 cm and 3 x the CPU's own spread under one-ulp
    changes of the 3D inputs; on the card the same CLI with autograd's
    product must pass that gate, and with a planted wrong product (the
    kernel's without its projection or its acceleration block) must fail
    it.

Retargeting, the staged physics solve and the whole pipeline (no kernel of
their own either: collocation, SRBD and durations are plain PyTorch, the LM
steps replayed as CUDA graphs):

17. building blocks on the card against the port on the CPU, float32, on a
    walking and a hopping clip of 100 frames with seeded variables and
    multipliers: ``dynamic_violation``, every constraint block, the AL
    residual of each of the five stage graphs (FIT, DYN, DYN_H, stage 3,
    stage 4), ``soft_contact`` and one JᵀJ·v product, each within
    ``BLOCK_REL`` of its largest value; the same blocks with their matmul
    inputs rounded to TF32 must break that bound;
18. the FIT stage (2 AL iterations of LM 25:50) on
    ``tests/fixtures/phys_fit_scipy_f20_seed0.npz``'s clip with the gates of
    ``tests/test_goldens.py``: every FIT constraint <= max(golden, 1e-3),
    the FIT cost <= 1.001 x the golden's and < 0.05, COM and feet within
    2 cm of the data;
19. the realistic batch (the slice's main path): ``solve_physics_full_batch``
    on 32 x ``walking_input(100, seed=i)``, the default ``SolveConfig`` and
    ``PhysWeights``, as CUDA graphs: a capturing call (with the JᵀJ·v
    kernel's launches: FIT, DYN, HEIGHT and the polish take it, stage 3
    autograd's product), a timed call (seconds, sequences/hour), the same
    graphs inside
    ``set_sync_debug_mode("error")`` with each stage's time by CUDA events
    (FIT, DYN, HEIGHT, stage 3, stage 4), bitwise the call's results; the
    ``durations_ok`` rate and the largest dynamics violation;
    ``tests/test_physics_scoreboard.py``'s gates on every sequence; 3 LM
    steps eager and replayed, bitwise equal; one eager LM step profiled
    (the kernel's product, as the main path);
    then a small ragged batch (24 and 20 frames), card vs CPU: float64 end
    to end, float32 stage by stage from the card's input, with the frames
    whose rasterized contact differs;
20. the ``run`` CLI on the card on a synthetic 12-frame video dir
    (kinematic, retargeting to the 67-joint ybot template of
    ``tests/fixtures/prepare_input/ybot``, physics at small budgets) and
    its retargeting and physics stages on the CPU from the card's
    kinematic results ([16] holds the kinematic stage): every artifact of
    the pipeline's layout, a success log that parses, three 67-joint BVHs,
    solutions and BVH joints within ``RUN_SOL_MAX_D`` m and
    ``RUN_BVH_MAX_D`` cm of the CPU's.

The banded LM solve, the kernel's precision modes and the rest of the
library:

21. the kinematic batch of [15] (16 x 100, default budget, CUDA graphs)
    with ``optimize_trajectory_batch(lm_solver="banded")``: a capturing
    call and two timed calls (seconds, sequences/hour), the stages by CUDA
    events with no host sync, each beside [15]'s PCG reading of this run;
    each sequence's final stage-2 cost against PCG's (<= ``BANDED_COST_X``
    times, or the gap printed); 3 banded LM steps eager and replayed,
    bitwise equal, no host sync; one eager banded step under
    ``torch.profiler`` (launches, kernels, idle share, peak memory); [14]'s
    golden gates with the banded solve; a small ragged batch card vs CPU in
    float64 end to end (joints within ``SMALL_F64_MAX_D`` cm);
22. the detector's precision modes on the kernel, golden weights, at
    ``lower``'s conv rows of 512 x 240 and on the golden dirs: for
    "default" (1 bf16 pass), "high" (3), "highest" (6) and bf16 storage,
    the kernel against its emulation (``fused_mlp_split_plain`` at its pass
    count, or ``fused_mlp_bf16_plain``) and a float64 chain ("highest"
    within ``HIGHEST_MAX_D`` of both, "high" within [3]'s bounds, the
    single-pass modes within ``ONE_PASS_ULPS`` bf16 roundings of the largest
    logit of their emulation), each mode's kernel time by CUDA events
    against its emulation's, TFLOP/s, share of its bound and
    ``detect_contacts`` launches; golden agreement >= 0.999 for "high" and
    "highest", binary agreement with "high" >= ``MODE_AGREE_MIN`` for the
    single-pass modes; each mode's weight stream and L2 rate, and beside
    "default" ``cublas_one_pass_ms``, one bf16 pass of layers 0-2 as three
    ``torch.matmul`` calls on the same rows (a yardstick the port never
    calls). [2]'s SASS counts cover every mode;
23. the library surface no pipeline stage calls, card vs the port on the
    CPU in float32 at small sizes: ``one_euro_filter``, ``skin``,
    ``solve_basic_ik``, ``solve_jacobian_ik`` and ``solve_icp`` (without
    nearest-point association, whose ties could part the devices), within
    [13]'s bounds.

The host layer:

24. ``utils.profiling.trace`` around ``TRACE_CALLS`` golden
    ``detect_contacts`` calls: its Chrome trace must hold exactly one
    ``fused_mlp_kernel...`` device event per call, as many as the wrapper
    counts; ``utils.profiling.benchmark`` on [5]'s ``_infer_batch`` (512 x
    240, device-resident) and on the kernel alone at its conv rows: each
    ``mean_s`` must read at least ``BENCH_MIN_RATIO`` of the same calls'
    CUDA-event time; beside them, ``benchmark`` with its host read taken
    out, which on the device-bound kernel must fail that gate; a ``run`` on the
    card of [20]'s 12-frame dir at [20]'s budgets, whose outputs (the
    kinematic joints and contacts, the floor, the picked physics result),
    a small training history on the card and the golden calls' confusion
    counts go as card tensors to ``blender.estimate_kinematic_forces``,
    ``blender.pick_result`` and every viz function: ``viz.video.to_host``
    must bring them to the host as they are and, where what it renders
    with is installed (cv2 for ``render_keypoint_video``, matplotlib and
    cv2 for the others), each function must render the same frames or PNG
    pixels from card tensors as from the same values as host numpy,
    bitwise (a line of its own names what is not installed and what it
    does not render); then
    ``python -m chd_tpu_torch.pipeline config`` and ``make-structure`` in
    fresh processes: the default config's JSON, the tree of video dirs, and
    no jax or chd_tpu module in either process.

The parallel layer (``chd_tpu_torch.parallel``):

25. ``distributed.initialize()`` without torchrun's variables must join
    nothing; then, on an in-process NCCL group of world size 1 (a
    ``HashStore``, rank 0): data-parallel detection at [5]'s 512 x 240
    (one kernel launch a rank, contacts and probabilities bitwise the
    unsharded call's, ms a call beside it), 3 sync-BN training steps at
    batch 64, ``lower``, within [9]'s bounds of the same steps without a
    mesh, data-parallel ``eval_step`` (one launch, equal loss and counts);
    the contact MLP's tensor parallelism in the single-process form of a
    mesh with "model" 2 (both shards on the card): its
    ``contact_model_shardings``, the model sharded and gathered back and its
    folded shards against the gathered fold (bitwise), 3 training steps of
    the sharded model on ``local_mesh(2, model=2)`` and on
    ``local_mesh(4, data=2, model=2)`` within [9]'s bounds of the unsharded
    steps in float64 (in float32, printed beside them, a BN output that
    rounds to the other side of its ReLU moves that element's gradient
    whole), its ``eval_step`` (one kernel launch on the gathered folded
    layers, equal to the gathered model's) and a step's ms sharded against
    unsharded; the physics and kinematic batches with the mesh, bitwise equal to
    the calls without it; ``dryrun_multichip(1, "cuda")`` in a spawned
    rank, and ``dryrun_multichip(min(count, 4), "cuda")`` where the machine
    has two cards or more (else a line says it did not run); then the
    single-process form of ``LONG_SHARDS`` frame shards on the card: [14]'s
    trajectory-golden gates with both LM stages frame-sharded, eager, at the
    cut budget ``SHARD_GOLDEN_LM``, a ``LONG_F``-frame clip's sharded probe
    against the unsharded one (within ``LONG_PROBE_REL``), and its whole
    refinement at a cut budget (seconds a stage, peak memory).

The kinematic LM's JᵀJ·v kernel (``csrc/traj_jtjv.cu``):

26. at [15]'s 16 x 100 frames in float32 and float64, product and
    diagonal, against autograd's double vjp in float64 at the same point
    (relative error of the output's norm within 1e-5 in float32, 1e-12 in
    float64; a product without its projection block must fail it), a
    second launch bitwise equal; a launch's time by CUDA events over a
    graph of 50, its bound from the bytes it moves and its FLOP, and the
    double vjp's time eager and replayed as a graph.

The physics LM's JᵀJ·v kernel (``csrc/phys_jtjv.cu``):

27. at [19]'s 32 x 100 frames in float32 and float64, DYN_H's structure
    (every block), product and the 90-mask coloring diagonal, against
    autograd's double vjp in float64 at the same point (the largest dof
    group's relative error norm within 1e-5 in float32, 1e-10 in float64;
    a product without its Newton–Euler block must fail it), a second
    launch bitwise equal; a launch's time by CUDA events over a graph of
    50, its bound from the bytes it moves and its FLOP, and the double
    vjp's time eager and replayed as a graph.

Then it prints one JSON line on the kernels (the fused-MLP kernel in each of
its four modes, each JᵀJ·v kernel in each mode and type with [15]'s and
[19]'s launch counts), the card's name and power limit, and, last,
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the
last line, and so does a machine without CUDA.
"""
from __future__ import annotations

import contextlib
import dataclasses
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
# H100 SXM peaks at 700 W (NVIDIA's H100 data sheet, dense)
BF16_PEAK, F32_PEAK, HBM_RATE = 989e12, 67e12, 3.35e12  # FLOP/s, FLOP/s, B/s
TRAJ_GOLDEN = os.path.join(REPO, "tests", "fixtures", "trajectory_golden.npz")
KIN_B, KIN_F = 16, 100           # the realistic kinematic batch (bench.py's)
CORE_ATOL, CORE_POS_ATOL = 1e-5, 1e-3  # [13] card vs CPU: quaternions and angles; cm
EAGER_LM_STEPS = 3               # [15]: LM steps run eager and replayed, bitwise
# [15]'s small batch, card vs CPU, joint positions (cm). In float64 with the
# LU IK end to end: SMALL_F64_MAX_D (read 1.9e-7). In float32 a whole run
# amplifies roundings: unconverged CG steps and LM accepts decided by a
# float32 cost part the card and the CPU by tenths of a cm. So float32 is
# held stage by stage, each stage from the card's input, where the CPU's
# own one-ulp spread is 1.2e-4 cm after IK 200 LU, 1.2e-3 after LM 1 5:15
# and 4.6e-3 after LM 2 (tests/test_torch_trajectory.py holds it 4x
# inside): SMALL_IK_MAX_D, SMALL_LM_MAX_D, the floor fits' normals within
# FLOOR_COS_GAP of cos 1. The card's IK with its matmul
# inputs rounded to TF32 must break SMALL_IK_MAX_D (cuBLAS runs these small
# batched products in full float32 even where TF32 is allowed). The CG
# IK's run is held, as information beside them, to SPREAD_X times the
# CPU's own spread under one-ulp changes of the 3D inputs (SPREAD_ULPS).
# Floor normals end to end: SMALL_COS_MIN; [16]'s CLI: CLI_MAX_D cm.
SMALL_F64_MAX_D, SMALL_IK_MAX_D, SMALL_LM_MAX_D, FLOOR_COS_GAP = 1e-5, 1e-3, 5e-2, 1e-9
SPREAD_X, SPREAD_ULPS = 3.0, (1, -1)
SMALL_COS_MIN, CLI_MAX_D = 0.9999, 0.05
# The physics stage: [19]'s realistic batch is bench.py's physics shape.
PHYS_B, PHYS_F = 32, 100
PHYS_GOLDEN = os.path.join(REPO, "tests", "fixtures", "phys_fit_scipy_f20_seed0.npz")
YBOT_TEMPLATE = os.path.join(REPO, "tests", "fixtures", "prepare_input", "ybot", "motion.bvh")
# [17] card vs CPU in float32: max |d| over max(1, max |CPU|) of each block
BLOCK_REL = 1e-5
# [19]'s small batch, card vs CPU: float64 end to end (m). In float32, stage
# by stage from the card's input, each quantity (positions m, angles rad,
# forces N, durations s) within SPREAD_X times the CPU's own spread under a
# one-ulp change of that stage's input (SPREAD_ULPS), or SMALL_PHYS_F32_FLOOR
# where that spread is smaller: 3 LM steps from zero forces part by up to
# 8e-3 m and 5 N on the CPU alone in the DYN stage.
SMALL_PHYS_F64_MAX_D, SMALL_PHYS_F32_FLOOR = 1e-6, 1e-5
# [20]: the run CLI's budget, and its card run against its CPU run:
# solutions (m) and BVH joints (cm)
RUN_BUDGET = {"kinematic.ik_iterations": 20, "kinematic.lm_iters": 8, "kinematic.cg_iters": 30,
              "physics.al_iters_fit": 1, "physics.al_iters_dyn": 1,
              "physics.al_iters_height": 1, "physics.al_iters_durations": 1,
              "physics.lm_iters": 3, "physics.cg_iters": 10}
RUN_SOL_MAX_D, RUN_BVH_MAX_D = 0.05, 2.0
# [21]: each sequence's final stage-2 cost, banded against PCG (a gap is
# printed, and explained in PERF.md)
BANDED_COST_X = 1.001
# [22]: the "highest" (6-pass) kernel against float64 and its emulation; the
# single-pass modes against their emulation by ops.fused_mlp.single_pass_gate
# (the mean, against the distance to the nearest other mode; its controls)
# and within ONE_PASS_ULPS bf16 roundings (2**-8 relative) of the largest
# logit, and their binary agreement with "high"
HIGHEST_MAX_D, ONE_PASS_ULPS, MODE_AGREE_MIN = 1e-5, 4, 0.99
# [24]: golden detect_contacts calls traced (one kernel event each);
# _infer_batch calls timed by utils.profiling.benchmark, whose mean_s must
# read at least BENCH_MIN_RATIO of the same calls' CUDA-event time
TRACE_CALLS, BENCH_ITERS, BENCH_MIN_RATIO = 2, 20, 0.9
# [25]: the long clip, 60 s at 30 fps, frame-sharded 4 ways in one process,
# and its refinement's cut budget (IK iterations, LM steps, CG iterations a
# step, for each LM stage). Its sharded probe (cost, Jᵀr, diag(JᵀJ)) is held
# to the unsharded one in float32 within LONG_PROBE_REL of the largest
# element: each is a sum over a frame's residual rows (or, for the cost,
# over ~1e6 rows) that the two evaluate through differently shaped tensors,
# so in other orders; float32's 6e-8 unit roundoff over such sums stays near
# 1e-6 relative, and a halo or ownership fault is O(1) at every shard edge.
# The sharded LM runs eagerly, 12-18 ms a JᵀJ·v product at the golden's 16
# frames (launch-bound), so [14]'s gates are held frame-sharded at the cut
# budget SHARD_GOLDEN_LM (LM steps a stage, CG iterations a step) in place
# of 50:100 (123 s); the mean joint error, the gate nearest its bound,
# needs CG 60 (at CG 30-40 it nears or passes 2 cm).
LONG_F, LONG_SHARDS = 1800, 4
LONG_IK, LONG_LM = 50, (4, 40)
LONG_PROBE_REL = 1e-4
SHARD_GOLDEN_LM = (20, 60)
# [26]: the JᵀJ·v kernel at [15]'s shapes against autograd's double vjp in
# float64 at the same point, on the norm of the whole output: float32 rounds
# ~6e-8 a step through a tree seven levels deep (read ~2e-7), and a block
# left out or a frame of a tile's halo dropped moves it by far more
JTJV_REL = {"float32": 1e-5, "float64": 1e-12}
JTJV_REPS = 50                   # launches in a timed graph
# FLOP a frame, counted from csrc/traj_jtjv.cu: a product's FK at x, its
# tangent and transpose through the tree and the seven residual blocks; the
# diagonal's 87 one-dof tangents through each subtree and the 28 slots'
# squared tangents. H100 SXM float64 (non-tensor) peak at 700 W
JTJV_FRAME_FLOP = {"product": 26e3, "diag": 0.21e6}
F64_PEAK = 34e12
# [27]: the physics JᵀJ·v kernel at [19]'s 32 x 100 frames against
# autograd's double vjp in float64 at the same point, on the largest of the
# dof groups' relative error norms (the Newton–Euler rows make some entries
# ~1e7 times others): float32 rounds R·I·Rᵀ and the rows to ~6e-8 a step,
# and a block left out moves a group by far more. FLOP a frame, counted
# from csrc/phys_jtjv.cu: level 0's sines, cosines and differences, the
# Newton–Euler block's 3x3 products, tangent and transpose, the leg,
# heel, height, terrain, slip and cone rows, the transposes of the
# differences and the cost residuals; the diagonal is 90 such products
PHYS_JTJV_REL = {"float32": 1e-5, "float64": 1e-10}
PHYS_JTJV_FRAME_FLOP = {"product": 3.0e3, "diag": 90 * 3.0e3}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def mlp_bound(args, passes: int) -> dict:
    """The least time the card could take for the kernel on ``args``
    (layers, x, width, row_stride), at the H100 SXM's peaks at 700 W:
    layers 0-2 as ``passes`` bf16 tensor-core passes, layers 3-4 in float32
    on CUDA cores, against the bytes (x, weights, logits, each moved once)."""
    layers, x, width, row_stride = args
    rows = x.shape[0] * ((x.shape[1] - width) // row_stride + 1)
    dims = [width] + [w.shape[1] for w, _ in layers]
    macs = [a * b for a, b in zip(dims, dims[1:])]
    tc_flop, cc_flop = passes * 2 * rows * sum(macs[:3]), 2 * rows * sum(macs[3:])
    n_bytes = (x.numel() + sum(w.numel() + b.numel() for w, b in layers) + rows * dims[-1]) * 4
    ops_ms = (tc_flop / BF16_PEAK + cc_flop / F32_PEAK) * 1e3
    return {"rows": rows, "dims": dims, "flop": 2 * rows * sum(macs), "tc_flop": tc_flop,
            "cc_flop": cc_flop, "bytes": n_bytes,
            "bound_ms": max(ops_ms, n_bytes / HBM_RATE * 1e3),
            "bound_by": "operations" if ops_ms >= n_bytes / HBM_RATE * 1e3 else "bytes"}


def weight_stream(lib, mode: str, rows: int, width: int) -> dict:
    """The kernel's weight stream on ``rows`` rows of ``width`` in ``mode``:
    the bytes it reads from L2 (each cluster reads each stage of each tile
    group once and multicasts it to its blocks: groups x stages x parts x
    16 KB), the bytes its blocks receive (x the cluster size), the tile
    groups and the clusters on the card."""
    from chd_tpu_torch.ops.fused_mlp import MODES

    mode_id, size = MODES.index(mode), lib.chd_fused_mlp_cluster_size()
    groups = -(-(-(-rows // 64)) // size)
    n = groups * lib.chd_fused_mlp_tiles(width, mode_id) * lib.chd_fused_mlp_parts(mode_id) * 16384
    return {"l2_bytes": n, "block_bytes": n * size, "groups": groups, "cluster_size": size,
            "clusters": lib.chd_fused_mlp_clusters(width, mode_id)}


def stream_line(ws: dict, ms: float) -> str:
    return (f"weight stream {ws['l2_bytes'] / 1e9:.3f} GB from L2 ({ws['groups']} groups of "
            f"{ws['cluster_size']} tiles on {ws['clusters']} clusters, "
            f"{ws['block_bytes'] / 1e9:.3f} GB into blocks): {ws['l2_bytes'] / ms / 1e9:.2f} TB/s "
            f"of L2 reads, {ws['block_bytes'] / ms / 1e9:.2f} TB/s into blocks")


@contextlib.contextmanager
def tf32_matmuls():
    """float32 matmuls in TF32 inside the block: stands in for a module's
    ``full_f32`` pin to show that a check tells the two apart."""
    import torch

    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def tf32_rounded(x):
    """float32 rounded to TF32's 10-bit mantissa, to nearest: what a TF32
    tensor-core product reads."""
    import torch

    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


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


# [2]: the first launch of every instantiation, in a child process: a
# ragged row count (5 tiles: the last cluster has a block with no rows) in
# each mode, resident (351) and slab (675) first-layer rows
FIRST_LAUNCH = r"""
import sys, torch
from chd_tpu_torch.models import contact_mlp
from chd_tpu_torch.ops.fused_mlp import MODES, MlpLayers, fused_mlp
gen = torch.Generator().manual_seed(0)
for d0 in (351, 675):
    dims = [d0, *contact_mlp.HIDDEN, 20]
    ws = [(torch.randn(dims[i], dims[i + 1], generator=gen) * dims[i] ** -0.5,
           torch.randn(dims[i + 1], generator=gen) * 0.1) for i in range(5)]
    x = torch.randn(FIRST_LAUNCH_ROWS, d0, generator=gen).cuda()
    for mode in MODES:
        print(f"launch {mode} d0={d0}", flush=True)
        out = fused_mlp(MlpLayers([(w.cuda(), b.cuda()) for w, b in ws], mode), x, d0, d0)
        torch.cuda.synchronize()
        if out.shape != (FIRST_LAUNCH_ROWS, 20) or not bool(torch.isfinite(out).all()):
            sys.exit(f"{mode} d0={d0}: logits {tuple(out.shape)}, finite "
                     f"{bool(torch.isfinite(out).all())}")
print("first launches ok", flush=True)
"""
FIRST_LAUNCH_ROWS, FIRST_LAUNCH_S = 300, 60


def sass_counts(sass: str) -> dict:
    """{(slabs, mode): {"HGMMA": n, "HMMA": n, "UBLKCP": n, "UTMALDG": n,
    "registers": highest register number + 1}} of each fused_mlp_kernel
    instantiation in ``cuobjdump -sass`` output."""
    import re

    counts, key = {}, None
    name = re.compile(r"Function : \S*fused_mlp_kernelILb([01])ELi(\d)E")
    for line in sass.splitlines():
        if "Function :" in line:
            m = name.search(line)
            key = (m.group(1) == "1", int(m.group(2))) if m else None
            if key is not None:
                counts[key] = dict.fromkeys(("HGMMA", "HMMA", "UBLKCP", "UTMALDG",
                                             "registers"), 0)
        elif key is not None:
            for op in ("HGMMA", "HMMA", "UBLKCP", "UTMALDG"):
                counts[key][op] += bool(re.search(rf"\b{op}\b", line))
            regs = [int(r) + 1 for r in re.findall(r"\bR(\d+)\b", line)]
            gmma = re.search(r"HGMMA\.64x(\d+)x16\S* R(\d+)", line)
            if gmma:  # the accumulators: N / 2 registers from the first
                regs.append(int(gmma.group(2)) + int(gmma.group(1)) // 2)
            counts[key]["registers"] = max([counts[key]["registers"], *regs])
    return counts


def build_phase(torch) -> None:
    """Phase [2]: build, ptxas' report, the SASS of each instantiation, and
    each instantiation's first launch in a child process."""
    from chd_tpu_torch.ops.fused_mlp import MODES
    from chd_tpu_torch.utils import build

    t0 = time.perf_counter()
    k = build.kernels()
    print(f"[2] build: {k.path}: nvcc {k.build_seconds:.2f} s "
          f"({time.perf_counter() - t0:.2f} s with loading; 0 nvcc s = an "
          "earlier build was loaded)")
    for line in k.log.splitlines():
        if any(w in line for w in ("registers", "spill", "wgmma", "Compiling entry")):
            print(f"    ptxas: {line.strip()}")
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", k.path], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    counts = sass_counts(sass)
    for (slab, mode), c in sorted(counts.items()):
        print(f"    SASS fused_mlp_kernel<{'slabs' if slab else 'resident'}, "
              f"{MODES[mode]}>: " + ", ".join(f"{op} {n}" for op, n in c.items()))
    for d0 in (351, 675):
        print(f"    d0={d0}: " + ", ".join(
            f"{m} {k.lib.chd_fused_mlp_smem_bytes(d0, i)} B shared, "
            f"{k.lib.chd_fused_mlp_ring_stages(d0, i)} ring stages"
            for i, m in enumerate(MODES)) + f"; cluster of {k.lib.chd_fused_mlp_cluster_size()}")
    if len(counts) != 2 * len(MODES):
        fail(f"[2] found {len(counts)} fused_mlp_kernel instantiations in the SASS, "
             f"not {2 * len(MODES)}")
    for slab in (False, True):
        c = counts[slab, MODES.index("high")]
        if c["HGMMA"] == 0 or c["UBLKCP"] + c["UTMALDG"] == 0:
            fail(f"[2] the high instantiation (slabs={slab}) has no wgmma (HGMMA) or no bulk "
                 f"copy in its SASS: {c}")
    code = f"FIRST_LAUNCH_ROWS = {FIRST_LAUNCH_ROWS}\n" + FIRST_LAUNCH
    t0 = time.perf_counter()
    try:
        res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             timeout=FIRST_LAUNCH_S, cwd=REPO)
        said, rc = res.stdout + res.stderr, res.returncode
    except subprocess.TimeoutExpired as e:
        said = (e.stdout or b"").decode() if isinstance(e.stdout, bytes) else (e.stdout or "")
        rc = "timeout"
    lines = said.strip().splitlines()
    print(f"    first launches in a child process, {FIRST_LAUNCH_ROWS} rows, each mode at d0=351 "
          f"and 675: rc {rc} in {time.perf_counter() - t0:.1f} s; last: {lines[-1:]}")
    if rc != 0:
        fail(f"[2] a first launch failed or hung (rc {rc}); the child said:\n{said[-3000:]}")


def contact_phases(torch, dev, smi: str) -> dict:
    """Phases [2]-[12]: the contact slices; returns the kernel's JSON entry."""
    from chd_tpu_torch.contact import data as data_lib
    from chd_tpu_torch.contact import infer
    from chd_tpu_torch.contact import train as train_lib
    from chd_tpu_torch.models import contact_mlp, torch_convert
    from chd_tpu_torch.ops import gapfill
    from chd_tpu_torch.ops.fused_mlp import (fused_mlp, fused_mlp_plain,
                                             fused_mlp_split_plain)
    from chd_tpu_torch.utils import build


    # -- 2. build ------------------------------------------------------------
    build_phase(torch)

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
    with tempfile.TemporaryDirectory() as tmp:
        dirs = golden_video_dirs(tmp, golden)
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
    b = mlp_bound(args, 3)
    rows, flop, bound_ms, bound_by = b["rows"], b["flop"], b["bound_ms"], b["bound_by"]
    print(f"    fused_mlp alone, conv rows of V={BIG_V} F={BIG_F}: kernel {ms:.3f} ms "
          f"({', '.join('%.3f' % t for t in kernel_ms)}), plain (unfold + 5 addmm) {p_ms:.3f} ms; "
          f"{rows} rows x widths {b['dims']}: {flop / 1e9:.1f} GFLOP, kernel "
          f"{flop / ms / 1e9:.1f} TFLOP/s, plain {flop / p_ms / 1e9:.1f} TFLOP/s")
    # the least time the card could take: the bytes take far less than the
    # operations
    print(f"    bound: {b['tc_flop'] / 1e9:.1f} GFLOP on tensor cores (3 bf16 passes) + "
          f"{b['cc_flop'] / 1e9:.2f} GFLOP float32 + {b['bytes'] / 1e6:.1f} MB -> "
          f"{bound_ms:.3f} ms ({bound_by}); the kernel takes {bound_ms / ms:.3f} of the card's "
          f"peak; {stream_line(weight_stream(build.kernels().lib, 'high', rows, args[2]), ms)}")

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
    full_ms, full_bound = {}, {}
    for use_conv in (True, False):
        det = infer.ContactDetector(rand_model(25), device=dev, joint_set="full",
                                    use_conv=use_conv)
        fargs = rows_of(det, big)
        compare(f"full use_conv={use_conv} V={BIG_V} F={BIG_F}", lambda mlp: mlp(*fargs))
        p1 = event_ms(fused_mlp_plain, fargs)
        k1, k2 = event_ms(fused_mlp, fargs), event_ms(fused_mlp, fargs)
        p2 = event_ms(fused_mlp_plain, fargs)
        full_ms[use_conv] = (statistics.mean([k1, k2]), statistics.mean([p1, p2]))
        fb = mlp_bound(fargs, 3)
        full_bound[use_conv] = fb["bound_ms"]
        print(f"    full use_conv={use_conv} d0={fargs[2]}, V={BIG_V} F={BIG_F}: kernel "
              f"{full_ms[use_conv][0]:.3f} ms ({k1:.3f}, {k2:.3f}), plain "
              f"{full_ms[use_conv][1]:.3f} ms; bound {fb['bound_ms']:.3f} ms ({fb['bound_by']}: "
              f"{fb['tc_flop'] / 1e9:.1f} GFLOP on tensor cores + {fb['cc_flop'] / 1e9:.2f} GFLOP "
              f"float32), {fb['bound_ms'] / full_ms[use_conv][0]:.3f} of it reached; "
              + stream_line(weight_stream(build.kernels().lib, "high", fb["rows"], fargs[2]),
                            full_ms[use_conv][0]))

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
    with mock.patch.object(train_lib, "full_f32", tf32_matmuls):
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

    return {
        "name": "fused_mlp",
        "route": "cuda",
        "source": "chd_tpu_torch/csrc/fused_mlp.cu",
        "replaces": "chd_tpu/ops/pallas_mlp.py:26",
        "launches": launches,
        "launches_by_path": {"detect_contacts": launches, "train_and_evaluate": train_launches},
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no one PyTorch call computes the folded 5-layer MLP
        "full_ms": full_ms[True][0],
        "full_plain_ms": full_ms[True][1],
        "full_bound_ms": full_bound[True],
    }


def golden_skeleton(g):
    """The combined template skeleton stored in trajectory_golden.npz."""
    from chd_tpu_torch.core.animation import Animation

    return Animation(g["skel_rotations"], g["skel_positions"], g["skel_orients"],
                     g["skel_offsets"], [int(p) for p in g["skel_parents"]])


def kin_problem(rng, skel, F: int, contact_p: float = 0.5) -> dict:
    """One synthetic kinematic problem: a smooth motion of ``skel`` seen by
    the MTC camera, SMPL angles near it, random contacts (on with
    probability 1 - contact_p). bench.py's kinematic recipe."""
    from chd_tpu_torch.characters import defs
    from chd_tpu_torch.kinematics import trajectory as traj_lib

    pose3d, world, root, es = kin_motion(rng, skel, F)
    fx, fy = defs.MTC_FOCAL
    cx, cy = defs.MTC_PP
    pose2d = np.stack([fx * world[..., 0] / world[..., 2] + cx,
                       fy * world[..., 1] / world[..., 2] + cy], axis=-1)
    conf = np.ones((F, 28))
    conf[:, 25:] = 0
    vc = traj_lib.contacts_to_vel_constraints((rng.uniform(size=(F, 4)) > contact_p).astype(int))
    return dict(pose2d=pose2d, conf2d=conf, pose3d=pose3d, root_pos=root, smpl_angles=-es,
                vel_constraints=vc)


def kin_motion(rng, skel, F: int):
    """(root-relative data-order pose3d, world joints, root, eulers) of a
    smooth motion of ``skel`` (float32 FK, as bench.py's recipe)."""
    import torch

    from chd_tpu_torch.characters import defs
    from chd_tpu_torch.kinematics.residuals import Layout, data_order_positions

    J = len(skel.parents)
    e0 = rng.uniform(-0.2, 0.2, size=(J, 3))
    e1 = e0 + rng.uniform(-0.15, 0.15, size=(J, 3))
    t = np.linspace(0, 1, F)[:, None, None]
    es = (1 - t) * e0[None] + t * e1[None]
    root = np.stack([np.linspace(0, 15, F), np.full(F, -95.0), np.linspace(380, 395, F)], axis=1)
    x = torch.from_numpy(np.concatenate([root, es.reshape(F, -1)], axis=1)).float()
    y, r = data_order_positions(
        x[None], torch.as_tensor(np.asarray(skel.offsets), dtype=torch.float32)[None],
        Layout(skel.parents))
    y, r = y[0].double().numpy(), r[0].double().numpy()
    pose3d = y.copy()
    pose3d[:, defs.COMBINED_ROOT_IDX] = 0.0
    world = y + r[:, None]
    world[:, defs.COMBINED_ROOT_IDX] = r
    return pose3d, world, root, es


def synth_video_dir(root: str, skel, F: int = 12) -> str:
    """A video dir (openpose_result/, tracked_results.json, all-on
    foot_contacts.npy) of a synthetic motion of ``skel``: the recipe of
    tests/test_pipeline.py. Returns its path."""
    rng = np.random.default_rng(9)
    vd = os.path.join(root, "dance_synth")
    os.makedirs(os.path.join(vd, "openpose_result"))
    pose3d, world, r, _ = kin_motion(rng, skel, F)
    fx, fy, cx, cy = 2000.0, 2000.0, 960.0, 540.0  # the MTC camera
    px = fx * world[..., 0] / world[..., 2] + cx
    py = fy * world[..., 1] / world[..., 2] + cy
    for f in range(F):
        kp = np.stack([px[f, :25], py[f, :25], np.ones(25)], axis=1)
        with open(os.path.join(vd, "openpose_result", f"{f:06d}_keypoints.json"), "w") as fh:
            json.dump({"people": [{"pose_keypoints_2d": kp.reshape(-1).tolist()}]}, fh)
    smpl3d = np.zeros((F, 22, 3))
    smpl3d[:, [3, 6, 9]] = pose3d[:, 25:]  # the SMPL spine joints
    frames = [{
        "trans": dict(zip("xyz", map(float, r[f]))),
        "joints": [{"pos": dict(zip("xyz", map(float, pose3d[f, j])))} for j in range(25)],
        "SMPLJoints": [{"pos": dict(zip("xyz", map(float, smpl3d[f, j]))),
                        "rot": dict(zip("xyz", (0.0, 0.0, 0.0)))} for j in range(22)],
        "bodyCoeffs": [0.0] * 30, "faceCoeffs": [0.0] * 200,
    } for f in range(F)]
    with open(os.path.join(vd, "tracked_results.json"), "w") as fh:
        json.dump({"totalcapResults": frames}, fh)
    np.save(os.path.join(vd, "foot_contacts.npy"), np.ones((F, 4), dtype=int))
    return vd


def trajectory_golden_gates(g, device, graphs=None, lm_solver="pcg", mesh=None,
                            lm=(50, 100)):
    """The port's solution of trajectory_golden.npz at its pinned budget
    ``lm`` (LM steps a stage, CG iterations a step; 50:100), and
    what the gates of tests/test_goldens.py read from it: floor normal cos,
    plane offset (cm), pruned contacts equal, mean and median joint error
    (cm), median reprojection error and its bound (px), and the stage-2
    objective of both solutions, each scored by the port's residual on the
    CPU in float32 on its own problem. ``lm_solver="banded"`` solves the
    same problem with the banded direct inner solve ([21]); a ``mesh``
    solves it with both LM stages frame-sharded over the mesh
    (``parallel.longseq``, [25])."""
    import torch

    from chd_tpu_torch.characters import defs
    from chd_tpu_torch.core import quat
    from chd_tpu_torch.kinematics import batch as batch_lib
    from chd_tpu_torch.kinematics import trajectory as traj_lib
    from chd_tpu_torch.kinematics.lm import LMConfig
    from chd_tpu_torch.kinematics.residuals import Layout, TrajectoryData, trajectory_residuals

    parents = [int(p) for p in g["skel_parents"]]
    # optimize_trajectory's own call, with the inner solve as an argument
    problem = dict(pose2d=g["pose2d"], conf2d=g["conf"], pose3d=g["pose3d"],
                   root_pos=g["root"], smpl_angles=g["smpl_angles"],
                   vel_constraints=g["vel_constraints"].astype(float))
    if mesh is None:
        res = batch_lib.optimize_trajectory_batch(
            [problem], golden_skeleton(g), cam_focal=tuple(g["cam_focal"]),
            cam_pp=tuple(g["cam_pp"]), lm_cfg=LMConfig(*lm),
            device=device, ik_solver="lu", graphs=graphs, lm_solver=lm_solver)[0]
    else:
        from chd_tpu_torch.parallel import longseq

        res = longseq.optimize_trajectory_frame_sharded(
            *(problem[k] for k in ("pose2d", "conf2d", "pose3d", "root_pos", "smpl_angles")),
            golden_skeleton(g), problem["vel_constraints"], mesh,
            cam_focal=tuple(g["cam_focal"]), cam_pp=tuple(g["cam_pp"]),
            lm_cfg=LMConfig(*lm))
    F = g["pose2d"].shape[0]
    n_ref, p_ref = g["out_plane_normal"], g["out_plane_point"]
    n_got = np.asarray(res.floor_normal, np.float64)
    p_got = np.asarray(res.floor_point, np.float64)
    err = np.linalg.norm(res.pose3d - g["out_pose3d"], axis=-1)
    perr = np.linalg.norm(res.proj2d - g["out_proj2d"], axis=-1)
    mask = g["conf"] > 0.2

    s2d = np.asarray(defs.COMBINED_SKEL_TO_DATA)
    targets = g["pose3d"][:, s2d] + g["root"][:, None, :]
    offsets = traj_lib.update_skeleton(np.asarray(g["skel_offsets"]), parents, targets)
    proj_w, data_w = traj_lib.build_weights(g["conf"])
    fx, fy = g["cam_focal"]
    cx, cy = g["cam_pp"]
    p2dn = np.stack([(g["pose2d"][..., 0] - cx) / fx, (g["pose2d"][..., 1] - cy) / fy], axis=-1)
    layout = Layout(parents)

    def stage2_cost(x, normal, point, vc):
        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32)[None]

        data = TrajectoryData(t(g["pose3d"]), t(g["root"]), t(p2dn), t(proj_w), t(data_w),
                              t(defs.COMBINED_SMOOTH_WEIGHTS), t(vc), t(normal), t(point),
                              t(offsets))
        r = trajectory_residuals(t(x), data, traj_lib.STAGE2, layout)
        return 0.5 * float((r * r).sum())

    eul = quat.to_euler(torch.as_tensor(res.anim.rotations), "xyz").numpy()
    x_ours = np.concatenate([res.anim.positions[:, 0], eul.reshape(F, -1)], axis=1).reshape(-1)
    x_gold = np.concatenate([g["out_root"], g["out_euler"].reshape(F, -1)], axis=1).reshape(-1)
    gates = {
        "cos": abs(float(n_got @ n_ref)),
        "offset": abs(float((p_got - p_ref) @ n_ref)),
        "contacts_equal": bool(np.array_equal(res.vel_constraints.astype(int),
                                              g["out_vel_constraints"].astype(int))),
        "mean_err": float(err.mean()),
        "median_err": float(np.median(err)),
        "median_px": float(np.median(perr[mask])),
        "px_bound": 2.0 * float(g["cam_focal"][0]) / float(np.median(g["out_pose3d"][..., 2])),
        "cost": stage2_cost(x_ours, res.floor_normal, res.floor_point, res.vel_constraints),
        "golden_cost": stage2_cost(x_gold, n_ref, p_ref, g["out_vel_constraints"]),
    }
    return res, gates


def golden_gates_pass(gates: dict) -> bool:
    return (gates["cos"] > 0.9994 and gates["offset"] < 2.0 and gates["contacts_equal"]
            and gates["mean_err"] < 2.0 and gates["median_err"] < 2.0
            and gates["median_px"] < gates["px_bound"]
            and gates["cost"] <= gates["golden_cost"] * 1.001)


def stage2_costs(batch_lib, arrs, consts, out, w2) -> np.ndarray:
    """Each sequence's final stage-2 cost, ½‖r‖² in float64 of the residual
    of the staged outputs (x0, x1, x2, normals, points, vc2): the solution
    scored on its own floor and pruned contacts."""
    _, _, x2, normals, points, vc2 = out
    r = consts.layout.residual(x2, batch_lib.make_data(arrs, consts, vc2, normals, points), w2)
    return (0.5 * (r.double() ** 2).sum(-1)).cpu().numpy()


def wall(fn):
    """(seconds, result) of fn() between two device syncs."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t, out


def no_sync(fn):
    """fn() with every host sync an error (sync debug mode 'error')."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def stage_ms(ev) -> list:
    """The milliseconds between consecutive CUDA events."""
    import torch

    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(len(ev) - 1)]


def kin_staged(batch_lib, arrs, consts, lm_cfg, graphs):
    """The kinematic batch's stages (_refine_core's) with a CUDA event
    between them and no host sync: ((x0, x1, x2, normals, points, vc2),
    events of [IK, LM 1, floor, LM 2])."""
    import torch

    from chd_tpu_torch.kinematics import trajectory as traj_lib

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    zero3 = torch.zeros((arrs["vc"].shape[0], 3), device=arrs["vc"].device)
    ev[0].record()
    x0 = batch_lib.initial_x(*batch_lib.ik_init_batch(arrs, consts, graphs))
    ev[1].record()
    x1 = batch_lib.lm_stage(x0, batch_lib.make_data(arrs, consts, arrs["vc"], zero3, zero3),
                            traj_lib.STAGE1, consts, lm_cfg, graphs)
    ev[2].record()
    normals, points, vc2 = batch_lib.floor_stage(x1, arrs, consts)
    ev[3].record()
    x2 = batch_lib.lm_stage(x1, batch_lib.make_data(arrs, consts, vc2, normals, points),
                            traj_lib.STAGE2, consts, lm_cfg, graphs)
    ev[4].record()
    return (x0, x1, x2, normals, points, vc2), ev


def profiled_step(one_step) -> dict:
    """One eager call of ``one_step``: its wall time and peak memory above
    what was allocated before it (GiB), then the same call under
    torch.profiler: wall time, kernel launches, device kernels, device busy
    time (s), idle share, and the device and host items by self time."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t_step, _ = wall(one_step)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t_prof, _ = wall(one_step)
    events = prof.key_averages()
    device_items = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                           and not getattr(e, "is_user_annotation", False)),
                          key=lambda e: e.self_device_time_total, reverse=True)
    host_items = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CPU),
                        key=lambda e: e.self_cpu_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in device_items) / 1e6
    return {"t_step": t_step, "peak_gib": peak, "t_prof": t_prof,
            "launches": sum(e.count for e in events if e.key in (
                "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")),
            "kernels": sum(e.count for e in device_items), "busy": busy,
            "idle": 1 - busy / t_prof, "device_items": device_items, "host_items": host_items}


def print_top_items(prof: dict, what=("device",)) -> None:
    """The six largest items by self time of each of ``what``."""
    for w in what:
        key = "self_device_time_total" if w == "device" else "self_cpu_time_total"
        for e in prof[f"{w}_items"][:6]:
            print(f"      {w} {getattr(e, key) / 1e3:8.2f} ms x{e.count:<6d} {e.key[:80]}")


def kinematic_phases(torch, dev, smi: str) -> dict:
    """Phases [13]-[16]: the kinematic stage on the card. Returns [15]'s PCG
    readings, which [21] sets beside the banded solve's."""
    from chd_tpu_torch.core import fk, quat
    from chd_tpu_torch.kinematics import batch as batch_lib
    from chd_tpu_torch.kinematics import ik as ik_lib
    from chd_tpu_torch.kinematics import jtjv as jtjv_lib
    from chd_tpu_torch.kinematics import lm as lm_lib
    from chd_tpu_torch.kinematics import trajectory as traj_lib
    from chd_tpu_torch.kinematics.ik import IKConfig
    from chd_tpu_torch.kinematics.lm import LMConfig
    from chd_tpu_torch.kinematics.residuals import Layout, data_order_positions
    from chd_tpu_torch.utils import profiling
    from chd_tpu_torch.utils.cuda_graph import GraphCache

    g = np.load(TRAJ_GOLDEN)
    skel = golden_skeleton(g)
    parents = skel.parents
    J = len(parents)

    # -- 13. core on the card ---------------------------------------------
    rng = np.random.default_rng(13)

    def unit(n):
        q = rng.normal(size=(n, 4))
        return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)

    n = 1 << 14
    qa, qb = unit(n), unit(n)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    ang = rng.uniform(-3, 3, size=n).astype(np.float32)
    eul = rng.uniform(-1.4, 1.4, size=(n, 3)).astype(np.float32)
    Ff = 100
    f_eul = rng.uniform(-0.5, 0.5, size=(Ff, J, 3)).astype(np.float32)
    f_pos = np.broadcast_to(np.asarray(skel.offsets, np.float32), (Ff, J, 3)).copy()
    f_pos[:, 0] = rng.normal(0, 20, size=(Ff, 3)) + [0, -95, 380]
    cases = {
        "mul": (lambda d: quat.mul(d(qa), d(qb)), CORE_ATOL),
        "rotate": (lambda d: quat.rotate(d(qa), d(v)), CORE_ATOL),
        "from_angle_axis": (lambda d: quat.from_angle_axis(d(ang), d(v)), CORE_ATOL),
        "from_euler xyz world": (lambda d: quat.from_euler(d(eul), "xyz", True), CORE_ATOL),
        "to_euler xyz": (lambda d: quat.to_euler(d(qa), "xyz"), CORE_ATOL),
        "fk rotations": (lambda d: fk.fk(quat.from_euler(d(f_eul), "xyz", True), d(f_pos),
                                         parents)[0], CORE_ATOL),
        "fk positions (cm)": (lambda d: fk.fk(quat.from_euler(d(f_eul), "xyz", True), d(f_pos),
                                              parents)[1], CORE_POS_ATOL),
    }
    print(f"[13] core on the card vs the port on the CPU, float32 ({n} quaternions; FK of "
          f"{Ff} frames of the {J}-joint combined skeleton)")
    for name, (fn, bound) in cases.items():
        got = fn(lambda a: torch.from_numpy(a).to(dev)).cpu()
        want = fn(torch.from_numpy)
        d = float((got - want).abs().max())
        print(f"    {name}: max|d| {d:.3e} (<= {bound})")
        if not d <= bound:
            fail(f"[13] {name}: card and CPU differ by {d}")

    # -- 14. the trajectory golden on the card ----------------------------
    graphs = GraphCache()
    t14, (res14, gates) = wall(lambda: trajectory_golden_gates(g, "cuda", graphs))
    print(f"[14] trajectory golden on the card (F={g['pose2d'].shape[0]}, IK 200 LU, LM 50:100 "
          f"as CUDA graphs): {t14:.2f} s with capture; floor cos {gates['cos']:.6f} (> 0.9994), "
          f"offset {gates['offset']:.3f} cm (< 2), contacts equal {gates['contacts_equal']}, "
          f"joint error mean {gates['mean_err']:.3f} / median {gates['median_err']:.3f} cm "
          f"(< 2), reprojection median {gates['median_px']:.2f} px (< {gates['px_bound']:.2f}), "
          f"stage-2 objective {gates['cost']:.1f} vs the golden's {gates['golden_cost']:.1f} "
          f"(<= x1.001)")
    if not golden_gates_pass(gates):
        fail(f"[14] the trajectory golden's gates failed on the card: {gates}")

    # -- 15. the realistic batch ------------------------------------------
    rng = np.random.default_rng(0)
    problems = [kin_problem(rng, skel, KIN_F) for _ in range(KIN_B)]
    lm_cfg = LMConfig(max_iters=40, cg_iters=80)
    ik_cfg = IKConfig(iterations=200, damping=7.0, solver="cg")
    arrs, F = batch_lib.prepare_batch_arrays(problems, skel, device=dev)
    w1, w2 = traj_lib.STAGE1, traj_lib.STAGE2
    print(f"[15] optimize_trajectory_batch, {KIN_B} sequences x {KIN_F} frames, default budget "
          f"(IK 200 x CG 64, LM 40:80 x 2 stages); {smi}")

    # the entry point twice: the first call captures the IK iteration and
    # the LM step, the second replays them
    graphs = GraphCache()

    def call():
        return batch_lib.optimize_trajectory_batch(problems, skel, ik_iterations=ik_cfg.iterations,
                                                   lm_cfg=lm_cfg, graphs=graphs)

    def counted(fn):
        """(seconds, result, the JᵀJ·v kernel's launches by mode, kernel
        solves) of fn(), the wrapper's and lm_solve's counts zeroed before."""
        for mode in jtjv_lib.traj_jtjv.launches:
            jtjv_lib.traj_jtjv.launches[mode] = 0
        solves = profiling.snapshot()["counters"].get("lm.jtjv.kernel", 0)
        t, out = wall(fn)
        return (t, out, dict(jtjv_lib.traj_jtjv.launches),
                profiling.snapshot()["counters"].get("lm.jtjv.kernel", 0) - solves)

    t_first, _, launch_first, solves_first = counted(call)
    t_call, res15, launch_call, solves_call = counted(call)
    print(f"    optimize_trajectory_batch with CUDA graphs: first call {t_first:.3f} s "
          f"({graphs.captures} captures), then {t_call:.3f} s = "
          f"{KIN_B / t_call * 3600:.0f} sequences/hour (host prep and copies included)")
    # the one LM step captured serves both stages: the capturing call
    # launches its warm-up's and its capture's products, the replays none
    want_first = {"product": 2 * lm_cfg.cg_iters, "diag": 2}
    print(f"    the JtJ.v kernel's launches by the wrapper: capturing call {launch_first}, "
          f"{solves_first} kernel solves (want {want_first}, 2); replayed call {launch_call}, "
          f"{solves_call} kernel solves (the graphs hold them)")
    if (launch_first != want_first or solves_first != 2
            or any(launch_call.values()) or solves_call != 2):
        fail("[15] the LM solves did not take the JtJ.v kernel as counted")
    finite = all(np.isfinite(r.pose3d).all() and np.isfinite(r.anim.rotations).all()
                 for r in res15)
    if not finite or len(res15) != KIN_B or res15[0].pose3d.shape != (KIN_F, 28, 3):
        fail("[15] the realistic batch returned non-finite or misshapen results")

    # the same graphs stage by stage: stage times, no host sync, and the
    # entry point's own results
    consts = batch_lib.batch_consts(parents, F, ik_cfg, dev, torch.float32, graphs)
    out_g, ev = no_sync(lambda: kin_staged(batch_lib, arrs, consts, lm_cfg, graphs))
    graph_ms = stage_ms(ev)
    pcg_cost2 = stage2_costs(batch_lib, arrs, consts, out_g, w2)
    x2 = out_g[2].reshape(KIN_B, F, -1)[..., :3].cpu().numpy()
    vc2 = out_g[5].cpu().numpy()
    same_call = all(np.array_equal(x2[i], r.anim.positions[:, 0])
                    and np.array_equal(vc2[i], r.vel_constraints) for i, r in enumerate(res15))
    print(f"    replayed stage by stage (no host sync inside: sync debug mode 'error'): IK "
          f"{graph_ms[0]:.0f} ms, LM 1 {graph_ms[1]:.0f} ms, floor {graph_ms[2]:.0f} ms, LM 2 "
          f"{graph_ms[3]:.0f} ms; core {sum(graph_ms) / 1e3:.2f} s; root path and pruned "
          f"contacts equal to the call's: {same_call}")
    if not same_call:
        fail("[15] the staged replay differs from optimize_trajectory_batch")

    # eager against replayed: the IK stage and the first LM steps, no host
    # sync. Every replay runs the one captured step, so a few steps show
    # what the 80 of a call would.
    zero3 = torch.zeros((KIN_B, 3), device=dev)
    data1 = batch_lib.make_data(arrs, consts, arrs["vc"], zero3, zero3)
    short = dataclasses.replace(lm_cfg, max_iters=EAGER_LM_STEPS)

    def ik_lm(graphs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        x0 = batch_lib.initial_x(*batch_lib.ik_init_batch(arrs, consts, graphs))
        ev[1].record()
        x1 = batch_lib.lm_stage(x0, data1, w1, consts, short, graphs)
        ev[2].record()
        return (x0, x1), ev

    captures = graphs.captures
    out_e, ev = no_sync(lambda: ik_lm(None))
    eager_ms = stage_ms(ev)
    out_r, ev = no_sync(lambda: ik_lm(graphs))
    rep_ms = stage_ms(ev)
    same = all(torch.equal(a, b) for a, b in zip(out_e, out_r)) and graphs.captures == captures
    print(f"    eager vs replayed, IK 200 and {EAGER_LM_STEPS} LM steps: eager IK "
          f"{eager_ms[0]:.0f} ms, LM {eager_ms[1] / EAGER_LM_STEPS:.0f} ms a step; replayed IK "
          f"{rep_ms[0]:.0f} ms, LM {rep_ms[1] / EAGER_LM_STEPS:.1f} ms a step; bitwise equal: "
          f"{same}")
    if not same:
        fail("[15] the CUDA-graph replay differs from the eager path")

    # one LM step, eager, under the profiler
    x0 = out_e[0]
    args = lm_lib._tensor_floats((data1, w1), x0)
    lam = torch.full((KIN_B, 1), lm_cfg.init_lambda, device=dev)

    def res_fn(x):
        return consts.layout.residual(x, *args)

    c0 = lm_lib._half_sq(res_fn(x0))

    def one_step():
        return lm_lib.lm_step(res_fn, x0, lam, c0, lm_cfg, consts.masks,
                              product=lm_lib._bound(consts.layout.residual.product_for(x0), args))

    st = profiled_step(one_step)
    step_launches = {m: sum(e.count for e in st["device_items"] if f"{m}_kernel" in e.key)
                     for m in jtjv_lib.traj_jtjv.launches}
    print(f"    one eager LM step ({lm_cfg.cg_iters} CG iterations and the diagonal on the "
          f"JtJ.v kernel): {st['t_step'] * 1e3:.1f} ms, {st['peak_gib']:.2f} GiB above the "
          f"inputs at peak; profiled: wall {st['t_prof'] * 1e3:.1f} ms, {st['launches']} "
          f"launches, {st['kernels']} device kernels, of them the kernel's {step_launches}, "
          f"device busy {st['busy'] * 1e3:.1f} ms, idle share {st['idle']:.3f}")
    print_top_items(st, ("host", "device"))
    if step_launches != {"product": lm_cfg.cg_iters, "diag": 1}:
        fail(f"[15] the LM step ran the JtJ.v kernel {step_launches} times")
    pcg15 = {"t_first": t_first, "t_call": t_call, "stage_ms": graph_ms,
             "eager_step_ms": eager_ms[1] / EAGER_LM_STEPS,
             "replayed_step_ms": rep_ms[1] / EAGER_LM_STEPS, "step": st,
             "stage2_cost": pcg_cost2,
             "jtjv_launches": {"optimize_trajectory_batch": launch_first,
                               "optimize_trajectory_batch, replayed": launch_call,
                               "lm_step": step_launches}}

    # a small ragged batch, card against the port on the CPU
    rng = np.random.default_rng(17)
    small = [kin_problem(rng, skel, 16, 0.3), kin_problem(rng, skel, 12, 0.3)]
    small_lm = LMConfig(5, 15)

    def joints(r):
        return fk.positions_global(torch.as_tensor(r.anim.rotations).double(),
                                   torch.as_tensor(r.anim.positions).double(), parents).numpy()

    def end_to_end(name, dtype, solver, bound=None):
        """Both devices from the same problems; joints within ``bound`` cm,
        or, without one, within SPREAD_X times the CPU's own spread under
        one-ulp changes of the 3D inputs."""
        kw = dict(ik_iterations=10, lm_cfg=small_lm, ik_solver=solver, dtype=dtype)
        on_card = batch_lib.optimize_trajectory_batch(small, skel, device="cuda", **kw)
        on_cpu = batch_lib.optimize_trajectory_batch(small, skel, device="cpu", **kw)
        spread = np.zeros(len(small))
        if bound is None:
            eps = torch.finfo(dtype).eps
            for k in SPREAD_ULPS:
                moved = [dict(p, pose3d=p["pose3d"] * (1 + k * eps)) for p in small]
                spread = np.maximum(spread, [
                    np.abs(joints(a) - joints(b)).max() for a, b in zip(
                        batch_lib.optimize_trajectory_batch(moved, skel, device="cpu", **kw),
                        on_cpu)])
        for i, (a, b) in enumerate(zip(on_card, on_cpu)):
            d = float(np.abs(joints(a) - joints(b)).max())
            bound_i = bound if bound is not None else SPREAD_X * float(spread[i])
            cos = float(a.floor_normal @ b.floor_normal)
            eq = bool(np.array_equal(a.vel_constraints, b.vel_constraints))
            ctx = "" if bound is not None else f"; the CPU's one-ulp spread {spread[i]:.3e}"
            print(f"    small batch {name} sequence {i}, card vs CPU end to end: joints max|d| "
                  f"{d:.3e} cm (<= {bound_i:.3e}{ctx}), pruned contacts equal {eq}, floor "
                  f"normal cos {cos:.10f} (>= {SMALL_COS_MIN})")
            if not (d <= bound_i and eq and cos >= SMALL_COS_MIN):
                fail(f"[15] small batch {name} sequence {i}: the card and the CPU disagree")

    # float64, LU IK: roundings stay small end to end
    end_to_end("(16 and 12 frames, IK 10 LU, LM 5:15, float64)", torch.float64, "lu",
               SMALL_F64_MAX_D)

    # float32, LU IK, stage by stage: each stage on the card against the
    # same stage on the CPU from the card's input
    f32 = torch.float32
    stage_ik = IKConfig(iterations=200, damping=7.0, solver="lu")
    arrs_c, Fs = batch_lib.prepare_batch_arrays(small, skel, device=dev, dtype=f32)
    arrs_h, _ = batch_lib.prepare_batch_arrays(small, skel, device="cpu", dtype=f32)
    cons_c = batch_lib.batch_consts(parents, Fs, stage_ik, dev, f32)
    cons_h = batch_lib.batch_consts(parents, Fs, stage_ik, "cpu", f32)
    real = arrs_h["fmask"].bool()
    lay64, off64 = Layout(parents, "cpu", torch.float64), arrs_h["offsets"].double()

    def world(x):
        y, r = data_order_positions(x.cpu().double().reshape(len(small), Fs, -1), off64, lay64)
        return (y + r.unsqueeze(2))[real]

    def cm(xc, xh):
        return float((world(xc) - world(xh)).abs().max())

    def card_ik():
        return batch_lib.initial_x(*batch_lib.ik_init_batch(arrs_c, cons_c))

    z_c, z_h = torch.zeros((len(small), 3), device=dev), torch.zeros((len(small), 3))
    x0c = card_ik()
    x0h = batch_lib.initial_x(*batch_lib.ik_init_batch(arrs_h, cons_h))
    x1c = batch_lib.lm_stage(x0c, batch_lib.make_data(arrs_c, cons_c, arrs_c["vc"], z_c, z_c),
                             w1, cons_c, small_lm)
    x1h = batch_lib.lm_stage(x0c.cpu(), batch_lib.make_data(arrs_h, cons_h, arrs_h["vc"], z_h,
                                                            z_h), w1, cons_h, small_lm)
    n_c, p_c, vc_c = batch_lib.floor_stage(x1c, arrs_c, cons_c)
    n_h, p_h, vc_h = batch_lib.floor_stage(x1c.cpu(), arrs_h, cons_h)
    x2c = batch_lib.lm_stage(x1c, batch_lib.make_data(arrs_c, cons_c, vc_c, n_c, p_c), w2,
                             cons_c, small_lm)
    x2h = batch_lib.lm_stage(x1c.cpu(), batch_lib.make_data(
        arrs_h, cons_h, vc_c.cpu(), n_c.cpu(), p_c.cpu()), w2, cons_h, small_lm)
    d_ik, d_lm1, d_lm2 = cm(x0c, x0h), cm(x1c, x1h), cm(x2c, x2h)
    f_cos = float(torch.nn.functional.cosine_similarity(n_c.cpu().double(), n_h.double()).min())
    f_eq = torch.equal(vc_c.cpu(), vc_h)
    with mock.patch.object(ik_lib, "full_f32", tf32_matmuls):
        d_allowed = cm(card_ik(), x0h)
    mm = torch.matmul
    with mock.patch.object(torch, "matmul", lambda a, b: mm(tf32_rounded(a), tf32_rounded(b))):
        d_tf32 = cm(card_ik(), x0h)
    print(f"    small batch (IK 200 LU, LM 5:15, float32) stage by stage, card vs CPU from the "
          f"card's input: joints max|d| IK {d_ik:.3e} cm (<= {SMALL_IK_MAX_D}), LM 1 "
          f"{d_lm1:.3e} cm, LM 2 {d_lm2:.3e} cm (<= {SMALL_LM_MAX_D}); floor normal cos "
          f"{f_cos:.12f} (>= {1 - FLOOR_COS_GAP}), pruned contacts equal {f_eq}; the card's IK "
          f"with TF32 allowed {d_allowed:.3e} cm, with its matmul inputs rounded to TF32 "
          f"{d_tf32:.3e} cm (must exceed {SMALL_IK_MAX_D})")
    if not (d_ik <= SMALL_IK_MAX_D and max(d_lm1, d_lm2) <= SMALL_LM_MAX_D
            and f_cos >= 1 - FLOOR_COS_GAP and f_eq):
        fail("[15] small batch, float32 stage by stage: the card and the CPU disagree")
    if not d_tf32 > SMALL_IK_MAX_D:
        fail("[15] the IK stage's bound does not tell TF32 products from full float32")

    # float32, CG IK (the default): end to end, beside the CPU's own spread
    end_to_end("(16 and 12 frames, IK 10 CG, LM 5:15, float32)", f32, "cg")

    # -- 16. the kinematic CLI on the card ----------------------------------
    kinematic_cli_phase(torch, dev, skel)
    return pcg15


def kinematic_cli_phase(torch, dev, skel) -> None:
    """Phase [16]: the ``kinematic`` CLI on the card on a synthetic 12-frame
    video dir against the port's CPU run of the same dir. Float32 runs part
    by roundings that unconverged CG steps amplify, so the joints are held
    to ``CLI_MAX_D`` cm or ``SPREAD_X`` times the CPU's own spread under
    one-ulp changes of the 3D inputs, whichever is larger ([15]'s method for
    its float32 end-to-end runs). Controls on the card: the autograd
    product (no kernel) must pass that gate, and each planted wrong
    product, the kernel's without its projection block and without its
    acceleration block, must fail it."""
    from chd_tpu_torch.core import bvh, fk
    from chd_tpu_torch.kinematics import batch as batch_lib
    from chd_tpu_torch.kinematics import jtjv as jtjv_lib
    from chd_tpu_torch.ops import jtjv as jtjv_ops
    from chd_tpu_torch.pipeline import cli
    from chd_tpu_torch.pipeline.run import run_kinematic_stage
    from chd_tpu_torch.utils.config import PipelineConfig

    J = len(skel.parents)
    budget = {"kinematic.ik_iterations": 20, "kinematic.lm_iters": 8, "kinematic.cg_iters": 30}
    want_files = ["final_test.bvh", "floor_out.txt", "foot_contacts.npy"]

    class Planted(jtjv_lib.TrajectoryProduct):
        """The kernel's product with the weight ``term`` zeroed: a product
        that leaves out one residual block (the gradient and the cost keep
        it)."""

        def __init__(self, layout, term):
            super().__init__(layout)
            self.term = term

        def __call__(self, x, data, w):
            return jtjv_lib.Linearization(self, x, data, w._replace(
                **{self.term: torch.zeros_like(getattr(w, self.term))}))

    rule = jtjv_ops.supplier
    prepare = batch_lib.prepare_batch_arrays

    with tempfile.TemporaryDirectory() as tmp:
        skel_bvh = os.path.join(tmp, "combined_body_25.bvh")
        bvh.save(skel_bvh, skel.slice_frames(0, 1), [f"joint_{j}" for j in range(J)])

        def run(device, ulps=0, product=None):
            """(rc, seconds, files, BVH joints (cm), floor normal, floor
            point, contacts) of one run of the dir on ``device``: on the card
            through the CLI, its products, where ``product`` is given, the
            supplier ``product(layout)`` (None: autograd's) in the kernel's
            place, one a layout; on the CPU through ``run_kinematic_stage``,
            the 3D inputs moved by ``ulps`` float32 roundings."""
            root = tempfile.mkdtemp(dir=tmp)
            vd = synth_video_dir(root, skel)
            made = {}

            def supplier(x0, make):
                found = rule(x0, make)
                if product is None or not isinstance(found, jtjv_lib.TrajectoryProduct):
                    return found
                if found not in made:
                    made[found] = product(found.layout)
                return made[found]

            def moved(problems, *a, **k):
                eps = np.finfo(np.float32).eps
                return prepare([dict(p, pose3d=p["pose3d"] * (1 + ulps * eps))
                                for p in problems], *a, **k)

            t = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()), \
                    mock.patch.object(jtjv_ops, "supplier", supplier), \
                    mock.patch.object(batch_lib, "prepare_batch_arrays", moved):
                if device == "cpu":
                    run_kinematic_stage(vd, PipelineConfig().override(
                        **{"kinematic.skel_path": skel_bvh, **budget}), device="cpu")
                    rc = 0
                else:
                    rc = cli.main(["kinematic", "--video-dir", vd, "--skel-path", skel_bvh,
                                   "--device", device, "--set",
                                   *[f"{k}={v}" for k, v in budget.items()]])
            t = time.perf_counter() - t
            kd = os.path.join(vd, "kinematic_results")
            anim, _, _ = bvh.load(os.path.join(kd, "final_test.bvh"))
            with open(os.path.join(kd, "floor_out.txt")) as fh:
                normal = np.array([float(v) for v in fh.readline().split()])
                point = np.array([float(v) for v in fh.readline().split()])
            joints = fk.positions_global(torch.from_numpy(anim.rotations),
                                         torch.from_numpy(anim.positions), anim.parents).numpy()
            return (rc, t, sorted(os.listdir(kd)), joints, normal, point,
                    np.load(os.path.join(kd, "foot_contacts.npy")))

        card = dev.type
        host = run("cpu")
        spread = max(float(np.abs(run("cpu", u)[3] - host[3]).max()) for u in SPREAD_ULPS)
        bound = max(CLI_MAX_D, SPREAD_X * spread)

        def against_cpu(out):
            """(joints max |d| cm, contacts equal, floor cos, point max |d|)."""
            return (float(np.abs(out[3] - host[3]).max()), bool(np.array_equal(out[6], host[6])),
                    float(out[4] @ host[4]), float(np.abs(out[5] - host[5]).max()))

        main = run(card)
        d, eq, cos, dp = against_cpu(main)
        print(f"[16] kinematic CLI on the card (synthetic 12-frame video dir, IK 20, LM 8:30): rc "
              f"{main[0]}, {main[1]:.2f} s, wrote {main[2]}; against the port's CPU run: BVH "
              f"joints max|d| {d:.4f} cm (<= {bound:.4f}: the larger of {CLI_MAX_D} and "
              f"{SPREAD_X} x the CPU's one-ulp spread {spread:.4f}), contacts equal {eq}, floor "
              f"cos {cos:.8f}, point |d| {dp:.4f}")
        if main[0] != 0 or main[2] != want_files or not (d <= bound and eq
                                                         and cos >= SMALL_COS_MIN):
            fail("[16] the kinematic CLI on the card disagrees with the CPU or missed a file")
        controls = {"the autograd product": lambda lay: None,
                    "the product without its projection block": (
                        lambda lay: Planted(lay, "proj")),
                    "the product without its acceleration block": (
                        lambda lay: Planted(lay, "smooth_acc"))}
        read = {}
        for name, product in controls.items():
            read[name] = against_cpu(run(card, product=product))[0]
            print(f"    control, {name} on the card: BVH joints max|d| {read[name]:.4f} cm")
        if not read["the autograd product"] <= bound:
            fail("[16] the autograd product on the card fails the CLI's gate")
        missed = [n for n, d in read.items() if "without" in n and not d > bound]
        if missed:
            fail(f"[16] the CLI's gate does not tell {missed} from the kernel")


def coloring_diag(fn, masks, like):
    """Σₖ mₖ ⊙ fn(mₖ) over the coloring masks, each broadcast over the
    sequences of ``like``, in one vmapped pass (as ``lm_step`` forms it)."""
    import torch

    m = masks.unsqueeze(1).expand((masks.shape[0],) + like.shape)
    return torch.func.vmap(lambda mk: mk * fn(mk))(m).sum(0)


def side_stream(torch):
    """(on_side, graph_ms) on one side stream, for [26] and [27]: the
    double vjp's linearization, its calls and its graph on one stream
    (autograd runs a backward op on its forward op's stream, a capture
    takes no work from the legacy stream, and a vmapped backward cannot
    sync a batched tensor across streams). ``on_side(fn)`` runs fn there;
    ``graph_ms(fn, reps)`` is the milliseconds a call of fn, by CUDA events
    over replays of a graph of ``reps`` calls captured there (the median
    of 5)."""
    side = torch.cuda.Stream()

    def on_side(fn):
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out = fn()
        torch.cuda.current_stream().wait_stream(side)
        return out

    def graph_ms(fn, reps):
        on_side(fn)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(reps):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph.replay()
        times = []
        for _ in range(5):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            graph.replay()
            ev[1].record()
            times.append(stage_ms(ev)[0] / reps)
        return statistics.median(times)

    return on_side, graph_ms


def jtjv_phase(torch, dev, smi: str, launches: dict) -> list:
    """Phase [26]: the kinematic LM's JᵀJ·v kernel (``csrc/traj_jtjv.cu``)
    at [15]'s 16 x 100 frames in float32 and float64, product and diagonal,
    each against autograd's double vjp in float64 at the same point within
    ``JTJV_REL`` (a product without its projection block must fail that),
    bitwise equal on a second launch; its time by CUDA events over a graph
    of ``JTJV_REPS`` launches, its bound from the bytes it moves and the
    FLOP it does, the double vjp's time eager and replayed as a graph.
    ``launches`` are [15]'s counts. Returns the kernel's entries of the
    kernels line."""
    from chd_tpu_torch.kinematics import batch as batch_lib
    from chd_tpu_torch.kinematics import lm as lm_lib
    from chd_tpu_torch.kinematics import trajectory as traj_lib
    from chd_tpu_torch.kinematics.ik import IKConfig

    skel = golden_skeleton(np.load(TRAJ_GOLDEN))
    rng = np.random.default_rng(0)
    problems = [kin_problem(rng, skel, KIN_F) for _ in range(KIN_B)]  # [15]'s batch

    def setup(dtype):
        """(x, data, weights, consts) at the SMPL initialization, STAGE2's
        weights (floor on), contacts on with p 0.5."""
        arrs, F = batch_lib.prepare_batch_arrays(problems, skel, device=dev, dtype=dtype)
        consts = batch_lib.batch_consts(skel.parents, F, IKConfig(), dev, dtype)
        x = batch_lib.initial_x(arrs["rot0"], arrs["pos0"]).contiguous()
        normal = torch.tensor([0.02, 0.999, -0.03], dtype=dtype, device=dev).expand(KIN_B, 3)
        point = torch.tensor([0.0, -95.0, 380.0], dtype=dtype, device=dev).expand(KIN_B, 3)
        data = batch_lib.make_data(arrs, consts, arrs["vc"], normal, point)
        return x, data, lm_lib._tensor_floats(traj_lib.STAGE2, x), consts

    def autograd(x, data, w, consts):
        """JᵀJ·v by the double vjp, as lm_step forms it without a product."""
        r, vjp_fn = torch.func.vjp(lambda z: consts.layout.residual(z, data, w), x)
        _, lin = torch.func.vjp(lambda c: vjp_fn(c)[0], torch.zeros_like(r))
        return lambda v: vjp_fn(lin(v)[0])[0]

    on_side, graph_ms = side_stream(torch)

    def rel(got, want):
        return float((got.double() - want).norm() / want.norm())

    x64, data64, w64, consts64 = setup(torch.float64)
    v64 = torch.randn(x64.shape, dtype=torch.float64, device=dev,
                      generator=torch.Generator(dev).manual_seed(26))
    print(f"[26] the JtJ.v kernel at [15]'s shapes ({KIN_B} x {KIN_F} frames, "
          f"{len(skel.parents)} joints, STAGE2's weights), against autograd's double vjp in "
          f"float64 at the same point (relative error of the whole output's norm); {smi}")
    entries = []
    for dtype, peak in ((torch.float32, F32_PEAK), (torch.float64, F64_PEAK)):
        name = str(dtype).split(".")[-1]
        x, data, w, consts = setup(dtype)
        v = v64.to(dtype)
        lin = consts.layout.residual.product_for(x)(x, data, w)
        # the float64 reference at this dtype's point
        ref = autograd(x.double(), type(data)(*(None if t is None else t.double() for t in data)),
                       type(w)(*(t.double() for t in w)), consts64)
        fn = on_side(lambda: autograd(x, data, w, consts))
        masks = consts.masks
        runs = {"product": (lambda: lin(v), lambda: ref(v.double()), lambda: fn(v)),
                "diag": (lambda: lin.diag(masks), lambda: coloring_diag(ref, masks.double(), x),
                         lambda: coloring_diag(fn, masks, x))}
        for mode, (kernel, want_fn, plain) in runs.items():
            got, want = kernel(), want_fn()
            err, again = rel(got, want), kernel()
            max_abs = float((got.double() - want).abs().max())
            ms = graph_ms(kernel, JTJV_REPS)
            plain_ms = wall(lambda: on_side(lambda: [plain() for _ in range(3)]))[0] / 3 * 1e3
            library_ms = graph_ms(plain, 1)
            n_bytes = sum(t.numel() * t.element_size() for t in (
                x, data.proj_weights, data.data_weights, data.smooth_weights,
                data.vel_constraints, data.offsets, got) + ((v,) if mode == "product" else ())
                + (() if data.frame_mask is None else (data.frame_mask,)))
            flop = JTJV_FRAME_FLOP[mode] * KIN_B * KIN_F
            by_bytes, by_flop = n_bytes / HBM_RATE * 1e3, flop / peak * 1e3
            bound_ms = max(by_bytes, by_flop)
            bound_by = "bytes" if by_bytes >= by_flop else "operations"
            print(f"    {mode}, {name}: relative error {err:.3e} (<= {JTJV_REL[name]}), max|d| "
                  f"{max_abs:.3e}; a second launch bitwise equal: {torch.equal(got, again)}; "
                  f"{ms * 1e3:.1f} us a launch (a graph of {JTJV_REPS}); bound {bound_ms * 1e3:.2f} "
                  f"us ({bound_by}: {n_bytes / 1e6:.3f} MB, {flop / 1e6:.1f} MFLOP), "
                  f"{bound_ms / ms:.3f} of it reached; the double vjp {plain_ms:.2f} ms eager, "
                  f"{library_ms:.3f} ms replayed as a graph")
            if not (err <= JTJV_REL[name] and torch.equal(got, again)):
                fail(f"[26] the JtJ.v kernel's {mode} in {name} disagrees with autograd's")
            entries.append({
                "name": "traj_jtjv", "mode": f"{mode}.{name}", "route": "cuda",
                "source": "chd_tpu_torch/csrc/traj_jtjv.cu",
                "replaces": "chd_tpu/kinematics/lm.py:133 (jax.linearize, its transpose)",
                "launches": launches["optimize_trajectory_batch"][mode],
                "launches_by_path": {k: c[mode] for k, c in launches.items()},
                "max_abs_err": max_abs, "rel_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms,  # torch.func's double vjp as a CUDA graph
            })
        if dtype == torch.float32:
            lin_bad = lin.product(x, data, w._replace(proj=torch.zeros_like(w.proj)))
            bad = rel(lin_bad(v), ref(v.double()))
            print(f"    control: the product without its projection block, float32: relative "
                  f"error {bad:.3e} (must exceed {JTJV_REL[name]})")
            if not bad > JTJV_REL[name]:
                fail("[26] the kernel's gate does not tell a product without its projection "
                     "block")
    return entries


def phys_jtjv_phase(torch, dev, smi: str, launches: dict) -> list:
    """Phase [27]: the physics AL residual's JᵀJ·v kernel
    (``csrc/phys_jtjv.cu``) at [19]'s 32 x 100 frames in float32 and
    float64, DYN_H's structure (every block) at a point with about half of
    every hinged block's rows active: product and the 90-mask diagonal,
    each against autograd's double vjp in float64 at the same point within
    ``PHYS_JTJV_REL`` (a product without its Newton–Euler block must fail
    that), bitwise equal on a second launch; its time by CUDA events over a
    graph of ``JTJV_REPS`` launches, its bound from the bytes it moves and
    the FLOP it does, the double vjp's time eager and replayed as a graph.
    ``launches`` are [19]'s counts. Returns the kernel's entries of the
    kernels line."""
    from chd_tpu_torch.kinematics import lm as lm_lib
    from chd_tpu_torch.physics import collocation as co
    from chd_tpu_torch.physics import jtjv as phys_jtjv_lib

    w, rho = phys_jtjv_structures()["DYN_H"]
    fn = co.make_al_residual_fn(w, rho)
    prod = phys_jtjv_lib.product_for(*co._structure(w, rho))
    lens = [PHYS_F] * PHYS_B

    def setup(dtype):
        pb, x, lams = phys_jtjv_point(lens, dev, dtype)
        args = lm_lib._tensor_floats((pb, lams, w, rho), x)
        return x, args, prod(x, *args)

    def autograd(x, args):
        r, vjp_fn = torch.func.vjp(lambda z: fn(z, *args), x)
        _, lin = torch.func.vjp(lambda c: vjp_fn(c)[0], torch.zeros_like(r))
        return lambda v: vjp_fn(lin(v)[0])[0]

    on_side, graph_ms = side_stream(torch)

    def rel(got, want):
        """The largest over the dof groups of the error norm over the norm."""
        g = got.double().reshape(PHYS_B, PHYS_F, co.DOF)
        h = want.double().reshape(PHYS_B, PHYS_F, co.DOF)
        return max(float((g[..., a:b] - h[..., a:b]).norm() / h[..., a:b].norm())
                   for a, b in ((0, 3), (3, 6), (6, 18), (18, 30)))

    x64, _, _ = setup(torch.float64)
    v64 = torch.randn(x64.shape, dtype=torch.float64, device=dev,
                      generator=torch.Generator(dev).manual_seed(27))
    masks64 = lm_lib.frame_coloring_masks(PHYS_F, co.DOF, dtype=torch.float64, device=dev)
    print(f"[27] the physics JtJ.v kernel at [19]'s shapes ({PHYS_B} x {PHYS_F} frames, DYN_H: "
          f"every block, about half of each hinged block's rows active), against autograd's "
          f"double vjp in float64 at the same point (the largest dof group's relative error "
          f"norm); {smi}")
    entries = []
    for dtype, peak in ((torch.float32, F32_PEAK), (torch.float64, F64_PEAK)):
        name = str(dtype).split(".")[-1]
        x, args, lin = setup(dtype)
        v, masks = v64.to(dtype), masks64.to(dtype)
        ref = autograd(x.double(), lm_lib._tensor_floats(tuple(
            type(a)(*(None if t is None else t.double() for t in a)) for a in args), x64))
        plain_fn = on_side(lambda: autograd(x, args))
        runs = {"product": (lambda: lin(v), lambda: ref(v64), lambda: plain_fn(v)),
                "diag": (lambda: lin.diag(masks), lambda: coloring_diag(ref, masks64, x64),
                         lambda: coloring_diag(plain_fn, masks, x))}
        pb = args[0]
        data = [pb.dt, pb.mass, pb.floor_normal, pb.contact, pb.left_hip, pb.right_hip,
                pb.inertia] + ([] if pb.frame_mask is None else [pb.frame_mask]) \
            + list(lin.hinge.values())
        for mode, (kernel, want_fn, plain) in runs.items():
            got, want = kernel(), want_fn()
            err, again = rel(got, want), kernel()
            max_abs = float((got.double() - want).abs().max())
            ms = graph_ms(kernel, JTJV_REPS)
            plain_ms = wall(lambda: on_side(lambda: [plain() for _ in range(3)]))[0] / 3 * 1e3
            library_ms = graph_ms(plain, 1)
            n_bytes = sum(t.numel() * t.element_size() for t in [x, got] + data
                          + ([v] if mode == "product" else []))
            flop = PHYS_JTJV_FRAME_FLOP[mode] * PHYS_B * PHYS_F
            by_bytes, by_flop = n_bytes / HBM_RATE * 1e3, flop / peak * 1e3
            bound_ms = max(by_bytes, by_flop)
            bound_by = "bytes" if by_bytes >= by_flop else "operations"
            print(f"    {mode}, {name}: relative error {err:.3e} (<= {PHYS_JTJV_REL[name]}), "
                  f"max|d| {max_abs:.3e}; a second launch bitwise equal: "
                  f"{torch.equal(got, again)}; {ms * 1e3:.1f} us a launch (a graph of "
                  f"{JTJV_REPS}); bound {bound_ms * 1e3:.2f} us ({bound_by}: {n_bytes / 1e6:.3f} "
                  f"MB, {flop / 1e6:.1f} MFLOP), {bound_ms / ms:.3f} of it reached; the double "
                  f"vjp {plain_ms:.2f} ms eager, {library_ms:.3f} ms replayed as a graph")
            if not (err <= PHYS_JTJV_REL[name] and torch.equal(got, again)):
                fail(f"[27] the physics JtJ.v kernel's {mode} in {name} disagrees with "
                     "autograd's")
            entries.append({
                "name": "phys_jtjv", "mode": f"{mode}.{name}", "route": "cuda",
                "source": "chd_tpu_torch/csrc/phys_jtjv.cu",
                "replaces": "chd_tpu/kinematics/lm.py:133 (jax.linearize, its transpose)",
                "launches": launches["solve_physics_full_batch"][mode],
                "launches_by_path": {k: c[mode] for k, c in launches.items()},
                "max_abs_err": max_abs, "rel_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms,  # torch.func's double vjp as a CUDA graph
            })
        if dtype == torch.float32:
            no_dyn = phys_jtjv_lib.PhysicsProduct(prod.accel, prod.active[1:])
            bad = rel(no_dyn(x, *args)(v), ref(v64))
            print(f"    control: the product without its Newton-Euler block, float32: "
                  f"relative error {bad:.3e} (must exceed {PHYS_JTJV_REL[name]})")
            if not bad > PHYS_JTJV_REL[name]:
                fail("[27] the kernel's gate does not tell a product without its Newton-Euler "
                     "block")
    return entries


def banded_phase(torch, dev, smi: str, pcg: dict) -> None:
    """Phase [21]: the kinematic batch with the banded direct LM solve, at
    [15]'s shape and budget, beside [15]'s PCG readings (``pcg``)."""
    from chd_tpu_torch.core import fk
    from chd_tpu_torch.kinematics import batch as batch_lib
    from chd_tpu_torch.kinematics import lm as lm_lib
    from chd_tpu_torch.kinematics import trajectory as traj_lib
    from chd_tpu_torch.kinematics.ik import IKConfig
    from chd_tpu_torch.kinematics.lm import LMConfig
    from chd_tpu_torch.utils.cuda_graph import GraphCache

    g = np.load(TRAJ_GOLDEN)
    skel = golden_skeleton(g)
    parents = skel.parents
    rng = np.random.default_rng(0)
    problems = [kin_problem(rng, skel, KIN_F) for _ in range(KIN_B)]  # [15]'s batch
    lm_cfg = LMConfig(max_iters=40, cg_iters=80)
    ik_cfg = IKConfig(iterations=200, damping=7.0, solver="cg")
    w1 = traj_lib.STAGE1
    print(f"[21] optimize_trajectory_batch(lm_solver=\"banded\"), {KIN_B} x {KIN_F}, default "
          f"budget (IK 200 x CG 64, LM 40 steps x 2 stages, block-Thomas over "
          f"{(KIN_F + 1) // 2} superblocks of {2 * (3 + 3 * len(parents))}); {smi}")
    graphs = GraphCache()

    def call():
        return batch_lib.optimize_trajectory_batch(problems, skel, ik_iterations=ik_cfg.iterations,
                                                   lm_cfg=lm_cfg, graphs=graphs,
                                                   lm_solver="banded")

    t_first, _ = wall(call)
    captures = graphs.captures
    t_calls = []
    for _ in range(2):
        t, res = wall(call)
        t_calls.append(t)
    print(f"    banded with CUDA graphs: first call {t_first:.3f} s ({captures} captures), then "
          f"{t_calls[0]:.3f} and {t_calls[1]:.3f} s = {KIN_B / t_calls[0] * 3600:.0f} and "
          f"{KIN_B / t_calls[1] * 3600:.0f} sequences/hour; PCG ([15], this run): first call "
          f"{pcg['t_first']:.3f} s, then {pcg['t_call']:.3f} s = "
          f"{KIN_B / pcg['t_call'] * 3600:.0f} sequences/hour")
    finite = all(np.isfinite(r.pose3d).all() and np.isfinite(r.anim.rotations).all()
                 for r in res)
    if not finite or len(res) != KIN_B or res[0].pose3d.shape != (KIN_F, 28, 3):
        fail("[21] the banded batch returned non-finite or misshapen results")

    # the same graphs stage by stage: no host sync, stage times, the call's
    # results, and each sequence's stage-2 cost against PCG's
    arrs, F = batch_lib.prepare_batch_arrays(problems, skel, device=dev)
    consts = batch_lib.batch_consts(parents, F, ik_cfg, dev, torch.float32, graphs,
                                    lm_solver="banded")
    out, ev = no_sync(lambda: kin_staged(batch_lib, arrs, consts, lm_cfg, graphs))
    ms = stage_ms(ev)
    root = out[2].reshape(KIN_B, F, -1)[..., :3].cpu().numpy()
    vc2 = out[5].cpu().numpy()
    same_call = all(np.array_equal(root[i], r.anim.positions[:, 0])
                    and np.array_equal(vc2[i], r.vel_constraints) for i, r in enumerate(res))
    pm = pcg["stage_ms"]
    print(f"    replayed stage by stage (no host sync inside: sync debug mode 'error'): IK "
          f"{ms[0]:.0f} ms, LM 1 {ms[1]:.0f} ms, floor {ms[2]:.0f} ms, LM 2 {ms[3]:.0f} ms, "
          f"core {sum(ms) / 1e3:.2f} s (PCG [15]: {pm[0]:.0f} / {pm[1]:.0f} / {pm[2]:.0f} / "
          f"{pm[3]:.0f} ms, {sum(pm) / 1e3:.2f} s); LM {ms[1] / lm_cfg.max_iters:.1f} ms a "
          f"replayed step (PCG {pcg['replayed_step_ms']:.1f}); root path and pruned contacts "
          f"equal to the call's: {same_call}")
    if not same_call:
        fail("[21] the staged replay differs from optimize_trajectory_batch")
    cost2 = stage2_costs(batch_lib, arrs, consts, out, traj_lib.STAGE2)
    ratio = cost2 / pcg["stage2_cost"]
    over = [i for i in range(KIN_B) if not ratio[i] <= BANDED_COST_X]
    print(f"    final stage-2 cost per sequence, banded / PCG: min {ratio.min():.6f}, max "
          f"{ratio.max():.6f} (<= {BANDED_COST_X} on {KIN_B - len(over)} of {KIN_B}); banded "
          f"{['%.1f' % c for c in cost2]}")
    for i in over:
        print(f"      GAP sequence {i}: banded {cost2[i]:.3f} vs PCG {pcg['stage2_cost'][i]:.3f} "
              f"(x{ratio[i]:.6f})")
    if not np.isfinite(cost2).all():
        fail("[21] a banded stage-2 cost is not finite")

    # eager against replayed: 3 banded LM steps from the IK's output
    zero3 = torch.zeros((KIN_B, 3), device=dev)
    data1 = batch_lib.make_data(arrs, consts, arrs["vc"], zero3, zero3)
    short = dataclasses.replace(lm_cfg, max_iters=EAGER_LM_STEPS)

    def lm3(graphs):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        x = batch_lib.lm_stage(out[0], data1, w1, consts, short, graphs)
        e1.record()
        return x, (e0, e1)

    x_e, ev = no_sync(lambda: lm3(None))
    eager_ms = stage_ms(ev)[0] / EAGER_LM_STEPS
    x_r, ev = no_sync(lambda: lm3(graphs))
    rep_ms = stage_ms(ev)[0] / EAGER_LM_STEPS
    same = torch.equal(x_e, x_r) and graphs.captures == captures
    print(f"    eager vs replayed, {EAGER_LM_STEPS} banded LM steps: eager {eager_ms:.1f} ms a "
          f"step (PCG [15] {pcg['eager_step_ms']:.0f}), replayed {rep_ms:.1f} ms a step; "
          f"bitwise equal: {same}")
    if not same:
        fail("[21] the banded LM step's replay differs from the eager path")

    # one banded LM step, eager, under the profiler
    x0 = out[0]
    args = lm_lib._tensor_floats((data1, w1), x0)
    lam = torch.full((KIN_B, 1), lm_cfg.init_lambda, device=dev)

    def res_fn(x):
        return consts.layout.residual(x, *args)

    c0 = lm_lib._half_sq(res_fn(x0))

    def one_step():
        return lm_lib.lm_step(res_fn, x0, lam, c0, lm_cfg, banded_masks=consts.masks,
                              product=lm_lib._bound(consts.layout.residual.product_for(x0), args))

    st, pst = profiled_step(one_step), pcg["step"]
    print(f"    one eager banded LM step ({consts.masks.shape[0]} banded products, "
          f"{(F + 1) // 2} Cholesky steps): {st['t_step'] * 1e3:.1f} ms, {st['peak_gib']:.2f} "
          f"GiB above the inputs at peak (PCG [15] {pst['peak_gib']:.2f}); profiled: wall "
          f"{st['t_prof'] * 1e3:.1f} ms, {st['launches']} launches, {st['kernels']} device "
          f"kernels (PCG {pst['launches']} and {pst['kernels']}), device busy "
          f"{st['busy'] * 1e3:.1f} ms, idle share {st['idle']:.3f} (PCG {pst['idle']:.3f})")
    print_top_items(st)

    # [14]'s golden gates with the banded solve
    t14, (_, gates) = wall(lambda: trajectory_golden_gates(g, "cuda", GraphCache(), "banded"))
    print(f"    trajectory golden with lm_solver=\"banded\" (LM 50 steps): {t14:.2f} s with "
          f"capture; floor cos {gates['cos']:.6f} (> 0.9994), offset {gates['offset']:.3f} cm "
          f"(< 2), contacts equal {gates['contacts_equal']}, joint error mean "
          f"{gates['mean_err']:.3f} / median {gates['median_err']:.3f} cm (< 2), reprojection "
          f"median {gates['median_px']:.2f} px (< {gates['px_bound']:.2f}), stage-2 objective "
          f"{gates['cost']:.1f} vs the golden's {gates['golden_cost']:.1f} (<= x1.001)")
    if not golden_gates_pass(gates):
        fail(f"[21] the trajectory golden's gates failed with the banded solve: {gates}")

    # a small ragged batch, card against the port on the CPU, float64
    rng = np.random.default_rng(17)
    small = [kin_problem(rng, skel, 16, 0.3), kin_problem(rng, skel, 12, 0.3)]
    kw = dict(ik_iterations=10, lm_cfg=LMConfig(5, 15), ik_solver="lu", dtype=torch.float64,
              lm_solver="banded")
    on_card = batch_lib.optimize_trajectory_batch(small, skel, device="cuda", **kw)
    on_cpu = batch_lib.optimize_trajectory_batch(small, skel, device="cpu", **kw)
    for i, (a, b) in enumerate(zip(on_card, on_cpu)):
        ja, jb = (fk.positions_global(torch.as_tensor(r.anim.rotations),
                                      torch.as_tensor(r.anim.positions), parents).numpy()
                  for r in (a, b))
        d = float(np.abs(ja - jb).max())
        eq = bool(np.array_equal(a.vel_constraints, b.vel_constraints))
        cos = float(a.floor_normal @ b.floor_normal)
        print(f"    small banded batch (16 and 12 frames, IK 10 LU, LM 5 steps, float64) "
              f"sequence {i}, card vs CPU end to end: joints max|d| {d:.3e} cm (<= "
              f"{SMALL_F64_MAX_D}), pruned contacts equal {eq}, floor normal cos {cos:.10f} "
              f"(>= {SMALL_COS_MIN})")
        if not (d <= SMALL_F64_MAX_D and eq and cos >= SMALL_COS_MIN):
            fail(f"[21] small banded batch sequence {i}: the card and the CPU disagree")


def golden_video_dirs(tmp: str, golden) -> list:
    """The golden's videos as OpenPose dirs under ``tmp`` ([4]'s layout)."""
    dirs = []
    for key in sorted(k for k in golden.files if k.startswith("keypoints_")):
        kpv = golden[key]
        opd = os.path.join(tmp, f"vid{key.split('_')[1]}", "openpose_result")
        os.makedirs(opd)
        for f in range(kpv.shape[0]):
            doc = {"people": [{"pose_keypoints_2d": kpv[f].reshape(-1).tolist()}]}
            with open(os.path.join(opd, f"frame_{f:06d}_keypoints.json"), "w") as fh:
                json.dump(doc, fh)
        dirs.append(os.path.dirname(opd))
    return dirs


def cublas_one_pass_ms(torch, args, reps: int = 10) -> float:
    """ms of one bf16 pass of layers 0-2 on the kernel's rows (``args``) as
    three bf16 ``torch.matmul`` calls (cuBLAS), the windows materialized
    beforehand and not timed: a yardstick for the kernel's one-pass
    "default" mode, which the port never calls."""
    layers, x, width, row_stride = args
    h = x.unfold(1, width, row_stride).reshape(-1, width).to(torch.bfloat16)
    ws = [w.to(torch.bfloat16) for w, _ in layers[:3]]

    def run():
        a = h
        for w in ws:
            a = torch.matmul(a, w)
        return a

    run()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def precision_phase(torch, dev, smi: str) -> list:
    """Phase [22]: the detector's precision modes on the kernel. Returns the
    kernel line's entries of the modes other than "high" ([5]'s)."""
    from chd_tpu_torch.contact import infer
    from chd_tpu_torch.models import torch_convert
    from chd_tpu_torch.ops import fused_mlp as fm
    from chd_tpu_torch.ops import gapfill
    from chd_tpu_torch.utils import build

    golden = np.load(GOLDEN)
    gmodel = torch_convert.from_state_dict(
        {key[3:]: golden[key] for key in golden.files if key.startswith("sd.")})
    big = torch.from_numpy(synth_videos(BIG_V, BIG_F, seed=0)).to(dev)
    with tempfile.TemporaryDirectory() as tmp:
        dirs = golden_video_dirs(tmp, golden)
        print(f"[22] the detector's precision modes on the kernel, golden weights, conv rows of "
              f"V={BIG_V} F={BIG_F} and the {len(dirs)} golden dirs; {smi}")

        def event_ms(mlp, args, reps: int = 10) -> float:
            mlp(*args)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                mlp(*args)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / reps

        entries, contacts, golden_contacts = [], {}, {}
        for mode in fm.MODES:
            precision, dt = (mode, None) if mode != "bf16" else ("high", torch.bfloat16)
            det = infer.ContactDetector(gmodel, device=dev, precision=precision, mlp_dtype=dt)
            joints, root, appended = infer.subset_joints(det.kw["joint_subset"])
            x = gapfill.preprocess_keypoints(big[:, :, joints], det.kw["conf_thresh"],
                                             det.kw["normalization"])
            args = infer.mlp_logits(x, det.layers, window_size=det.kw["window_size"],
                                    root_in_subset=root, root_appended=appended,
                                    use_confidence=det.kw["use_confidence"],
                                    use_conv=det.kw["use_conv"], mlp=lambda *a: a)
            got = fm.fused_mlp(*args)
            emu = fm.emulation(mode)(*args)
            layers, frames2d, width, row_stride = args
            exact = fm.fused_mlp_plain([(w.double(), b.double()) for w, b in layers],
                                       frames2d.double(), width, row_stride)
            torch.cuda.synchronize()
            e_emu = (got - emu).abs().max().item()
            e_f64 = (got.double() - exact).abs().max().item()
            if mode == "high":
                bound_emu, ok_emu = f"atol {5e-5} rtol {1e-5}", bool(
                    torch.allclose(got, emu, atol=5e-5, rtol=1e-5))
                bound_f64 = F64_MAX_D
            elif mode == "highest":
                bound_emu = bound_f64 = HIGHEST_MAX_D
                ok_emu = e_emu <= HIGHEST_MAX_D
            else:
                # one bf16 pass is not float64-accurate: its distance to
                # float64 is printed, the gate is its emulation's
                cap = ONE_PASS_ULPS * 2.0 ** -8 * emu.abs().max().item()
                gate = fm.single_pass_gate(got, *args, mode)
                bound_emu, bound_f64 = f"{cap:.3e}", None
                ok_emu = e_emu <= cap and gate["ok"] and gate["controls_fail"]
                print(f"    {mode}: single_pass_gate, mean |kernel - emulation| by mode "
                      f"(limit 1/{fm.GATE_SHARE} of that emulation's mean distance to the "
                      f"nearest other's): " + ", ".join(
                          f"{n} {gate['mean'][n]:.3e} (limit {gate['limit'][n]:.3e})"
                          for n in fm.MODES)
                      + f"; within its own: {gate['ok']}, the controls fail: "
                      f"{gate['controls_fail']}")
            ok_f64 = bound_f64 is None or e_f64 <= bound_f64
            # the kernel alone, against the mode's plain version, in turns
            p1 = event_ms(fm.emulation(mode), args)
            k1, k2 = event_ms(fm.fused_mlp, args), event_ms(fm.fused_mlp, args)
            p2 = event_ms(fm.emulation(mode), args)
            ms, p_ms = statistics.mean([k1, k2]), statistics.mean([p1, p2])
            b = mlp_bound(args, fm.PASSES[mode])
            rows, bound_ms, bound_by = b["rows"], b["bound_ms"], b["bound_by"]
            tc_flop, cc_flop = b["tc_flop"], b["cc_flop"]
            stream = weight_stream(build.kernels().lib, mode, rows, width)
            extra = {}
            if mode == "default":
                # a yardstick, which the port never calls: one bf16 pass of
                # layers 0-2 as three cuBLAS products on the same rows
                extra["cublas_one_pass_ms"] = cublas_one_pass_ms(torch, args)
            # the main path in this mode, its launches counted alone
            contacts[mode], _ = det.infer(big)
            fm.fused_mlp.launches = 0
            fm.fused_mlp.mode_launches = dict.fromkeys(fm.MODES, 0)
            golden_contacts[mode] = infer.detect_contacts(dirs, gmodel, device="cuda", save=False,
                                                          precision=precision, mlp_dtype=dt)
            torch.cuda.synchronize()
            launches = fm.fused_mlp.mode_launches[mode]
            agree = [float((c.astype(int) == golden[f"contacts_{i}"].astype(int)).mean())
                     for i, c in enumerate(golden_contacts[mode])]
            print(f"    {mode} ({fm.PASSES[mode]} pass{'es' if fm.PASSES[mode] > 1 else ''}"
                  f"{', bf16 storage' if mode == 'bf16' else ''}): kernel vs its emulation max|d| "
                  f"{e_emu:.3e} (bound {bound_emu}: {ok_emu}), vs float64 {e_f64:.3e} "
                  f"({'bound ' + str(bound_f64) if bound_f64 else 'printed only'}); kernel "
                  f"{ms:.3f} ms ({k1:.3f}, {k2:.3f}), emulation {p_ms:.3f} ms; "
                  f"{b['flop'] / ms / 1e9:.1f} TFLOP/s of the model's multiply-adds, "
                  f"{(tc_flop + cc_flop) / ms / 1e9:.1f} executed; bound {bound_ms:.3f} ms "
                  f"({bound_by}: {tc_flop / 1e9:.1f} GFLOP on tensor cores + "
                  f"{cc_flop / 1e9:.2f} GFLOP float32), {bound_ms / ms:.3f} of it reached; "
                  f"detect_contacts launches {launches}, golden agreement "
                  f"{['%.6f' % a for a in agree]}; {stream_line(stream, ms)}"
                  + "".join(f"; {k} {v:.3f}" for k, v in extra.items()))
            if not ok_emu:
                fail(f"[22] {mode}: the kernel disagrees with its emulation ({e_emu})")
            if not ok_f64:
                fail(f"[22] {mode}: the kernel is {e_f64} from a float64 chain")
            if launches < 1:
                fail(f"[22] detect_contacts in mode {mode} never launched the kernel")
            if mode in ("high", "highest") and min(agree) < AGREE_MIN:
                fail(f"[22] {mode}: golden agreement {agree}")
            if mode != "high":
                entries.append({
                    "name": f"fused_mlp[{mode}]", "mode": mode, "route": "cuda",
                    "source": "chd_tpu_torch/csrc/fused_mlp.cu",
                    "replaces": "chd_tpu/ops/pallas_mlp.py:26", "launches": launches,
                    "max_abs_err": e_emu, "ms": ms, "plain_ms": p_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": None, **extra})
        for mode in ("default", "bf16"):
            a_big = float((contacts[mode] == contacts["high"]).float().mean())
            a_gold = min(float((a == b).mean())
                         for a, b in zip(golden_contacts[mode], golden_contacts["high"]))
            print(f"    {mode}: binary agreement with high, V={BIG_V} batch {a_big:.6f}, "
                  f"golden dirs {a_gold:.6f} (>= {MODE_AGREE_MIN})")
            if min(a_big, a_gold) < MODE_AGREE_MIN:
                fail(f"[22] {mode}: binary agreement with high {a_big}, {a_gold}")
    return entries


def library_phase(torch, dev) -> None:
    """Phase [23]: the library surface that no pipeline stage calls, card
    against the port on the CPU in float32, at small sizes."""
    from chd_tpu_torch.core import fk, quat, skinning
    from chd_tpu_torch.core.animation import Animation
    from chd_tpu_torch.ingest import one_euro
    from chd_tpu_torch.kinematics import basic_ik, icp
    from chd_tpu_torch.kinematics.ik import IKConfig

    g = np.load(TRAJ_GOLDEN)
    skel = golden_skeleton(g)
    parents, J = skel.parents, len(skel.parents)
    rng = np.random.default_rng(23)
    print(f"[23] the library surface, card vs the port on the CPU, float32 (bounds: "
          f"{CORE_ATOL} on unit quaternions, {CORE_POS_ATOL} cm on positions)")
    F = 4
    es = rng.uniform(-0.3, 0.3, size=(F, J, 3)).astype(np.float32)
    pos = np.broadcast_to(np.asarray(skel.offsets, np.float32), (F, J, 3)).copy()
    pos[:, 0] = rng.normal(0, 10, size=(F, 3)) + [0, 90, 300]
    rest = Animation(np.asarray(skel.rotations[:1], np.float32),
                     np.asarray(skel.positions[:1], np.float32), skel.orients, skel.offsets,
                     parents)

    def anim_on(d):
        return Animation(quat.from_euler(torch.from_numpy(es), "xyz", True).to(d),
                         torch.from_numpy(pos).to(d), skel.orients, skel.offsets, parents)

    def world(a):
        return fk.positions_global(a.rotations, a.positions, parents)

    gp = world(anim_on("cpu")).numpy()
    V = 200
    w = np.zeros((V, J), np.float32)
    for v in range(V):
        js = rng.choice(J, size=3, replace=False)
        w[v, js] = rng.uniform(0.1, 1.0, size=3)
    mesh = (rng.normal(0, 30, size=(V, 3)) + [0, 90, 300]).astype(np.float32)
    targets = {j: gp[:, j] + rng.normal(0, 2.0, size=(F, 3)).astype(np.float32)
               for j in (4, 7, 11, 14, 22)}
    tgt_all = gp + rng.normal(0, 3.0, size=gp.shape).astype(np.float32)
    track = (rng.normal(size=(120, 25, 2)) * 20 + 500).astype(np.float32)
    chain = (-1, 0, 1, 2)
    offsets = np.zeros((4, 3), np.float32)
    offsets[1:, 0] = 1.0
    crest = Animation(np.tile(np.float32([1, 0, 0, 0]), (2, 4, 1)),
                      np.broadcast_to(offsets[None], (2, 4, 3)).copy(), np.zeros((4, 4)),
                      offsets, chain)
    cmesh = np.zeros((12, 3), np.float32)
    cmesh[:, 0] = np.linspace(0.2, 3.2, 12)
    cmesh[:, 1] = 0.05
    cw = np.zeros((12, 4), np.float32)
    cw[np.arange(12), np.clip(cmesh[:, 0].astype(int), 0, 3)] = 1.0
    ces = rng.uniform(-0.25, 0.25, size=(2, 4, 3)).astype(np.float32)
    posed = crest.replace(rotations=quat.from_euler(torch.from_numpy(ces), "xyz", True),
                          positions=torch.from_numpy(crest.positions))
    goal = skinning.skin(posed, crest, cw, cmesh, maxjoints=1).numpy()

    def on(d, a):
        return Animation(torch.as_tensor(np.asarray(a.rotations)).to(d),
                         torch.as_tensor(np.asarray(a.positions)).to(d), a.orients, a.offsets,
                         a.parents)

    cases = {
        "one_euro_filter (120 frames x 25 x 2, px)": (
            lambda d: one_euro.one_euro_filter(torch.from_numpy(track).to(d),
                                               timestamps=np.arange(120)), CORE_POS_ATOL),
        "skin (28 joints, 200 vertices, cm)": (
            lambda d: skinning.skin(anim_on(d), rest, w, mesh), CORE_POS_ATOL),
        "solve_basic_ik, 2 iterations: rotations": (
            lambda d: basic_ik.solve_basic_ik(anim_on(d), tgt_all, 2).rotations, CORE_ATOL),
        "solve_jacobian_ik, 5 iterations: rotations": (
            lambda d: basic_ik.solve_jacobian_ik(anim_on(d), targets,
                                                 IKConfig(iterations=5, damping=5.0)).rotations,
            CORE_ATOL),
        "solve_jacobian_ik, 5 iterations: joints (cm)": (
            lambda d: world(basic_ik.solve_jacobian_ik(
                anim_on(d), targets, IKConfig(iterations=5, damping=5.0))), CORE_POS_ATOL),
        "solve_icp (4-joint chain, 10 iterations): rotations": (
            lambda d: icp.solve_icp(on(d, crest), crest, cw, cmesh, goal,
                                    IKConfig(iterations=10, damping=3.0), maxjoints=1,
                                    find_closest=False).rotations, CORE_ATOL),
    }
    for name, (fn, bound) in cases.items():
        got = fn(dev)
        want = fn("cpu")
        dv = float((got.cpu() - want).abs().max())
        print(f"    {name}: max|d| {dv:.3e} (<= {bound}); on {got.device}, {got.dtype}")
        if not (dv <= bound and got.device.type == "cuda" and got.dtype == torch.float32):
            fail(f"[23] {name}: card and CPU differ by {dv}")


def phys_jtjv_structures() -> dict:
    """The four AL stages whose JᵀJ·v is the kernel's: (cost weights,
    penalties) of FIT, DYN, HEIGHT (DYN_H) and the stage-4 polish."""
    from chd_tpu_torch.physics import collocation as co
    from chd_tpu_torch.physics.types import PhysWeights

    dyn = co.dyn_cost_for(PhysWeights())
    return {"FIT": (co.FIT_COST, co.FIT_RHO), "DYN": (dyn, co.DYN_RHO),
            "DYN_H": (dyn, co.DYN_H_RHO),
            "stage4": (co.dyn_cost_for(PhysWeights(), accel=0.0), co.DYN_H_RHO)}


def phys_jtjv_point(lens, device, dtype, seed: int = 0, start: bool = False):
    """(phys, x, lams) of ``walking_input`` clips of ``lens`` frames padded to
    one batch, on ``device`` in ``dtype``, made in float64 on the host so
    every device and type starts from the same point. ``start``: the FIT
    stage's start (the data, zero forces and multipliers: the friction
    cone's normal-force rows at exact ties). Else a point off it: the data
    moved ~2 cm, forces spread 60, 60, 250 N, multipliers 0.5, and the leg
    and height multipliers set so that about half of those rows are active
    (their shifted values ±0.01 around 0)."""
    import torch

    from chd_tpu_torch.parallel import batch as batch_lib
    from chd_tpu_torch.physics import collocation as co
    from chd_tpu_torch.physics.synth import walking_input

    f64 = torch.float64
    pb, _ = batch_lib.pad_phys_inputs([walking_input(L, seed=seed + i) for i, L in enumerate(lens)],
                                      device="cpu", dtype=f64)
    B, F = pb.base_lin.shape[:2]
    x = co.join_vars(pb.base_lin, pb.base_ang, pb.ee_pos, torch.zeros_like(pb.ee_pos))
    lams = co.init_multipliers(pb)
    if not start:
        rng = np.random.default_rng(seed)
        x = (x + torch.from_numpy(rng.normal(0, 0.02, x.shape))).reshape(B, F, co.DOF)
        x[..., 18:] = torch.from_numpy(rng.normal(0, 1, (B, F, 12)) * np.tile([60, 60, 250], 4))
        x = x.reshape(B, -1)
        lams = co.Constraints(*(torch.from_numpy(rng.normal(0, 0.5, v.shape)) for v in lams))
        cons, rho = co.constraints(x, pb), co.DYN_H_RHO
        lams = lams._replace(**{k: getattr(rho, k) * (torch.from_numpy(
            rng.normal(0, 0.01, getattr(cons, k).shape)) - getattr(cons, k))
            for k in ("leg", "height")})

    def move(t):
        return None if t is None else t.to(device=device, dtype=dtype)

    return (type(pb)(*(move(t) for t in pb)), move(x).contiguous(),
            type(lams)(*(move(t) for t in lams)))


def phys_fit_golden_gates(device, graphs=None) -> dict:
    """The port's FIT stage (the default budget: 2 AL iterations of LM 25:50)
    on walking_input(20, seed=0) in float32, and what the gates of
    tests/test_goldens.py::test_physics_fit_matches_scipy_golden read: each
    FIT constraint's violation beside the scipy golden's, the FIT cost of
    both solutions, and the largest COM and foot distances to the data (m)."""
    import torch

    from chd_tpu_torch.parallel import batch as batch_lib
    from chd_tpu_torch.physics import collocation as co
    from chd_tpu_torch.physics.synth import walking_input
    from chd_tpu_torch.utils.precision import full_f32

    g = np.load(PHYS_GOLDEN)
    if not bool(g["finished"]):
        fail("the FIT golden was saved from an unfinished solve")
    F = int(g["frames"])
    pb, _ = batch_lib.pad_phys_inputs([walking_input(F, seed=0)], device=device)
    cfg = co.SolveConfig()
    x = co.join_vars(pb.base_lin, pb.base_ang, pb.ee_pos, torch.zeros_like(pb.ee_pos))
    with full_f32():
        x, _ = co.run_stage(x, pb, co.init_multipliers(pb), co.FIT_COST, co.FIT_RHO,
                            cfg.al_iters_fit, cfg.lm, batch_lib._masks(F, pb, graphs), graphs)
        x_gold = torch.as_tensor(g["x"], dtype=torch.float32, device=pb.dt.device)[None]

        def cost(v):
            r = co.cost_residuals(v, pb, co.FIT_COST)
            return 0.5 * float((r.double() * r.double()).sum())

        ours, gold = co.violation_stats(x, pb), co.violation_stats(x_gold, pb)
        res = co._to_result(x, pb)
        return {
            "violations": {k: (float(ours[k][0]), float(gold[k][0]))
                           for k in ("leg", "heel", "terrain", "slip", "height")},
            "cost": cost(x), "golden_cost": cost(x_gold),
            "com": float((res.base_lin - pb.base_lin).norm(dim=-1).max()),
            "feet": float((res.ee_pos - pb.ee_pos).norm(dim=-1).max()),
        }


def phys_golden_gates_pass(gates: dict) -> bool:
    return (all(ours <= max(gold, 1e-3) for ours, gold in gates["violations"].values())
            and gates["cost"] <= gates["golden_cost"] * 1.001 and gates["cost"] < 0.05
            and gates["com"] < 0.02 and gates["feet"] < 0.02)


def phys_scoreboard(phys, final) -> dict:
    """tests/test_physics_scoreboard.py's readings of one solved sequence
    (host arrays of one problem): COM and stance-foot distances to the input
    (m), the net impulse's residual against the momentum change (a fraction
    of the clip's gravity impulse), the mean interior Newton–Euler
    violation, the lowest swing foot (m) and the largest change of a foot's
    phase count."""
    import torch

    from chd_tpu_torch.physics import srbd
    from chd_tpu_torch.physics.types import GRAVITY

    def arr(a):
        return np.asarray(a, np.float64)

    base, ee, f = arr(final.base_lin), arr(final.ee_pos), arr(final.ee_force)
    c, dt, m = arr(phys.contact), float(phys.dt), float(phys.mass)
    F = base.shape[0]
    com = np.linalg.norm(base - arr(phys.base_lin), axis=-1)
    feet = np.linalg.norm((ee - arr(phys.ee_pos)) * c[..., None], axis=-1)
    grf = f.sum(axis=0)
    v0, v1 = (base[2] - base[0]) / (2 * dt), (base[-1] - base[-3]) / (2 * dt)
    impulse = (grf[1:-1] + np.array([0.0, 0.0, -GRAVITY]) * m).sum(axis=0) * dt
    imp = np.linalg.norm(impulse - m * (v1 - v0)) / (m * GRAVITY * (F - 2) * dt)

    def t(a):
        return torch.as_tensor(arr(a))[None]

    viol = srbd.dynamic_violation(t(base), t(final.base_ang), t(ee),
                                  t(f / np.maximum(c[..., None], 1e-9)), t(c), t(phys.inertia),
                                  t(phys.mass), -t(phys.floor_normal), t(phys.dt))
    swing = c < 0.5
    stance = np.abs(f).sum(-1) > 1e-6
    phases = max(abs(int(np.abs(np.diff(c[e])).sum())
                     - int(np.abs(np.diff(stance[e].astype(float))).sum())) for e in range(4))
    return {"com_mean": com.mean(), "com_max": com.max(), "feet_mean": feet.sum() / max(c.sum(), 1),
            "feet_max": feet.max(), "impulse": imp,
            "newton_euler": float(viol[0, 2:-2].abs().mean()),
            "clearance": ee[..., 2][swing].min() if swing.any() else np.inf, "phases": phases}


def phys_scoreboard_pass(s: dict) -> bool:
    return (s["com_mean"] < 0.05 and s["com_max"] < 0.15 and s["feet_mean"] < 0.05
            and s["feet_max"] < 0.10 and s["impulse"] < 0.05 and s["newton_euler"] < 10.0
            and s["clearance"] > -0.02 and s["phases"] <= 2)


def physics_phases(torch, dev, smi: str) -> dict:
    """Phases [17]-[20]: retargeting, the staged physics solve and the whole
    per-video pipeline on the card. Returns the physics JᵀJ·v kernel's
    launches in [19]'s capturing call."""
    from chd_tpu_torch.kinematics import lm as lm_lib
    from chd_tpu_torch.parallel import batch as batch_lib
    from chd_tpu_torch.physics import collocation as co
    from chd_tpu_torch.physics import durations as dur
    from chd_tpu_torch.physics import jtjv as phys_jtjv_lib
    from chd_tpu_torch.physics import srbd
    from chd_tpu_torch.physics.synth import hopping_input, walking_input
    from chd_tpu_torch.physics.types import PhysWeights
    from chd_tpu_torch.utils.cuda_graph import GraphCache
    from chd_tpu_torch.utils.precision import full_f32

    f32 = torch.float32
    weights, cfg = PhysWeights(), co.SolveConfig()
    dyn_cost = co.dyn_cost_for(weights)
    stage4_cost = co.dyn_cost_for(weights, accel=0.0)

    # -- 17. building blocks, card vs CPU --------------------------------
    clips = [walking_input(PHYS_F, seed=0), hopping_input(PHYS_F, seed=0)]
    pc, _ = batch_lib.pad_phys_inputs(clips, device="cpu", dtype=f32)
    pd, _ = batch_lib.pad_phys_inputs(clips, device=dev, dtype=f32)
    rng = np.random.default_rng(17)
    B2 = len(clips)
    x = co.join_vars(pc.base_lin, pc.base_ang, pc.ee_pos, torch.zeros_like(pc.ee_pos))
    x = (x + torch.from_numpy(rng.normal(0, 0.02, x.shape).astype(np.float32))).reshape(
        B2, PHYS_F, co.DOF)
    x[..., 18:] = torch.from_numpy((rng.normal(0, 1.0, (B2, PHYS_F, 4, 3))
                                    * [60, 60, 250]).astype(np.float32)).reshape(B2, PHYS_F, 12)
    x = x.reshape(B2, -1)
    lams = co.Constraints(*(torch.from_numpy(rng.normal(0, 0.5, v.shape).astype(np.float32))
                            for v in co.init_multipliers(pc)))
    spec_c = batch_lib.pad_duration_specs(pc)
    d = spec_c.durations + torch.from_numpy(
        rng.normal(0, 0.01, spec_c.durations.shape).astype(np.float32)) * spec_c.phase_mask
    v = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))

    def on(device):
        """Phase 17's inputs on ``device``: (phys, x, lams, spec, d, v)."""
        def move(tree):
            return type(tree)(*(t.to(device) for t in tree))
        return (pc if device == "cpu" else pd, x.to(device), move(lams), move(spec_c),
                d.to(device), v.to(device))

    def al(w, rho):
        fn = co.make_al_residual_fn(w, rho)
        return lambda p, xx, lm, s, dd, vv: fn(xx, p, lm, w, rho)

    def stage3(p, xx, lm, s, dd, vv):
        xa = torch.cat([xx, dd.reshape(B2, -1)], dim=-1)
        return co.make_stage3_residual_fn(stage4_cost, co.DYN_H_RHO)(
            xa, p, lm, s, stage4_cost, co.DYN_H_RHO, weights.w_dur)

    def jtjv(p, xx, lm, s, dd, vv):
        """One JᵀJ·v of the DYN_H residual, as lm_step forms it."""
        fn = co.make_al_residual_fn(dyn_cost, co.DYN_H_RHO)
        r, vjp_fn = torch.func.vjp(lambda y: fn(y, p, lm, dyn_cost, co.DYN_H_RHO), xx)
        _, lin = torch.func.vjp(lambda cot: vjp_fn(cot)[0], torch.zeros_like(r))
        return vjp_fn(lin(vv)[0])[0]

    def violation(p, xx, *_):
        base_lin, base_ang, ee, force = co.split_vars(xx, PHYS_F)
        return srbd.dynamic_violation(base_lin, base_ang, ee, force, p.contact, p.inertia,
                                      p.mass, -p.floor_normal, p.dt)

    cases = {"dynamic_violation": violation}
    for name in co.Constraints._fields:
        cases[f"constraints.{name}"] = (lambda n: lambda p, xx, *_: getattr(
            co.constraints(xx, p), n))(name)
    cases.update({
        "AL FIT": al(co.FIT_COST, co.FIT_RHO), "AL DYN": al(dyn_cost, co.DYN_RHO),
        "AL DYN_H": al(dyn_cost, co.DYN_H_RHO), "AL stage 3": stage3,
        "AL stage 4": al(stage4_cost, co.DYN_H_RHO),
        "soft_contact": lambda p, xx, lm, s, dd, vv: dur.soft_contact(dd, s, PHYS_F, p.dt),
        "JtJ.v (DYN_H)": jtjv,
    })

    card_in, cpu_in = on(dev), on("cpu")
    with full_f32():
        want = {name: fn(*cpu_in) for name, fn in cases.items()}

    def rel_d(name):
        with full_f32():
            got = cases[name](*card_in).cpu()
        return (float((got - want[name]).abs().max())
                / max(1.0, float(want[name].abs().max())))

    print(f"[17] physics building blocks, card vs CPU in float32 ({B2} clips x {PHYS_F} "
          f"frames: walking and hopping, seeded variables and multipliers): max|d| / "
          f"max(1, max|CPU|) <= {BLOCK_REL}")
    for name in cases:
        r = rel_d(name)
        print(f"    {name}: {r:.3e}")
        if not r <= BLOCK_REL:
            fail(f"[17] {name}: the card and the CPU differ by {r:.3e} relative")
    mm = torch.matmul
    with mock.patch.object(torch, "matmul", lambda a, b: mm(tf32_rounded(a), tf32_rounded(b))):
        tf32 = {name: rel_d(name) for name in cases}
    name, r = max(tf32.items(), key=lambda kv: kv[1])
    print(f"    the card's blocks with their matmul inputs rounded to TF32: largest {r:.3e} "
          f"({name}); outside the bound: {r > BLOCK_REL}")
    if not r > BLOCK_REL:
        fail("[17] the bound does not tell TF32 products from full float32")

    # -- 18. the FIT-stage golden on the card ------------------------------
    t18, gates = wall(lambda: phys_fit_golden_gates(dev, GraphCache()))
    viol = ", ".join(f"{k} {a:.2e} (golden {b:.2e})" for k, (a, b) in gates["violations"].items())
    print(f"[18] FIT-stage golden on the card (F=20, 2 AL x LM 25:50, CUDA graphs): {t18:.2f} s "
          f"with capture; violations {viol} (each <= max(golden, 1e-3)); FIT cost "
          f"{gates['cost']:.5f} vs the golden's {gates['golden_cost']:.1f} (<= x1.001 and < "
          f"0.05); COM {gates['com']:.4f} m, feet {gates['feet']:.4f} m from the data (< 0.02)")
    if not phys_golden_gates_pass(gates):
        fail(f"[18] the FIT golden's gates failed on the card: {gates}")

    # -- 19. the realistic batch ------------------------------------------
    inputs = [walking_input(PHYS_F, seed=i) for i in range(PHYS_B)]
    pb, lens = batch_lib.pad_phys_inputs(inputs, device=dev)
    spec = batch_lib.pad_duration_specs(pb)
    graphs = GraphCache()
    print(f"[19] solve_physics_full_batch, {PHYS_B} x walking_input({PHYS_F}, seed=i), the default "
          f"SolveConfig (AL 2/3/3/2 + 3 polish, LM 25:50) and PhysWeights, CUDA graphs; {smi}")

    def call():
        return batch_lib.solve_physics_full_batch(pb, weights, cfg, spec_b=spec, graphs=graphs)

    launches = dict(phys_jtjv_lib.phys_jtjv.launches)
    t_first, _ = wall(call)
    launches = {k: v - launches[k] for k, v in phys_jtjv_lib.phys_jtjv.launches.items()}
    t_calls = []
    for _ in range(2):
        t, out = wall(call)
        t_calls.append(t)
    captures = graphs.captures
    print(f"    first call {t_first:.3f} s ({captures} captures; JtJ.v kernel launches "
          f"{launches}), then " + ", ".join(
              f"{t:.3f} s = {PHYS_B / t * 3600:.0f}" for t in t_calls) + " sequences/hour")

    stages = ["fit", "dyn", "height", "stage3", "stage4"]
    events = []

    def core():
        ev0 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        events.append(ev0)

        def hook(name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events.append(e)

        with full_f32():
            rf, rd = batch_lib._staged_core(pb, weights, cfg, graphs, hook)
            return (rf, rd) + batch_lib.durations_core(pb, rd, spec, weights, cfg, graphs, hook)

    t_core, out3 = wall(lambda: no_sync(core))
    ms = [events[i].elapsed_time(events[i + 1]) for i in range(len(stages))]
    same = (all(torch.equal(a, b) for r2, r3 in zip(out[:3], out3[:3]) for a, b in zip(r2, r3))
            and all(torch.equal(out[3][k], out3[3][k]) for k in out[3])
            and np.array_equal(out[4], out3[4].cpu().numpy()) and graphs.captures == captures)
    print(f"    the same graphs inside torch.cuda.set_sync_debug_mode('error') (no host sync): "
          f"{t_core:.3f} s; by CUDA events " + ", ".join(
              f"{s} {m:.0f} ms" for s, m in zip(stages, ms))
          + f"; equal to the call's results, bitwise: {same}")
    if not same:
        fail("[19] the staged replay differs from solve_physics_full_batch")

    res_fit, res_dyn, res3, stats, ok = out
    max_dyn = float(stats["dyn"].max())
    print(f"    convergence: durations_ok {int(ok.sum())}/{PHYS_B} (rate {ok.mean():.4f}), max "
          f"dynamics violation {max_dyn:.4e} N")
    finals = [r3 if k else r2 for r3, r2, k in zip(batch_lib.unbatch_results(res3, lens),
                                                    batch_lib.unbatch_results(res_dyn, lens), ok)]
    boards = [phys_scoreboard(p, f) for p, f in zip(inputs, finals)]
    worst = {k: (min if k == "clearance" else max)(b[k] for b in boards) for k in boards[0]}
    print("    scoreboard, worst of the sequences: " + ", ".join(
        f"{k} {v:.4g}" for k, v in worst.items()) + " (COM mean < 0.05 / max < 0.15 m, stance "
        "feet < 0.05 / < 0.10 m, impulse < 0.05, Newton-Euler < 10, clearance > -0.02 m, "
        "phase counts within 2)")
    failed = [i for i, b in enumerate(boards) if not phys_scoreboard_pass(b)]
    if failed or not all(np.isfinite(_np_res(r)).all() for r in finals):
        fail(f"[19] the scoreboard's gates failed on sequences {failed}")

    # eager against replayed: 3 LM steps of the DYN_H stage, no host sync
    masks = batch_lib._masks(PHYS_F, pb, graphs)
    x_dyn = co.join_vars(res_dyn.base_lin, res_dyn.base_ang, res_dyn.ee_pos, res_dyn.ee_force)
    lams0 = co.init_multipliers(pb)
    fn = co.make_al_residual_fn(dyn_cost, co.DYN_H_RHO)
    args = (pb, lams0, dyn_cost, co.DYN_H_RHO)
    short = dataclasses.replace(cfg.lm, max_iters=EAGER_LM_STEPS)

    def steps(g):
        with full_f32():
            return lm_lib.lm_solve(fn, x_dyn, args, short, masks, g)

    t_eager, eager = wall(lambda: no_sync(lambda: steps(None)))
    t_rep, rep = wall(lambda: no_sync(lambda: steps(graphs)))
    same = all(torch.equal(a, b) for a, b in zip(eager, rep)) and graphs.captures == captures
    print(f"    eager vs replayed, {EAGER_LM_STEPS} LM steps of DYN_H: eager {t_eager * 1e3:.0f} ms, "
          f"replayed {t_rep * 1e3:.0f} ms; bitwise equal: {same}")
    if not same:
        fail("[19] the CUDA-graph replay differs from the eager path")

    # one LM step, eager, under the profiler
    targs = lm_lib._tensor_floats(args, x_dyn)

    def res_fn(y):
        return fn(y, *targs)

    lam = torch.full((PHYS_B, 1), cfg.lm.init_lambda, device=dev)
    with full_f32():
        c0 = lm_lib._half_sq(res_fn(x_dyn))

    product = lm_lib._bound(fn.product_for(x_dyn), targs)  # the main path's: the kernel's

    def one_step():
        with full_f32():
            return lm_lib.lm_step(res_fn, x_dyn, lam, c0, cfg.lm, masks, product=product)

    st = profiled_step(one_step)
    print(f"    one eager DYN_H LM step ({cfg.lm.cg_iters} CG iterations, a JtJ.v kernel "
          f"launch each, the {masks.shape[0]}-mask diagonal in one): {st['t_step'] * 1e3:.1f} "
          f"ms, {st['peak_gib']:.2f} GiB above the inputs at peak; profiled: wall "
          f"{st['t_prof'] * 1e3:.1f} ms, {st['launches']} launches, {st['kernels']} device "
          f"kernels, device busy {st['busy'] * 1e3:.1f} ms, idle share {st['idle']:.3f}")
    print_top_items(st)

    # a small ragged batch, card against the port on the CPU
    small = [walking_input(24, seed=0), walking_input(20, seed=1)]
    small_cfg = co.SolveConfig(1, 1, 1, 1, lm=lm_lib.LMConfig(3, 10, 1e-2))

    def traj_d(a, b):
        return max(float((_t(getattr(a, k)) - _t(getattr(b, k))).abs().max())
                   for k in ("base_lin", "base_ang", "ee_pos"))

    f64 = torch.float64
    sb_c, _ = batch_lib.pad_phys_inputs(small, device=dev, dtype=f64)
    sb_h, _ = batch_lib.pad_phys_inputs(small, device="cpu", dtype=f64)
    card = batch_lib.solve_physics_full_batch(sb_c, weights, small_cfg)
    host = batch_lib.solve_physics_full_batch(sb_h, weights, small_cfg)
    d64 = max(traj_d(a, b) for a, b in zip(card[:3], host[:3]))
    eq64 = (torch.equal(card[2].contact.cpu(), host[2].contact)
            and np.array_equal(card[4], host[4]))
    print(f"    small batch (24 and 20 frames, AL 1/1/1/1, LM 3:10), float64 end to end, card vs "
          f"CPU: trajectories max|d| {d64:.3e} m (<= {SMALL_PHYS_F64_MAX_D}), rasterized "
          f"contacts and durations_ok equal: {eq64}")
    if not (d64 <= SMALL_PHYS_F64_MAX_D and eq64):
        fail("[19] small batch, float64: the card and the CPU disagree")

    # float32 stage by stage, each stage on the CPU from the card's input
    sb_c, _ = batch_lib.pad_phys_inputs(small, device=dev, dtype=f32)
    sb_h, _ = batch_lib.pad_phys_inputs(small, device="cpu", dtype=f32)
    sp_c, sp_h = batch_lib.pad_duration_specs(sb_c), batch_lib.pad_duration_specs(sb_h)
    Fs = sb_c.base_lin.shape[1]

    def host_of(tree):
        return type(tree)(*(t.cpu() for t in tree))

    def parts(a, b):
        """max|d| of positions (m), angles (rad), forces (N) and, where
        given, durations (s) between two stage outputs (x, durations)."""
        va, vb = co.split_vars(a[0].cpu(), Fs), co.split_vars(b[0].cpu(), Fs)
        out = {"pos": max(float((va[i] - vb[i]).abs().max()) for i in (0, 2)),
               "ang": float((va[1] - vb[1]).abs().max()),
               "force": float((va[3] - vb[3]).abs().max())}
        if a[1] is not None:
            out["durations"] = float((a[1].cpu() - b[1].cpu()).abs().max())
        return out

    readings, spreads = {}, {}

    def hold(name, card_out, host_stage, x_in):
        """The card's stage output against ``host_stage`` from the same input
        on the CPU, and the CPU's own spread under one-ulp changes of it."""
        x_h = x_in.cpu()
        host = host_stage(x_h)
        readings[name] = parts(card_out, host)
        sp = [parts(host_stage(torch.nextafter(x_h, torch.full_like(x_h, u * np.inf))), host)
              for u in SPREAD_ULPS]
        spreads[name] = {k: max(s[k] for s in sp) for k in readings[name]}

    with full_f32():
        x_c = co.join_vars(sb_c.base_lin, sb_c.base_ang, sb_c.ee_pos,
                           torch.zeros_like(sb_c.ee_pos))
        l_c = co.init_multipliers(sb_c)
        for name, w, rho in (("FIT", co.FIT_COST, co.FIT_RHO), ("DYN", dyn_cost, co.DYN_RHO),
                             ("HEIGHT", dyn_cost, co.DYN_H_RHO)):
            l_h = host_of(l_c)
            x_in, (x_c, l_c) = x_c, co.run_stage(x_c, sb_c, l_c, w, rho, 1, small_cfg.lm,
                                                 batch_lib._masks(Fs, sb_c, None))
            hold(name, (x_c, None), lambda xh, w=w, rho=rho, l_h=l_h: (co.run_stage(
                xh, sb_h, l_h, w, rho, 1, small_cfg.lm, batch_lib._masks(Fs, sb_h, None))[0],
                None), x_in)
        x3_c, d3_c = batch_lib.stage3_solve(sb_c, x_c, sp_c, weights, small_cfg)
        hold("stage 3", (x3_c, d3_c),
             lambda xh: batch_lib.stage3_solve(sb_h, xh, sp_h, weights, small_cfg), x_c)
        new_c = dur.rasterize(d3_c, sp_c, Fs, sb_c.dt)
        new_h = dur.rasterize(d3_c.cpu(), sp_h, Fs, sb_h.dt)
        flips = int((new_c.cpu() != new_h).sum())
        x4_c = batch_lib.stage4_solve(sb_c._replace(contact=new_c), x3_c, weights, small_cfg)
        hold("stage 4", (x4_c, None), lambda xh: (batch_lib.stage4_solve(
            sb_h._replace(contact=new_c.cpu()), xh, weights, small_cfg), None), x3_c)
    bad = [f"{n} {k}" for n, r in readings.items() for k, v in r.items()
           if not v <= max(SPREAD_X * spreads[n][k], SMALL_PHYS_F32_FLOOR)]
    print("    small batch, float32 stage by stage (each on the CPU from the card's input), max|d| "
          f"card vs CPU (the CPU's own one-ulp spread); bound max({SPREAD_X} x spread, "
          f"{SMALL_PHYS_F32_FLOOR}):")
    for n, r in readings.items():
        print(f"      {n}: " + ", ".join(f"{k} {v:.3e} ({spreads[n][k]:.3e})" for k, v in r.items()))
    print(f"    frames whose rasterized contact differs between the card and the CPU: {flips}")
    if bad:
        fail(f"[19] small batch, float32 stage by stage: the card and the CPU disagree: {bad}")

    # -- 20. the run CLI on the card --------------------------------------
    run_cli_phase(torch, dev)
    return {"solve_physics_full_batch": launches}


def run_cli_phase(torch, dev) -> None:
    """Phase [20]: the ``run`` CLI on the card on a synthetic 12-frame video
    dir, and its retargeting and physics stages on the CPU from the card's
    kinematic results (each stage on the CPU from the card's input, as [15]
    and [19] hold theirs: the kinematic stage at this budget on this dir is
    [16]'s, which [16] holds card against CPU)."""
    import shutil

    from chd_tpu_torch.core import bvh, fk
    from chd_tpu_torch.physics import towr_io
    from chd_tpu_torch.pipeline import cli
    from chd_tpu_torch.pipeline.run import run_physics_stage, run_retarget_stage
    from chd_tpu_torch.utils.config import PipelineConfig

    g = np.load(TRAJ_GOLDEN)
    skel = golden_skeleton(g)
    J = len(skel.parents)
    with tempfile.TemporaryDirectory() as tmp:
        skel_bvh = os.path.join(tmp, "combined_body_25.bvh")
        bvh.save(skel_bvh, skel.slice_frames(0, 1), [f"joint_{j}" for j in range(J)])
        sets = [f"{k}={val}" for k, val in RUN_BUDGET.items()]
        dirs, t20 = {}, {}
        for device in ("cuda", "cpu"):
            root = os.path.join(tmp, device)
            dirs[device] = synth_video_dir(root, skel)
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["run", "--data", os.path.join(tmp, "cuda"), "--character", "ybot",
                           "--skel-path", skel_bvh, "--char-bvh", YBOT_TEMPLATE, "--device",
                           dev.type, "--set", *sets])
        t20["cuda"] = time.perf_counter() - t
        if rc != 0:
            fail(f"[20] the run CLI on {dev.type} returned {rc}")
        # the CPU's stages from the card's kinematic results
        kin = os.path.join(dirs["cpu"], "kinematic_results")
        os.makedirs(kin)
        for name in ("final_test.bvh", "floor_out.txt", "foot_contacts.npy"):
            shutil.copyfile(os.path.join(dirs["cuda"], "kinematic_results", name),
                            os.path.join(kin, name))
        cfg = PipelineConfig().override(**{"character": "ybot", "kinematic.skel_path": skel_bvh,
                                           **RUN_BUDGET})
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            run_retarget_stage(dirs["cpu"], cfg, YBOT_TEMPLATE, device="cpu")
            run_physics_stage(dirs["cpu"], cfg, device="cpu")
        t20["cpu"] = time.perf_counter() - t
        labels = ("no_dynamics", "dynamics", "durations")
        want = {"kinematic_results": ["final_test.bvh", "floor_out.txt", "foot_contacts.npy",
                                      "ybot_out.bvh"],
                "phys_optim_in_ybot": ["contact_info.txt", "motion_info.txt", "skel_info.txt",
                                       "terrain_info.txt"],
                "phys_optim_out_ybot": sorted([f"sol_out_{s}.txt" for s in labels]
                                              + ["success_log.txt"]
                                              + [f"dance_synth_ybot_{s}.bvh" for s in labels])}
        found, logs, sol_d, bvh_d, joints = {}, {}, 0.0, 0.0, set()
        for device, vd in dirs.items():
            found[device] = {k: sorted(os.listdir(os.path.join(vd, k))) for k in want
                             if os.path.isdir(os.path.join(vd, k))}
            logs[device] = towr_io.load_success_log(
                os.path.join(vd, "phys_optim_out_ybot", "success_log.txt"))
        for label in labels:
            a, b = (towr_io.load_results(os.path.join(dirs[k], "phys_optim_out_ybot",
                                                      f"sol_out_{label}.txt"))
                    for k in ("cuda", "cpu"))
            sol_d = max(sol_d, float(np.abs(a.base_pos - b.base_pos).max()),
                        float(np.abs(a.feet_pos - b.feet_pos).max()))
            pa, pb_ = [], []
            for k, acc in (("cuda", pa), ("cpu", pb_)):
                anim, _, _ = bvh.load(os.path.join(dirs[k], "phys_optim_out_ybot",
                                                   f"dance_synth_ybot_{label}.bvh"))
                joints.add(anim.num_joints)
                acc.append(fk.positions_global(torch.from_numpy(anim.rotations),
                                               torch.from_numpy(anim.positions),
                                               anim.parents).numpy())
            bvh_d = max(bvh_d, float(np.abs(pa[0] - pb_[0]).max()))
        print(f"[20] run CLI on the card (synthetic 12-frame video dir; kinematic IK 20, LM 8:30; "
              f"retarget to ybot, IK 200; physics AL 1/1/1/1, LM 3:10): {t20['cuda']:.2f} s "
              f"(retargeting and physics {t20['cpu']:.2f} s on the CPU); wrote {found['cuda']}; "
              f"success logs {logs}; BVH joints {sorted(joints)}; against the CPU's retargeting "
              f"and physics from the card's kinematic results: solutions max|d| {sol_d:.3e} m "
              f"(<= {RUN_SOL_MAX_D}), BVH joints max|d| {bvh_d:.3e} cm (<= {RUN_BVH_MAX_D})")
        if (found["cuda"] != want or found["cpu"] != want or joints != {67}
                or set(logs["cuda"]) != {"dynamics", "durations"}):
            fail("[20] the run CLI missed an artifact on the card")
        if not (sol_d <= RUN_SOL_MAX_D and bvh_d <= RUN_BVH_MAX_D):
            fail("[20] the run CLI on the card disagrees with the CPU")


def _not_installed(*modules) -> list:
    import importlib.util

    return [m for m in modules if importlib.util.find_spec(m) is None]


def _captured_frames(video_lib, render) -> list:
    """The frames ``render()`` hands to ``VideoSink.write`` (still written)."""
    frames, write = [], video_lib.VideoSink.write

    def capture(sink, frame):
        frames.append(np.array(frame, copy=True))
        write(sink, frame)

    with mock.patch.object(video_lib.VideoSink, "write", capture):
        render()
    return frames


def _png_pixels(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        fail(f"[24] {path} does not decode")
    return img


def _trace_kernel_events(trace_dir: str) -> tuple:
    """(the device kernels named ``fused_mlp_kernel...``, the names of the
    other device kernels) of the one Chrome trace under ``trace_dir``."""
    import glob
    import re

    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    if len(files) != 1:
        fail(f"[24] profiling.trace wrote {files}, not one Chrome trace")
    with open(files[0]) as f:
        kernels = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    # the instantiations are templates in an anonymous namespace: a
    # demangled name reads "void (anonymous namespace)::fused_mlp_kernel<...>(...)"
    name = re.compile(r"(void )?(\(anonymous namespace\)::)?fused_mlp_kernel<")
    found = [e for e in kernels if name.match(e.get("name", ""))]
    return found, sorted({e.get("name", "")[:80] for e in kernels} - {e["name"][:80] for e in found})


def host_layer_phase(torch, dev, smi: str) -> None:
    """Phase [24]: the host layer on the card: ``utils.profiling``'s trace
    and benchmark on the detector, the viz entry points and blender's host
    helpers on card tensors from a ``run`` on the card, and the CLI's host
    commands in a fresh process."""
    import chd_tpu_torch.viz as viz
    from chd_tpu_torch.characters import defs
    from chd_tpu_torch.contact import infer, synth
    from chd_tpu_torch.contact import train as train_lib
    from chd_tpu_torch.core import bvh, fk
    from chd_tpu_torch.ingest import openpose
    from chd_tpu_torch.models import torch_convert
    from chd_tpu_torch.ops import gapfill
    from chd_tpu_torch.ops.fused_mlp import fused_mlp
    from chd_tpu_torch.physics import towr_io
    from chd_tpu_torch.pipeline.run import run_pipeline
    from chd_tpu_torch.utils import metrics as metrics_lib
    from chd_tpu_torch.utils import profiling
    from chd_tpu_torch.utils.config import PipelineConfig
    from chd_tpu_torch.viz import blender
    from chd_tpu_torch.viz import video as video_lib

    t_phase = time.perf_counter()
    golden = np.load(GOLDEN)
    gmodel = torch_convert.from_state_dict(
        {key[3:]: golden[key] for key in golden.files if key.startswith("sd.")})

    # -- trace: two detect_contacts calls, one kernel event each ------------
    with tempfile.TemporaryDirectory() as tmp:
        dirs = golden_video_dirs(tmp, golden)
        infer.detect_contacts(dirs, gmodel, device=dev, image_dims=(1920, 1080), save=False)
        fused_mlp.launches = 0
        with profiling.trace(os.path.join(tmp, "trace")):
            for _ in range(TRACE_CALLS):
                results = infer.detect_contacts(dirs, gmodel, device=dev,
                                                image_dims=(1920, 1080), save=False)
        launches = fused_mlp.launches
        found, others = _trace_kernel_events(os.path.join(tmp, "trace"))
    print(f"[24] the host layer on the card ({smi}): profiling.trace around {TRACE_CALLS} "
          f"golden detect_contacts calls: {len(found)} fused_mlp_kernel device events "
          f"({sorted({e['name'].split('(float')[0] for e in found})}), {launches} launches "
          "counted")
    if len(found) != TRACE_CALLS or launches != TRACE_CALLS:
        fail(f"[24] the trace holds {len(found)} fused_mlp_kernel events for {TRACE_CALLS} "
             f"calls ({launches} launches counted; the other kernels: {others})")

    # -- benchmark: _infer_batch at [5]'s batch, and the kernel alone at its
    # conv rows, each against CUDA events of the same calls ----------------
    big = torch.from_numpy(synth_videos(BIG_V, BIG_F, seed=0)).to(dev)
    det = infer.ContactDetector(gmodel, device=dev)
    joints_in, root, appended = infer.subset_joints(det.kw["joint_subset"])
    rows = infer.mlp_logits(
        gapfill.preprocess_keypoints(big[:, :, joints_in], det.kw["conf_thresh"],
                                     det.kw["normalization"]),
        det.layers, window_size=det.kw["window_size"], root_in_subset=root,
        root_appended=appended, use_confidence=det.kw["use_confidence"],
        use_conv=det.kw["use_conv"], mlp=lambda *a: a)
    calls = {"_infer_batch": lambda: infer._infer_batch(big, det.layers, **det.kw),
             "fused_mlp": lambda: fused_mlp(*rows)}

    def event_s(fn) -> float:
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(BENCH_ITERS):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / BENCH_ITERS / 1e3

    print(f"    profiling.benchmark, {BENCH_ITERS} iters, against CUDA events of the same calls "
          f"(ratio >= {BENCH_MIN_RATIO}; {smi}):")
    for name, fn in calls.items():
        ev = [event_s(fn)]
        bench = profiling.benchmark(fn, warmup=2, iters=BENCH_ITERS)
        ev.append(event_s(fn))
        torch.cuda.synchronize()
        with mock.patch.object(profiling, "_sync", lambda tree: None):
            no_read = profiling.benchmark(fn, warmup=2, iters=BENCH_ITERS)["mean_s"]
        torch.cuda.synchronize()
        ev_mean = statistics.mean(ev)
        print(f"      {name} ({BIG_V} x {BIG_F}): mean_s {bench['mean_s'] * 1e3:.3f} ms "
              f"({bench['iters_per_s']:.1f} calls/s); CUDA events {ev[0] * 1e3:.3f} and "
              f"{ev[1] * 1e3:.3f} ms; ratio {bench['mean_s'] / ev_mean:.3f}; without its host "
              f"read {no_read * 1e3:.3f} ms, ratio {no_read / ev_mean:.3f}")
        if not bench["mean_s"] >= BENCH_MIN_RATIO * ev_mean:
            fail(f"[24] profiling.benchmark reads {bench['mean_s']} s of {name} against "
                 f"{ev_mean} s of CUDA events: it times the launches, not the work")
        # the control: the kernel alone is device-bound, so a benchmark
        # without its host read must fail the gate
        if name == "fused_mlp" and no_read >= BENCH_MIN_RATIO * ev_mean:
            fail("[24] the gate does not see a benchmark of the kernel without its host read")

    # -- a run on the card, and its outputs as card tensors -----------------
    g = np.load(TRAJ_GOLDEN)
    skel = golden_skeleton(g)
    J = len(skel.parents)
    with tempfile.TemporaryDirectory() as tmp:
        skel_bvh = os.path.join(tmp, "combined_body_25.bvh")
        bvh.save(skel_bvh, skel.slice_frames(0, 1), [f"joint_{j}" for j in range(J)])
        vd = synth_video_dir(os.path.join(tmp, "data"), skel)
        cfg = PipelineConfig().override(**{"character": "ybot", "kinematic.skel_path": skel_bvh},
                                        **RUN_BUDGET)
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            run_pipeline(vd, cfg, char_skel_bvh=YBOT_TEMPLATE, device=dev)
        t_run = time.perf_counter() - t
        kin = os.path.join(vd, "kinematic_results")
        phys_out = os.path.join(vd, "phys_optim_out_ybot")
        anim, _, _ = bvh.load(os.path.join(kin, "final_test.bvh"))
        joints = fk.positions_global(torch.from_numpy(anim.rotations).to(dev),
                                     torch.from_numpy(anim.positions).to(dev), anim.parents)
        contacts = torch.from_numpy(np.load(os.path.join(kin, "foot_contacts.npy"))).to(dev)
        with open(os.path.join(kin, "floor_out.txt")) as f:
            normal = torch.tensor([float(x) for x in f.readline().split()],
                                  dtype=torch.float64, device=dev)
            point = torch.tensor([float(x) for x in f.readline().split()],
                                 dtype=torch.float64, device=dev)
        label = blender.pick_result(phys_out)
        log = towr_io.load_success_log(os.path.join(phys_out, "success_log.txt"))
        want_label = ("durations" if log.get("durations") else
                      "dynamics" if log.get("dynamics") else "no_dynamics")
        sol = towr_io.load_results(os.path.join(phys_out, f"sol_out_{label}.txt"))
        sol_card = sol._replace(**{k: torch.from_numpy(v).to(dev) for k, v in sol._asdict().items()
                                   if isinstance(v, np.ndarray)})
        # the 1920 x 1080 keypoints drawn at a quarter of that size
        keypoints = torch.from_numpy(openpose.load_keypoint_dir(
            os.path.join(vd, "openpose_result"))).to(dev) * torch.tensor([0.25, 0.25, 1.0],
                                                                          device=dev)
        mass = 70.0
        forces = blender.estimate_kinematic_forces(sol_card.base_pos, normal, mass)
        forces_host = blender.estimate_kinematic_forces(sol.base_pos, normal.cpu().numpy(), mass)
        print(f"    run on the card (the synthetic 12-frame dir, [20]'s budgets): {t_run:.2f} s; "
              f"blender.pick_result {label!r} (success log {log}); estimate_kinematic_forces "
              f"on card tensors {forces.shape}, equal to numpy's: "
              f"{np.array_equal(forces, forces_host)}")
        if label != want_label or not np.array_equal(forces, forces_host):
            fail("[24] blender's host helpers disagree on card tensors")

        # the training history of the port's train on the card
        ds = synth.learnable_dataset(n_seq=24, frames=60, device=dev)
        _, hist = train_lib.train(ds, train_lib.TrainConfig(epochs=3, batch_size=8, val_every=1),
                                  log_every=1, verbose=False)
        hist_card = {k: torch.tensor(hist[k], dtype=torch.float64, device=dev)
                     for k in ("train_loss", "val_loss", "train_acc", "val_f1")}
        acc_card = torch.tensor([m["accuracy"] for m in hist["val_metrics"][-1]],
                                dtype=torch.float64, device=dev)
        pred = torch.from_numpy(np.concatenate(results)).to(dev) > 0
        labels = torch.from_numpy(np.concatenate([golden[f"contacts_{i}"]
                                                  for i in range(len(results))])).to(dev) > 0
        confusion = metrics_lib.confusion_counts(pred, labels)

        joint_contacts = torch.zeros(joints.shape[:2], dtype=torch.int64, device=dev)
        joint_contacts[:, defs.COMBINED_SKEL_FEET_IDX] = contacts.amax(1, keepdim=True)
        adjacency = [np.array([(j, p) for j, p in enumerate(anim.parents) if p >= 0])]
        card_args = {
            "animate_skeletons": dict(joints3d=[joints], adjacency=adjacency,
                                      contacts=joint_contacts, floor_normal=normal,
                                      floor_point=point, figsize=(4, 3), max_frames=3),
            "render_keypoint_video": dict(joint2d_list=[keypoints], contacts=contacts,
                                          dimensions=(480, 270)),
            "animate_physics_results": dict(results=[sol_card], floor_normal=normal,
                                            floor_point=point * 0.01, max_frames=3),
            "plot_train_curves": dict(history=hist_card),
            "plot_confusion_matrix": dict(confusion=confusion),
            "plot_accuracy_hist": dict(accuracies=acc_card),
            "plot_3curve": dict(arr=sol_card.base_pos, dt=sol_card.dt, ylabel="COM (m)"),
        }
        host_args = video_lib.to_host(card_args)
        same = (np.array_equal(host_args["animate_skeletons"]["joints3d"][0],
                               joints.cpu().numpy())
                and np.array_equal(host_args["animate_physics_results"]["results"][0].feet_force,
                                   sol.feet_force)
                and isinstance(host_args["plot_confusion_matrix"]["confusion"],
                               metrics_lib.Confusion))
        print(f"    viz.video.to_host of the card tensors equals their host copies: {same}")
        if not same:
            fail("[24] viz.video.to_host does not bring card tensors to the host as they are")
        # render_keypoint_video needs cv2; the others matplotlib and cv2
        from chd_tpu_torch.viz import plots

        readings, skipped = [], {}
        for name, args in card_args.items():
            missing = _not_installed("cv2") if name == "render_keypoint_video" else \
                _not_installed("matplotlib", "cv2")
            if missing:
                skipped[name] = missing
                continue
            fn = getattr(viz, name, None) or getattr(plots, name)
            t = time.perf_counter()
            outs = []
            for k, a in enumerate((args, host_args[name])):
                path = os.path.join(tmp, f"{name}_{k}.{'png' if 'plot' in name else 'mp4'}")
                if name.startswith("plot"):
                    fn(out_path=path, **a)
                    outs.append([_png_pixels(path)])
                else:
                    outs.append(_captured_frames(video_lib, lambda: fn(out_path=path, **a)))
            equal = (len(outs[0]) == len(outs[1]) > 0
                     and all(np.array_equal(x, y) for x, y in zip(*outs)))
            readings.append(f"{name} {len(outs[0])} x {outs[0][0].shape} "
                            f"{(time.perf_counter() - t) / 2:.2f} s a render, "
                            f"{'equal' if equal else 'DIFFERENT'}")
            if not equal:
                fail(f"[24] {name} renders other pixels from card tensors than from numpy")
        for missing in sorted({tuple(m) for m in skipped.values()}):
            print(f"    {' and '.join(missing)} not installed on this machine: [24] renders none "
                  f"of {', '.join(n for n, m in skipped.items() if tuple(m) == missing)}")
        if readings:
            print("    viz from card tensors against the same values as host numpy, bitwise "
                  "(host seconds per render, not a metric of the card): " + "; ".join(readings))

    # -- the CLI's host commands in a fresh process -------------------------
    code = ("import json, runpy, sys\n"
            "sys.argv = ['chd_tpu_torch.pipeline'] + sys.argv[1:]\n"
            "try:\n"
            "    runpy.run_module('chd_tpu_torch.pipeline', run_name='__main__', alter_sys=True)\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "print(json.dumps(sorted(m for m in sys.modules\n"
            "                        if m.split('.')[0] in ('jax', 'chd_tpu'))), file=sys.stderr)\n"
            "sys.exit(rc)\n")
    with tempfile.TemporaryDirectory() as tmp:
        src, out_dir = os.path.join(tmp, "videos"), os.path.join(tmp, "structured")
        os.makedirs(src)
        for name in ("walk.mp4", "jump.mp4", "notes.txt"):
            with open(os.path.join(src, name), "wb") as f:
                f.write(name.encode())
        outs = {}
        for args in (["config"], ["make-structure", "--data", src, "--out", out_dir]):
            t = time.perf_counter()
            p = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO,
                               capture_output=True, text=True, timeout=300)
            outs[args[0]] = (p, time.perf_counter() - t)
        cfg_p, mk_p = outs["config"][0], outs["make-structure"][0]
        tree = sorted(os.path.relpath(os.path.join(d, f), out_dir)
                      for d, _, fs in os.walk(out_dir) for f in fs)
        ok = (cfg_p.returncode == 0 and mk_p.returncode == 0
              and cfg_p.stdout == PipelineConfig().to_json() + "\n"
              and mk_p.stdout.split() == [os.path.join(out_dir, "jump"),
                                          os.path.join(out_dir, "walk")]
              and tree == ["jump/jump.mp4", "walk/walk.mp4"])
        foreign = [p.stderr.strip().splitlines()[-1] if p.stderr.strip() else "?"
                   for p, _ in outs.values()]
        print(f"    python -m chd_tpu_torch.pipeline config: rc {cfg_p.returncode}, "
              f"{len(cfg_p.stdout)} bytes, {outs['config'][1]:.2f} s; make-structure: rc "
              f"{mk_p.returncode}, tree {tree}, {outs['make-structure'][1]:.2f} s; jax or chd_tpu "
              f"modules in each process: {foreign}")
        if not ok or foreign != ["[]", "[]"]:
            fail(f"[24] the CLI's host commands: {cfg_p.stderr[-2000:]} {mk_p.stderr[-2000:]}")
    print(f"    [24] took {time.perf_counter() - t_phase:.1f} s")


def parallel_phase(torch, dev, smi: str) -> dict:
    """[25]: the parallel layer (``chd_tpu_torch.parallel``) on the card.
    Returns the kernel's launches on the data-parallel paths."""
    import torch.distributed as dist

    from chd_tpu_torch.contact import data as data_lib
    from chd_tpu_torch.contact import infer, synth
    from chd_tpu_torch.contact import train as train_lib
    from chd_tpu_torch.kinematics import batch as kin_batch
    from chd_tpu_torch.kinematics import trajectory as traj_lib
    from chd_tpu_torch.kinematics.ik import IKConfig
    from chd_tpu_torch.kinematics.lm import LMConfig, frame_coloring_masks
    from chd_tpu_torch.models import contact_mlp, torch_convert
    from chd_tpu_torch.ops.fused_mlp import fused_mlp
    from chd_tpu_torch.parallel import batch as phys_batch
    from chd_tpu_torch.parallel import distributed, longseq, tensor
    from chd_tpu_torch.parallel import mesh as mesh_lib
    from chd_tpu_torch.parallel.dryrun import dryrun_multichip
    from chd_tpu_torch.physics import collocation
    from chd_tpu_torch.physics.synth import walking_input
    from chd_tpu_torch.physics.types import PhysWeights

    t_phase = time.perf_counter()
    env = [k for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR") if k in os.environ]
    joined = distributed.initialize()
    print(f"[25] the parallel layer on the card, {smi}: distributed.initialize() with "
          f"torchrun's variables {env or 'unset'}: {joined}, group initialized "
          f"{dist.is_initialized()}")
    if joined or dist.is_initialized():
        fail("[25] initialize() joined a group without torchrun's environment")
    distributed.initialize("cuda", store=dist.HashStore(), world_size=1, rank=0, local_rank=0,
                           timeout=300)
    launches = {}
    try:
        mesh = mesh_lib.make_mesh()
        print(f"    in-process group: backend {dist.get_backend()}, world size "
              f"{dist.get_world_size()}, mesh {mesh.shape} on {mesh.device}")

        # data-parallel detection at [5]'s batch, the kernel on every rank
        golden = np.load(GOLDEN)
        gmodel = torch_convert.from_state_dict(
            {key[3:]: golden[key] for key in golden.files if key.startswith("sd.")})
        det = infer.ContactDetector(gmodel, device=dev)
        big = torch.from_numpy(synth_videos(BIG_V, BIG_F, seed=0)).to(dev)
        c_one, p_one = det.infer(big)
        torch.cuda.synchronize()
        fused_mlp.launches = 0
        c_dp, p_dp = det.infer(big, mesh=mesh)
        torch.cuda.synchronize()
        launches["dp_detect"] = fused_mlp.launches
        t_one = statistics.median(wall(lambda: det.infer(big))[0] for _ in range(3))
        t_dp = statistics.median(wall(lambda: det.infer(big, mesh=mesh))[0] for _ in range(3))
        same = torch.equal(c_dp, c_one) and torch.equal(p_dp, p_one)
        print(f"    data-parallel detection, V={BIG_V} F={BIG_F}, golden weights: fused_mlp "
              f"launches {launches['dp_detect']} (1 a rank), contacts and probabilities equal to "
              f"[5]'s unsharded call {same}; {t_dp * 1e3:.3f} ms a call against "
              f"{t_one * 1e3:.3f} ms unsharded (median of 3 synced)")
        if launches["dp_detect"] != 1 or not same:
            fail("[25] data-parallel detection: launches or contacts differ")

        # 3 sync-BN steps at [9]'s batch, against the same steps without a mesh
        cfg = train_lib.TrainConfig(lr=3e-4)
        ds = synth.learnable_dataset(cfg.batch_size + 16, TRAIN_F, seed=0, n_holdout=16,
                                     device=dev)
        train_op, train_ct = ds.split_arrays("train")
        gen = torch.Generator(device=dev).manual_seed(9)
        steps = []
        for _ in range(3):
            feats, labels = data_lib.sample_train_windows(
                gen, train_op, train_ct, cfg.window_size, cfg.pred_size, cfg.joint_subset,
                cfg.noise_dev)
            steps.append((feats, labels, contact_mlp.dropout_keep_mask(
                (cfg.batch_size, contact_mlp.HIDDEN[2]), gen, dev)))

        def fresh(m_mesh=None, dtype=torch.float32):
            """[9]'s initial model, sharded over m_mesh's "model" axis if given."""
            m = contact_mlp.init(cfg.model_config(), torch.Generator().manual_seed(3))
            m = m.to(dev, dtype)
            return m if m_mesh is None else tensor.shard_contact_model(m, m_mesh)

        def run_steps(m, m_mesh, dtype=torch.float32):
            opt = train_lib.make_optimizer(m, cfg)
            g_min = {k: torch.full_like(p, float("inf")) for k, p in m.named_parameters()}
            for feats, labels, mask in steps:
                before = {k: p.detach().clone() for k, p in m.named_parameters()}
                train_lib.train_step(m, opt, None, None, cfg, None,
                                     windows=(feats.to(dtype), labels.to(dtype)),
                                     dropout_mask=mask, mesh=m_mesh)
                for k, p in m.named_parameters():
                    g_min[k] = torch.minimum(g_min[k],
                                             (p.grad + cfg.weight_decay * before[k]).abs())
            return m, g_min

        def unsharded(dtype):
            """The unsharded steps' parameters, firm masks and buffers."""
            m_one, g_min = run_steps(fresh(dtype=dtype), None, dtype)
            return (dict(m_one.named_parameters()), {k: g >= G_MIN for k, g in g_min.items()},
                    dict(m_one.named_buffers()))

        def held_to_phase9(m, what, ref, gate=True):
            """m's last gradients, parameters and BN statistics against the
            unsharded steps' (``ref``) within [9]'s bounds; fails the run if
            not, where ``gate``."""
            one, firm, bufs = ref
            d_grad = max(float((p.grad - one[k].grad).abs().max())
                         for k, p in m.named_parameters())
            d = {k: (p - one[k]).detach().abs() for k, p in m.named_parameters()}
            d_param = max(float(d[k][firm[k]].max()) if firm[k].any() else 0.0 for k in d)
            d_noise = max(float(d[k][~firm[k]].max()) if (~firm[k]).any() else 0.0 for k in d)
            d_bn = max(float((b.double() - bufs[k].double()).abs().max())
                       for k, b in m.named_buffers())
            print(f"    3 {what}, batch {cfg.batch_size} of {TRAIN_F}-frame sequences, lower: "
                  f"against the same steps without a mesh, max|d| grads {d_grad:.3e} (<= "
                  f"{GRAD_MAX_D}), params {d_param:.3e} where |grad + L2| >= {G_MIN} (<= "
                  f"{PARAM_MAX_D}), {d_noise:.3e} on the others (<= {6 * cfg.lr:.1e}), BN "
                  f"stats {d_bn:.3e} (<= {BN_MAX_D})" + ("" if gate else ": not a gate"))
            if gate and (d_grad > GRAD_MAX_D or d_param > PARAM_MAX_D or d_noise > 6 * cfg.lr
                         or d_bn > BN_MAX_D):
                fail(f"[25] the {what} leave [9]'s bounds")

        one32 = unsharded(torch.float32)
        m_dp, _ = run_steps(fresh(), mesh)
        held_to_phase9(m_dp, "sync-BN steps over the mesh", one32)
        val_op, val_ct = ds.split_arrays("val")
        fused_mlp.launches = 0
        loss_dp, conf_dp = train_lib.eval_step(m_dp, val_op, val_ct, cfg, mesh=mesh)
        torch.cuda.synchronize()
        launches["dp_eval"] = fused_mlp.launches
        loss_one, conf_one = train_lib.eval_step(m_dp, val_op, val_ct, cfg)
        d_loss = abs(float(loss_dp) - float(loss_one))
        print(f"    data-parallel eval_step on {val_op.shape[0]} held-out sequences: fused_mlp "
              f"launches {launches['dp_eval']}, loss |d| {d_loss:.3e} (<= 1e-6), confusion "
              f"counts equal {torch.equal(conf_dp, conf_one)}")
        if launches["dp_eval"] != 1 or d_loss > 1e-6 or not torch.equal(conf_dp, conf_one):
            fail("[25] data-parallel evaluation differs from the unsharded one")

        # tensor parallelism of the contact MLP: the single-process form of
        # the mesh holds both "model" shards on this card
        tp_mesh = mesh_lib.local_mesh(2, model=2, device=dev)
        p_specs, s_specs = mesh_lib.contact_model_shardings(tp_mesh)
        print("    contact_model_shardings over model=2: "
              + ", ".join(f"{mod}.{leaf} {spec}" for tree in (p_specs, s_specs)
                          for mod, leaves in tree.items() for leaf, spec in leaves.items()
                          if mod.endswith(("0", "4"))) + " (linear1-3 and bn1-3 as 0)")
        whole = fresh()
        tp0 = tensor.shard_contact_model(whole, tp_mesh)
        back = tensor.gather_contact_model(tp0)
        same_back = all(torch.equal(a, b) for a, b in zip(back.state_dict().values(),
                                                          whole.state_dict().values()))
        f_tp, f_back = tensor.fold_batchnorm(tp0), contact_mlp.fold_batchnorm(back)
        same_fold = all(torch.equal(a, b) for k in "wb" for a, b in zip(f_tp[k], f_back[k]))
        print(f"    sharded and gathered back: bitwise {same_back}; folded shards against the "
              f"gathered model's fold: bitwise {same_fold}")
        if not (same_back and same_fold):
            fail("[25] sharding the contact MLP and gathering it back is not bitwise")
        # The gate runs in float64. In float32 the sharded products (other
        # GEMM shapes, so other sum orders) can round a BN output near 0 to
        # the other side of its ReLU, and that element's gradient is then
        # all or nothing (PERF.md, PR 9); float32 is printed beside it.
        tp_forms = {"model=2": tp_mesh,
                    "data=2 x model=2": mesh_lib.local_mesh(4, data=2, model=2, device=dev)}
        one64 = unsharded(torch.float64)
        for what, t_mesh in tp_forms.items():
            m64, _ = run_steps(fresh(t_mesh, torch.float64), t_mesh, torch.float64)
            held_to_phase9(tensor.gather_contact_model(m64),
                           f"float64 tensor-parallel steps ({what}, one process)", one64)
            m_tp, _ = run_steps(fresh(t_mesh), t_mesh)
            held_to_phase9(tensor.gather_contact_model(m_tp),
                           f"float32 tensor-parallel steps ({what})", one32, gate=False)
        fused_mlp.launches = 0
        loss_tp, conf_tp = train_lib.eval_step(m_tp, val_op, val_ct, cfg, mesh=t_mesh)
        torch.cuda.synchronize()
        launches["tp_evaluate"] = fused_mlp.launches
        loss_g, conf_g = train_lib.eval_step(tensor.gather_contact_model(m_tp), val_op, val_ct,
                                             cfg)
        d_loss = abs(float(loss_tp) - float(loss_g))
        print(f"    tensor-parallel eval_step ({what}) on {val_op.shape[0]} held-out sequences: "
              f"fused_mlp launches {launches['tp_evaluate']}, against the gathered model's "
              f"eval_step: loss |d| {d_loss:.3e} (<= 1e-6), confusion counts equal "
              f"{torch.equal(conf_tp, conf_g)}")
        if launches["tp_evaluate"] != 1 or d_loss > 1e-6 or not torch.equal(conf_tp, conf_g):
            fail("[25] tensor-parallel evaluation differs from the gathered model's")

        def step_ms(m_mesh):
            """ms of one train_step (median of 3 synced, after a warm-up)."""
            m = fresh(m_mesh)
            opt = train_lib.make_optimizer(m, cfg)
            feats, labels, mask = steps[0]

            def step():
                return train_lib.train_step(m, opt, None, None, cfg, None,
                                            windows=(feats, labels), dropout_mask=mask,
                                            mesh=m_mesh)

            wall(step)
            return statistics.median(wall(step)[0] for _ in range(3)) * 1e3

        ms = {"unsharded": step_ms(None), **{what: step_ms(t) for what, t in tp_forms.items()}}
        print(f"    train_step ms at batch {cfg.batch_size}, lower, {smi} (median of 3 synced): "
              + ", ".join(f"{what} {t:.3f}" for what, t in ms.items()))

        # the physics and kinematic batches with the mesh, against without
        phys_cfg = collocation.SolveConfig(1, 1, 1, 1, lm=LMConfig(3, 10, 1e-2))
        batched, _ = phys_batch.pad_phys_inputs([walking_input(24, seed=i) for i in range(2)],
                                                device=dev)
        t_p1, a = wall(lambda: phys_batch.solve_physics_full_batch(batched, PhysWeights(),
                                                                   phys_cfg))
        t_p2, b = wall(lambda: phys_batch.solve_physics_full_batch(batched, PhysWeights(),
                                                                   phys_cfg, mesh=mesh))
        phys_same = (all(torch.equal(x, y) for ra, rb in zip(a[:3], b[:3])
                         for x, y in zip(ra, rb))
                     and all(torch.equal(a[3][k], b[3][k]) for k in a[3])
                     and np.array_equal(a[4], b[4]))
        skel = golden_skeleton(np.load(TRAJ_GOLDEN))
        rng = np.random.default_rng(25)
        problems = [kin_problem(rng, skel, 24) for _ in range(2)]
        kin_kw = dict(ik_iterations=20, lm_cfg=LMConfig(5, 15), device=dev)
        t_k1, ka = wall(lambda: kin_batch.optimize_trajectory_batch(problems, skel, **kin_kw))
        t_k2, kb = wall(lambda: kin_batch.optimize_trajectory_batch(problems, skel, mesh=mesh,
                                                                    **kin_kw))
        kin_same = all(np.array_equal(x.pose3d, y.pose3d)
                       and np.array_equal(x.vel_constraints, y.vel_constraints)
                       and np.array_equal(x.floor_normal, y.floor_normal)
                       for x, y in zip(ka, kb))
        print(f"    solve_physics_full_batch of 2 x 24 frames (LM 3:10, CUDA graphs) with the "
              f"mesh: bitwise equal to the call without it {phys_same} ({t_p2:.2f} s against "
              f"{t_p1:.2f} s); optimize_trajectory_batch of 2 x 24 frames (IK 20, LM 5:15) with "
              f"the mesh: equal {kin_same} ({t_k2:.2f} s against {t_k1:.2f} s)")
        if not (phys_same and kin_same):
            fail("[25] a batch solved over the mesh differs from the unsharded call")
    finally:
        dist.destroy_process_group()

    # the multi-rank dry run: one NCCL rank here, every card where there are more
    t, line = wall(lambda: dryrun_multichip(1, "cuda"))
    print(f"    dryrun_multichip(1, \"cuda\") in a spawned rank: {t:.1f} s")
    count = torch.cuda.device_count()
    if count >= 2:
        t, line = wall(lambda: dryrun_multichip(min(count, 4), "cuda"))
        print(f"    dryrun_multichip({min(count, 4)}, \"cuda\"): {t:.1f} s")
    else:
        print(f"    the multi-card dry run did not run: torch sees {count} card (NCCL "
              "takes one rank a card, so two ranks need two)")

    # the single-process form: n frame shards on this card
    mesh4 = mesh_lib.local_mesh(LONG_SHARDS, device=dev)
    g = np.load(TRAJ_GOLDEN)
    t_g, (_, gates) = wall(lambda: trajectory_golden_gates(g, dev, mesh=mesh4,
                                                           lm=SHARD_GOLDEN_LM))
    print(f"    trajectory golden with both LM stages frame-sharded {LONG_SHARDS} ways in one "
          f"process (F={g['pose2d'].shape[0]}, {g['pose2d'].shape[0] // LONG_SHARDS} frames a "
          f"shard, IK 200 LU, LM {SHARD_GOLDEN_LM[0]}:{SHARD_GOLDEN_LM[1]} eager, cut from "
          f"50:100): {t_g:.2f} s; floor cos {gates['cos']:.6f} "
          f"(> 0.9994), offset {gates['offset']:.3f} cm (< 2), contacts equal "
          f"{gates['contacts_equal']}, joint error mean {gates['mean_err']:.3f} / median "
          f"{gates['median_err']:.3f} cm (< 2), reprojection median {gates['median_px']:.2f} "
          f"px (< {gates['px_bound']:.2f}), stage-2 objective {gates['cost']:.1f} vs the "
          f"golden's {gates['golden_cost']:.1f} (<= x1.001)")
    if not golden_gates_pass(gates):
        fail(f"[25] the trajectory golden's gates failed frame-sharded: {gates}")

    skel = golden_skeleton(g)
    parents = tuple(skel.parents)
    F, D = LONG_F, 3 + 3 * len(parents)
    prob = kin_problem(np.random.default_rng(26), skel, F)
    arrs, _ = kin_batch.prepare_batch_arrays([prob], skel, device=dev)
    consts = kin_batch.BatchConsts(parents, F, IKConfig(iterations=1), dev, torch.float32)
    x0 = kin_batch.initial_x(arrs["rot0"], arrs["pos0"])
    normal = torch.tensor([[0.0, -1.0, 0.0]], device=dev)
    point = torch.tensor([[0.0, 95.0, 0.0]], device=dev)
    data = kin_batch.make_data(arrs, consts, arrs["vc"], normal, point)
    w = traj_lib.STAGE2
    torch.cuda.reset_peak_memory_stats()
    t_sh, (c_sh, g_sh, d_sh) = wall(lambda: longseq.probe_grad_diag(
        x0.reshape(F, D), data, w, parents, mesh4))
    mem_sh = torch.cuda.max_memory_allocated()

    def unsharded_probe():
        r, vjp_fn = torch.func.vjp(lambda x: consts.layout.residual(x, data, w), x0)
        _, lin = torch.func.vjp(lambda cot: vjp_fn(cot)[0], torch.zeros_like(r))
        masks = frame_coloring_masks(F, D, device=dev)
        diag = torch.func.vmap(lambda m: m * vjp_fn(lin(m)[0])[0])(masks[:, None]).sum(0)
        return 0.5 * (r * r).sum(), vjp_fn(r)[0].reshape(F, D), diag.reshape(F, D)

    torch.cuda.reset_peak_memory_stats()
    t_un, (c_un, g_un, d_un) = wall(unsharded_probe)
    mem_un = torch.cuda.max_memory_allocated()
    rel = {"cost": abs(float(c_sh) - float(c_un)) / abs(float(c_un)),
           "grad": float((g_sh - g_un).abs().max() / g_un.abs().max()),
           "diag": float((d_sh - d_un).abs().max() / d_un.abs().max())}
    print(f"    long clip, F={F} ({F / 30:.0f} s at 30 fps), 28 joints, float32: the probe "
          f"frame-sharded "
          f"{LONG_SHARDS} ways ({t_sh:.2f} s, {mem_sh / 2**30:.2f} GiB at peak) against the "
          f"unsharded one ({t_un:.2f} s, {mem_un / 2**30:.2f} GiB): relative max|d| cost "
          f"{rel['cost']:.3e}, Jᵀr {rel['grad']:.3e}, diag {rel['diag']:.3e} (each <= "
          f"{LONG_PROBE_REL})")
    if not all(v <= LONG_PROBE_REL for v in rel.values()):
        fail(f"[25] the long clip's sharded probe differs from the unsharded one: {rel}")

    stamps = [("start", time.perf_counter())]

    def hook(name):
        torch.cuda.synchronize()
        stamps.append((name, time.perf_counter()))

    torch.cuda.reset_peak_memory_stats()
    res = longseq.optimize_trajectory_frame_sharded(
        prob["pose2d"], prob["conf2d"], prob["pose3d"], prob["root_pos"], prob["smpl_angles"],
        skel, prob["vel_constraints"], mesh4, ik_iterations=LONG_IK,
        lm_cfg=LMConfig(*LONG_LM), stage_hook=hook)
    peak = torch.cuda.max_memory_allocated()
    per_stage = ", ".join(f"{name} {t - stamps[i][1]:.2f} s"
                          for i, (name, t) in enumerate(stamps[1:]))
    ok = (res.pose3d.shape == (F, 28, 3) and np.isfinite(res.pose3d).all()
          and res.refined_contacts.shape == (F, 4))
    print(f"    its refinement frame-sharded {LONG_SHARDS} ways (cut from IK 200, LM 50:100 to "
          f"IK {LONG_IK} LU, LM {LONG_LM[0]}:{LONG_LM[1]} a stage, eager): {per_stage}; "
          f"{stamps[-1][1] - stamps[0][1]:.2f} s in all, {peak / 2**30:.2f} GiB at peak; "
          f"finite joints of the clip's shape {ok}")
    if not ok:
        fail("[25] the long clip's sharded refinement is not finite or of the wrong shape")
    print(f"    [25] took {time.perf_counter() - t_phase:.1f} s")
    return launches


def _t(a):
    import torch

    return torch.as_tensor(np.asarray(a.cpu() if hasattr(a, "cpu") else a), dtype=torch.float64)


def _np_res(r) -> np.ndarray:
    return np.concatenate([np.asarray(r.base_lin).ravel(), np.asarray(r.ee_pos).ravel(),
                           np.asarray(r.ee_force).ravel()])


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this needs one CUDA card")
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

    entry = contact_phases(torch, dev, smi)
    entry["mode"] = "high"
    pcg = kinematic_phases(torch, dev, smi)
    phys_launches = physics_phases(torch, dev, smi)
    banded_phase(torch, dev, smi, pcg)
    modes = precision_phase(torch, dev, smi)
    library_phase(torch, dev)
    host_layer_phase(torch, dev, smi)
    entry["launches_by_path"].update(parallel_phase(torch, dev, smi))
    jtjv_entries = jtjv_phase(torch, dev, smi, pcg["jtjv_launches"])
    jtjv_entries += phys_jtjv_phase(torch, dev, smi, phys_launches)

    if "jax" in sys.modules or any(m.split(".")[0] == "chd_tpu" for m in sys.modules):
        fail("jax or chd_tpu was imported")
    print(json.dumps({"kernels": [entry] + modes + jtjv_entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
