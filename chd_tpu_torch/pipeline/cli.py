"""Command-line interface: ``python -m chd_tpu_torch.pipeline <command>``
(port of chd_tpu/pipeline/cli.py).

Ported so far:
- ``detect-contacts``: foot-contact detection over a directory of video
  dirs, each with an ``openpose_result/``, writing ``foot_contacts.npy``
  into each;
- ``kinematic``: the kinematic optimization of one video dir, writing
  ``kinematic_results/{final_test.bvh, floor_out.txt, foot_contacts.npy}``;
- ``retarget``: a combined-skeleton BVH onto a Mixamo character;
- ``physics``: the physics stage of one video dir, writing
  ``phys_optim_in_<char>/`` and ``phys_optim_out_<char>/``;
- ``run``: kinematic, retargeting and physics for every video dir of a
  data dir;
- ``train-contacts``: contact-model training on the synthetic dataset,
  writing ``contact_weights.npz``, ``_BEST.npz`` and ``_FINAL.npz``;
- ``eval-contacts``: its evaluation, writing ``eval_results.json`` and, with
  ``--full-video``, ``merged_predictions.npy``;
- ``openpose`` and ``totalcap``: the external OpenPose and MTC binaries per
  video dir (``pipeline/external.py``);
- ``make-structure``: a directory of mp4s into a directory of video dirs;
- ``config``: the default ``PipelineConfig`` as JSON.
The files are ``chd_tpu``'s. ``--device`` names the device of the commands
that compute and defaults to ``cuda``, which raises where CUDA is absent;
the last four are host code and take no device. Started by ``torchrun
--nproc-per-node N``, a command that computes joins the process group
(``parallel.distributed.initialize``), each rank on its own card: the
kinematic stage shards one sequence of ``kinematic.frame_shard_threshold``
frames or more over the ranks, ``train-contacts`` takes data-parallel steps
over them (its batches must divide over the ranks), and the rest runs on
rank 0 alone while the others wait for it. Rank 0 alone writes files and
prints.
"""
from __future__ import annotations

import argparse
import json
import os


def _add_config_args(p):
    p.add_argument("--config", help="JSON config file (PipelineConfig)")
    p.add_argument(
        "--set", nargs="*", default=[], metavar="KEY=VALUE",
        help="dotted config overrides, e.g. physics.w_ee=0.5",
    )


def _load_config(args):
    from ..utils.config import PipelineConfig

    if args.config:
        with open(args.config) as f:
            cfg = PipelineConfig.from_json(f.read())
    else:
        cfg = PipelineConfig()
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v
    if getattr(args, "character", None):
        overrides["character"] = args.character
    if getattr(args, "skel_path", None):
        overrides["kinematic.skel_path"] = args.skel_path
    return cfg.override(**overrides) if overrides else cfg


def _video_dirs(data_path):
    return sorted(
        os.path.join(data_path, f)
        for f in os.listdir(data_path)
        if os.path.isdir(os.path.join(data_path, f)) and not f.startswith(".")
    )


def _add_device_arg(p):
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="chd_tpu_torch", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("detect-contacts", help="foot-contact detection over video dirs")
    p.add_argument("--data", required=True)
    p.add_argument("--weights", required=True, help=".npz (converted) or .pth weights")
    _add_device_arg(p)
    _add_config_args(p)

    p = sub.add_parser("kinematic", help="kinematic optimization for one video dir")
    p.add_argument("--video-dir", required=True)
    p.add_argument("--skel-path", dest="skel_path", required=True)
    p.add_argument("--character", default="ybot")
    _add_device_arg(p)
    _add_config_args(p)

    p = sub.add_parser("retarget", help="retarget final_test.bvh onto a character")
    p.add_argument("--src-bvh", required=True)
    p.add_argument("--out-bvh", required=True)
    p.add_argument("--character", default="ybot")
    p.add_argument("--char-bvh", required=True, help="character template BVH")
    _add_device_arg(p)

    p = sub.add_parser("physics", help="physics optimization for one video dir")
    p.add_argument("--video-dir", required=True)
    p.add_argument("--character", default="ybot")
    _add_device_arg(p)
    _add_config_args(p)

    p = sub.add_parser("run", help="full pipeline over a data dir of video dirs")
    p.add_argument("--data", required=True)
    p.add_argument("--character", default="ybot")
    p.add_argument("--skel-path", dest="skel_path", required=True)
    p.add_argument("--char-bvh", help="character template BVH (non-combined)")
    _add_device_arg(p)
    _add_config_args(p)

    p = sub.add_parser("train-contacts", help="train the contact model")
    p.add_argument("--data", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--epochs", type=int, default=5000)
    p.add_argument("--batch-size", type=int, default=64)
    _add_device_arg(p)

    p = sub.add_parser("eval-contacts",
                       help="evaluate the contact model on the synthetic dataset")
    p.add_argument("--data", required=True)
    p.add_argument("--weights", required=True, help=".npz (converted) or .pth weights")
    p.add_argument("--out", help="directory for eval_results.json + merged_predictions.npy")
    p.add_argument("--split", default="test", choices=["train", "val", "test"])
    p.add_argument("--full-video", action="store_true", help="vote-merged full-video metrics")
    p.add_argument("--joint-set", default="lower")
    _add_device_arg(p)

    p = sub.add_parser("openpose", help="run the OpenPose binary per video dir")
    p.add_argument("--data", required=True)
    p.add_argument("--openpose", required=True, help="OpenPose root (with build/)")
    p.add_argument("--hands", action="store_true")
    p.add_argument("--face", action="store_true")
    p.add_argument("--save-video", action="store_true")

    p = sub.add_parser("totalcap", help="run MonocularTotalCapture per video dir")
    p.add_argument("--data", required=True)
    p.add_argument("--totalcap", required=True, help="MTC fork root")

    p = sub.add_parser("make-structure", help="dir of mp4s → dir of video dirs")
    p.add_argument("--data", required=True)
    p.add_argument("--out", required=True)

    sub.add_parser("config", help="print the default config JSON")

    args = parser.parse_args(argv)

    if args.cmd == "config":
        from ..utils.config import PipelineConfig

        print(PipelineConfig().to_json())
        return 0

    if args.cmd == "make-structure":
        from .structure import create_optim_data_structure

        print("\n".join(create_optim_data_structure(args.data, args.out)))
        return 0

    if args.cmd == "openpose":
        from .external import run_openpose

        run_openpose(_video_dirs(args.data), args.openpose, hands=args.hands, face=args.face,
                     save_video=args.save_video)
        return 0

    if args.cmd == "totalcap":
        from .external import run_totalcap

        run_totalcap(_video_dirs(args.data), args.totalcap)
        return 0

    from ..models import torch_convert
    from ..parallel import distributed
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    distributed.initialize(device)  # joins torchrun's group; a no-op without one
    say = print if distributed.is_primary() else (lambda *a, **k: None)

    if args.cmd == "detect-contacts":
        from ..contact.infer import detect_contacts

        cfg = _load_config(args)
        model = torch_convert.load_weights(args.weights)
        dirs = _video_dirs(args.data)
        results = distributed.on_primary(detect_contacts, dirs, model, device=device,
                                         image_dims=tuple(cfg.image_dims))
        for d, r in zip(dirs, results):
            say(f"{d}: {r.shape[0]} frames, contact rate {r.mean():.3f}")
        return 0

    if args.cmd == "kinematic":
        from .run import run_kinematic_stage

        say(run_kinematic_stage(args.video_dir, _load_config(args), device=device))
        return 0

    if args.cmd == "retarget":
        from ..core import bvh
        from ..retarget.mixamo import retarget

        def run_retarget():
            src, _, _ = bvh.load(args.src_bvh)
            retarget(src, args.character, args.char_bvh, out_bvh=args.out_bvh, device=device)

        distributed.on_primary(run_retarget)
        say(args.out_bvh)
        return 0

    if args.cmd == "physics":
        from .run import run_physics_stage

        say(json.dumps(run_physics_stage(args.video_dir, _load_config(args), device=device)))
        return 0

    if args.cmd == "run":
        from .run import run_pipeline

        cfg = _load_config(args)
        for vd in _video_dirs(args.data):
            say(f"=== {vd} ===")
            res = run_pipeline(vd, cfg, char_skel_bvh=args.char_bvh, device=device)
            say(json.dumps(res["stats"]))
        return 0

    from ..contact.data import ContactDataset
    from ..contact.train import TrainConfig

    ds = ContactDataset.load(args.data, device=device)

    if args.cmd == "train-contacts":
        from ..contact.train import train
        from ..parallel import mesh as mesh_lib

        os.makedirs(args.out, exist_ok=True)
        # data-parallel over the ranks; rank 0 alone writes the weights
        train(ds, TrainConfig(epochs=args.epochs, batch_size=args.batch_size), out_dir=args.out,
              verbose=distributed.is_primary(),
              mesh=mesh_lib.make_mesh() if distributed.multi_rank() else None)
        return 0

    import numpy as np

    from ..contact import evaluate

    def run_eval():
        model = torch_convert.load_weights(args.weights).to(device)
        cfg = TrainConfig(joint_set=args.joint_set)
        if args.full_video:
            res = evaluate.evaluate_full_video(model, ds, args.split, cfg)
        else:
            res = evaluate.evaluate_windows(model, ds, args.split, cfg)
        merged_pred = res.pop("merged_predictions", None)
        print(json.dumps(res, indent=2))
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "eval_results.json"), "w") as f:
                json.dump(res, f, indent=2)
            if merged_pred is not None:
                np.save(os.path.join(args.out, "merged_predictions.npy"), merged_pred)

    distributed.on_primary(run_eval)
    return 0
