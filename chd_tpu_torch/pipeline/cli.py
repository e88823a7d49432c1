"""Command-line interface: ``python -m chd_tpu_torch.pipeline <command>``
(port of chd_tpu/pipeline/cli.py).

Ported so far:
- ``detect-contacts``: foot-contact detection over a directory of video
  dirs, each with an ``openpose_result/``, writing ``foot_contacts.npy``
  into each;
- ``train-contacts``: contact-model training on the synthetic dataset,
  writing ``contact_weights.npz``, ``_BEST.npz`` and ``_FINAL.npz``;
- ``eval-contacts``: its evaluation, writing ``eval_results.json`` and, with
  ``--full-video``, ``merged_predictions.npy``.
The files are ``chd_tpu``'s. ``--device`` names the device and defaults to
``cuda``, which raises where CUDA is absent.
"""
from __future__ import annotations

import argparse
import json
import os

# host-only helpers, shared with chd_tpu's CLI (that module imports no jax)
from chd_tpu.pipeline.cli import _add_config_args, _load_config, _video_dirs


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

    args = parser.parse_args(argv)
    from ..contact.infer import resolve_device
    from ..models import torch_convert

    device = resolve_device(args.device)

    if args.cmd == "detect-contacts":
        from ..contact.infer import detect_contacts

        cfg = _load_config(args)
        model = torch_convert.load_weights(args.weights)
        dirs = _video_dirs(args.data)
        results = detect_contacts(dirs, model, device=device, image_dims=tuple(cfg.image_dims))
        for d, r in zip(dirs, results):
            print(f"{d}: {r.shape[0]} frames, contact rate {r.mean():.3f}")
        return 0

    from ..contact.data import ContactDataset
    from ..contact.train import TrainConfig

    ds = ContactDataset.load(args.data, device=device)

    if args.cmd == "train-contacts":
        from ..contact.train import train

        os.makedirs(args.out, exist_ok=True)
        train(ds, TrainConfig(epochs=args.epochs, batch_size=args.batch_size), out_dir=args.out)
        return 0

    import numpy as np

    from ..contact import evaluate

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
    return 0
