"""Command-line interface: ``python -m chd_tpu_torch.pipeline <command>``
(port of chd_tpu/pipeline/cli.py).

Only ``detect-contacts`` is ported so far: foot-contact detection over a
directory of video dirs, each with an ``openpose_result/``, writing
``foot_contacts.npy`` into each. ``--device`` names the device and defaults
to ``cuda``, which raises where CUDA is absent.
"""
from __future__ import annotations

import argparse

# host-only helpers, shared with chd_tpu's CLI (that module imports no jax)
from chd_tpu.pipeline.cli import _add_config_args, _load_config, _video_dirs


def main(argv=None):
    parser = argparse.ArgumentParser(prog="chd_tpu_torch", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("detect-contacts", help="foot-contact detection over video dirs")
    p.add_argument("--data", required=True)
    p.add_argument("--weights", required=True, help=".npz (converted) or .pth weights")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    _add_config_args(p)

    args = parser.parse_args(argv)
    from ..contact.infer import detect_contacts
    from ..models import torch_convert

    cfg = _load_config(args)
    if args.weights.endswith(".pth"):
        model = torch_convert.load_pth(args.weights)
    else:
        model = torch_convert.load_npz(args.weights)
    dirs = _video_dirs(args.data)
    results = detect_contacts(dirs, model, device=args.device,
                              image_dims=tuple(cfg.image_dims))
    for d, r in zip(dirs, results):
        print(f"{d}: {r.shape[0]} frames, contact rate {r.mean():.3f}")
    return 0
