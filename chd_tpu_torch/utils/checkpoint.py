"""Training-state checkpoints (port of chd_tpu/utils/checkpoint.py).

``chd_tpu`` saves its full training state through Orbax; here it is one
``torch.save`` file: the step, the model's ``state_dict`` (BN running
statistics and counters included), the optimizer's state and the random
generator's state, so a resumed run takes the same next step as one that
never stopped. Weight-only artifacts are ``models.torch_convert.save_npz``.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch


def save_train_state(path: str, step: int, model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer, generator: torch.Generator) -> None:
    torch.save({"step": step, "model": model.state_dict(),
                "optimizer": optimizer.state_dict(), "generator": generator.get_state()},
               path)


def load_train_state(path: str) -> Optional[Dict[str, Any]]:
    """The saved state, its tensors on the devices they were saved from, or
    None where there is no file."""
    if not os.path.exists(path):
        return None
    return torch.load(path, weights_only=True)


def restore_train_state(ckpt: Dict[str, Any], model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer, generator: torch.Generator) -> int:
    """Load a ``load_train_state`` result into the three; returns its step."""
    model.load_state_dict(ckpt["model"])
    optimizer.load_state_dict(ckpt["optimizer"])
    generator.set_state(ckpt["generator"])
    return int(ckpt["step"])
