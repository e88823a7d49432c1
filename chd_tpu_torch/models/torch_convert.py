"""Load contact-model weights into ``ContactMLP`` (port of
chd_tpu/models/torch_convert.py).

Three sources, all ending in the same module:
- a reference ``.pth`` ``state_dict``: its ``model.{0,1,3,4,6,7,10,11,13}.*``
  keys are ``ContactMLP``'s own, so it loads with no key mapping;
- the ``.npz`` that ``chd_tpu`` writes (``params.linear0.w``, ...,
  ``state.bn0.mean``, ...);
- ``chd_tpu``'s (params, state) pytrees as numpy arrays (``from_jax_params``),
  the carry-over the tests use to hand both packages the same weights.

``to_jax_params`` and ``save_npz`` go the other way: the ``.npz`` they write
is the one ``chd_tpu``'s ``load_npz`` reads, so weights trained by either
package run in the other.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from .contact_mlp import BN_IDX, LINEAR_IDX, ContactMLP


def from_state_dict(sd: Mapping[str, object]) -> ContactMLP:
    """A reference ``state_dict`` (tensors or arrays) → ``ContactMLP``.

    BatchNorm's ``num_batches_tracked`` counters, which eval never reads, may
    be absent; every other key must be present.
    """
    sd = {k: v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
          for k, v in sd.items()}
    w0 = sd[f"model.{LINEAR_IDX[0]}.weight"]
    w_last = sd[f"model.{LINEAR_IDX[-1]}.weight"]
    model = ContactMLP(in_dim=w0.shape[1], out_dim=w_last.shape[0])
    own = model.state_dict()
    for k, v in own.items():
        if k not in sd and k.endswith("num_batches_tracked"):
            sd[k] = v
    model.load_state_dict(sd, strict=True)
    return model.eval()


def from_jax_params(params: Dict, state: Dict) -> ContactMLP:
    """``chd_tpu`` (params, state) pytrees → ``ContactMLP``."""
    sd = {}
    for i, li in enumerate(LINEAR_IDX):
        sd[f"model.{li}.weight"] = params[f"linear{i}"]["w"]
        sd[f"model.{li}.bias"] = params[f"linear{i}"]["b"]
    for i, bi in enumerate(BN_IDX):
        sd[f"model.{bi}.weight"] = params[f"bn{i}"]["scale"]
        sd[f"model.{bi}.bias"] = params[f"bn{i}"]["bias"]
        sd[f"model.{bi}.running_mean"] = state[f"bn{i}"]["mean"]
        sd[f"model.{bi}.running_var"] = state[f"bn{i}"]["var"]
    return from_state_dict({k: np.array(v, np.float32) for k, v in sd.items()})


def to_jax_params(model: ContactMLP) -> Tuple[Dict, Dict]:
    """``ContactMLP`` → ``chd_tpu``'s (params, state) pytrees of float32
    numpy arrays (copies, on the host)."""
    def arr(t):
        return t.detach().to("cpu", torch.float32).numpy().copy()

    params: Dict = {}
    state: Dict = {}
    for i, lin in enumerate(model.linears()):
        params[f"linear{i}"] = {"w": arr(lin.weight), "b": arr(lin.bias)}
    for i, bn in enumerate(model.batchnorms()):
        params[f"bn{i}"] = {"scale": arr(bn.weight), "bias": arr(bn.bias)}
        state[f"bn{i}"] = {"mean": arr(bn.running_mean), "var": arr(bn.running_var)}
    return params, state


def save_npz(path: str, model: ContactMLP) -> None:
    """The ``params.<module>.<leaf>`` / ``state.<module>.<leaf>`` ``.npz`` of
    ``chd_tpu``'s ``save_npz``."""
    flat = {}
    for scope, tree in zip(("params", "state"), to_jax_params(model)):
        for mod, leaves in tree.items():
            for leaf, v in leaves.items():
                flat[f"{scope}.{mod}.{leaf}"] = v
    np.savez(path, **flat)


def load_pth(path: str) -> ContactMLP:
    """A reference ``.pth`` checkpoint (a ``state_dict``) → ``ContactMLP``."""
    return from_state_dict(torch.load(path, map_location="cpu", weights_only=True))


def load_weights(path: str) -> ContactMLP:
    """A ``.pth`` reference checkpoint, or else a ``chd_tpu`` ``.npz``."""
    return load_pth(path) if path.endswith(".pth") else load_npz(path)


def load_npz(path: str) -> ContactMLP:
    """The ``params.<module>.<leaf>`` / ``state.<module>.<leaf>`` ``.npz`` →
    ``ContactMLP``."""
    params: Dict = {}
    state: Dict = {}
    with np.load(path) as data:
        for key in data.files:
            scope, mod, leaf = key.split(".")
            tgt = params if scope == "params" else state
            tgt.setdefault(mod, {})[leaf] = data[key]
    return from_jax_params(params, state)

