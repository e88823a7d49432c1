"""Full-video foot-contact inference (port of chd_tpu/contact/infer.py).

Raw ``(V, F, 25, 3)`` OpenPose keypoints become ``(V, F, 4)`` binary
contacts on one device: gap-fill → normalize → window featurization and the
BN-folded MLP → sigmoid threshold → sliding-window vote merge. The MLP runs
through the hand-written kernel of ``ops.fused_mlp`` in both modes:

- ``use_conv=True`` (the default): the kernel reads each window's first-layer
  input straight out of the preprocessed frames through strides, with the
  featurization folded into the first weight (``windows.layer1_conv_kernel``);
  the window tensor is never materialized.
- ``use_conv=False``: ``windows.featurize_batch`` materializes every window
  and the kernel reads them as a dense batch.

Left out of ``chd_tpu``'s detector, on purpose:

- ``max_device_batch`` and ``_infer_batch_chunked``: they chunk the video
  axis to dodge a fault of the TPU v5e runtime at flat batches past ~768
  videos. Here the whole batch is one flat batch, and the tests hold the rows
  of one video equal between V=1 and V=21.
- ``use_pallas`` and its backend sniffing: the kernel is the MLP of every
  path, so there is nothing to select.

``precision`` (None or "default", "high", "highest") and ``mlp_dtype`` (None
or ``torch.bfloat16``) are chd_tpu's: on the card the kernel runs layers 0-2
on tensor cores in 1, 3 or 6 bf16 passes with float32 sums, or with bf16
storage in one pass (``ops.fused_mlp.mlp_mode``); on the CPU the plain
version runs full float32 in every precision, as chd_tpu's matmuls do
there, and the bf16 roundings of ``mlp_dtype``. Any other value raises.

``ContactDetector`` takes a ``ContactMLP`` where ``chd_tpu``'s takes the
(params, state) pytrees; ``models.torch_convert.from_jax_params`` converts.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..characters import defs
from ..ingest import openpose
from ..models import contact_mlp
from ..models.contact_mlp import ContactMLP
from ..ops import gapfill, voting, windows
from ..ops.fused_mlp import MlpLayers, fused_mlp, mlp_mode
from ..parallel import mesh as mesh_lib
from ..utils.device import resolve_device
from ..utils.profiling import span

# Constants matching training of the reference model
TRAIN_DIM = (1280, 720)
TRAIN_NORMALIZATION = 200.4160302695367  # median hip→toe pixels in training

Folded = Dict[str, List[torch.Tensor]]
Layers = List[Tuple[torch.Tensor, torch.Tensor]]
Mlp = Callable[..., torch.Tensor]


def subset_joints(joint_subset: Sequence[int]) -> Tuple[List[int], int, bool]:
    """(joints, root index in them, root appended?) for a model joint subset.

    Subsets lacking the root joint still normalize root-relative: the root is
    appended for featurization only and its column dropped from the model
    input, as the reference root-normalizes all 25 joints before subsetting.
    """
    joints = list(joint_subset)
    root_appended = defs.OP_ROOT_JOINT not in joints
    if root_appended:
        joints.append(defs.OP_ROOT_JOINT)
    return joints, joints.index(defs.OP_ROOT_JOINT), root_appended


def mlp_layers(folded: Folded, *, window_size: int, joint_subset: Sequence[int],
               use_confidence: bool, use_conv: bool, precision: Optional[str] = "high",
               mlp_dtype=None) -> MlpLayers:
    """BN-folded weights → the kernel's ``(in, out)`` layers in the mode of
    ``precision`` and ``mlp_dtype``, once per detector.

    In conv mode the first layer is ``windows.layer1_conv_kernel`` as
    ``(window_size * J * 3, out)``: featurization folded into the weight, so
    the kernel's strided rows over the preprocessed frames are its input.
    With bf16 storage the conv kernel is built in bf16 arithmetic from the
    bf16 weights, as chd_tpu builds it.
    """
    mode = mlp_mode(precision, mlp_dtype)
    layers = [(w.T.contiguous(), b) for w, b in zip(folded["w"], folded["b"])]
    if use_conv:
        joints, root_in_subset, root_appended = subset_joints(joint_subset)
        J = len(joints)
        w0 = folded["w"][0].to(torch.bfloat16) if mode == "bf16" else folded["w"][0]
        K = windows.layer1_conv_kernel(w0, window_size, J, root_in_subset,
                                       J - root_appended, use_confidence).float()
        layers[0] = (K.reshape(window_size * J * 3, -1), folded["b"][0])
    return MlpLayers(layers, mode)


def mlp_logits(x: torch.Tensor, layers: Layers, *, window_size: int,
               root_in_subset: int, root_appended: bool, use_confidence: bool,
               use_conv: bool, mlp: Mlp = fused_mlp) -> torch.Tensor:
    """Preprocessed subset keypoints x (V, F, J, 3) → (V * N, out) window
    logits, N = F - window_size + 1, through ``mlp`` (``fused_mlp`` or its
    plain version, same arguments) on the ``mlp_layers`` of the same mode."""
    V, F, J, _ = x.shape
    if F < window_size:
        raise ValueError(f"{F} frames are fewer than one {window_size}-frame window")
    if use_conv:
        return mlp(layers, x.reshape(V, F * J * 3), window_size * J * 3, J * 3)
    feats = windows.featurize_batch(x, window_size, root_in_subset, use_confidence)
    if root_appended:
        feats = feats[:, :, :, :-1, :]
    flat = feats.reshape(V * feats.shape[1], -1).contiguous()
    return mlp(layers, flat, flat.shape[1], flat.shape[1])


@torch.no_grad()
def _infer_batch(op_batch: torch.Tensor, layers: Layers, *, window_size: int,
                 pred_size: int, joint_subset: Tuple[int, ...],
                 use_confidence: bool, conf_thresh: float, normalization: float,
                 classify_thresh: float, use_conv: bool = True,
                 mlp: Mlp = fused_mlp) -> Tuple[torch.Tensor, torch.Tensor]:
    """(V, F, 25, 3) float32 → ((V, F, 4) int32 contacts, (V, N, P, 4) probs),
    with ``layers`` from ``mlp_layers`` of the same keyword arguments, which
    carry the precision mode.

    Gap-fill runs on the subset joints only: the other joints never feed
    the model. The three steps are spans: ``detect.gapfill`` (the joint
    subset, gap-fill and normalization), ``detect.mlp`` (the kernel's
    logits) and ``detect.vote`` (sigmoid, threshold and the vote merge).
    """
    V, F = op_batch.shape[:2]
    joints, root_in_subset, root_appended = subset_joints(joint_subset)
    with span("detect.gapfill"):
        idx = torch.tensor(joints, device=op_batch.device)
        x = gapfill.preprocess_keypoints(op_batch[:, :, idx], conf_thresh, normalization)
    with span("detect.mlp"):
        logits = mlp_logits(x, layers, window_size=window_size,
                            root_in_subset=root_in_subset, root_appended=root_appended,
                            use_confidence=use_confidence, use_conv=use_conv, mlp=mlp)
    with span("detect.vote"):
        probs = torch.sigmoid(logits).reshape(V, F - window_size + 1, pred_size, 4)
        preds = (probs > classify_thresh).to(torch.float32)
        return voting.merge_votes_batch(preds, window_size), probs


class ContactDetector:
    """BN-folded contact weights on one device, and the inference entry points.

    ``kw`` holds the keyword arguments of ``_infer_batch`` this detector runs
    with; ``layers`` the kernel's layers for them (``mlp_layers``) on
    ``device``, built here once and packed for the kernel at the first call,
    so that a call only launches kernels.
    """

    def __init__(
        self,
        model: ContactMLP,
        *,
        device,
        window_size: int = 9,
        pred_size: int = 5,
        joint_set: str = "lower",
        use_confidence: bool = True,
        conf_thresh: float = 0.2,
        normalization: float = TRAIN_NORMALIZATION,
        classify_thresh: float = 0.5,
        use_conv: bool = True,
        precision: Optional[str] = "high",
        mlp_dtype=None,
    ):
        if window_size % 2 == 0:  # must be odd, as the reference coerces it
            window_size += 1
        self.device = resolve_device(device)
        folded = {k: [t.to(self.device, torch.float32) for t in v]
                  for k, v in contact_mlp.fold_batchnorm(model).items()}
        self.kw = dict(
            window_size=window_size,
            pred_size=pred_size,
            joint_subset=tuple(defs.OP_JOINT_SUBSETS[joint_set]),
            use_confidence=use_confidence,
            conf_thresh=conf_thresh,
            normalization=normalization,
            classify_thresh=classify_thresh,
            use_conv=use_conv,
        )
        self.layers = mlp_layers(folded, window_size=window_size,
                                 joint_subset=self.kw["joint_subset"],
                                 use_confidence=use_confidence, use_conv=use_conv,
                                 precision=precision, mlp_dtype=mlp_dtype)

    def infer(self, op_batch: torch.Tensor, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(V, F, 25, 3) tensor → ((V, F, 4) contacts, (V, N, P, 4) probs),
        both on the detector's device. With ``mesh`` (``parallel.mesh``, on
        the detector's device) each rank runs its contiguous slice of the
        videos (V must divide over the mesh's batch shards), and so the
        kernel, and the results are gathered to every rank. A call is the
        span ``detect.infer`` (attributes ``V``, ``F``) over
        ``_infer_batch``'s."""
        with span("detect.infer", V=op_batch.shape[0], F=op_batch.shape[1]):
            x = op_batch.to(self.device, torch.float32)
            if mesh is None:
                return _infer_batch(x, self.layers, **self.kw)
            local = mesh_lib.shard_batch(mesh, x)
            return mesh_lib.gather(mesh, _infer_batch(local, self.layers, **self.kw))

    def detect(self, op_data: np.ndarray, seq_len: Optional[int] = None) -> np.ndarray:
        """Single video (F, 25, 3) → (seq_len, 4) int contacts."""
        contacts, _ = self.infer(torch.as_tensor(np.asarray(op_data, np.float32))[None])
        contacts = contacts[0].cpu().numpy()
        return contacts[: seq_len if seq_len is not None else len(contacts)]

    def detect_batch(self, op_batch: np.ndarray, seq_lens: Optional[Sequence[int]] = None,
                     mesh=None) -> list:
        """(B, F, 25, 3) padded batch → list of (len_i, 4) contacts (over
        ``mesh``'s ranks where given, as ``infer``)."""
        contacts, _ = self.infer(torch.as_tensor(np.asarray(op_batch, np.float32)), mesh=mesh)
        contacts = contacts.cpu().numpy()
        if seq_lens is None:
            return list(contacts)
        return [c[:n] for c, n in zip(contacts, seq_lens)]


def pad_to_length(arrs: Sequence[np.ndarray], length: Optional[int] = None):
    """Pad each (F_i, ...) array to the max length by repeating the last frame
    (reference fix_data_len)."""
    if length is None:
        length = max(a.shape[0] for a in arrs)
    out = []
    for a in arrs:
        if a.shape[0] >= length:
            out.append(a[:length])
        else:
            pad = np.repeat(a[-1:], length - a.shape[0], axis=0)
            out.append(np.concatenate([a, pad], axis=0))
    return np.stack(out, axis=0), length


def detect_contacts(
    video_dirs: Sequence[str],
    model: ContactMLP,
    *,
    device,
    image_dims=(1920, 1080),
    save: bool = True,
    **detector_kw,
) -> list:
    """End-to-end contact detection over video directories.

    Reads each dir's ``openpose_result``, rescales pixels to the training
    resolution, batches all videos padded to the longest, and writes
    ``foot_contacts.npy`` per video dir.
    """
    det = ContactDetector(model, device=device, **detector_kw)
    scale_w = float(TRAIN_DIM[0]) / image_dims[0]
    scale_h = float(TRAIN_DIM[1]) / image_dims[1]
    if abs(scale_w - scale_h) > 1e-5:
        raise ValueError("videos must match the training aspect ratio")

    data, lens = [], []
    for vd in video_dirs:
        kp = openpose.load_keypoint_dir(os.path.join(vd, "openpose_result"))
        if kp is None:
            raise FileNotFoundError(f"no openpose_result under {vd}")
        kp = kp.copy()
        kp[..., :2] *= scale_w  # x/y only; confidence stays as detected
        data.append(kp)
        lens.append(kp.shape[0])

    batch, _ = pad_to_length(data)
    results = det.detect_batch(batch, lens)
    if save:
        for vd, contacts in zip(video_dirs, results):
            np.save(os.path.join(vd, "foot_contacts.npy"), contacts)
    return results
