"""The contact detector's ``precision`` and ``mlp_dtype`` (chd_tpu's
``contact/infer.py``) on the CPU, and the fused-MLP kernel's four modes
through their CPU emulation and weight packing.

On the CPU the port's plain MLP runs full float32 in every precision, as
chd_tpu's matmuls do there, and the bf16 storage roundings of
``mlp_dtype=bfloat16`` in plain torch. Tolerances:
- the detector at each precision against chd_tpu's ``_infer_batch`` at the
  same precision: window probabilities within 1e-5 and contacts equal on the
  frames stable under a ±1e-3 threshold move (tests/test_torch_contact_infer.py's
  bounds);
- with bf16 storage: probabilities within 8e-3, about two bf16 roundings of
  a logit of magnitude 4 (read: 1.5e-3; XLA's bf16 conv sums in another
  order, so a few hidden values round to the neighbouring bf16), and the
  same stable contacts;
- the 6-pass emulation (``"highest"``) within 1e-5 of a float64 chain at the
  golden weights (read: 6.3e-7), and within tests/test_pallas_mlp.py's
  atol 2e-4, rtol 1e-4 of chd_tpu's Pallas kernel in interpret mode;
- the golden contacts through each mode's emulation: agreement >= 0.999 for
  "high" and "highest"; for the single-pass modes ("default", bf16 storage)
  binary agreement >= 0.99 with "high" (chd_tpu measured bf16 storage
  flipping 0.37 % of synthetic labels on its TPU);
- the packed weight stream of 1 and 3 parts: the split parts exactly;
- ``single_pass_gate``, the card's check of the single-pass modes: each
  mode's emulation with float64 sums (another order, the roundings of the
  kernel's) passes it, its controls fail, and every other mode's emulation
  fails it.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chd_tpu.characters.defs import OP_JOINT_SUBSETS
from chd_tpu.contact import infer as jax_infer
from chd_tpu.models import contact_mlp as jax_mlp
from chd_tpu.ops.pallas_mlp import fused_mlp as pallas_fused_mlp
from chd_tpu_torch.contact import infer
from chd_tpu_torch.models import contact_mlp, torch_convert
from chd_tpu_torch.ops import fused_mlp as fm
from chd_tpu_torch.ops import gapfill
from test_torch_contact_infer import _keypoints, _stable, _write_video_dirs
from test_torch_contact_mlp import golden_state_dict, random_params
from test_torch_fused_mlp import _as_f32, _folded, _layers, _walk_stream

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
W, P = 9, 5
PRECISIONS = [None, "default", "high", "highest"]


def _pair(joint_set, use_conv, precision, bf16):
    """(port probs, port contacts, chd_tpu probs, chd_tpu contacts) on seeded
    keypoints and weights."""
    subset = tuple(OP_JOINT_SUBSETS[joint_set])
    params, state = random_params(np.random.default_rng(0), in_dim=W * len(subset) * 3)
    kp = _keypoints(np.random.default_rng(1), 3, 50)
    kw = dict(window_size=W, pred_size=P, joint_subset=subset, use_confidence=True,
              conf_thresh=0.2, normalization=jax_infer.TRAIN_NORMALIZATION,
              classify_thresh=0.5, use_conv=use_conv)
    c_want, p_want = jax.jit(functools.partial(
        jax_infer._infer_batch, precision=precision,
        mlp_dtype=jnp.bfloat16 if bf16 else None, **kw))(
        jnp.asarray(kp), jax_mlp.fold_batchnorm(params, state))
    det = infer.ContactDetector(torch_convert.from_jax_params(params, state), device="cpu",
                                joint_set=joint_set, use_conv=use_conv, precision=precision,
                                mlp_dtype=torch.bfloat16 if bf16 else None)
    c_got, p_got = det.infer(torch.from_numpy(kp))
    return p_got, c_got, np.asarray(p_want, np.float32), np.asarray(c_want)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_detector_at_each_precision_matches_jax(precision):
    p_got, c_got, p_want, c_want = _pair("lower", True, precision, False)
    np.testing.assert_allclose(p_got.numpy(), p_want, atol=1e-5)
    stable = _stable(p_got)
    assert stable.mean() > 0.95
    np.testing.assert_array_equal(np.where(stable, c_got.numpy(), 0),
                                  np.where(stable, c_want, 0))


@pytest.mark.parametrize("use_conv", [True, False])
@pytest.mark.parametrize("joint_set", ["lower", "lower_ankles", "full"])
def test_bf16_storage_matches_jax(joint_set, use_conv):
    p_got, c_got, p_want, c_want = _pair(joint_set, use_conv, "high", True)
    np.testing.assert_allclose(p_got.numpy(), p_want, atol=8e-3, rtol=0)
    stable = _stable(p_got)
    assert stable.mean() > 0.95
    np.testing.assert_array_equal(np.where(stable, c_got.numpy(), 0),
                                  np.where(stable, c_want, 0))


def test_modes_and_their_rejections():
    assert [fm.mlp_mode(p) for p in PRECISIONS] == ["default", "default", "high", "highest"]
    assert fm.mlp_mode("highest", torch.bfloat16) == "bf16"
    with pytest.raises(ValueError, match="precision"):
        fm.mlp_mode("fastest")
    with pytest.raises(ValueError, match="mlp_dtype"):
        fm.mlp_mode("high", torch.float16)
    with pytest.raises(ValueError, match="mode"):
        fm.MlpLayers([], mode="tf32")
    model = torch_convert.from_state_dict(golden_state_dict())
    with pytest.raises(ValueError, match="precision"):
        infer.ContactDetector(model, device="cpu", precision="HIGH")
    det = infer.ContactDetector(model, device="cpu", precision="highest")
    assert det.layers.mode == "highest"
    kp = torch.from_numpy(_keypoints(np.random.default_rng(2), 1, 20))
    # the layers carry the mode: a call cannot ask for another one
    with pytest.raises(TypeError, match="precision"):
        infer._infer_batch(kp, det.layers, **dict(det.kw, precision="high"))
    with pytest.raises(ValueError, match="passes"):
        fm.fused_mlp_split_plain(det.layers, torch.zeros((1, 351)), 351, 351, passes=2)


def test_bf16_layers_are_rounded():
    model = torch_convert.from_state_dict(golden_state_dict())
    det = infer.ContactDetector(model, device="cpu", mlp_dtype=torch.bfloat16)
    assert det.layers.mode == "bf16"
    for w, b in det.layers:
        assert w.dtype == b.dtype == torch.float32
        assert torch.equal(w, w.to(torch.bfloat16).float())
        assert torch.equal(b, b.to(torch.bfloat16).float())


def test_split_bf16_three_parts_reconstruct_x():
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.normal(size=10000) * 10.0 ** rng.uniform(-6, 6, 10000))
                         .astype(np.float32))
    a1, a2, a3 = fm.split_bf16(x, 3)
    assert torch.equal(a1, x.to(torch.bfloat16))
    assert fm.split_bf16(x)[1].equal(a2)  # the 2-part split is its first two parts
    err = (a1.double() + a2.double() + a3.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -24 * x.double().abs()).all())


def test_six_pass_emulation_against_float64_and_pallas():
    folded = contact_mlp.fold_batchnorm(torch_convert.from_state_dict(golden_state_dict()))
    layers = _layers(folded)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4096, 351)).astype(np.float32))
    got = fm.fused_mlp_split_plain(layers, x, 351, 351, passes=6)
    want = fm.fused_mlp_plain([(w.double(), b.double()) for w, b in layers], x.double(), 351, 351)
    assert (got.double() - want).abs().max().item() <= 1e-5

    params, state = random_params(np.random.default_rng(0))
    jf = jax_mlp.fold_batchnorm(*[{k: {leaf: jnp.asarray(v) for leaf, v in d.items()}
                                   for k, d in t.items()} for t in (params, state)])
    xs = np.random.default_rng(65).normal(size=(65, 351)).astype(np.float32)
    pallas = np.asarray(pallas_fused_mlp(jf, jnp.asarray(xs), P, interpret=True))
    for passes in (1, 3, 6):
        emu = fm.fused_mlp_split_plain(_layers(_folded(params, state)), torch.from_numpy(xs),
                                       351, 351, passes=passes)
        if passes == 1:  # one bf16 pass is ~1e-2 from f32: its own bound is below
            assert np.abs(emu.numpy().reshape(65, P, 4) - pallas).max() < 0.1
        else:
            np.testing.assert_allclose(emu.numpy().reshape(65, P, 4), pallas, atol=2e-4,
                                       rtol=1e-4)


@pytest.mark.parametrize("use_conv", [True, False])
def test_golden_contacts_through_each_modes_emulation(use_conv):
    data = np.load(os.path.join(FIXTURES, "contact_golden.npz"))
    vids = sorted(k for k in data.files if k.startswith("keypoints_"))
    kps = [data[k].copy() for k in vids]
    for kp in kps:
        kp[..., :2] *= infer.TRAIN_DIM[0] / 1920.0
    batch, _ = infer.pad_to_length(kps)
    model = torch_convert.from_state_dict(golden_state_dict())
    contacts = {}
    for mode in fm.MODES:
        precision, dt = (mode, None) if mode != "bf16" else ("high", torch.bfloat16)
        det = infer.ContactDetector(model, device="cpu", use_conv=use_conv,
                                    precision=precision, mlp_dtype=dt)
        emu = (fm.fused_mlp_bf16_plain if mode == "bf16"
               else functools.partial(fm.fused_mlp_split_plain, passes=fm.PASSES[mode]))
        contacts[mode], _ = infer._infer_batch(torch.from_numpy(batch), det.layers, mlp=emu,
                                               **det.kw)
    for i, kp in enumerate(kps):
        n = kp.shape[0]
        for mode in ("high", "highest"):
            agree = (contacts[mode][i, :n].numpy() == data[f"contacts_{i}"]).mean()
            assert agree >= 0.999, f"{mode} video {i}: agreement {agree}"
        for mode in ("default", "bf16"):
            agree = (contacts[mode][i, :n] == contacts["high"][i, :n]).float().mean().item()
            assert agree >= 0.99, f"{mode} video {i}: agreement with high {agree}"


def test_detect_contacts_takes_precision_and_mlp_dtype(tmp_path):
    """The main path's entry point with each mode, on the CPU: every
    precision runs the same float32 MLP, and bf16 storage keeps the golden
    contacts to >= 0.99."""
    data = np.load(os.path.join(FIXTURES, "contact_golden.npz"))
    vids = sorted(k for k in data.files if k.startswith("keypoints_"))
    dirs = _write_video_dirs(tmp_path, [data[k] for k in vids])
    model = torch_convert.from_state_dict(golden_state_dict())
    high = infer.detect_contacts(dirs, model, device="cpu", save=False)
    for precision in PRECISIONS:
        got = infer.detect_contacts(dirs, model, device="cpu", save=False, precision=precision)
        for a, b in zip(got, high):
            np.testing.assert_array_equal(a, b)
    got = infer.detect_contacts(dirs, model, device="cpu", save=True, mlp_dtype=torch.bfloat16)
    for i, c in enumerate(got):
        assert (c == data[f"contacts_{i}"]).mean() >= 0.99
        np.testing.assert_array_equal(np.load(os.path.join(dirs[i], "foot_contacts.npy")), c)


@pytest.mark.parametrize("parts", [1, 3])
def test_pack_weights_parts_are_the_kernels_tile_stream(parts):
    """The stream of a 1-part ("default", bf16 storage) and a 3-part
    ("highest") mode, walked in the kernel's order, gives back each split
    part of layers 0-2, then layers 3-4 in float32: in two 1-part stages, or
    in parts 0 and 1 of one 3-part stage with zeros in part 2
    (tests/test_torch_fused_mlp.py walks the 2-part stream the same way)."""
    d0 = 351
    rng = np.random.default_rng(parts)
    dims = [d0, *contact_mlp.HIDDEN, 20]
    layers = [(torch.from_numpy(rng.normal(size=(dims[i], dims[i + 1])).astype(np.float32)),
               torch.zeros(dims[i + 1])) for i in range(5)]
    pack = fm.pack_weights(layers, parts)
    assert pack.shape == (8 * (6 + 8) + 8 + (2 if parts == 1 else 1), parts, 8192)
    w0, w1, w2, tail = _walk_stream(pack, d0, parts)
    for g, (w, _) in zip((w0[:, :, :d0], w1, w2), layers):
        for h, part in enumerate(fm.split_bf16(w.T.contiguous(), parts)):
            assert torch.equal(g[h], part)
    blocks = [t[0] for t in tail] if parts == 1 else list(tail[0])
    assert len(blocks) == (2 if parts == 1 else 3)
    assert torch.equal(_as_f32(blocks[0]).reshape(128, 32), layers[3][0])
    assert torch.equal(_as_f32(blocks[1])[:1024].reshape(32, 32)[:, :20], layers[4][0])
    assert all(not b.any() for b in blocks[2:])


def _summed_in_float64(mode, layers, x, width, row_stride):
    """A single-pass mode's roundings with each layer's sum taken in
    float64 and rounded to float32: the emulation's arithmetic in another
    order, as the tensor cores' is."""
    def b16(t):
        return t.to(torch.bfloat16).float()

    h = x.unfold(1, width, row_stride).reshape(-1, width)
    for i, (w, b) in enumerate(layers):
        if mode == "bf16":
            h = b16(b16((b16(h).double() @ b16(w).double()).float()) + b16(b))
        elif i < fm.SPLIT_LAYERS:
            h = (b16(h).double() @ b16(w).double() + b.double()).float()
        else:
            h = (h.double() @ w.double() + b.double()).float()
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


@pytest.mark.parametrize("mode", ["default", "bf16"])
def test_single_pass_gate_tells_the_modes_apart(mode):
    """The gate the card holds the single-pass kernels to: the mode's own
    arithmetic summed in another order passes, with its controls failing;
    the arithmetic of any other mode fails."""
    precision, dt = (mode, None) if mode != "bf16" else ("high", torch.bfloat16)
    det = infer.ContactDetector(torch_convert.from_state_dict(golden_state_dict()),
                                device="cpu", precision=precision, mlp_dtype=dt)
    joints, root, appended = infer.subset_joints(det.kw["joint_subset"])
    x = gapfill.preprocess_keypoints(
        torch.from_numpy(_keypoints(np.random.default_rng(3), 8, 60))[:, :, joints],
        det.kw["conf_thresh"], det.kw["normalization"])
    layers, rows, width, stride = infer.mlp_logits(
        x, det.layers, window_size=W, root_in_subset=root, root_appended=appended,
        use_confidence=True, use_conv=True, mlp=lambda *a: a)
    gate = fm.single_pass_gate(_summed_in_float64(mode, layers, rows, width, stride),
                               layers, rows, width, stride, mode)
    assert gate["ok"] and gate["controls_fail"], gate
    for other in fm.MODES:
        if other != mode:
            got = fm.emulation(other)(layers, rows, width, stride)
            assert not fm.single_pass_gate(got, layers, rows, width, stride, mode)["ok"], other
