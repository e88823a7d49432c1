"""chd_tpu_torch.ops.fused_mlp against chd_tpu's Pallas kernel and conv path.

On the CPU the wrapper runs the plain version, which is what these tests hold
against chd_tpu: the Pallas kernel in interpret mode for dense rows, and the
conv-fused first layer (lax.conv_general_dilated) plus the folded tail for
strided rows. Tolerance atol 2e-4, rtol 1e-4 on logits, as
tests/test_pallas_mlp.py holds the Pallas kernel: float32 sums in different
orders. The kernel itself runs only on a CUDA card:
tests/test_torch_fused_mlp_cuda.py holds it against this plain version there.

The kernel's arithmetic, the 3-pass bf16 split of chd_tpu's
precision="high", is held here through its CPU emulation
``fused_mlp_split_plain`` (against the same chd_tpu functions, a float64
chain and the golden contacts), and the weight stream it reads through
``pack_weights``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chd_tpu.characters.defs import OP_JOINT_SUBSETS
from chd_tpu.models import contact_mlp as jax_mlp
from chd_tpu.ops import gapfill as jax_gapfill
from chd_tpu.ops import windows as jax_windows
from chd_tpu.ops.pallas_mlp import fused_mlp as pallas_fused_mlp
from chd_tpu_torch.contact import infer
from chd_tpu_torch.models import contact_mlp, torch_convert
from chd_tpu_torch.ops import gapfill
from chd_tpu_torch.ops.fused_mlp import (fused_mlp, fused_mlp_plain, fused_mlp_split_plain,
                                         pack_weights, split_bf16)
from test_torch_contact_infer import FIXTURES
from test_torch_contact_mlp import golden_state_dict, random_params

ATOL, RTOL = 2e-4, 1e-4
P = 5


def _folded(params, state):
    return contact_mlp.fold_batchnorm(torch_convert.from_jax_params(params, state))


def _layers(folded):
    return [(w.T.contiguous(), b) for w, b in zip(folded["w"], folded["b"])]


@pytest.fixture(scope="module")
def weights():
    params, state = random_params(np.random.default_rng(0))
    jf = jax_mlp.fold_batchnorm(
        *[{k: {leaf: jnp.asarray(v) for leaf, v in d.items()} for k, d in t.items()}
          for t in (params, state)])
    return params, state, jf


@pytest.mark.parametrize("B", [1, 7, 256, 300])
def test_dense_rows_match_pallas_kernel(weights, B):
    params, state, jf = weights
    x = np.random.default_rng(B).normal(size=(B, 351)).astype(np.float32)
    want = np.asarray(pallas_fused_mlp(jf, jnp.asarray(x), P, interpret=True))
    launches = fused_mlp.launches
    got = fused_mlp(_layers(_folded(params, state)), torch.from_numpy(x), 351, 351)
    assert fused_mlp.launches == launches  # a CPU tensor runs the plain version
    assert got.shape == (B, 4 * P)
    np.testing.assert_allclose(got.numpy().reshape(B, P, 4), want, atol=ATOL, rtol=RTOL)


def _conv_case(joint_set):
    """chd_tpu's conv path + folded tail on seeded keypoints, and a function
    of (use_conv, mlp) giving the port's logits on the same input."""
    joints, root, appended = infer.subset_joints(OP_JOINT_SUBSETS[joint_set])
    Jm = len(joints) - appended
    params, state = random_params(np.random.default_rng(1), in_dim=9 * Jm * 3)
    V, F, J = 3, 40, len(joints)
    rng = np.random.default_rng(2)
    kp = np.empty((V, F, J, 3), np.float32)
    kp[..., 0] = rng.uniform(0, 1280, size=(V, F, J))
    kp[..., 1] = rng.uniform(0, 720, size=(V, F, J))
    kp[..., 2] = rng.uniform(0, 1, size=(V, F, J))

    x = np.asarray(jax_gapfill.preprocess_keypoints(jnp.asarray(kp), 0.2, 200.0))
    jf = jax_mlp.fold_batchnorm(params, state)
    K = jax_windows.layer1_conv_kernel(jf["w"][0], 9, J, root, Jm)
    h = jax.lax.conv_general_dilated(
        jnp.asarray(x.reshape(V, F, J * 3)), K, (1,), "VALID",
        dimension_numbers=("NWC", "WIO", "NWC")) + jf["b"][0]
    h = jax.nn.relu(h).reshape(V * (F - 8), -1)
    want = np.asarray(jax_mlp.apply_folded_tail(jf, h, P))

    xt = gapfill.preprocess_keypoints(torch.from_numpy(kp), 0.2, 200.0)

    def logits(use_conv, mlp=fused_mlp):
        layers = infer.mlp_layers(_folded(params, state), window_size=9,
                                  joint_subset=OP_JOINT_SUBSETS[joint_set],
                                  use_confidence=True, use_conv=use_conv)
        return infer.mlp_logits(xt, layers, window_size=9, root_in_subset=root,
                                root_appended=appended, use_confidence=True,
                                use_conv=use_conv, mlp=mlp)

    return want, logits


@pytest.mark.parametrize("joint_set", ["lower", "lower_ankles", "full"])
def test_strided_rows_match_jax_conv_path(joint_set):
    """Conv mode: the kernel's strided first-layer rows over the preprocessed
    frames, with layer1_conv_kernel weights, equal chd_tpu's temporal conv
    followed by the folded tail."""
    want, logits = _conv_case(joint_set)
    got = logits(True)
    assert got.shape == (want.shape[0], 4 * P)
    np.testing.assert_allclose(got.numpy().reshape(-1, P, 4), want, atol=ATOL, rtol=RTOL)

    # the same rows through the materialized windows (dense mode)
    dense = logits(False)
    np.testing.assert_allclose(dense.numpy(), got.numpy(), atol=ATOL, rtol=RTOL)


def test_wrapper_rejects_what_the_kernel_does_not_take(weights):
    params, state, _ = weights
    layers = _layers(_folded(params, state))
    x = torch.zeros((4, 351))
    with pytest.raises(TypeError):
        fused_mlp(layers, x.double(), 351, 351)
    with pytest.raises(TypeError):
        fused_mlp([(w.double(), b) for w, b in layers], x, 351, 351)
    with pytest.raises(ValueError):  # first weight does not take 350 columns
        fused_mlp(layers, torch.zeros((4, 350)), 350, 350)
    with pytest.raises(ValueError):  # width past the end of a row
        fused_mlp(layers, x, 352, 1)
    with pytest.raises(ValueError):  # not (groups, length)
        fused_mlp(layers, x.reshape(2, 2, 351), 351, 351)
    with pytest.raises(ValueError):  # not contiguous
        fused_mlp(layers, torch.zeros((351, 4)).T, 351, 351)
    with pytest.raises(ValueError):  # four layers
        fused_mlp(layers[:4], x, 351, 351)
    with pytest.raises(ValueError):  # neither cpu nor cuda
        fused_mlp([(w.to("meta"), b.to("meta")) for w, b in layers],
                  x.to("meta"), 351, 351)


def test_plain_version_reads_strided_rows():
    """fused_mlp_plain's rows of a (G, L) input are x[g, n*s : n*s + width]."""
    rng = np.random.default_rng(3)
    dims = [12, 8, 8, 6, 4, 3]
    layers = [(torch.from_numpy(rng.normal(size=(dims[i], dims[i + 1])).astype(np.float32)),
               torch.from_numpy(rng.normal(size=dims[i + 1]).astype(np.float32)))
              for i in range(5)]
    x = torch.from_numpy(rng.normal(size=(2, 30)).astype(np.float32))
    got = fused_mlp_plain(layers, x, 12, 3)
    rows = torch.stack([x[g, n * 3:n * 3 + 12] for g in range(2) for n in range(7)])
    want = rows
    for i, (w, b) in enumerate(layers):
        want = want @ w + b
        if i < 4:
            want = torch.relu(want)
    assert got.shape == (14, 3)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)



def test_build_raises_without_nvcc_and_on_a_failed_build(monkeypatch, tmp_path):
    """No fallback: a missing nvcc and a failing nvcc both raise."""
    import shutil

    import torch.utils.cpp_extension as cpp_extension

    from chd_tpu_torch.utils import build

    monkeypatch.setattr(build, "_BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(build, "_kernels", None)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.kernels()
    monkeypatch.setattr(build, "_nvcc", lambda: "false")  # exits 1
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.kernels()
    assert build._kernels is None


def test_split_bf16_reconstructs_x():
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.normal(size=10000) * 10.0 ** rng.uniform(-6, 6, 10000))
                         .astype(np.float32))
    hi, lo = split_bf16(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, x.to(torch.bfloat16))
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -16 * x.double().abs()).all())


@pytest.mark.parametrize("B", [1, 7, 63, 64, 65, 300])
def test_split_emulation_matches_pallas_kernel(weights, B):
    """The kernel's 3-pass bf16 arithmetic on dense rows, around its 64-row
    tile, against chd_tpu's Pallas kernel in interpret mode (float32)."""
    params, state, jf = weights
    x = np.random.default_rng(B).normal(size=(B, 351)).astype(np.float32)
    want = np.asarray(pallas_fused_mlp(jf, jnp.asarray(x), P, interpret=True))
    got = fused_mlp_split_plain(_layers(_folded(params, state)), torch.from_numpy(x), 351, 351)
    assert got.shape == (B, 4 * P)
    np.testing.assert_allclose(got.numpy().reshape(B, P, 4), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("B", [7, 65])
def test_split_emulation_matches_pallas_kernel_at_full_width(B):
    """The widest first layer, the full joint set's 9 x 25 x 3 = 675, which
    the kernel stages in 128-input slabs: its arithmetic against chd_tpu's
    Pallas kernel in interpret mode."""
    params, state = random_params(np.random.default_rng(6), in_dim=675)
    jf = jax_mlp.fold_batchnorm(params, state)
    x = np.random.default_rng(B).normal(size=(B, 675)).astype(np.float32)
    want = np.asarray(pallas_fused_mlp(jf, jnp.asarray(x), P, interpret=True))
    layers = _layers(_folded(params, state))
    for mlp in (fused_mlp_split_plain, fused_mlp):
        got = mlp(layers, torch.from_numpy(x), 675, 675)
        np.testing.assert_allclose(got.numpy().reshape(B, P, 4), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("joint_set", ["lower", "lower_ankles", "full"])
def test_split_emulation_matches_jax_conv_path(joint_set):
    """The kernel's arithmetic on strided conv-mode rows against chd_tpu's
    temporal conv followed by the folded tail."""
    want, logits = _conv_case(joint_set)
    got = logits(True, mlp=fused_mlp_split_plain)
    np.testing.assert_allclose(got.numpy().reshape(-1, P, 4), want, atol=ATOL, rtol=RTOL)


def test_split_emulation_against_float64_at_golden_weights():
    """3 bf16 passes with float32 sums keep the golden MLP's logits within
    1e-4 of a float64 chain (1.9e-5 measured on 4096 N(0, 1) rows)."""
    folded = contact_mlp.fold_batchnorm(torch_convert.from_state_dict(golden_state_dict()))
    layers = _layers(folded)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4096, 351)).astype(np.float32))
    got = fused_mlp_split_plain(layers, x, 351, 351)
    want = fused_mlp_plain([(w.double(), b.double()) for w, b in layers], x.double(), 351, 351)
    assert (got.double() - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("use_conv", [True, False])
def test_golden_contacts_with_split_emulation(use_conv):
    """The golden detector flow (detect_contacts' scaling and padding) with
    the kernel's arithmetic as the MLP: agreement >= 0.999 per video."""
    data = np.load(os.path.join(FIXTURES, "contact_golden.npz"))
    vids = sorted(k for k in data.files if k.startswith("keypoints_"))
    det = infer.ContactDetector(torch_convert.from_state_dict(golden_state_dict()),
                                device="cpu", use_conv=use_conv)
    kps = [data[k].copy() for k in vids]
    for kp in kps:
        kp[..., :2] *= infer.TRAIN_DIM[0] / 1920.0
    batch, _ = infer.pad_to_length(kps)
    contacts, _ = infer._infer_batch(torch.from_numpy(batch), det.layers,
                                     mlp=fused_mlp_split_plain, **det.kw)
    for i, kp in enumerate(kps):
        got = contacts[i, :kp.shape[0]].numpy()
        want = data[f"contacts_{i}"]
        assert got.shape == want.shape
        agree = (got.astype(int) == want.astype(int)).mean()
        assert agree >= 0.999, f"video {i}: agreement {agree}"


def _unswizzle(half, rows, row_bits):
    """One (rows x 16-byte chunks) half of a packed tile back to (rows, in)."""
    t = half.reshape(rows, -1, 8)
    r = torch.arange(rows)[:, None]
    c = torch.arange(t.shape[1])[None, :]
    return t[r, c ^ row_bits(r)].reshape(rows, -1)


@pytest.mark.parametrize("d0", [351, 243, 216, 675])  # 675: the full joint set
def test_pack_weights_is_the_kernels_tile_stream(d0):
    """Walking the packed stream in the kernel's order (per 64-column h1
    chunk: layer 0's 64 x 128 tiles along k, then layer 1's 512 x 16 tiles
    along k; then layer 2's 64 x 128 tiles, k outer) and undoing the
    swizzle gives back the split weights of layers 0-2, zero past d0."""
    rng = np.random.default_rng(d0)
    dims = [d0, *contact_mlp.HIDDEN, 20]
    layers = [(torch.from_numpy(rng.normal(size=(dims[i], dims[i + 1])).astype(np.float32)),
               torch.zeros(dims[i + 1])) for i in range(5)]
    pack = pack_weights(layers)
    kt0 = -(-d0 // 128)
    assert pack.dtype == torch.bfloat16 and pack.shape == (16 * (kt0 + 4) + 8, 2, 8192)
    w0 = torch.zeros((2, 1024, kt0 * 128), dtype=torch.bfloat16)
    w1 = torch.zeros((2, 512, 1024), dtype=torch.bfloat16)
    w2 = torch.zeros((2, 128, 512), dtype=torch.bfloat16)
    tiles = iter(pack)
    for c in range(16):
        for kt in range(kt0):
            tile = next(tiles)
            for h in range(2):
                w0[h, c * 64:(c + 1) * 64, kt * 128:(kt + 1) * 128] = _unswizzle(
                    tile[h], 64, lambda r: r & 7)
        for ks in range(4):
            tile = next(tiles)
            for h in range(2):
                w1[h, :, c * 64 + ks * 16:c * 64 + (ks + 1) * 16] = _unswizzle(
                    tile[h], 512, lambda r: (r >> 2) & 1)
    for kt in range(4):
        for nt in range(2):
            tile = next(tiles)
            for h in range(2):
                w2[h, nt * 64:(nt + 1) * 64, kt * 128:(kt + 1) * 128] = _unswizzle(
                    tile[h], 64, lambda r: r & 7)
    assert next(tiles, None) is None
    for got, (w, _) in zip((w0[:, :, :d0], w1, w2), layers):
        hi, lo = split_bf16(w.T.contiguous())
        assert torch.equal(got[0], hi) and torch.equal(got[1], lo)
    assert not w0[:, :, d0:].any()
