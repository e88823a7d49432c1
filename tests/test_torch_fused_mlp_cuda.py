"""The fused-MLP CUDA kernel against its plain PyTorch version, on the card.

Every test here needs a CUDA card (marker ``cuda``) and skips without one.
The file imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fused_mlp_cuda.py

Tolerances on logits: atol 2e-4, rtol 1e-4 against the float32 plain version
(the kernel's 3-pass bf16 split keeps ~2e-5, as chd_tpu's precision="high"
does); atol 5e-5, rtol 1e-5 against the split emulation
``fused_mlp_split_plain``, which rounds the same bf16 operands but sums the
exact products in float32 through cuBLAS, where the tensor cores add each
k16 step's products with their own internal rounding (~1.4e-5 measured at
4096 rows on an H100). Rows are bitwise the same whatever batch they are in,
because every row runs the same code in a fixed order.
"""
import numpy as np
import pytest
import torch

from chd_tpu.characters.defs import OP_JOINT_SUBSETS
from chd_tpu_torch.contact import infer
from chd_tpu_torch.models import contact_mlp
from chd_tpu_torch.ops import gapfill
from chd_tpu_torch.ops.fused_mlp import (D0_MAX, MlpLayers, fused_mlp, fused_mlp_plain,
                                         fused_mlp_split_plain)

pytestmark = pytest.mark.cuda

ATOL, RTOL = 2e-4, 1e-4
SPLIT_ATOL, SPLIT_RTOL = 5e-5, 1e-5


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    m = contact_mlp.init(contact_mlp.ModelConfig(), gen)
    with torch.no_grad():
        for bn in m.batchnorms():
            bn.weight.uniform_(0.5, 1.5, generator=gen)
            bn.bias.normal_(0, 0.1, generator=gen)
            bn.running_mean.normal_(0, 0.1, generator=gen)
            bn.running_var.uniform_(0.5, 2.0, generator=gen)
    return m.eval()


def _layers(model):
    folded = contact_mlp.fold_batchnorm(model)
    return MlpLayers((w.T.contiguous().cuda(), b.cuda()) for w, b in zip(folded["w"], folded["b"]))


@pytest.mark.parametrize("B", [1, 7, 63, 64, 65, 300])  # around the 64-row tile
def test_dense_rows(model, B):
    layers = _layers(model)
    x = torch.from_numpy(np.random.default_rng(B).normal(size=(B, 351)).astype(np.float32)).cuda()
    launches = fused_mlp.launches
    got = fused_mlp(layers, x, 351, 351)
    torch.cuda.synchronize()
    assert fused_mlp.launches == launches + 1
    torch.testing.assert_close(got, fused_mlp_plain(layers, x, 351, 351), atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(got, fused_mlp_split_plain(layers, x, 351, 351),
                               atol=SPLIT_ATOL, rtol=SPLIT_RTOL)
    assert torch.equal(fused_mlp(layers, x[:1].contiguous(), 351, 351), got[:1])


def test_strided_rows(model):
    layers = _layers(model)
    u = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 60 * 39)).astype(np.float32)).cuda()
    got = fused_mlp(layers, u, 351, 39)
    torch.cuda.synchronize()
    assert got.shape == (3 * 52, 20)
    torch.testing.assert_close(got, fused_mlp_plain(layers, u, 351, 39), atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(got, fused_mlp_split_plain(layers, u, 351, 39),
                               atol=SPLIT_ATOL, rtol=SPLIT_RTOL)


def test_wrapper_rejects_mixed_devices(model):
    layers = _layers(model)
    with pytest.raises(ValueError):
        fused_mlp(layers, torch.zeros((4, 351)), 351, 351)


def test_wrapper_takes_only_layers_that_keep_their_packing(model):
    layers = _layers(model)
    x = torch.zeros((4, 351), device="cuda")
    with pytest.raises(TypeError, match="MlpLayers"):
        fused_mlp(list(layers), x, 351, 351)
    pack = layers.packed()
    fused_mlp(layers, x, 351, 351)
    assert layers.packed() is pack


@pytest.mark.parametrize("use_conv", [True, False])
@pytest.mark.parametrize("joint_set", sorted(OP_JOINT_SUBSETS))
def test_every_joint_set(joint_set, use_conv):
    """Each joint set's first-layer rows as the detector hands them to the
    kernel, strided (conv mode) or dense, up to full's 675 inputs, which
    the kernel stages in slabs: against the plain version and the split
    emulation, and each video's rows bitwise the same alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    cfg = contact_mlp.ModelConfig(num_joints=len(OP_JOINT_SUBSETS[joint_set]))
    model = contact_mlp.init(cfg, torch.Generator().manual_seed(1)).eval()
    det = infer.ContactDetector(model, device="cuda", joint_set=joint_set, use_conv=use_conv)
    rng = np.random.default_rng(4)
    kp = np.empty((5, 70, 25, 3), np.float32)
    kp[..., 0] = rng.uniform(200, 1100, size=kp.shape[:3])
    kp[..., 1] = rng.uniform(100, 650, size=kp.shape[:3])
    kp[..., 2] = rng.uniform(0.0, 1.0, size=kp.shape[:3])
    joints, root, appended = infer.subset_joints(det.kw["joint_subset"])
    x = gapfill.preprocess_keypoints(torch.from_numpy(kp).cuda()[:, :, joints], 0.2, 200.0)
    layers, rows, width, stride = infer.mlp_logits(
        x, det.layers, window_size=9, root_in_subset=root, root_appended=appended,
        use_confidence=True, use_conv=use_conv, mlp=lambda *a: a)
    assert width == (9 * len(joints) * 3 if use_conv else cfg.in_dim)
    got = fused_mlp(layers, rows, width, stride)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, fused_mlp_plain(layers, rows, width, stride),
                               atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(got, fused_mlp_split_plain(layers, rows, width, stride),
                               atol=SPLIT_ATOL, rtol=SPLIT_RTOL)
    one = fused_mlp(layers, rows[:1].contiguous(), width, stride)
    assert torch.equal(one, got[:one.shape[0]])


def test_widest_first_layer(model):
    """D0_MAX inputs, dense, the widest first layer the kernel takes."""
    rng = np.random.default_rng(5)
    dims = [D0_MAX, *contact_mlp.HIDDEN, 20]
    layers = MlpLayers(
        (torch.from_numpy(rng.normal(0, dims[i] ** -0.5, (dims[i], dims[i + 1]))
                          .astype(np.float32)).cuda(),
         torch.from_numpy(rng.normal(0, 0.1, dims[i + 1]).astype(np.float32)).cuda())
        for i in range(5))
    x = torch.from_numpy(rng.normal(size=(130, D0_MAX)).astype(np.float32)).cuda()
    got = fused_mlp(layers, x, D0_MAX, D0_MAX)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, fused_mlp_plain(layers, x, D0_MAX, D0_MAX),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dims", [
    [D0_MAX + 1, 1024, 512, 128, 32, 20],  # first layer wider than six layer-0 tiles
    [351, 1024, 256, 128, 32, 20],  # hidden widths other than HIDDEN
    [351, 1024, 512, 128, 32, 33],  # more than 32 outputs
])
def test_wrapper_rejects_widths_the_kernel_does_not_take(model, dims):
    rng = np.random.default_rng(0)
    layers = MlpLayers(
        (torch.from_numpy(rng.normal(size=(dims[i], dims[i + 1])).astype(np.float32)).cuda(),
         torch.zeros(dims[i + 1], device="cuda")) for i in range(5))
    x = torch.zeros((4, dims[0]), device="cuda")
    launches = fused_mlp.launches
    with pytest.raises(ValueError, match="the kernel takes widths"):
        fused_mlp(layers, x, dims[0], dims[0])
    assert fused_mlp.launches == launches
    # the plain version takes them
    assert fused_mlp_plain(layers, x, dims[0], dims[0]).shape == (4, dims[-1])


@pytest.mark.parametrize("use_conv", [True, False])
def test_detector_rows_do_not_depend_on_the_batch(model, use_conv):
    rng = np.random.default_rng(3)
    V, F = 21, 40
    kp = np.zeros((V, F, 25, 3), np.float32)
    kp[..., 0] = rng.uniform(200, 1100, size=(V, F, 25))
    kp[..., 1] = rng.uniform(100, 650, size=(V, F, 25))
    kp[..., 2] = rng.uniform(0.0, 1.0, size=(V, F, 25))
    det = infer.ContactDetector(model, device="cuda", use_conv=use_conv)
    c_all, p_all = det.infer(torch.from_numpy(kp))
    for v in range(V):
        c1, p1 = det.infer(torch.from_numpy(kp[v:v + 1]))
        assert torch.equal(c1[0], c_all[v]) and torch.equal(p1[0], p_all[v])
