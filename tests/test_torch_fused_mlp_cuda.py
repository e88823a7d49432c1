"""The fused-MLP CUDA kernel against its plain PyTorch version, on the card.

Every test here needs a CUDA card and skips without one. The file imports no
JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fused_mlp_cuda.py

Tolerance atol 2e-4, rtol 1e-4 on logits (float32 sums in another order than
cuBLAS's); rows are bitwise the same whatever batch they are in, because the
kernel sums each row alone in a fixed order.
"""
import numpy as np
import pytest
import torch

from chd_tpu_torch.contact import infer
from chd_tpu_torch.models import contact_mlp
from chd_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_plain

ATOL, RTOL = 2e-4, 1e-4


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
    return [(w.T.contiguous().cuda(), b.cuda()) for w, b in zip(folded["w"], folded["b"])]


@pytest.mark.parametrize("B", [1, 7, 31, 32, 33, 256, 300])
def test_dense_rows(model, B):
    layers = _layers(model)
    x = torch.from_numpy(np.random.default_rng(B).normal(size=(B, 351)).astype(np.float32)).cuda()
    launches = fused_mlp.launches
    got = fused_mlp(layers, x, 351, 351)
    torch.cuda.synchronize()
    assert fused_mlp.launches == launches + 1
    torch.testing.assert_close(got, fused_mlp_plain(layers, x, 351, 351), atol=ATOL, rtol=RTOL)
    assert torch.equal(fused_mlp(layers, x[:1].contiguous(), 351, 351), got[:1])


def test_strided_rows(model):
    layers = _layers(model)
    u = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 60 * 39)).astype(np.float32)).cuda()
    got = fused_mlp(layers, u, 351, 39)
    torch.cuda.synchronize()
    assert got.shape == (3 * 52, 20)
    torch.testing.assert_close(got, fused_mlp_plain(layers, u, 351, 39), atol=ATOL, rtol=RTOL)


def test_wrapper_rejects_mixed_devices(model):
    layers = _layers(model)
    with pytest.raises(ValueError):
        fused_mlp(layers, torch.zeros((4, 351)), 351, 351)


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
