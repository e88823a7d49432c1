"""The trajectory residual's JᵀJ·v kernel (``csrc/traj_jtjv.cu``) on the
card, against autograd's double vjp and the kernel's plain-torch emulation.

Every test needs a CUDA card (marker ``cuda``) and skips without one. The
file imports no JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_jtjv_cuda.py

Problems are the benchmark's recipe (``chip_smoke.kin_problem``: smooth
motion of the golden fixture's 28-joint skeleton, the MTC camera, contacts
on with p 0.5) at its 16 x 100 frames, and ragged batches padded by
``prepare_batch_arrays`` (frames masked); x is the SMPL initialization and
the weights are ``STAGE2``'s (floor on). Tolerances, on the norm of the
whole output: float64 within 1e-12 of autograd's float64 product and of the
emulation's; float32 within 1e-5 of the float64 product (float32 rounds
~6e-8 a step through a tree seven levels deep). Outputs are bitwise equal
across launches and graph replays (no atomics, fixed orders).
"""
import os

import numpy as np
import pytest
import torch

from chd_tpu_torch.core.animation import Animation
from chd_tpu_torch.kinematics import batch, jtjv, lm, residuals
from chd_tpu_torch.kinematics import trajectory as traj_lib
from chd_tpu_torch.kinematics.ik import IKConfig
from chd_tpu_torch.utils import profiling
from chd_tpu_torch.utils.cuda_graph import GraphCache
from chip_smoke import kin_problem
from torch_jtjv_helpers import linearize

pytestmark = pytest.mark.cuda

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
F64_REL, F32_REL = 1e-12, 1e-5


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def skel():
    g = np.load(os.path.join(FIXTURES, "trajectory_golden.npz"))
    return Animation(g["skel_rotations"], g["skel_positions"], g["skel_orients"],
                     g["skel_offsets"], [int(p) for p in g["skel_parents"]])


def _problems(skel, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [kin_problem(rng, skel, L, 0.5) for L in lens]


def _setup(skel, lens, dtype, device="cuda", seed=0):
    """(x, data, weights, consts) of ``lens`` at the SMPL initialization."""
    problems = _problems(skel, lens, seed)
    arrs, F = batch.prepare_batch_arrays(problems, skel, device=device, dtype=dtype)
    consts = batch.batch_consts(skel.parents, F, IKConfig(), device, dtype)
    x = batch.initial_x(arrs["rot0"], arrs["pos0"]).contiguous()
    B = x.shape[0]
    normal = torch.tensor([0.02, 0.999, -0.03], dtype=dtype, device=device).expand(B, 3)
    point = torch.tensor([0.0, -95.0, 380.0], dtype=dtype, device=device).expand(B, 3)
    data = batch.make_data(arrs, consts, arrs["vc"], normal, point)
    w = lm._tensor_floats(traj_lib.STAGE2, x)
    return x, data, w, consts


def _autograd(x, data, w, consts):
    res = lambda z: consts.layout.residual(z, data, w)  # noqa: E731
    r, vjp_fn = torch.func.vjp(res, x)
    _, lin = torch.func.vjp(lambda c: vjp_fn(c)[0], torch.zeros_like(r))
    return lambda v: vjp_fn(lin(v)[0])[0]


def _to(x, data, w, device, dtype=None):
    """(x, data, w) on ``device`` (in ``dtype``)."""
    def to(t):
        return t if t is None else t.to(device=device, dtype=dtype or t.dtype)

    return to(x), type(data)(*(to(t) for t in data)), type(w)(*(to(t) for t in w))


def _rel(got, want):
    return float((got.double() - want.double()).norm() / want.double().norm())


LENS = {"cell": [100] * 16, "ragged": [37, 25, 12, 3, 37], "one": [1, 1], "two": [2]}


@pytest.mark.parametrize("shape", list(LENS))
def test_kernel_matches_autograd_and_the_emulation(card, skel, shape):
    lens = LENS[shape]
    x, data, w, consts = _setup(skel, lens, torch.float64)
    v = torch.randn(x.shape, dtype=torch.float64, device=card,
                    generator=torch.Generator(card).manual_seed(1))
    want = _autograd(x, data, w, consts)(v)
    got = linearize(consts.layout.residual, x, data, w)(v)
    assert _rel(got, want) <= F64_REL
    if shape != "cell":  # the emulation is slow at the cell's size on the host
        emu = jtjv.TrajectoryProduct(residuals.Layout(skel.parents, "cpu", torch.float64))
        emu = emu.emulated()(*_to(x, data, w, "cpu"))
        assert _rel(got, emu(v.cpu()).to(card)) <= F64_REL
    # float32 against the float64 product at the same point
    x32, data32, w32, consts32 = _setup(skel, lens, torch.float32)
    got32 = linearize(consts32.layout.residual, x32, data32, w32)(v.float())
    want64 = _autograd(*_to(x32, data32, w32, card, torch.float64), consts)(v.float().double())
    assert _rel(got32, want64) <= F32_REL


@pytest.mark.parametrize("shape", ["cell", "ragged"])
def test_kernel_diagonal_and_tangent_axis_match_autograd(card, skel, shape):
    lens = LENS[shape]
    x, data, w, consts = _setup(skel, lens, torch.float64)
    fn = _autograd(x, data, w, consts)
    F = max(lens)
    D = 3 + 3 * len(skel.parents)
    masks = lm.frame_coloring_masks(F, D, dtype=torch.float64, device=card)
    m = masks.unsqueeze(1).expand((masks.shape[0],) + x.shape)
    want = torch.func.vmap(lambda mk: mk * fn(mk))(m).sum(0)
    lin = linearize(consts.layout.residual, x, data, w)
    assert _rel(lin.diag(masks), want) <= F64_REL
    x32, data32, w32, consts32 = _setup(skel, lens, torch.float32)
    fn32 = _autograd(*_to(x32, data32, w32, card, torch.float64), consts)
    want32 = torch.func.vmap(lambda mk: mk * fn32(mk))(m).sum(0)
    lin32 = linearize(consts32.layout.residual, x32, data32, w32)
    assert _rel(lin32.diag(masks.float()), want32) <= F32_REL
    # a leading tangent axis: two random tangents and a mask read through
    # a stride-0 sequence axis
    vs = torch.randn((2,) + tuple(x.shape), dtype=torch.float64, device=card)
    bm = masks[7].expand(1, *x.shape)
    got = lin.many(torch.cat([vs, bm]))
    assert _rel(got, torch.stack([fn(vs[0]), fn(vs[1]), fn(bm[0])])) <= F64_REL
    assert torch.equal(lin.many(bm)[0], got[2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_is_bitwise_repeatable_and_replays_alike(card, skel, dtype):
    x, data, w, consts = _setup(skel, LENS["cell"], dtype)
    v = torch.randn(x.shape, dtype=dtype, device=card)
    lin = linearize(consts.layout.residual, x, data, w)
    masks = consts.masks
    first, first_d = lin(v), lin.diag(masks)
    for _ in range(3):
        assert torch.equal(lin(v), first) and torch.equal(lin.diag(masks), first_d)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        lin(v), lin.diag(masks)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, out_d = lin(v), lin.diag(masks)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first) and torch.equal(out_d, first_d)


def test_lm_step_capture_holds_few_kernels_and_solves_count_the_kernel(card, skel):
    profiling.reset()
    problems = _problems(skel, [100] * 16, seed=3)
    graphs = GraphCache()
    launches = dict(jtjv.traj_jtjv.launches)
    batch.optimize_trajectory_batch(problems, skel, ik_iterations=4,
                                    lm_cfg=lm.LMConfig(max_iters=2, cg_iters=80),
                                    device=card, graphs=graphs)
    snap = profiling.snapshot()
    assert snap["counters"] == {"lm.jtjv.kernel": 2}
    # one capture: the warm-up's and the captured step's launches, the
    # replays' none
    assert {k: v - launches[k] for k, v in jtjv.traj_jtjv.launches.items()} == \
        {"product": 2 * 80, "diag": 2}
    (lm_nodes,) = [r["attrs"]["kernel_nodes"] for r in snap["spans"]["graphs.capture"]["readings"]
                   if r["parent"] == "kin.lm1"]
    assert lm_nodes < 5000


def test_wrapper_refuses_what_the_kernel_does_not_take(card, skel):
    x, data, w, consts = _setup(skel, [4, 3], torch.float32)
    product = consts.layout.residual.product_for(x)
    lin = product(x, data, w)
    v = torch.ones_like(x)
    with pytest.raises(ValueError, match="CUDA"):  # device
        product(x.cpu(), data, w)(v.cpu())
    with pytest.raises(TypeError):                 # type of the data
        product(x, data._replace(proj_weights=data.proj_weights.double()), w)(v)
    with pytest.raises(TypeError):                 # a weight given as a float
        product(x, data, w._replace(floor=10.0))(v)
    with pytest.raises(TypeError):                 # type of x
        product(x.half(), data, w)(v.half())
    with pytest.raises(TypeError):                 # type of the tangent
        lin(v.double())
    with pytest.raises(ValueError, match="shape"):  # shape
        product(x, data._replace(vel_constraints=data.vel_constraints[:, :2]), w)(v)
    with pytest.raises(ValueError):                # shape of the tangent
        lin(v[:, :-1])
    with pytest.raises(ValueError, match="contiguous"):  # layout of x
        wide = torch.zeros((x.shape[0], 2 * x.shape[1]), device=card)
        product(wide[:, ::2], data, w)(v)
    with pytest.raises(ValueError, match="contiguous"):  # layout of the tangent
        lin(torch.zeros((x.shape[0], 2 * x.shape[1]), device=card)[:, ::2])
    with pytest.raises(ValueError, match="contiguous"):  # layout of the data
        t = data.proj_weights.transpose(1, 2).contiguous().transpose(1, 2)
        product(x, data._replace(proj_weights=t), w)(v)
