"""The physics AL residual's JᵀJ·v kernel (``csrc/phys_jtjv.cu``) on the
card, against autograd's double vjp.

Every test needs a CUDA card (marker ``cuda``) and skips without one. The
file imports no JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_phys_jtjv_cuda.py

Problems are walking clips (``chip_smoke.phys_jtjv_point``) at the
benchmark's 32 x 100 frames and a ragged batch padded to 37 frames (frames
masked), at the FIT stage's start (zero forces: the friction cone's rows at
exact ties) and at a point off it with about half of every hinged block's
rows active, for the four structures the kernel serves (FIT, DYN, DYN_H,
the stage-4 polish). Tolerances, on each dof group's norm (base position,
base angles, feet, forces: the Newton–Euler rows make some entries ~1e7
times others, so a whole-output norm would hide a block): float64 within
``F64_REL`` of autograd's float64 product; float32 within ``F32_REL`` of
the float64 product at the float32 point. Outputs are bitwise equal across
launches and graph replays (no atomics, fixed orders).
"""
import copy

import numpy as np
import pytest
import torch

from chd_tpu_torch.kinematics import lm
from chd_tpu_torch.parallel import batch as batch_lib
from chd_tpu_torch.physics import collocation as co
from chd_tpu_torch.physics import jtjv
from chd_tpu_torch.physics.synth import walking_input
from chd_tpu_torch.utils import profiling
from chd_tpu_torch.utils.cuda_graph import GraphCache
from chip_smoke import phys_jtjv_point, phys_jtjv_structures
from torch_jtjv_helpers import linearize

pytestmark = pytest.mark.cuda

F64_REL, F32_REL = 1e-10, 1e-5
STRUCTURES = phys_jtjv_structures()
LENS = {"cell": [100] * 32, "ragged": [37, 25, 12, 3, 37]}
GROUPS = {"base_lin": slice(0, 3), "base_ang": slice(3, 6), "feet": slice(6, 18),
          "forces": slice(18, 30)}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _setup(lens, structure, dtype, start):
    """(x, args, fn, lin) at the point, on the card."""
    w, rho = STRUCTURES[structure]
    pb, x, lams = phys_jtjv_point(lens, "cuda", dtype, start=start)
    args = lm._tensor_floats((pb, lams, w, rho), x)
    fn = co.make_al_residual_fn(w, rho)
    return x, args, fn, linearize(fn, x, *args)


def _autograd(fn, x, args):
    r, vjp_fn = torch.func.vjp(lambda z: fn(z, *args), x)
    _, lin = torch.func.vjp(lambda c: vjp_fn(c)[0], torch.zeros_like(r))
    return lambda v: vjp_fn(lin(v)[0])[0]


def _coloring(fn, masks, like):
    m = masks.unsqueeze(1).expand((masks.shape[0],) + like.shape)
    return torch.func.vmap(lambda mk: mk * fn(mk))(m).sum(0)


def _rel(got, want):
    """The largest, over the dof groups, of the group's error norm over its
    norm (groups that are zero in ``want`` must be zero in ``got``)."""
    F = want.shape[-1] // co.DOF
    g = got.double().reshape(*got.shape[:-1], F, co.DOF)
    w = want.double().reshape(*want.shape[:-1], F, co.DOF)
    out = 0.0
    for s in GROUPS.values():
        err, ref = float((g[..., s] - w[..., s]).norm()), float(w[..., s].norm())
        out = max(out, err / ref if ref > 0 else (0.0 if err == 0 else np.inf))
    return out


@pytest.mark.parametrize("start", [False, True], ids=["off", "start"])
@pytest.mark.parametrize("shape", list(LENS))
@pytest.mark.parametrize("structure", list(STRUCTURES))
def test_kernel_matches_autograd(card, structure, shape, start):
    lens = LENS[shape]
    x, args, fn, lin = _setup(lens, structure, torch.float64, start)
    ag = _autograd(fn, x, args)
    gen = torch.Generator(card).manual_seed(20)
    v = torch.randn(x.shape, dtype=torch.float64, device=card, generator=gen)
    want = ag(v)
    assert _rel(lin(v), want) <= F64_REL
    masks = lm.frame_coloring_masks(max(lens), co.DOF, dtype=torch.float64, device=card)
    want_d = _coloring(ag, masks, x)
    assert _rel(lin.diag(masks), want_d) <= F64_REL
    # a leading tangent axis: a random tangent and a mask read through a
    # stride-0 sequence axis
    bm = masks[40].expand(1, *x.shape)
    got = lin.many(torch.cat([v.unsqueeze(0), bm]))
    assert _rel(got, torch.stack([want, ag(bm[0])])) <= F64_REL
    assert torch.equal(lin.many(bm)[0], got[1])
    # float32 against the float64 product at the float32 point
    x32, args32, fn32, lin32 = _setup(lens, structure, torch.float32, start)
    to64 = lm._tensor_floats(tuple(type(a)(*(None if t is None else t.double() for t in a))
                                   for a in args32), x)
    ag64 = _autograd(fn, x32.double(), to64)
    assert _rel(lin32(v.float()), ag64(v)) <= F32_REL
    assert _rel(lin32.diag(masks.float()), _coloring(ag64, masks, x)) <= F32_REL


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_is_bitwise_repeatable_and_replays_alike(card, dtype):
    x, args, fn, lin = _setup(LENS["cell"], "DYN_H", dtype, False)
    v = torch.randn(x.shape, dtype=dtype, device=card)
    masks = lm.frame_coloring_masks(100, co.DOF, dtype=dtype, device=card)
    first, first_d = lin(v), lin.diag(masks)
    for _ in range(3):
        assert torch.equal(lin(v), first) and torch.equal(lin.diag(masks), first_d)
    # at a strided x, as stage 4 starts from a slice of stage 3's variables,
    # and with strided data, as the pipeline's batch can hold its hips
    wide = torch.cat([x, x[:, :12]], dim=1)[:, :x.shape[1]]
    assert torch.equal(lin.product(wide, *args)(v), first)
    pb = args[0]
    hips = pb.left_hip.transpose(1, 2).contiguous().transpose(1, 2)
    assert not hips.is_contiguous()
    assert torch.equal(lin.product(x, pb._replace(left_hip=hips), *args[1:])(v), first)
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


def test_a_call_takes_the_kernel_in_four_stages_and_autograd_in_stage3(card):
    profiling.reset()
    pb, _ = batch_lib.pad_phys_inputs([walking_input(100, seed=i) for i in range(32)],
                                      device=card)
    graphs = GraphCache()
    launches = dict(jtjv.phys_jtjv.launches)
    cfg = co.SolveConfig(lm=lm.LMConfig(max_iters=2, cg_iters=50, init_lambda=1e-2))
    out = batch_lib.solve_physics_full_batch(pb, cfg=cfg, graphs=graphs)
    snap = profiling.snapshot()
    assert snap["counters"]["lm.jtjv.phys_kernel"] == 11
    assert snap["counters"]["lm.jtjv.autograd"] == 2
    # four captures (FIT, DYN, DYN_H, the polish), each a warm-up and a
    # captured step: 50 products and one diagonal a step
    assert {k: v - launches[k] for k, v in jtjv.phys_jtjv.launches.items()} == \
        {"product": 4 * 2 * 50, "diag": 4 * 2}
    (nodes,) = [r["attrs"]["kernel_nodes"] for r in snap["spans"]["graphs.capture"]["readings"]
                if r["parent"] == "phys.dyn"]
    assert nodes < 4000
    assert all(torch.isfinite(t).all() for t in out[2][1:5])


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    x, args, fn, lin = _setup([4, 3], "DYN_H", torch.float32, False)
    v = torch.ones_like(x)
    pb = args[0]

    def with_(**kw):  # the linearization with one field changed
        bad = copy.copy(lin)
        for k, val in kw.items():
            setattr(bad, k, val)
        return bad

    with pytest.raises(TypeError):                 # type of the data
        with_(phys=pb._replace(inertia=pb.inertia.double()))(v)
    with pytest.raises(TypeError):                 # a weight given as a float
        with_(w=lin.w._replace(pin=1e3))(v)
    with pytest.raises(TypeError):                 # type of the tangent
        lin(v.double())
    with pytest.raises(ValueError, match="shape"):  # shape of the data
        with_(phys=pb._replace(contact=pb.contact[:, :2]))(v)
    with pytest.raises(ValueError, match="shape"):  # a hinge factor's shape
        with_(hinge=dict(lin.hinge, leg=lin.hinge["leg"][:, :2]))(v)
    with pytest.raises(ValueError):                # shape of the tangent
        lin(v[:, :-1])
    with pytest.raises(ValueError, match="contiguous"):  # layout of x
        with_(x=torch.zeros((x.shape[0], 2 * x.shape[1]), device=card)[:, ::2])(v)
    with pytest.raises(ValueError, match="contiguous"):  # layout of the data
        t = pb.inertia.transpose(2, 3).contiguous().transpose(2, 3)
        with_(phys=pb._replace(inertia=t))(v)
    with pytest.raises(ValueError, match="frame_coloring_masks"):
        lin.diag(torch.ones((89, x.shape[1]), device=card))
