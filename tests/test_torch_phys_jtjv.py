"""The physics AL residual's JᵀJ·v kernel (``physics/jtjv.py``,
``csrc/phys_jtjv.cu``): its algorithm, and who engages it, on the CPU.

The kernel itself runs only on a card (``tests/test_torch_phys_jtjv_cuda.py``);
here ``phys_jtjv_plain``, the same tiles, halos, hand-derived tangent and
transpose in plain torch, is held against autograd's double vjp in float64,
for the four structures the kernel serves (FIT, DYN, DYN_H, the stage-4
polish), on each dof group's norm within ``REL`` (the Newton–Euler rows
make some entries ~1e7 times others):
- products on single tangents and on a leading tangent axis (a coloring
  mask broadcast over the sequences by ``expand``), on batches of 1-3
  walking clips of 2-16 frames, padded ragged batches among them, with
  tiles of 1, 4 and ``TILE`` frames (below and around a tile and its halo);
- at a point off the start with about half of every hinged block's rows
  active, and at the first step's zero forces, where the friction cone's
  normal-force rows sit at exact ties (hinge derivative ½);
- the diagonal equal to ``lm_step``'s coloring diagonal, whose base-angle
  entries keep cross terms of frames three apart (it is not diag(JᵀJ));
- planted faults fail that comparison: a block dropped, the ½ of a tie
  taken as 1;
- an LM stage with the emulation as its product follows the autograd stage.
And: each structure has its own product object and graph key, a solve
takes the supplier its residual names (so a caller that passes no product
replays the stage's captured step), a CPU solve takes autograd, and the
wrapper refuses CPU tensors. Float64, one intra-op thread (as the other
solver files); the file imports no JAX.
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
from chip_smoke import phys_jtjv_point, phys_jtjv_structures
from torch_jtjv_helpers import RecordingGraphs, emulate

F64 = torch.float64
REL = 1e-12
STRUCTURES = phys_jtjv_structures()
GROUPS = {"base_lin": slice(0, 3), "base_ang": slice(3, 6), "feet": slice(6, 18),
          "forces": slice(18, 30)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as the port's other solver test files pin it."""
    torch.set_num_threads(1)


def _setup(lens, structure, start=False, tile=jtjv.TILE, seed=0):
    """(x, args, autograd's JᵀJ·v, the emulation's linearization)."""
    w, rho = STRUCTURES[structure]
    pb, x, lams = phys_jtjv_point(lens, "cpu", F64, seed=seed, start=start)
    args = lm._tensor_floats((pb, lams, w, rho), x)
    fn = co.make_al_residual_fn(w, rho)
    r, vjp_fn = torch.func.vjp(lambda z: fn(z, *args), x)
    _, lin = torch.func.vjp(lambda c: vjp_fn(c)[0], torch.zeros_like(r))
    prod = jtjv.product_for(*co._structure(w, rho)).emulated(tile)
    return x, args, (lambda v: vjp_fn(lin(v)[0])[0]), prod(x, *args)


def _rel(got, want):
    """The largest, over the dof groups, of the group's error norm over its
    norm (a group that is zero in ``want`` must be zero in ``got``)."""
    F = want.shape[-1] // co.DOF
    g = got.reshape(*got.shape[:-1], F, co.DOF)
    w = want.reshape(*want.shape[:-1], F, co.DOF)
    out = 0.0
    for s in GROUPS.values():
        err, ref = float((g[..., s] - w[..., s]).norm()), float(w[..., s].norm())
        out = max(out, err / ref if ref > 0 else (0.0 if err == 0 else np.inf))
    return out


def _coloring(fn, masks, like):
    m = masks.unsqueeze(1).expand((masks.shape[0],) + like.shape)
    return torch.func.vmap(lambda mk: mk * fn(mk))(m).sum(0)


CASES = [  # lens, tile, start
    ([12, 9, 5], jtjv.TILE, False), ([12, 9, 5], 4, True), ([16, 16], 5, False),
    ([16], 1, True), ([3, 2], 1, False), ([2], jtjv.TILE, True), ([7, 4, 3], 4, False),
]


@pytest.mark.parametrize("lens,tile,start", CASES,
                         ids=[f"{'x'.join(map(str, c[0]))}-t{c[1]}-{'start' if c[2] else 'off'}"
                              for c in CASES])
@pytest.mark.parametrize("structure", list(STRUCTURES))
def test_emulated_product_and_diagonal_match_autograd(structure, lens, tile, start):
    x, args, fn, lin = _setup(lens, structure, start, tile, seed=len(lens) + tile)
    v = torch.from_numpy(np.random.default_rng(tile).normal(size=x.shape))
    assert _rel(lin(v), fn(v)) <= REL
    masks = lm.frame_coloring_masks(max(lens), co.DOF, dtype=F64, device="cpu")
    assert _rel(lin.diag(masks), _coloring(fn, masks, x)) <= REL
    # a leading tangent axis: two tangents and a mask broadcast over the
    # sequences (stride 0), as the coloring and banded passes hand them
    vs = torch.cat([torch.stack([v, -2 * v]), masks[4].expand(1, *x.shape)])
    assert _rel(lin.many(vs), torch.func.vmap(fn)(vs)) <= REL
    if start:  # the friction cone's normal-force rows sit at ties
        assert "force" not in lin.hinge or bool((lin.hinge["force"] == 0.5).any())


def test_the_coloring_diagonal_keeps_cross_terms_of_the_base_angles():
    """Σₖ mₖ ⊙ JᵀJ mₖ differs from diag(JᵀJ) in the base angles (the angular
    Newton–Euler row at g couples g-2 and g+1, one colour) and nowhere
    inside the clip's feet and forces; the emulation gives the former."""
    x, args, fn, lin = _setup([9], "DYN_H")
    n = x.shape[1]
    eye = torch.eye(n, dtype=F64).unsqueeze(1)
    exact = torch.stack([fn(e)[0, i] for i, e in enumerate(eye)]).reshape(9, co.DOF)
    masks = lm.frame_coloring_masks(9, co.DOF, dtype=F64, device="cpu")
    got = lin.diag(masks).reshape(9, co.DOF)
    assert _rel(got.reshape(1, -1), _coloring(fn, masks, x)) <= REL
    gap = (got - exact).abs() / exact.abs().amax(0)
    assert float(gap[:, 3:6].max()) > 1e-2
    assert float(gap[:, 6:].max()) < 1e-12


def _planted(lin, fault):
    bad = copy.copy(lin)
    if fault == "dyn":  # the Newton–Euler block, which no hinge scales
        p = lin.product
        bad.product = jtjv.PhysicsProduct(p.accel, p.active[1:]).emulated(p.tile)
    elif fault == "tie as 1":
        bad.hinge = dict(lin.hinge, force=torch.where(lin.hinge["force"] == 0.5, 1.0,
                                                      lin.hinge["force"]))
    else:
        bad.hinge = dict(lin.hinge, **{fault: lin.hinge[fault] * 0})
    return bad


@pytest.mark.parametrize("fault,start", [("dyn", False), ("leg", False), ("height", False),
                                         ("force", False), ("tie as 1", True)])
def test_a_planted_fault_fails_the_comparison(fault, start):
    x, args, fn, lin = _setup([12, 9, 5], "DYN_H", start, tile=4)
    v = torch.from_numpy(np.random.default_rng(3).normal(size=x.shape))
    want = fn(v)
    assert _rel(lin(v), want) <= REL
    assert _rel(_planted(lin, fault)(v), want) > 1e3 * REL


def test_each_structure_has_its_own_product_and_graph_key(monkeypatch):
    """On the CPU the residual names no supplier; with the emulation put in
    the kernel's place, each stage's solves take their structure's product,
    count its path, and key their graph by it, and a caller that passes no
    product (the benchmark's traced step) finds the stage's key."""
    products = {s: jtjv.product_for(*co._structure(*wr)) for s, wr in STRUCTURES.items()}
    assert len({id(p) for p in products.values()}) == 4
    assert len({p.flags for p in products.values()}) == 4
    assert all(jtjv.product_for(*co._structure(*wr)) is products[s]
               for s, wr in STRUCTURES.items())

    emulated = emulate(monkeypatch)
    graphs = RecordingGraphs()
    pb, x, lams = phys_jtjv_point([6, 5], "cpu", F64)
    masks = lm.frame_coloring_masks(6, co.DOF, dtype=F64, device="cpu")
    cfg = lm.LMConfig(max_iters=1, cg_iters=2)
    profiling.reset()
    for w, rho in STRUCTURES.values():
        co.run_stage(x, pb, lams, w, rho, 2, cfg, masks, graphs)
    assert profiling.snapshot()["counters"] == {"lm.jtjv.phys_emulation": 8}
    keys = graphs.keys[::2]
    assert len(set(keys)) == 4 and graphs.keys[1::2] == keys
    assert len(emulated) == 4
    for key, s in zip(keys, STRUCTURES):
        assert emulated[products[s]] in key
    w, rho = STRUCTURES["DYN"]
    lm.lm_solve(co.make_al_residual_fn(w, rho), x, (pb, lams, w, rho),
                lm.LMConfig(max_iters=3, cg_iters=2), masks, graphs)
    assert graphs.keys[-1] == keys[1]


def test_an_lm_stage_with_the_emulation_follows_the_autograd_stage(monkeypatch):
    pb, x, lams = phys_jtjv_point([8, 6], "cpu", F64, start=True)
    masks = lm.frame_coloring_masks(8, co.DOF, dtype=F64, device="cpu")
    cfg = lm.LMConfig(max_iters=3, cg_iters=15, init_lambda=1e-2)
    w, rho = STRUCTURES["DYN"]
    want = co.run_stage(x, pb, lams, w, rho, 1, cfg, masks)
    emulate(monkeypatch, tile=3)
    got = co.run_stage(x, pb, lams, w, rho, 1, cfg, masks)
    assert not torch.equal(got[0], x)  # the stage moved
    assert float((got[0] - want[0]).abs().max()) <= 1e-9 * float((want[0] - x).abs().max())


def test_a_cpu_physics_call_takes_autograd_in_every_solve():
    profiling.reset()
    pb, _ = batch_lib.pad_phys_inputs([walking_input(8, seed=0), walking_input(6, seed=1)],
                                      device="cpu", dtype=F64)
    batch_lib.solve_physics_full_batch(pb, cfg=co.SolveConfig(1, 1, 1, 1, lm=lm.LMConfig(1, 2,
                                                                                           1e-2)))
    assert profiling.snapshot()["counters"]["lm.jtjv.autograd"] == 5  # 4 AL stages, stage 3
    assert "lm.jtjv.phys_kernel" not in profiling.snapshot()["counters"]
    assert co.make_al_residual_fn(*STRUCTURES["DYN"]).product_for(torch.zeros(1)) is None


def test_the_kernel_wrapper_refuses_cpu_tensors():
    x, args, fn, lin = _setup([4, 3], "DYN_H")
    prod = jtjv.product_for(*co._structure(*STRUCTURES["DYN_H"]))
    assert prod.path == "phys_kernel"
    with pytest.raises(ValueError, match="CUDA"):
        prod(x, *args)(torch.ones_like(x))
    with pytest.raises(ValueError, match="mode"):
        jtjv.phys_jtjv("jvp", lin)
    with pytest.raises(ValueError, match="blocks"):
        jtjv.PhysicsProduct(True, ("dyn", "torque"))
