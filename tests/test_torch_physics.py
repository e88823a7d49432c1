"""chd_tpu_torch's physics stage (physics/, parallel/batch.py) against
chd_tpu's, on the same seeded inputs.

Tolerances:
- ``srbd``, ``constraints``, ``cost_residuals``, the five AL residual graphs
  (FIT, DYN, DYN_H, stage 3, stage 4), ``soft_contact``,
  ``duration_residuals`` and ``rasterize`` in float64 on a ragged batch (a
  walking clip of 24 frames, a hopping clip of 20): max |d| <= 1e-10 of the
  largest value (the port's batched ops sum in other orders than chd_tpu's
  per-problem ones);
- the hinges' derivative at an exact tie: the port's tangent of the DYN
  residual at the first step (zero forces, so the friction-cone rows sit at
  ties) equals chd_tpu's to 1e-10, and a hinge whose derivative at a tie is
  1 (``clamp``) does not;
- ``prepare_input`` on the three ``tests/fixtures/prepare_input`` cases:
  the text files against ``ref_out`` at atol 2e-4 (the flow of
  tests/test_goldens.py), the problem against chd_tpu's at rtol 1e-6 (both
  cast to float32);
- ``towr_io``: the text written for the same arrays is chd_tpu's, byte for
  byte; ``load_results`` agrees with chd_tpu's to 1e-12 and round-trips;
- the staged solve, ``solve_physics_full_batch`` on the ragged pair (24 and
  20 frames), AL 1/1/1/1, LM 3:10, float64: every result's trajectories
  within 1e-6 m of chd_tpu's, the same rasterized contacts and
  ``durations_ok``;
- the single-problem entry points equal the batched path on a batch of one;
- the FIT-stage golden (``phys_fit_scipy_f20_seed0.npz``) at the default
  budget in float32: the gates of tests/test_goldens.py (marked slow, as
  chd_tpu's is: ~20 s on the CPU; ``chip_smoke.py`` [18] holds it on the
  card).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chd_tpu.kinematics.lm import LMConfig as JaxLMConfig
from chd_tpu.parallel import batch as jax_batch
from chd_tpu.physics import collocation as jax_co
from chd_tpu.physics import durations as jax_dur
from chd_tpu.physics import srbd as jax_srbd
from chd_tpu.physics import synth as jax_synth
from chd_tpu.physics import towr_io as jax_towr_io
from chd_tpu.physics.prepare import prepare_input as jax_prepare_input
from chd_tpu_torch.core import bvh
from chd_tpu_torch.kinematics.lm import LMConfig
from chd_tpu_torch.parallel import batch
from chd_tpu_torch.physics import collocation as co
from chd_tpu_torch.physics import durations as dur
from chd_tpu_torch.physics import srbd, synth, towr_io
from chd_tpu_torch.physics.prepare import prepare_input
from chd_tpu_torch.physics.types import PhysResult
from chip_smoke import phys_fit_golden_gates, phys_golden_gates_pass

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's CPU solves: they are many small
    ops, whose every parallel region stalls when the other test workers
    hold the cores.
    Not raised again after the module: in one process, a count raised back
    makes MKL's next batched LU (``torch.linalg.solve_ex``) hang."""
    torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_executables():
    yield
    jax.clear_caches()


def _jax64(tree):
    return type(tree)(*(None if v is None else jnp.asarray(np.asarray(v), jnp.float64)
                        for v in tree))


def _row(tree, b):
    return type(tree)(*(None if v is None else v[b] for v in tree))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, rel=1e-10):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= rel * scale, float(np.abs(got - want).max())


@pytest.fixture(scope="module")
def ragged():
    """(port batch, chd_tpu batch, chd_tpu per-problem inputs, x, lams): a
    24-frame walking clip and a 20-frame hopping clip padded to 24, float64,
    with seeded variables near the input and forces of a few hundred N."""
    clips = [synth.walking_input(24, seed=0), synth.hopping_input(20, seed=2)]
    jclips = [_jax64(jax_synth.walking_input(24, seed=0)),
              _jax64(jax_synth.hopping_input(20, seed=2))]
    pb, lens = batch.pad_phys_inputs(clips, device="cpu", dtype=F64)
    jpb, jlens = jax_batch.pad_phys_inputs(jclips)
    np.testing.assert_array_equal(lens, jlens)
    rng = np.random.default_rng(5)
    B, F = 2, 24
    x = co.join_vars(pb.base_lin, pb.base_ang, pb.ee_pos, torch.zeros_like(pb.ee_pos))
    x = x + torch.from_numpy(rng.normal(0, 0.02, x.shape))
    force = torch.from_numpy(rng.normal(0, 1.0, (B, F, 4, 3)) * [60, 60, 250])
    x = x.reshape(B, F, 30)
    x[..., 18:] = force.reshape(B, F, 12)
    x = x.reshape(B, -1)
    lams = co.Constraints(*(torch.from_numpy(rng.normal(0, 0.5, v.shape))
                            for v in co.init_multipliers(pb)))
    return pb, jpb, [_row(jpb, b) for b in range(B)], x, lams


def test_synth_clips_equal_chd_tpu():
    for fn, jfn in ((synth.walking_input, jax_synth.walking_input),
                    (synth.hopping_input, jax_synth.hopping_input)):
        for got, want in zip(fn(100, seed=3), jfn(100, seed=3)):
            np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_srbd_matches_chd_tpu(ragged):
    pb, _, jrows, x, _ = ragged
    base_lin, base_ang, ee, force = co.split_vars(x, 24)
    got = srbd.dynamic_violation(base_lin, base_ang, ee, force, pb.contact, pb.inertia, pb.mass,
                                 -pb.floor_normal, pb.dt)
    omega, omega_dot = srbd.angular_velocity(base_ang, pb.dt)
    for b, jp in enumerate(jrows):
        jx = jnp.asarray(_np(x[b]))
        jl, ja, je, jf = jax_co.split_vars(jx, 24)
        want = jax_srbd.dynamic_violation(jl, ja, je, jf, jp.contact, jp.inertia, jp.mass,
                                          -jp.floor_normal, jp.dt)
        _close(got[b], want)
        _close(srbd.rot_zyx(base_ang)[b], jax_srbd.rot_zyx(ja))
        _close(srbd.euler_rate_matrix(base_ang)[b], jax_srbd.euler_rate_matrix(ja))
        _close(srbd.central_diff(base_lin, pb.dt)[b], jax_srbd.central_diff(jl, jp.dt))
        w, wd = jax_srbd.angular_velocity(ja, jp.dt)
        _close(omega[b], w)
        _close(omega_dot[b], wd)


def test_constraints_and_costs_match_chd_tpu(ragged):
    pb, _, jrows, x, _ = ragged
    cons = co.constraints(x, pb)
    costs = {w: co.cost_residuals(x, pb, w) for w in (co.FIT_COST, co.DYN_COST)}
    assert cons._fields == tuple(sorted(cons._fields))
    for b, jp in enumerate(jrows):
        jx = jnp.asarray(_np(x[b]))
        want = jax_co.constraints(jx, jp)
        assert sorted(want) == list(cons._fields)
        for name in cons._fields:
            _close(getattr(cons, name)[b], want[name])
        for w, got in costs.items():
            _close(got[b], jax_co.cost_residuals(jx, jp, jax_co.CostW(*w)))
        stats = co.violation_stats(x, pb)
        for name, v in jax_co.violation_stats(jx, jp).items():
            _close(stats[name][b], v)


def _specs(pb, jpb):
    spec = batch.pad_duration_specs(pb)
    jspec = jax_batch.pad_duration_specs(jpb)
    for got, want in zip(spec, jspec):
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    return spec, jspec


STAGES = {
    "fit": (co.FIT_COST, co.FIT_RHO),
    "dyn": (co.dyn_cost_for(co.PhysWeights()), co.DYN_RHO),
    "dyn_h": (co.dyn_cost_for(co.PhysWeights()), co.DYN_H_RHO),
    "stage4": (co.dyn_cost_for(co.PhysWeights(), accel=0.0), co.DYN_H_RHO),
}


@pytest.mark.parametrize("stage", sorted(STAGES) + ["stage3"])
def test_al_residuals_match_chd_tpu(ragged, stage):
    pb, jpb, jrows, x, lams = ragged
    if stage == "stage3":
        spec, jspec = _specs(pb, jpb)
        w, rho = STAGES["stage4"]
        d = spec.durations + torch.from_numpy(
            np.random.default_rng(6).normal(0, 0.01, spec.durations.shape)) * spec.phase_mask
        xa = torch.cat([x, d.reshape(2, -1)], dim=-1)
        got = co.make_stage3_residual_fn(w, rho)(xa, pb, lams, spec, w, rho, 0.1)
        jfn = jax_co.make_stage3_residual_fn(jax_co.CostW(*w), jax_co.Rho(*rho), 0.1, 24)
    else:
        w, rho = STAGES[stage]
        got = co.make_al_residual_fn(w, rho)(x, pb, lams, w, rho)
        jfn = jax_co.make_al_residual_fn(jax_co.CostW(*w), jax_co.Rho(*rho))
    for b, jp in enumerate(jrows):
        jl = {k: jnp.asarray(_np(v[b])) for k, v in lams._asdict().items()}
        if stage == "stage3":
            want = jfn(jnp.asarray(_np(xa[b])), jp, jl, _row(jspec, b))
        else:
            want = jfn(jnp.asarray(_np(x[b])), jp, jl)
        _close(got[b], want)


def test_multiplier_update_matches_chd_tpu(ragged):
    pb, _, jrows, x, lams = ragged
    got = co.update_multipliers(x, pb, lams, co.DYN_RHO)
    for b, jp in enumerate(jrows):
        jl = {k: jnp.asarray(_np(v[b])) for k, v in lams._asdict().items()}
        want = jax_co.update_multipliers(jnp.asarray(_np(x[b])), jp, jl, jax_co.DYN_RHO)
        for name in got._fields:
            _close(getattr(got, name)[b], want[name])


def test_durations_match_chd_tpu(ragged):
    pb, jpb, jrows, _, _ = ragged
    spec, jspec = _specs(pb, jpb)
    rng = np.random.default_rng(8)
    d = spec.durations + torch.from_numpy(rng.normal(0, 0.02, spec.durations.shape))
    d = d * spec.phase_mask
    soft = dur.soft_contact(d, spec, 24, pb.dt)
    raster = dur.rasterize(d, spec, 24, pb.dt)
    res = dur.duration_residuals(d, spec, 0.1)
    for b, jp in enumerate(jrows):
        js, jd = _row(jspec, b), jnp.asarray(_np(d[b]))
        _close(soft[b], jax_dur.soft_contact(jd, js, 24, jp.dt))
        np.testing.assert_array_equal(_np(raster[b]), np.asarray(jax_dur.rasterize(jd, js, 24,
                                                                                   jp.dt)))
        _close(res[b], jax_dur.duration_residuals(jd, js, 0.1))
    # the unperturbed durations rasterize back to the input schedule
    np.testing.assert_array_equal(_np(dur.rasterize(spec.durations, spec, 24, pb.dt)),
                                  _np(pb.contact))


def test_hinge_derivative_at_a_tie_matches_chd_tpu(ragged, monkeypatch):
    """At the first step the forces are zero: −fn = 0 and ft² − μ²fn² = 0
    exactly, so the friction-cone rows of the DYN residual are hinged at
    ties. chd_tpu's jnp.maximum has derivative 1/2 there, and so has the
    port's torch.maximum."""
    pb, _, jrows, _, _ = ragged
    x0 = co.join_vars(pb.base_lin, pb.base_ang, pb.ee_pos, torch.zeros_like(pb.ee_pos))
    zero = co.init_multipliers(pb)
    w, rho = STAGES["dyn"]
    fn = co.make_al_residual_fn(w, rho)
    v = torch.from_numpy(np.random.default_rng(9).normal(size=x0.shape))

    def tangent():
        return torch.func.jvp(lambda x: fn(x, pb, zero, w, rho), (x0,), (v,))[1]

    got = tangent()
    jfn = jax_co.make_al_residual_fn(jax_co.CostW(*w), jax_co.Rho(*rho))
    want = []
    for b, jp in enumerate(jrows):
        jl = {k: jnp.zeros(t.shape[1:], jnp.float64) for k, t in zero._asdict().items()}
        want.append(np.asarray(jax.jvp(lambda x: jfn(x, jp, jl), (jnp.asarray(_np(x0[b])),),
                                       (jnp.asarray(_np(v[b])),))[1]))
        _close(got[b], want[b])
    assert float(co._hinge(torch.zeros(()))) == 0.0
    assert torch.func.grad(co._hinge)(torch.zeros((), dtype=F64)) == 0.5
    monkeypatch.setattr(co, "_hinge", lambda t: torch.clamp(t, min=0.0))
    assert float(np.abs(_np(tangent()) - np.stack(want)).max()) > 1e-3


@pytest.mark.parametrize("tag,character,combined_contacts", [
    ("ybot", "ybot", False),
    ("combined", "combined", False),
    ("ybot_cc", "ybot", True),
])
def test_prepare_input_matches_golden_and_chd_tpu(tmp_path, tag, character, combined_contacts):
    from chd_tpu.core import bvh as jax_bvh

    cdir = os.path.join(FIXTURES, "prepare_input", tag)
    anim, _, _ = bvh.load(os.path.join(cdir, "motion.bvh"))
    with open(os.path.join(cdir, "floor_out.txt")) as f:
        normal = np.array([float(x) for x in f.readline().split()])
        point = np.array([float(x) for x in f.readline().split()])
    contacts = np.load(os.path.join(cdir, "foot_contacts.npy"))
    F = contacts.shape[0]
    out = str(tmp_path / "ours")
    got = prepare_input(anim, normal, point, contacts, character, start_idx=0, end_idx=F,
                        dt=1.0 / 30.0, out_dir=out, combined_contacts=combined_contacts)
    for fname in ["skel_info.txt", "motion_info.txt", "terrain_info.txt", "contact_info.txt"]:
        with open(os.path.join(cdir, "ref_out", fname)) as f:
            ref_rows = [[float(v) for v in ln.split()] for ln in f if ln.strip()]
        with open(os.path.join(out, fname)) as f:
            our_rows = [[float(v) for v in ln.split()] for ln in f if ln.strip()]
        assert len(ref_rows) == len(our_rows), fname
        for i, (a, b) in enumerate(zip(ref_rows, our_rows)):
            np.testing.assert_allclose(b, a, atol=2e-4, err_msg=f"{fname} line {i}")
    janim, _, _ = jax_bvh.load(os.path.join(cdir, "motion.bvh"))
    want = jax_prepare_input(janim, normal, point, contacts, character, start_idx=0, end_idx=F,
                             dt=1.0 / 30.0, combined_contacts=combined_contacts)
    for name in want._fields:
        if getattr(want, name) is None:
            assert getattr(got, name) is None
            continue
        assert _np(getattr(got, name)).dtype == np.float32, name
        np.testing.assert_allclose(_np(getattr(got, name)), np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def test_towr_io_text_equals_chd_tpu_and_round_trips(tmp_path):
    rng = np.random.default_rng(4)
    F = 9
    for dtype in (np.float32, np.float64):
        res = PhysResult(
            dt=np.asarray(1 / 30, dtype), base_lin=rng.normal(size=(F, 3)).astype(dtype),
            base_ang=rng.uniform(-0.5, 0.5, (F, 3)).astype(dtype),
            ee_pos=rng.normal(size=(4, F, 3)).astype(dtype),
            ee_force=rng.normal(0, 300, (4, F, 3)).astype(dtype),
            contact=(rng.uniform(size=(4, F)) > 0.4).astype(dtype))
        ours, theirs = str(tmp_path / "ours.txt"), str(tmp_path / "theirs.txt")
        towr_io.save_solution(PhysResult(*(torch.from_numpy(np.asarray(v)) for v in res)), ours)
        jax_towr_io.save_solution(res, theirs)
        with open(ours) as a, open(theirs) as b:
            assert a.read() == b.read()
        got, want = towr_io.load_results(ours), jax_towr_io.load_results(ours)
        assert got.num_feet == want.num_feet == 4 and got.dt == want.dt
        for name in got._fields[2:]:
            np.testing.assert_allclose(getattr(got, name), np.asarray(getattr(want, name)),
                                       atol=1e-12, err_msg=name)
        np.testing.assert_allclose(got.base_pos, -res.base_lin[:, [0, 2, 1]], atol=1e-9)
        np.testing.assert_array_equal(got.feet_contact, res.contact.T.astype(int))
    log = str(tmp_path / "success_log.txt")
    towr_io.save_success_log(log, True, False)
    assert towr_io.load_success_log(log) == jax_towr_io.load_success_log(log) == {
        "dynamics": True, "durations": False}


def test_staged_solve_matches_chd_tpu():
    """solve_physics_full_batch, the whole FIT→DYN→HEIGHT→durations→polish
    schedule, on a ragged pair: the padded frames repeat the last one and
    the base pins read the padded length, as in chd_tpu."""
    clips = [synth.walking_input(24, seed=0), synth.walking_input(20, seed=1)]
    jclips = [_jax64(jax_synth.walking_input(24, seed=0)),
              _jax64(jax_synth.walking_input(20, seed=1))]
    pb, lens = batch.pad_phys_inputs(clips, device="cpu", dtype=F64)
    jpb, _ = jax_batch.pad_phys_inputs(jclips)
    got = batch.solve_physics_full_batch(pb, cfg=co.SolveConfig(1, 1, 1, 1, lm=LMConfig(3, 10, 1e-2)))
    want = jax_batch.solve_physics_full_batch(
        jpb, cfg=jax_co.SolveConfig(1, 1, 1, 1, lm=JaxLMConfig(3, 10, 1e-2)))
    for g, w in zip(got[:3], want[:3]):
        for name in ("base_lin", "base_ang", "ee_pos"):
            assert float(np.abs(_np(getattr(g, name)) - np.asarray(getattr(w, name))).max()) <= 1e-6
        np.testing.assert_allclose(_np(g.ee_force), np.asarray(w.ee_force), atol=1e-6, rtol=1e-9)
        np.testing.assert_array_equal(_np(g.contact), np.asarray(w.contact))
    for name, v in want[3].items():
        np.testing.assert_allclose(_np(got[3][name]), np.asarray(v), rtol=1e-8, atol=1e-10)
    np.testing.assert_array_equal(got[4], np.asarray(want[4]))
    # the unbatched results keep each sequence's own length
    out = batch.unbatch_results(got[2], lens)
    assert [r.base_lin.shape[0] for r in out] == [24, 20] and out[1].contact.shape == (4, 20)


def test_single_problem_entry_points_equal_the_batch():
    clip = synth.walking_input(16, seed=4)
    cfg = co.SolveConfig(1, 1, 1, 1, lm=LMConfig(2, 6, 1e-2))
    pb, _ = batch.pad_phys_inputs([clip], device="cpu", dtype=F64)
    fit_b, dyn_b = batch.solve_physics_batch(pb, cfg=cfg)
    fit, dyn, stats = co.solve_physics(clip, cfg=cfg, device="cpu", dtype=F64)
    for one, many in ((fit, fit_b), (dyn, dyn_b)):
        for a, b in zip(one, batch.unbatch_results(many, [16])[0]):
            np.testing.assert_array_equal(a, b)
    res, stats3, ok = co.solve_physics_durations(clip, dyn, cfg=cfg, device="cpu", dtype=F64)
    res_b, stats_b, ok_b = batch.solve_physics_durations_batch(pb, dyn_b, cfg=cfg)
    for a, b in zip(res, batch.unbatch_results(res_b, [16])[0]):
        np.testing.assert_array_equal(a, b)
    assert ok == bool(ok_b[0]) and stats3 == {k: float(v[0]) for k, v in stats_b.items()}
    assert set(stats) == set(co.Constraints._fields)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the test is of a machine without it")
    clip = synth.walking_input(8)
    for call in (lambda: batch.pad_phys_inputs([clip]), lambda: co.solve_physics(clip)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.slow
def test_physics_fit_matches_scipy_golden():
    """The code of chip_smoke.py's phase 18, on the CPU."""
    gates = phys_fit_golden_gates("cpu")
    assert phys_golden_gates_pass(gates), gates
