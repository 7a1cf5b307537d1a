"""The acoustic-wave slice of stfem_tpu_torch vs stfem_tpu (CPU): the
Schur-reduced wave tables, the FP64 slab residual with the wave couplings,
and the wave hierarchy at 4^3 cells, Q4 x dG(2), 4 steps per slab with
run_wave_bench's V-cycle (Relaxation, inner=2, variable smoothing,
Identity levels skipped, Direct coarse, 20-step power estimates on every
full level, float32 levels here; the bf16 levels and bench_wave's route are
in test_torch_wave_bf16.py, so that the two files run on separate workers).

Tolerances: the tables are equal (both packages build them in NumPy);
the v-recovery 1e-5 of the max in float32 and 1e-12 in FP64 against a
numpy solve; the residual 1e-12 of ||rhs|| (float-float carries ~2^-48
per operation, FP64 ~2^-53); omega 1e-5 relative (20 float32 power
sweeps; the two packages' float32 sums differ in order); one V-cycle with
the JAX factors carried 1e-5 relative; equal Richardson counts with
float32 levels."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu import types as jtypes
from stfem_tpu.krylov import richardson_solve as jrichardson
from stfem_tpu.mesh.grid import StructuredMesh as JMesh
from stfem_tpu.ops.floatfloat import FFSlabResidual, ff_from_f64
from stfem_tpu.ops.spatial import LaplaceMassOperator as JOp
from stfem_tpu.stmg.gmg import GMGParams as JParams, build_stmg as jbuild
from stfem_tpu.system import SystemMatrix as JSys
from stfem_tpu.time import tables as jtab
from stfem_tpu_torch import types as ttypes
from stfem_tpu_torch.integrators import WaveVelocityRecovery
from stfem_tpu_torch.krylov import richardson_solve
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.kronfac import KronAssembled
from stfem_tpu_torch.ops.slab_residual import SlabResidual64
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
from stfem_tpu_torch.stmg.gmg import bench_params, build_stmg
from stfem_tpu_torch.system import SystemMatrix
from stfem_tpu_torch.time import tables as ttab
from stfem_tpu_torch.utils.carry import load_gmg, load_vanka

torch.set_num_threads(1)

CELLS, NTAO, TAU = 4, 4, 1.0 / 16.0


@pytest.fixture(autouse=True, scope="module")
def _no_estimate_cache():
    """The port's hierarchies estimate afresh: no estimate disk cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STFEM_EIG_CACHE", "0")
        yield


def _eq(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("tname,r", [(t, r) for t in ("DG", "CGP")
                                     for r in range(4)
                                     if not (t == "CGP" and r == 0)])
def test_wave_tables_equal(tname, r):
    jt, tt = jtypes.TimeStepType[tname], ttypes.TimeStepType[tname]
    first = jtab.get_fe_time_weights(jt, r, 0.125, 1)
    for n_at_once in (1, 2, 3, 4):
        _eq(jtab.get_fe_time_weights_wave(jt, *first, n_at_once),
            ttab.get_fe_time_weights_wave(tt, *first, n_at_once))
    lad = ["h", "tau", "p", "k", "p"] if r > 1 else ["h", "tau", "p"]
    degs = [r - 1, r] if r > 1 else [r]
    _eq(jtab.get_fe_time_weights_wave_sequence(
            jt, 1 / 16, 4, [jtypes.MGType[m] for m in lad], degs),
        ttab.get_fe_time_weights_wave_sequence(
            tt, 1 / 16, 4, [ttypes.MGType[m] for m in lad], degs))


def _wave_residual_inputs(random_gamma_k):
    """The inputs of tests/test_floatfloat.py::
    test_ff_wave_slab_residual_parity, optionally with a nonzero K-path
    previous-u table (the DG wave's own is zero)."""
    jm = JMesh([2, 2, 2], [0.0] * 3, [1.0] * 3, refinement=1)
    tm = StructuredMesh([2, 2, 2], [0.0] * 3, [1.0] * 3, refinement=1)
    deg = 3
    jK = JOp(jm, deg, deg + 1, 0.0, 1.0, dtype=jnp.float64)
    jM = JOp(jm, deg, deg + 1, 1.0, 0.0, dtype=jnp.float64)
    tK = LaplaceMassOperator(tm, deg, deg + 1, 0.0, 1.0, dtype=torch.float64,
                             device="cpu")
    tM = LaplaceMassOperator(tm, deg, deg + 1, 1.0, 0.0, dtype=torch.float64,
                             device="cpu")
    first = jtab.get_fe_time_weights(jtypes.TimeStepType.DG, 2, 1 / 16, 1)
    A, B, uK, uM, vM = jtab.get_fe_time_weights_wave(
        jtypes.TimeStepType.DG, *first, 4)
    rng = np.random.default_rng(11)
    nb = A.shape[0]
    x = rng.standard_normal((nb,) + jm.dof_shape(deg))
    prev_u = rng.standard_normal(jm.dof_shape(deg))
    prev_v = rng.standard_normal(jm.dof_shape(deg))
    fslab = rng.standard_normal(x.shape)
    if random_gamma_k:
        uK = np.zeros_like(uK)
        uK[:3, 0] = rng.standard_normal(3)
    return (jK, jM, tK, tM), (A, B, uK, uM, vM), (x, prev_u, prev_v, fslab)


@pytest.mark.parametrize("random_gamma_k", [False, True])
def test_wave_slab_residual(random_gamma_k):
    """Full step coupling, Gamma_K and Gamma_v: the FP64 residual against
    the f64 SystemMatrix oracle and (the wave's own tables) stfem_tpu's
    float-float engine."""
    (jK, jM, tK, tM), (A, B, uK, uM, vM), (x, pu, pv, f) = \
        _wave_residual_inputs(random_gamma_k)
    run = lambda op, a: np.asarray(jax.jit(op.vmult)(jnp.asarray(a)))
    rhs_ref = (run(JSys(jK, jM, uK, uM), pu[None])
               + run(JSys(jK, jM, np.zeros_like(vM), vM), pv[None]) + f)
    r_ref = rhs_ref - run(JSys(jK, jM, A, B), x)
    res = SlabResidual64(KronAssembled(tK, tM, torch.float64), tK.mask_np,
                         A, B, uM, Gamma_K=uK, Gamma_v=vM)
    assert res.full_coupling
    t = torch.as_tensor
    r, rn, bn = res.residual(t(pu), t(x), t(f), t(pv))
    scale = np.linalg.norm(rhs_ref.reshape(-1))
    assert np.linalg.norm((r.numpy() - r_ref).reshape(-1)) / scale <= 1e-12
    np.testing.assert_allclose(float(rn), np.linalg.norm(r_ref.reshape(-1)),
                               rtol=1e-12)
    np.testing.assert_allclose(float(bn), scale, rtol=1e-12)
    if random_gamma_k:
        # stfem_tpu's jitted float-float residual is off by ~2e-9 of ||rhs||
        # on the K-path rows with a nonzero Gamma_K (its eager rhs() is not);
        # the DG wave's own Gamma_K is zero, so the bench never meets it
        return
    ffres = FFSlabResidual(jK, jM, A, B, uM, Gamma_K=uK, Gamma_v=vM)
    (rh, rl), _, _ = jax.jit(ffres.residual)(
        ff_from_f64(jnp.asarray(pu)), ff_from_f64(jnp.asarray(x)),
        ff_from_f64(jnp.asarray(f)), prev_v_ff=ff_from_f64(jnp.asarray(pv)))
    r_ff = np.asarray(rh, np.float64) + np.asarray(rl, np.float64)
    assert np.linalg.norm((r.numpy() - r_ff).reshape(-1)) / scale <= 1e-12


@pytest.mark.parametrize("n_steps", [1, 4])
def test_wave_velocity_recovery(n_steps):
    """Every step's v (float32) and the last step's v (FP64) against the
    dense numpy oracle  A1 v_s = B1 u_s - G1 u_{s-1}[last]  (DG), with the
    tables stfem_tpu's wave bench uses."""
    A1, B1, G1, _ = jtab.get_fe_time_weights(jtypes.TimeStepType.DG, 2,
                                             TAU, 1)
    rng = np.random.default_rng(n_steps)
    u = rng.standard_normal((3 * n_steps, 5, 6))
    prev = rng.standard_normal((5, 6))
    pu = np.concatenate([prev[None], u[2::3][:-1]])     # each step's prev
    us = u.reshape(n_steps, 3, -1)
    rhs = (np.einsum("ij,sjn->sin", B1, us)
           - G1[:, 0][None, :, None] * pu.reshape(n_steps, 1, -1))
    ref = np.linalg.solve(A1[None], rhs).reshape(u.shape)
    rec = WaveVelocityRecovery(A1, B1, G1, n_steps, device="cpu")
    got = rec.all_steps(torch.as_tensor(u), torch.as_tensor(prev))
    assert got.dtype == torch.float32
    assert np.max(np.abs(got.double().numpy() - ref)) <= 1e-5 * np.max(
        np.abs(ref))
    last = rec.last(torch.as_tensor(u), torch.as_tensor(prev)).numpy()
    np.testing.assert_allclose(last, ref[-1], rtol=1e-12,
                               atol=1e-12 * np.max(np.abs(ref)))


def _jax_params(bf16):
    """run_wave_bench's GMGParams (bench.py:550-571)."""
    return JParams(smoother=jtypes.SupportedSmoothers.Relaxation,
                   smoothing_range=1.0, coarse_grid_smoother_type="Direct",
                   smoother_inner_iterations=2, skip_identity_levels=True,
                   vanka_bf16=bf16, level_bf16=bf16, eig_exact=False,
                   eig_proxy_cells=0)


def _torch_params(bf16):
    return bench_params(ttypes.ProblemType.wave, level_bf16=bf16,
                        vanka_bf16=bf16,
                        eig_exact=False)


def build_wave_slice(bf16):
    """(jax gmg, torch gmg, jax f32 outer operator, torch f32 outer
    operator, a fixed masked rhs), each package building its own wave
    hierarchy with bf16 or float32 levels."""
    saved = os.environ.get("STFEM_EIG_CACHE")
    os.environ["STFEM_EIG_CACHE"] = "0"     # no repo-local estimate memo
    try:
        jm = JMesh([2, 2, 2], [0.0] * 3, [1.0] * 3, refinement=1)
        tm = StructuredMesh([2, 2, 2], [0.0] * 3, [1.0] * 3, refinement=1)
        jg = jbuild(jm, 2, 4, jtypes.TimeStepType.DG, NTAO, TAU,
                    problem=jtypes.ProblemType.wave, dtype=jnp.float32,
                    fe_degree_min=1, params=_jax_params(bf16))
        tg = build_stmg(tm, 2, 4, ttypes.TimeStepType.DG, NTAO, TAU,
                        _torch_params(bf16), device="cpu",
                        problem=ttypes.ProblemType.wave)
    finally:
        if saved is None:
            os.environ.pop("STFEM_EIG_CACHE")
        else:
            os.environ["STFEM_EIG_CACHE"] = saved
    first = jtab.get_fe_time_weights(jtypes.TimeStepType.DG, 2, TAU, 1)
    A, B = jtab.get_fe_time_weights_wave(jtypes.TimeStepType.DG, *first,
                                         NTAO)[:2]
    jK = JOp(jm, 4, 5, 0.0, 1.0, dtype=jnp.float32)
    jM = JOp(jm, 4, 5, 1.0, 0.0, dtype=jnp.float32)
    tK = LaplaceMassOperator(tm, 4, 5, 0.0, 1.0, dtype=torch.float32,
                             device="cpu")
    tM = LaplaceMassOperator(tm, 4, 5, 1.0, 0.0, dtype=torch.float32,
                             device="cpu")
    b = np.random.default_rng(0).standard_normal(
        (A.shape[0],) + jK.dof_shape).astype(np.float32) * jK.mask_np
    return jg, tg, JSys(jK, jM, A, B), SystemMatrix(tK, tM, A, B), b


@pytest.fixture(scope="module")
def slice_setup():
    return build_wave_slice(False)


def omegas(gmg):
    """Relaxation omegas above the (directly solved) coarsest level."""
    return [None] + [getattr(lvl.smoother, "omega", None)
                     for lvl in gmg.levels[1:]]


def check_ladder(jg, tg):
    assert [m.name for m in jg.mg_type_level] == \
        [m.name for m in tg.mg_type_level]
    assert [s.name for s in jg.precondition_sequence] == \
        [s.name for s in tg.precondition_sequence]
    assert len(jg.levels) == len(tg.levels) and tg.variable
    for level, (jl, tl) in enumerate(zip(jg.levels, tg.levels)):
        assert (jl.n_blocks, tuple(jl.dof_shape)) == \
            (tl.n_blocks, tuple(tl.dof_shape))
        for name in ("Alpha", "Beta"):
            np.testing.assert_array_equal(
                np.asarray(getattr(jl.matrix, name)).astype(np.float64),
                getattr(tl.matrix, name).double().numpy())
        if level > 0:
            assert type(jl.smoother).__name__ == type(tl.smoother).__name__
            pre = getattr(tl.smoother, "precond", None)
            # the wave tables have no rank-1 step coupling: dense T x T
            assert pre is None or (pre.n_steps == 1 and pre.TTg is not None)


def check_richardson_iterations(jg, tg, jmat, tmat, b, slack):
    jres = jax.jit(lambda v: jrichardson(
        jmat.vmult, v, jnp.zeros_like(v), jg.vmult, maxiter=40,
        reltol=1e-6))(jnp.asarray(b))
    bt = torch.as_tensor(b)
    tres = richardson_solve(tmat.vmult, bt, torch.zeros_like(bt), tg.vmult,
                            maxiter=40, reltol=1e-6)
    assert bool(jres.converged) and tres.converged
    assert abs(int(jres.iterations) - tres.iterations) <= slack, \
        (int(jres.iterations), tres.iterations)


def test_level_ladder(slice_setup):
    check_ladder(*slice_setup[:2])


def test_power_omega_per_level(slice_setup):
    jg, tg = slice_setup[:2]
    pairs = [(jo, to) for jo, to in zip(omegas(jg), omegas(tg))
             if jo is not None or to is not None]
    assert pairs
    for jo, to in pairs:
        assert abs(to / jo - 1.0) <= 1e-5, (jo, to)


def test_vcycle_carried(slice_setup):
    """One float32 wave V-cycle with the JAX level factors (TTg), omegas
    and coarse inverse carried across: within 1e-5 relative."""
    jg, b = slice_setup[0], slice_setup[4]
    tm = StructuredMesh([2, 2, 2], [0.0] * 3, [1.0] * 3, refinement=1)
    tg = build_stmg(tm, 2, 4, ttypes.TimeStepType.DG, NTAO, TAU,
                    _torch_params(False), device="cpu",
                    problem=ttypes.ProblemType.wave)
    f32 = lambda a: None if a is None else np.asarray(a, np.float32)
    for jl, tl in zip(jg.levels[1:], tg.levels[1:]):
        jv = getattr(jl.smoother, "precond", None)
        if jv is not None:
            load_vanka(tl.smoother.precond, [f32(w) for w in jv.Wdn],
                       [f32(w) for w in jv.Wup], TTg=f32(jv.TTg))
    load_gmg(tg, omegas(jg), np.asarray(jg.coarse_Ainv))
    ref = np.asarray(jax.jit(jg.vmult)(jnp.asarray(b)), np.float64)
    got = tg.vmult(torch.as_tensor(b)).double().numpy()
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= 1e-5


def test_richardson_iterations(slice_setup):
    """Each package's own build, float32 levels: equal counts."""
    check_richardson_iterations(*slice_setup, slack=0)
