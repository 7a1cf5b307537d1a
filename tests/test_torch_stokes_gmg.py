"""The Stokes hierarchy of stfem_tpu_torch vs stfem_tpu (CPU): the ladder
and preconditioner sequence of build_stmg_stokes, the power-estimate
omegas, the StokesVanka factors, the transfers, one V-cycle with
stfem_tpu's factors carried over, and the float32 Richardson counts of
the first two slabs.  4^3 cells (Q2^3 x DGP1), dG(1), 4 steps per slab,
float32 levels, run_stokes_bench's parameters (smoothing range 5, one
Relaxation sweep, variable smoothing, Identity levels visited, the FP64
pseudo-inverse coarse solve with the constant-pressure projection).

Tolerances: omega 1e-5 relative (20 float32 power sweeps; the two
packages' float32 sums differ in order); Binv/Kappa 1e-5 of the max
(float32 batched inverses of the same patch matrices); the transfers and
one V-cycle with the same factors 1e-5 of the max (float32); Richardson
counts equal to +-1."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu import types as jtypes
from stfem_tpu.krylov import richardson_solve as jrichardson
from stfem_tpu.mesh.grid import StructuredMesh as JMesh
from stfem_tpu.ops.spatial import LaplaceMassOperator as JOp
from stfem_tpu.ops.stokes import StokesOperator as JStokes
from stfem_tpu.stmg.gmg import GMGParams as JParams
from stfem_tpu.stmg.gmg import build_stmg_stokes as jbuild
from stfem_tpu.system_stokes import StokesSystemMatrix as JSys
from stfem_tpu.time import tables as jtab
from stfem_tpu_torch import bench_stokes
from stfem_tpu_torch import types as ttypes
from stfem_tpu_torch.krylov import richardson_solve
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
from stfem_tpu_torch.ops.stokes import StokesOperator
from stfem_tpu_torch.stmg.gmg import GMGParams, build_stmg_stokes
from stfem_tpu_torch.stmg.smoother import IdentitySmoother
from stfem_tpu_torch.system_stokes import StokesSystemMatrix
from stfem_tpu_torch.utils.carry import load_gmg, load_stokes_vanka

torch.set_num_threads(1)

CELLS, NTAO, TAU = 4, 4, 1.0 / 16.0
F32 = torch.float32


@pytest.fixture(scope="module")
def hierarchies():
    jm = JMesh([2, 2, 2], [0.0] * 3, [1.0] * 3, refinement=1)
    tm = StructuredMesh([2, 2, 2], [0.0] * 3, [1.0] * 3, refinement=1)
    params = JParams(smoothing_range=5.0, smoothing_steps=1,
                     coarse_grid_smoother_type="Smoother")
    jg = jbuild(jm, 1, jtypes.TimeStepType.DG, NTAO, TAU, viscosity=1.0,
                dtype=jnp.float32, params=params, fe_degree_min=1)
    tg = build_stmg_stokes(tm, 1, ttypes.TimeStepType.DG, NTAO, TAU,
                           params=GMGParams(smoothing_range=5.0), dtype=F32,
                           device="cpu")
    return jm, tm, jg, tg


def _rel_close(t, j, rel):
    j = np.asarray(j, np.float64)
    np.testing.assert_allclose(np.asarray(t.detach(), np.float64), j,
                               atol=rel * max(np.abs(j).max(), 1e-300))


def test_stokes_ladder_and_precond_seq(hierarchies):
    _, _, jg, tg = hierarchies
    assert [m.name for m in tg.mg_type_level] == \
        [m.name for m in jg.mg_type_level]
    assert [p.name for p in tg.precondition_sequence] == \
        [p.name for p in jg.precondition_sequence]
    assert len(tg.levels) == len(jg.levels)
    assert jg.params.variable and not jg.params.skip_identity_levels
    assert tg.variable and not tg.skip_identity
    assert jg.params.coarse_direct_pinv
    for l, (jl, tl) in enumerate(zip(jg.levels, tg.levels)):
        assert (tl.n_blocks, tuple(tl.dof_shape)) == \
            (jl.n_blocks, tuple(jl.dof_shape))
        if l:
            assert isinstance(tl.smoother, IdentitySmoother) == (
                type(jl.smoother).__name__ == "IdentitySmoother")
    np.testing.assert_allclose(np.asarray(tg.coarse_null),
                               np.asarray(jg.coarse_null), rtol=1e-6)


def _relaxation_levels(jg, tg):
    pairs = enumerate(zip(jg.levels, tg.levels))
    return [(l, jl, tl) for l, (jl, tl) in pairs
            if l and not isinstance(tl.smoother, IdentitySmoother)]


def test_stokes_power_omegas(hierarchies):
    _, _, jg, tg = hierarchies
    levels = _relaxation_levels(jg, tg)
    assert levels
    for _, jl, tl in levels:
        jo, to = float(jl.smoother.omega), float(tl.smoother.omega)
        assert abs(to - jo) <= 1e-5 * abs(jo), (to, jo)


def test_stokes_vanka_factors(hierarchies):
    _, _, jg, tg = hierarchies
    for _, jl, tl in _relaxation_levels(jg, tg):
        jv, tv = jl.smoother.precond, tl.smoother.precond
        assert tv.n_steps == jv.n_steps
        _rel_close(tv.Binv, jv.Binv, 1e-5)
        if jv.Kappa is None:
            assert tv.Kappa is None
        else:
            _rel_close(tv.Kappa, jv.Kappa, 1e-5)


def test_stokes_transfers(hierarchies):
    _, _, jg, tg = hierarchies
    rng = np.random.default_rng(4)
    for l in range(1, len(tg.levels)):
        jt, tt = jg.transfers[l - 1], tg.transfers[l - 1]
        fine = rng.standard_normal((tg.levels[l].n_blocks,)
                                   + tg.levels[l].dof_shape)
        coarse = rng.standard_normal((tg.levels[l - 1].n_blocks,)
                                     + tg.levels[l - 1].dof_shape)
        _rel_close(tt.restrict(torch.as_tensor(fine, dtype=F32)),
                   jt.restrict(jnp.asarray(fine, jnp.float32)), 1e-5)
        _rel_close(tt.prolongate(torch.as_tensor(coarse, dtype=F32)),
                   jt.prolongate(jnp.asarray(coarse, jnp.float32)), 1e-5)


def test_stokes_vcycle_with_jax_factors(hierarchies):
    _, tm, jg, _ = hierarchies
    # a hierarchy of its own: loading stfem_tpu's factors must not leak
    # into the other tests
    tg = build_stmg_stokes(tm, 1, ttypes.TimeStepType.DG, NTAO, TAU,
                           params=GMGParams(smoothing_range=5.0), dtype=F32,
                           device="cpu")
    omegas = [None] * len(jg.levels)
    for l, jl, tl in _relaxation_levels(jg, tg):
        omegas[l] = float(jl.smoother.omega)
        load_stokes_vanka(tl.smoother.precond,
                          np.asarray(jl.smoother.precond.Binv),
                          None if jl.smoother.precond.Kappa is None
                          else np.asarray(jl.smoother.precond.Kappa))
    load_gmg(tg, omegas, np.asarray(jg.coarse_Ainv),
             np.asarray(jg.coarse_null))
    top = tg.levels[-1]
    x = np.random.default_rng(9).standard_normal((top.n_blocks,)
                                                 + top.dof_shape)
    _rel_close(tg.vmult(torch.as_tensor(x, dtype=F32)),
               jg.vmult(jnp.asarray(x, jnp.float32)), 1e-5)


def test_stokes_richardson_counts_first_two_slabs(hierarchies):
    """The float32 first-stage solve of run_stokes_bench (rhs coupling +
    force, start from the previous value) on slabs 0 and 1, in each
    package with its own hierarchy, to rel 1e-5."""
    jm, tm, jg, tg = hierarchies
    dg_j, dg_t = jtypes.TimeStepType.DG, ttypes.TimeStepType.DG
    a, b, g, _ = jtab.get_fe_time_weights(dg_j, 1, TAU, NTAO)
    jS = JStokes(jm, 2, 1, 3, 1.0, dtype=jnp.float32)
    jM = JOp(jm, 2, 3, 1.0, 0.0, dtype=jnp.float32, mask=jS.mask_u_np)
    tS = StokesOperator(tm, 2, 1, 3, 1.0, dtype=F32, device="cpu")
    tM = LaplaceMassOperator(tm, 2, 3, 1.0, 0.0, dtype=F32, device="cpu",
                             mask=tS.mask_u_np)
    jsys, jrhs = (JSys(jS, jM, a, b),
                  JSys(jS, jM, a, b, gamma=None, zeta=g, type_=dg_j))
    tsys, trhs = (StokesSystemMatrix(tS, tM, a, b),
                  StokesSystemMatrix(tS, tM, a, b, zeta=g, type_=dg_t))
    S64 = StokesOperator(tm, 2, 1, 3, 1.0, dtype=torch.float64,
                         device="cpu")
    tq = jtab.get_time_quad(dg_j, 1)[0]
    a1 = jtab.get_fe_time_weights(dg_j, 1, TAU, 1)[0]
    t_off = np.array([TAU * it + TAU * float(q) for it in range(NTAO)
                      for q in tq])
    sc = np.array([a1[j, j] for _ in range(NTAO) for j in range(len(tq))])
    T, n = a.shape[0], tS.n_u + tS.n_p
    jprev = np.zeros(n, np.float32)
    tprev = torch.zeros(n, dtype=F32)
    for i in range(2):
        f = bench_stokes.force_slab(tm, S64, i * TAU * NTAO + t_off,
                                    sc).numpy().astype(np.float32)
        rhs = jrhs.vmult_slice(*jS.unpack(jnp.asarray(jprev))) + f
        jres = jrichardson(lambda v: jsys.vmult(v).astype(jnp.float32), rhs,
                           jnp.broadcast_to(jnp.asarray(jprev), (T, n)),
                           lambda v: jg.vmult(v).astype(jnp.float32),
                           maxiter=60, reltol=1e-5)
        trhs_v = trhs.vmult_slice(*tS.unpack(tprev)) + torch.as_tensor(f)
        tres = richardson_solve(tsys.vmult, trhs_v, tprev.expand(T, n),
                                tg.vmult, maxiter=60, reltol=1e-5)
        assert tres.converged and bool(jres.converged)
        assert abs(tres.iterations - int(jres.iterations)) <= 1, \
            (i, tres.iterations, int(jres.iterations))
        jprev = np.asarray(jres.x[-1])
        tprev = tres.x[-1].contiguous()
