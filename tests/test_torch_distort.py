"""The distorted-mesh heat path of stfem_tpu_torch against stfem_tpu's
(CPU, numpy seeds): random vertex distortion and the Q1 geometry, the
operators and smoother on it, error norms, probes and run_heat_cycle.

Tolerances:
- the distorted vertices (dims 2 and 3, two seeds) and the coarsened
  meshes' strided vertices bitwise equal (the same NumPy stream);
- Geometry (jxw, jinv, points) and dof_coordinates (Q1 node placement)
  within 1e-13 of their largest entry;
- LaplaceMassOperator.apply on tests/test_spatial_operator.py's distorted
  cases (2, 2, 0.15) and (3, 2, 0.1), also with a coefficient field and
  weights_np(), within 1e-12; SystemMatrix.vmult / vmult_slice (route
  "cell", FP64) and one cell-mode PreconditionVanka apply (FP64) within
  1e-12;
- SpatialEvaluator on tests/test_errors.py:26's meshes (refinements 3 and
  4, distortion 0.2, and a stepped mesh) within 1e-12; PointEvaluator on
  tests/test_probes.py:33's mesh within 1e-12 (and exact for a linear
  field, as stfem_tpu's test holds it);
- run_heat_cycle, 2D DG(1) at refinement 2 with distortion 0.15: every
  slab's FGMRES iterations equal to stfem_tpu's, every slab's solution
  within 1e-8 of the largest entry of stfem_tpu's, the error norms
  within 1e-8 relative (stfem_tpu's Dirichlet dofs zeroed after each
  slab, as the port does); every level of the STMG ladder on a coarsened
  (strided) mesh with the "cell" route and the cell-mode Vanka; the 3D
  4^3 ladder's eigenvalue estimates (test_distorted_3d_estimate).  The
  slow case is tests/test_robustness.py:21-30 (refinement 3): at most 14
  iterations a slab on average, equal to stfem_tpu's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu import integrators as jintegrators
from stfem_tpu.drivers.heat import run_heat_cycle as jrun
from stfem_tpu.drivers.heat import stmg_preconditioner_factory as jfactory
from stfem_tpu.errors import SpatialEvaluator as JEvaluator
from stfem_tpu.mesh.grid import StructuredMesh as JMesh
from stfem_tpu.ops.spatial import LaplaceMassOperator as JOp
from stfem_tpu.problems.coefficient import Coefficient as JCoefficient
from stfem_tpu.stmg.vanka import PreconditionVanka as JVanka
from stfem_tpu.system import SystemMatrix as JSystem
from stfem_tpu.types import TimeStepType as JTimeStepType
from stfem_tpu.utils.probes import PointEvaluator as JPointEvaluator
from stfem_tpu_torch.drivers.heat import (run_heat_cycle,
                                          stmg_preconditioner_factory)
from stfem_tpu_torch.errors import SpatialEvaluator
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
from stfem_tpu_torch.problems.coefficient import Coefficient
from stfem_tpu_torch.stmg.vanka import PreconditionVanka
from stfem_tpu_torch.system import SystemMatrix
from stfem_tpu_torch.time.tables import get_fe_time_weights
from stfem_tpu_torch.types import TimeStepType
from stfem_tpu_torch.utils.probes import PointEvaluator

torch.set_num_threads(1)
F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _no_estimate_cache():
    """The port's hierarchies estimate afresh: no estimate disk cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STFEM_EIG_CACHE", "0")
        yield


def _close(got, ref, rel):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def _meshes(dim, refinement, distort, seed=42, sub=2):
    args = ([sub] * dim, [0.0] * dim, [1.0] * dim)
    kw = dict(refinement=refinement, distort=distort, distort_seed=seed)
    return JMesh(*args, **kw), StructuredMesh(*args, **kw)


@pytest.mark.parametrize("dim,seed", [(2, 42), (2, 7), (3, 42), (3, 7)])
def test_vertices_and_coarsening(dim, seed):
    jm, tm = _meshes(dim, 2, 0.15, seed)
    np.testing.assert_array_equal(tm.vertex_grid(), jm.vertex_grid())
    for _ in range(2):
        jm, tm = jm.coarsened(), tm.coarsened()
        np.testing.assert_array_equal(tm.vertex_grid(), jm.vertex_grid())
        assert tm.distort == jm.distort and tm.cells == jm.cells
    np.testing.assert_array_equal(tm.boundary_dof_mask(2),
                                  jm.boundary_dof_mask(2))


@pytest.mark.parametrize("dim,distort", [(2, 0.15), (3, 0.1)])
def test_geometry_and_nodes(dim, distort):
    jm, tm = _meshes(dim, 1, distort)
    for n_q in (2, 3, 4):
        jg, tg = jm.geometry(n_q, 1), tm.geometry(n_q)
        for name in ("jxw", "jinv", "points"):
            _close(getattr(tg, name), getattr(jg, name), 1e-13)
        _close(tm.quad_coordinates(n_q), jg.points, 1e-13)
    for k in (1, 2, 3):
        _close(tm.dof_coordinates(k), jm.dof_coordinates(k), 1e-13)


def test_q1_mapped_geometry():
    """A vertex map used on the vertices only: Q1 cells, as stfem_tpu's
    map_exact=False."""
    def bend(x, stack):
        g = 0.3 * x[..., 0] * (1 - x[..., 0]) * x[..., 1] * (1 - x[..., 1])
        return stack([x[..., 0] + g, x[..., 1] - g], -1)

    args = ([2, 2], [0.0, 0.0], [1.0, 1.0])
    jm = JMesh(*args, refinement=1, vertex_map=lambda x: bend(x, jnp.stack))
    tm = StructuredMesh(*args, refinement=1,
                        vertex_map=lambda x: bend(x, torch.stack))
    _close(tm.vertex_grid(), jm.vertex_grid(), 1e-15)
    jg, tg = jm.geometry(3, 1), tm.geometry(3)
    for name in ("jxw", "jinv", "points"):
        _close(getattr(tg, name), getattr(jg, name), 1e-13)
    _close(tm.dof_coordinates(2), jm.dof_coordinates(2), 1e-13)
    _close(tm.coarsened().vertex_grid(), jm.coarsened().vertex_grid(),
           1e-15)


@pytest.mark.parametrize("dim,degree,distort,coeff", [
    (2, 2, 0.15, False), (3, 2, 0.1, False), (2, 2, 0.15, True)])
def test_laplace_mass_operator(dim, degree, distort, coeff):
    jm, tm = _meshes(dim, 1, distort)
    lo, hi = [0.0] * dim, [1.0] * dim
    jc = JCoefficient([2] * dim, lo, hi, 0.5) if coeff else None
    tc = Coefficient([2] * dim, lo, hi, 0.5) if coeff else None
    jop = JOp(jm, degree, degree + 1, 1.0, 1.0, coefficient=jc)
    top = LaplaceMassOperator(tm, degree, degree + 1, 1.0, 1.0, dtype=F64,
                              device="cpu", coefficient=tc)
    assert top.jfac is None and top.jinv.shape[-2:] == (dim, dim)
    np.testing.assert_array_equal(top.mask_np, jop.mask_np)
    w = np.asarray(jop.jxw) * (1.0 if jc is None else np.asarray(jop.coeff))
    _close(top.weights_np(), w, 1e-13)
    x = np.random.default_rng(dim).standard_normal(tm.dof_shape(degree))
    _close(top.apply(torch.as_tensor(x)), jop.apply(jnp.asarray(x)), 1e-12)
    _close(top.element_matrices(), jop.element_matrices(), 1e-12)


@pytest.mark.parametrize("dim", [2, 3])
def test_system_matrix_and_vanka(dim):
    jm, tm = _meshes(dim, 1, 0.15)
    jK, jM = JOp(jm, 2, 3, 0.0, 1.0), JOp(jm, 2, 3, 1.0, 0.0)
    tK = LaplaceMassOperator(tm, 2, 3, 0.0, 1.0, dtype=F64, device="cpu")
    tM = LaplaceMassOperator(tm, 2, 3, 1.0, 0.0, dtype=F64, device="cpu")
    A, B, G, _ = get_fe_time_weights(TimeStepType.DG, 1, 0.05, 2)
    x = np.random.default_rng(dim).standard_normal((4,) + tK.dof_shape)
    sm = SystemMatrix(tK, tM, A, B)
    assert sm.route == "cell"
    _close(sm.vmult(torch.as_tensor(x)),
           JSystem(jK, jM, A, B).vmult(jnp.asarray(x)), 1e-12)
    zero = np.zeros_like(G)
    _close(SystemMatrix(tK, tM, zero, G).vmult_slice(torch.as_tensor(x[0])),
           JSystem(jK, jM, zero, G).vmult_slice(jnp.asarray(x[0])), 1e-12)
    tv = PreconditionVanka(tK, tM, A, B, dtype=F64, n_steps=2)
    jv = JVanka(jK, jM, A, B, dtype=jnp.float64, n_steps=2)
    assert tv.mode == "cell" and jv.Wdn is None
    r = x * tK.mask_np
    _close(tv.vmult(torch.as_tensor(r)), jv.vmult(jnp.asarray(r)), 1e-12)


@pytest.mark.parametrize("mesh_kw", [
    dict(refinement=3, distort=0.2), dict(refinement=4, distort=0.2),
    dict(refinement=1, axis_steps=[[0.2, 0.5, 0.3], [0.6, 0.4]])])
def test_spatial_evaluator(mesh_kw):
    sub = [3, 2] if "axis_steps" in mesh_kw else [1, 1]
    jm = JMesh(sub, [0.0, 0.0], [1.0, 1.0], **mesh_kw)
    tm = StructuredMesh(sub, [0.0, 0.0], [1.0, 1.0], **mesh_kw)
    jev, tev = JEvaluator(jm, 1, 3), SpatialEvaluator(tm, 1, 3, device="cpu")
    _close(tev.coords, jev.coords, 1e-13)
    _close(tev.jxw, jev.jxw, 1e-13)
    u = np.random.default_rng(3).standard_normal(tm.dof_shape(1))
    for name in ("values", "gradients"):
        _close(getattr(tev, name)(torch.as_tensor(u)),
               getattr(jev, name)(jnp.asarray(u)), 1e-12)


def test_point_evaluator():
    jm, tm = (M([1, 1], [0, 0], [1, 1], refinement=2, distort=0.2)
              for M in (JMesh, StructuredMesh))
    pts = [[0.4, 0.6], [0.77, 0.12], [0.05, 0.95], [1.0, 0.3]]
    jpe, tpe = JPointEvaluator(jm, 2, pts), PointEvaluator(tm, 2, pts)
    assert tpe.cells_of_point == jpe.cells_of_point
    coords = tm.dof_coordinates(2)
    u = coords @ np.array([0.7, -0.3]) + 0.11
    _close(tpe(u), np.asarray(pts) @ np.array([0.7, -0.3]) + 0.11, 1e-12)
    v = np.random.default_rng(5).standard_normal((3,) + tm.dof_shape(2))
    _close(tpe(torch.as_tensor(v)), np.stack([jpe(vi) for vi in v]), 1e-12)
    _close(tpe.tensor(torch.as_tensor(v)), tpe(v), 1e-15)


def _both_cycles(refinement, jkw=None, tkw=None, **kw):
    """(stfem_tpu's per-slab iterations and solutions, its result, the
    port's per-slab solutions, its result, the port's V-cycle) of the
    distorted 2D DG(1) heat cycle with each package's STMG factory
    (fe_degree_min 1); jkw / tkw go to one package's run alone."""
    jslabs, jxs, txs, gmgs = [], [], [], []
    orig = jintegrators.TimeIntegratorFO.solve

    def solve(self, *args):
        x, stats = orig(self, *args)
        # the Dirichlet dofs take their zero value after each slab, as the
        # port's (the reference's constraints.distribute()); stfem_tpu
        # leaves FGMRES's rounding noise there, which the H1 norm reads
        x = x * self.matrix.K.mask
        jslabs.append(stats.iterations)
        jxs.append(np.asarray(x))
        return x, stats

    tbase = stmg_preconditioner_factory(fe_degree_min=1)

    def tfac(ctx):
        gmgs.append(tbase(ctx))
        return gmgs[-1]

    common = dict(refinement=refinement, fe_degree=1,
                  n_timesteps_at_once=2, distort_grid=0.15,
                  gmres_maxiter=40, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STFEM_EIG_CACHE", "0")
        mp.setattr(jintegrators.TimeIntegratorFO, "solve", solve)
        jres = jrun(type_=JTimeStepType.DG,
                    preconditioner_factory=jfactory(fe_degree_min=1),
                    **common, **(jkw or {}))
    tres = run_heat_cycle(
        type_=TimeStepType.DG, preconditioner_factory=tfac, device="cpu",
        on_slab=lambda step, t, dt, prev, x, stats: txs.append(x.numpy()),
        **common, **(tkw or {}))
    return (jslabs, jxs, jres), (txs, tres), gmgs[0]


def test_heat_cycle_distorted():
    (jslabs, jxs, jres), (txs, tres), gmg = _both_cycles(2, end_time=0.25)
    assert tres.slab_iterations == jslabs and len(jslabs) == 4
    for xj, xt in zip(jxs, txs):
        _close(xt, xj, 1e-8)
    for name in ("linf_linf", "l2_l2", "l2_h1"):
        a, b = getattr(tres, name), getattr(jres, name)
        assert abs(a / b - 1.0) <= 1e-8, (name, a, b)
    fine = gmg.levels[-1].matrix.K.mesh
    for lvl in gmg.levels:
        mesh = lvl.matrix.K.mesh
        stride = 2 ** (fine.refinement - mesh.refinement)
        np.testing.assert_array_equal(
            mesh.vertex_grid(), fine.vertex_grid()[::stride, ::stride])
        assert lvl.matrix.route == "cell"
        v = getattr(lvl.smoother, "precond", None)
        assert v is None or v.mode == "cell"
    assert sum(getattr(lvl.smoother, "precond", None) is not None
               for lvl in gmg.levels) >= 2


class _Built(Exception):
    """Raised by a factory once it has built the slab's V-cycle."""


def _ladders(**cycle):
    """(stfem_tpu's, the port's) STMG V-cycles of the first slab of a
    distorted heat cycle, built by each package's factory (fe_degree_min
    1) and then stopped."""
    gmgs = {}

    def stop(base, key):
        def factory(ctx):
            gmgs[key] = base(ctx)
            raise _Built
        return factory

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STFEM_EIG_CACHE", "0")
        with pytest.raises(_Built):
            jrun(type_=JTimeStepType.DG, **cycle, preconditioner_factory=stop(
                jfactory(fe_degree_min=1), "j"))
    with pytest.raises(_Built):
        run_heat_cycle(type_=TimeStepType.DG, device="cpu", **cycle,
                       preconditioner_factory=stop(
                           stmg_preconditioner_factory(fe_degree_min=1), "t"))
    return gmgs["j"], gmgs["t"]


def test_distorted_3d_estimate():
    """chip_smoke.py phase 15(c)'s ladder (3D, 4^3 cells, Q2 x dG(1), 2
    steps, distortion 0.15) against stfem_tpu's.  Below the finest level
    every relaxation omega within 1e-3 of stfem_tpu's (float32 sweeps put
    them 1e-5 to 1e-4 apart).  The finest level's P A has two complex
    pairs, each twice, within 7e-5 in modulus on top of its spectrum,
    where ARPACK converges or fails by the float32 rounding of the sweeps
    (stfem_tpu's jitted sweep converges, its eager one does not), and a
    failure takes the 1.2-safety power estimate (ROADMAP.md section 3).
    So there: P A on the start vector within 1e-5 of stfem_tpu's, the
    port's converged lambda_max (Krylov-Schur) within 1e-4 of stfem_tpu's
    ARPACK one, the power estimates within 1e-3, and the port's omega,
    within 1e-3, one of the two that those estimates give."""
    from stfem_tpu.stmg import smoother as jsm
    from stfem_tpu_torch.stmg import smoother as tsm

    jg, tg = _ladders(refinement=2, fe_degree=1, n_timesteps_at_once=2,
                      subdivisions=(1, 1, 1), lower=(0.0,) * 3,
                      upper=(1.0,) * 3, distort_grid=0.15)
    jo = [getattr(l.smoother, "omega", None) for l in jg.levels]
    to = [getattr(l.smoother, "omega", None) for l in tg.levels]
    assert [o is None for o in to] == [o is None for o in jo]
    assert sum(o is not None for o in to) >= 3
    for a, b in zip(to[:-1], jo[:-1]):
        if b is not None:
            assert abs(a / b - 1.0) <= 1e-3, (to, jo)
    jl, tl = jg.levels[-1], tg.levels[-1]
    shape = (tl.n_blocks,) + tuple(tl.matrix.K.dof_shape)
    mask = tl.matrix.K.mask_np
    jm, jv = jl.matrix, jl.smoother.precond
    tm, tv = tl.matrix, tl.smoother.precond
    v0 = tsm.start_vector(shape, mask)
    t_pa = tsm.pa_apply(tm, tv, shape)(torch.as_tensor(v0)).numpy()
    j_pa = np.asarray(jv.vmult(jm.vmult(jnp.asarray(
        v0.reshape(shape), jnp.float32)))).reshape(-1)
    _close(t_pa, j_pa, 1e-5)
    lam_j = jsm.arnoldi_lambda_max(jm, jv, shape, mask, jnp.float32)
    lam_t = tsm.krylov_schur_lambda_max(tsm.pa_apply(tm, tv, shape),
                                        torch.as_tensor(v0))
    assert lam_j is not None and lam_t is not None
    assert abs(lam_t / lam_j - 1.0) <= 1e-4, (lam_t, lam_j)
    pw_j = jsm.estimate_eigenvalues(jm, jv, shape, mask, jnp.float32)
    pw_t = tsm.estimate_eigenvalues(tm, tv, shape, mask, device="cpu")
    assert abs(pw_t.max_eigenvalue / pw_j.max_eigenvalue - 1.0) <= 1e-3
    choices = [tsm.relaxation_parameters(info, 1.0) for info in
               (tsm.EigInfo(lam_t, lam_t), pw_t)]
    assert min(abs(to[-1] / c - 1.0) for c in choices) <= 1e-3, (
        to[-1], choices)


def _bump(coords, lib):
    """tests/test_robustness.py's smooth bump at the centre."""
    d2 = lib.sum((coords - 0.5) ** 2, -1)
    inside = d2 < 0.3 ** 2
    arg = lib.where(inside, 1.0 - 1.0 / (1.0 - d2 / 0.3 ** 2), 0.0 * d2)
    return lib.where(inside, lib.exp(arg), 0.0 * d2)


@pytest.mark.slow
def test_heat_distorted_mesh_iterations():
    """tests/test_robustness.py:21-30's configuration."""
    (jslabs, _, _), (_, tres), _ = _both_cycles(
        3, compute_errors=False,
        jkw=dict(initial_fn=lambda c: _bump(np.asarray(c), np),
                 rhs_fn_override=lambda p, t: p[..., 0] * 0.0),
        tkw=dict(initial_fn=lambda c: _bump(c, torch),
                 rhs_fn_override=lambda p, t: torch.zeros_like(p[..., 0])))
    assert tres.avg_iterations <= 14, tres.avg_iterations
    assert tres.slab_iterations == jslabs
