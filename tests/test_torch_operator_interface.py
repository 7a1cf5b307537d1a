"""The operator interface of stfem_tpu_torch against stfem_tpu's (CPU,
float64, numpy seeds): SystemMatrix.Tvmult on the routes "kron", "grid",
"quad" and "cell", SystemMatrix.diagonal and dof_shape,
LaplaceMassOperator.diagonal and its vmult alias.

Tolerances, relative to the largest entry of stfem_tpu's result:
- Tvmult within 1e-12 (the Tvmult legs of tests/test_spatial_operator.py's
  test_grid_sumfac_parity and test_kron_matvec_parity), and within 1e-12
  of vmult of a SystemMatrix built on the transposed tables;
- the adjoint identity <A x, y> = <x, A^T y> within 1e-12 of |<A x, y>|;
- the diagonals within 1e-11 (tests/test_spatial_operator.py's
  test_diagonal_matches_assembled), and the port's against unit-vector
  probing of its own apply within 1e-11."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu.drivers import stokes as jstokes
from stfem_tpu.mesh.grid import StructuredMesh as JMesh
from stfem_tpu.ops.spatial import LaplaceMassOperator as JOp
from stfem_tpu.problems.coefficient import Coefficient as JCoefficient
from stfem_tpu.system import SystemMatrix as JSystem
from stfem_tpu_torch.drivers import stokes as tstokes
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
from stfem_tpu_torch.problems.coefficient import Coefficient
from stfem_tpu_torch.system import SystemMatrix
from stfem_tpu_torch.time.tables import (get_fe_time_weights,
                                         get_fe_time_weights_wave)
from stfem_tpu_torch.types import TimeStepType

torch.set_num_threads(1)
F64 = torch.float64


def _close(got, ref, rel):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def _steps(dim):
    return [[0.2, 0.5, 0.3], [0.6, 0.4], [0.3, 0.7]][:dim]


def _meshes(geometry, dim):
    """(stfem_tpu's mesh, the port's) of one geometry kind."""
    if geometry == "masked":
        return jstokes.dfg_square_mesh(0, dim), tstokes.dfg_square_mesh(0, dim)
    if geometry == "mapped":
        return jstokes.dfg_cylinder_mesh(1), tstokes.dfg_cylinder_mesh(1)
    kw = {"uniform": dict(refinement=1), "coefficient": dict(refinement=1),
          "stepped": dict(refinement=1, axis_steps=_steps(dim)),
          "distorted": dict(refinement=1, distort=0.15)}[geometry]
    sub = [3, 2, 2][:dim] if geometry in ("uniform", "coefficient") \
        else [2] * dim
    return (JMesh(sub, [0.0] * dim, [1.0] * dim, **kw),
            StructuredMesh(sub, [0.0] * dim, [1.0] * dim, **kw))


def _ops(meshes, geometry, k, mass, laplace, coefficient=None):
    """stfem_tpu's and the port's operator on the meshes (jm, tm); the
    "coefficient" geometry's field unless coefficient is False."""
    jm, tm = meshes
    dim = tm.dim
    if coefficient is None and geometry == "coefficient":
        coefficient = True
    jc = tc = None
    if coefficient:
        lo, hi = [0.0] * dim, [1.0] * dim
        jc, tc = (C([2] * dim, lo, hi, 0.5) for C in (JCoefficient,
                                                      Coefficient))
    jop = JOp(jm, k, k + 1, mass, laplace, dtype=jnp.float64, coefficient=jc)
    top = LaplaceMassOperator(tm, k, k + 1, mass, laplace, dtype=F64,
                              device="cpu", coefficient=tc)
    np.testing.assert_array_equal(top.mask_np, jop.mask_np)
    return jop, top


# route, geometry, dim, degree, tables: every route on a geometry it takes
ROUTES = [("kron", "uniform", 3, 3, "dg"), ("kron", "stepped", 2, 3, "cgp"),
          ("grid", "coefficient", 2, 3, "dg"), ("grid", "stepped", 3, 2,
                                                "wave"),
          ("quad", "coefficient", 3, 3, "dg"), ("quad", "masked", 2, 2,
                                                "cgp"),
          ("cell", "distorted", 2, 2, "dg"), ("cell", "mapped", 2, 2, "wave")]


def _tables(kind):
    if kind == "wave":
        one = get_fe_time_weights(TimeStepType.DG, 1, 0.125)
        A, B = get_fe_time_weights_wave(TimeStepType.DG, *one, 2)[:2]
    else:
        t = TimeStepType.DG if kind == "dg" else TimeStepType.CGP
        A, B = get_fe_time_weights(t, 2, 0.125, 2)[:2]
    return np.asarray(A), np.asarray(B)


def _systems(route, geometry, dim, k, kind):
    A, B = _tables(kind)
    meshes = _meshes(geometry, dim)
    jK, tK = _ops(meshes, geometry, k, 0.0, 1.0)
    jM, tM = _ops(meshes, geometry, k, 1.0, 0.0, coefficient=False)
    tS = SystemMatrix(tK, tM, A, B, route=route)
    assert tS.route == route
    rng = np.random.default_rng(dim * 10 + k)
    x = rng.standard_normal((A.shape[0],) + tuple(tK.dof_shape))
    y = rng.standard_normal(x.shape)
    return (JSystem(jK, jM, A, B), tS,
            SystemMatrix(tK, tM, A.T, B.T, route=route), x, y)


@pytest.mark.parametrize("route,geometry,dim,k,kind", ROUTES)
def test_tvmult(route, geometry, dim, k, kind):
    """Tvmult against stfem_tpu's and against vmult of the transposed
    tables, and the adjoint identity <A x, y> = <x, A^T y>."""
    jS, tS, tST, x, y = _systems(route, geometry, dim, k, kind)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    got = tS.Tvmult(yt)
    _close(got, jS.Tvmult(jnp.asarray(y)), 1e-12)
    _close(got, tST.vmult(yt), 1e-12)
    # the tables really are non-symmetric: Tvmult is not vmult
    ax = tS.vmult(xt)
    assert float((got - tS.vmult(yt)).abs().max()) > \
        1e-6 * float(got.abs().max())
    lhs, rhs = float((ax * yt).sum()), float((xt * got).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs), (lhs, rhs)


def test_tvmult_slice_columns():
    """Tvmult of the previous-slab coupling columns (n_blocks x 1) maps n
    blocks to one, past the rhs-slice shortcut, as stfem_tpu's does."""
    A, B, G, Z = get_fe_time_weights(TimeStepType.DG, 1, 0.125, 4)
    meshes = _meshes("uniform", 2)
    jK, tK = _ops(meshes, "uniform", 2, 0.0, 1.0)
    jM, tM = _ops(meshes, "uniform", 2, 1.0, 0.0)
    tS = SystemMatrix(tK, tM, Z, G)
    assert tS._slice_reduced is not None
    y = np.random.default_rng(1).standard_normal(
        (np.asarray(G).shape[0],) + tuple(tK.dof_shape))
    got = tS.Tvmult(torch.as_tensor(y))
    assert got.shape == (1,) + tuple(tK.dof_shape)
    _close(got, JSystem(jK, jM, Z, G).Tvmult(jnp.asarray(y)), 1e-12)


GEOMETRIES = [("uniform", 2), ("uniform", 3), ("stepped", 2),
              ("masked", 2), ("coefficient", 3), ("mapped", 2),
              ("distorted", 2), ("distorted", 3)]


@pytest.mark.parametrize("geometry,dim", GEOMETRIES)
@pytest.mark.parametrize("mass,laplace", [(1.0, 1.0), (0.0, 1.0)])
def test_operator_diagonal(geometry, dim, mass, laplace):
    jop, top = _ops(_meshes(geometry, dim), geometry, 2, mass, laplace)
    d = top.diagonal()
    _close(d, jop.diagonal(), 1e-11)
    # unit-vector probing of the port's own apply
    flat, mask = d.reshape(-1), top.mask_np.reshape(-1)
    n = flat.numel()
    for i in range(0, n, max(1, n // 9)):
        e = torch.zeros(n, dtype=F64)
        e[i] = 1.0
        di = float(top.apply(e.reshape(top.dof_shape)).reshape(-1)[i])
        want = di if mask[i] else 1.0
        assert abs(float(flat[i]) - want) <= 1e-11 * float(flat.abs().max())


@pytest.mark.parametrize("geometry,dim", GEOMETRIES)
def test_system_diagonal(geometry, dim):
    A, B = _tables("dg")
    meshes = _meshes(geometry, dim)
    jK, tK = _ops(meshes, geometry, 2, 0.0, 1.0)
    jM, tM = _ops(meshes, geometry, 2, 1.0, 0.0, coefficient=False)
    tS = SystemMatrix(tK, tM, A, B)
    d = tS.diagonal()
    assert d.shape == (A.shape[0],) + tuple(tS.dof_shape)
    _close(d, JSystem(jK, jM, A, B).diagonal(), 1e-11)


@pytest.mark.parametrize("geometry,dim", [("uniform", 2), ("distorted", 3)])
def test_dof_shape_and_vmult_alias(geometry, dim):
    meshes = _meshes(geometry, dim)
    jop, top = _ops(meshes, geometry, 2, 1.0, 1.0)
    A, B = _tables("dg")
    jM, tM = _ops(meshes, geometry, 2, 1.0, 0.0)
    tS = SystemMatrix(top, tM, A, B)
    assert tuple(tS.dof_shape) == tuple(top.dof_shape) == \
        tuple(JSystem(jop, jM, A, B).dof_shape)
    x = np.random.default_rng(dim).standard_normal(tuple(top.dof_shape))
    xt = torch.as_tensor(x)
    assert torch.equal(top.vmult(xt), top.apply(xt))
    assert torch.equal(top.vmult(xt, mask_input=False),
                       top.apply(xt, mask_input=False))
    _close(top.vmult(xt), jop.vmult(jnp.asarray(x)), 1e-12)
