"""Kernel K5's plain version and the slab operator's coefficient routes,
stfem_tpu_torch vs stfem_tpu on the CPU.

- quad_middle_reference after the block premix against stfem_tpu's
  _middle_reference (pallas_kernels.py:56-64) on seeded inputs: float64 to
  1e-12, float32 to 1e-5 relative (the same products in another order).
- The port's route-3 ("quad") FP64 SystemMatrix, vmult and the reduced
  vmult_slice, against stfem_tpu's route 3 (STFEM_GRID_SUMFAC=0, as
  tests/test_spatial_operator.py selects it), and the port's "grid" route
  (float64 and float32) against stfem_tpu's default GridSumFac route, on
  3^3-cell Q3 meshes with the distorted coefficient: 1e-12 in float64,
  1e-5 in float32.  Each test asserts the route both packages took."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu.mesh.grid import StructuredMesh as JMesh
from stfem_tpu.ops.pallas_kernels import _middle_reference
from stfem_tpu.ops.spatial import LaplaceMassOperator as JOp
from stfem_tpu.problems.coefficient import Coefficient as JCoefficient
from stfem_tpu.system import SystemMatrix as JSys
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.quad_middle import quad_middle, quad_middle_reference
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
from stfem_tpu_torch.problems.coefficient import Coefficient
from stfem_tpu_torch.system import SystemMatrix
from stfem_tpu_torch.time.tables import get_fe_time_weights
from stfem_tpu_torch.types import TimeStepType

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("T_src,T_dst,C,A,Q,dim", [(6, 6, 27, 64, 64, 3),
                                                  (1, 3, 8, 64, 64, 3),
                                                  (4, 4, 12, 9, 9, 2)])
def test_quad_middle_reference(T_src, T_dst, C, A, Q, dim, dtype):
    rng = np.random.default_rng(T_src * C + A)
    npdt = np.float64 if dtype == torch.float64 else np.float32
    u = rng.standard_normal((T_src, C, A)).astype(npdt)
    PhiG = rng.standard_normal((A, (1 + dim) * Q)).astype(npdt)
    W = np.abs(rng.standard_normal((C, (1 + dim) * Q))).astype(npdt)
    Al = rng.standard_normal((T_dst, T_src)).astype(npdt)
    Be = rng.standard_normal((T_dst, T_src)).astype(npdt)
    ref = _middle_reference(*(jnp.asarray(a) for a in (u, PhiG, W, Al, Be)),
                            Q)
    t = [torch.as_tensor(a) for a in (u, PhiG, W, Al, Be)]
    flat = t[0].reshape(T_src, -1)
    ub, ua = ((t[i] @ flat).reshape(T_dst, C, A) for i in (4, 3))
    got = quad_middle_reference(ub, ua, t[1], t[2], Q)
    assert got.dtype == dtype and got.shape == (T_dst, C, A)
    assert _rel(got.numpy(), ref) <= TOL[dtype]
    # the wrapper takes the plain version for CPU tensors and counts no
    # launch there
    before = quad_middle.launches
    assert torch.equal(quad_middle(ub, ua, t[1], t[2], Q), got)
    assert quad_middle.launches == before


def _operators(dtype, coefficient=True):
    sub, lo, hi = (3, 3, 3), (0.0,) * 3, (1.0,) * 3
    jm, tm = JMesh(sub, lo, hi), StructuredMesh(sub, lo, hi)
    jc = JCoefficient(sub, lo, hi, 0.5) if coefficient else None
    tc = Coefficient(sub, lo, hi, 0.5) if coefficient else None
    jops = (JOp(jm, 3, 4, 0.0, 1.0, dtype=JDT[dtype], coefficient=jc),
            JOp(jm, 3, 4, 1.0, 0.0, dtype=JDT[dtype]))
    tops = (LaplaceMassOperator(tm, 3, 4, 0.0, 1.0, dtype=dtype,
                                device="cpu", coefficient=tc),
            LaplaceMassOperator(tm, 3, 4, 1.0, 0.0, dtype=dtype,
                                device="cpu"))
    return jops, tops


def _tables():
    Al, Be, Ga, _ = get_fe_time_weights(TimeStepType.DG, 2, 1.0 / 32, 2)
    return Al, Be, np.zeros_like(Ga), Ga


@pytest.mark.parametrize("form", ["vmult", "vmult_slice"])
def test_quad_route_fp64(monkeypatch, form):
    """The port's default FP64 coefficient route is route 3; JAX takes
    it with STFEM_GRID_SUMFAC=0."""
    monkeypatch.setenv("STFEM_GRID_SUMFAC", "0")
    (jK, jM), (tK, tM) = _operators(torch.float64)
    Al, Be, Zc, Ga = _tables()
    A, B = (Al, Be) if form == "vmult" else (Zc, Ga)
    jsys, tsys = JSys(jK, jM, A, B), SystemMatrix(tK, tM, A, B)
    assert jsys._phig is not None and jsys._grid is None
    assert jsys._kron is None and tsys.route == "quad"
    x = np.random.default_rng(1).standard_normal(
        (Al.shape[0],) + tK.dof_shape)
    if form == "vmult":
        got, ref = tsys.vmult(torch.as_tensor(x)), jsys.vmult(jnp.asarray(x))
    else:
        # the rhs coupling keeps its reduced-row form: 3 rows from 1 block
        assert tsys._slice_nz == (0, 1, 2)
        assert tsys._slice_reduced.route == "quad"
        got = tsys.vmult_slice(torch.as_tensor(x[0]))
        ref = jsys.vmult_slice(jnp.asarray(x[0]))
    assert _rel(got.numpy(), ref) <= TOL[torch.float64]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_grid_route(dtype):
    """The float32 levels' route (and, asked by name, the float64 one)
    against stfem_tpu's default GridSumFac route."""
    (jK, jM), (tK, tM) = _operators(dtype)
    Al, Be, _, _ = _tables()
    jsys = JSys(jK, jM, Al, Be, precision=None)
    route = None if dtype == torch.float32 else "grid"
    tsys = SystemMatrix(tK, tM, Al, Be, precision=None, route=route)
    assert jsys._grid is not None and tsys.route == "grid"
    x = np.random.default_rng(2).standard_normal(
        (Al.shape[0],) + tK.dof_shape).astype(
            np.float64 if dtype == torch.float64 else np.float32)
    got = tsys.vmult(torch.as_tensor(x))
    assert got.dtype == dtype
    assert _rel(got.numpy(), jsys.vmult(jnp.asarray(x))) <= TOL[dtype]


def test_routes_agree_without_coefficient():
    """Without a coefficient the default route is Kronecker; all three
    routes give the same operator."""
    (_, _), (tK, tM) = _operators(torch.float64, coefficient=False)
    Al, Be, _, _ = _tables()
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (Al.shape[0],) + tK.dof_shape))
    assert SystemMatrix(tK, tM, Al, Be).route == "kron"
    ys = [SystemMatrix(tK, tM, Al, Be, route=r).vmult(x).numpy()
          for r in ("kron", "quad", "grid")]
    assert _rel(ys[1], ys[0]) <= 1e-12 and _rel(ys[2], ys[0]) <= 1e-12


def test_tables_match_and_load(monkeypatch):
    """Route 3's PhiG/W, GridSumFac's weight grids and the coefficient
    table equal stfem_tpu's; loaded through utils/carry.py they leave the
    applies unchanged."""
    from stfem_tpu_torch.utils.carry import (load_coefficient,
                                             load_gridsumfac,
                                             load_quad_tables)

    (jK, jM), (tK, tM) = _operators(torch.float64)
    Al, Be, _, _ = _tables()
    jgrid = JSys(jK, jM, Al, Be)
    monkeypatch.setenv("STFEM_GRID_SUMFAC", "0")
    jquad = JSys(jK, jM, Al, Be)
    tquad = SystemMatrix(tK, tM, Al, Be)
    tgrid = SystemMatrix(tK, tM, Al, Be, route="grid")
    assert _rel(tquad._phig.numpy(), jquad._phig) <= 1e-15
    assert _rel(tquad._w.numpy(), jquad._w) <= 1e-15
    assert _rel(tgrid._grid.Wb.numpy(), jgrid._grid.Wb) <= 1e-15
    for e in range(3):
        assert _rel(tgrid._grid.Wa[e].numpy(), jgrid._grid.Wa[e]) <= 1e-15
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (Al.shape[0],) + tK.dof_shape))
    before = [tquad.vmult(x), tgrid.vmult(x), tK.apply(x)]
    load_quad_tables(tquad, np.asarray(jquad._phig), np.asarray(jquad._w))
    load_gridsumfac(tgrid, np.asarray(jgrid._grid.Wb),
                    [np.asarray(w) for w in jgrid._grid.Wa])
    load_coefficient(tK, np.asarray(jK.coeff))
    after = [tquad.vmult(x), tgrid.vmult(x), tK.apply(x)]
    for b, a in zip(before, after):
        assert _rel(a.numpy(), b.numpy()) <= 1e-14
