"""The DFG channel's geometry in stfem_tpu_torch against stfem_tpu's (CPU):
the dfgBenchmarkSquare grid (cell mask, non-uniform steps) in 2D at
refinements 0-2 and in 3D at refinement 0, its cylinder morph (exact
vertex map) at refinements 1-2, and the operators, element matrices,
element route and functionals on them.

Tolerances: cells, masks and steps exact; jxw, jinv_axis, jinv, points
and dof coordinates within 1e-13 of their largest entry; the cylinder's
obstacle-boundary nodes on the circle within 1e-12; LaplaceMassOperator
and StokesOperator applies (float64), element and face element matrices
within 1e-12 of the largest entry; the element route against the
sum-factorised apply within 1e-12; drag, lift and divergence of a random
field within 1e-12 relative."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu.drivers import stokes as jstokes
from stfem_tpu.mesh.fe import shape_data_1d as jshape_data_1d
from stfem_tpu.ops import functionals as jfun
from stfem_tpu.ops.spatial import LaplaceMassOperator as JOp
from stfem_tpu.ops.stokes import StokesOperator as JStokes
from stfem_tpu_torch.drivers import stokes as tstokes
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops import functionals as tfun
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
from stfem_tpu_torch.ops.stokes import StokesOperator
from stfem_tpu_torch.system_stokes import StokesSystemMatrix
from stfem_tpu_torch.time.tables import get_fe_time_weights
from stfem_tpu_torch.types import TimeStepType
from stfem_tpu_torch.utils.carry import load_geometry

torch.set_num_threads(1)

NU = 1e-3
WEAK_2D, FREE = ((0, 0), (1, 0), (1, 1)), ((0, 1),)
WEAK_3D = WEAK_2D + ((2, 0), (2, 1))
GRIDS = {"square": lambda r, dim=2: (jstokes.dfg_square_mesh(r, dim),
                                     tstokes.dfg_square_mesh(r, dim)),
         "cylinder": lambda r, dim=2: (jstokes.dfg_cylinder_mesh(r, dim),
                                       tstokes.dfg_cylinder_mesh(r, dim))}


def _rel_close(t, j, rel):
    t = np.asarray(t.detach() if torch.is_tensor(t) else t, np.float64)
    j = np.asarray(j, np.float64)
    assert t.shape == j.shape, (t.shape, j.shape)
    np.testing.assert_allclose(t, j, rtol=0, atol=rel * max(np.abs(j).max(),
                                                            1e-300))


def _same_mesh(jm, tm):
    assert tm.cells == jm.cells and tm.subdivisions == jm.subdivisions
    np.testing.assert_array_equal(tm.lower, jm.lower)
    np.testing.assert_array_equal(tm.upper, jm.upper)
    np.testing.assert_array_equal(tm.cell_mask, jm.cell_mask)
    for a, b in zip(tm.axis_steps, jm.axis_steps, strict=True):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tm.boundary_dof_mask(2),
                                  jm.boundary_dof_mask(2))
    tg, jg = tm.geometry(3), jm.geometry(3, 2)
    _rel_close(tg.jxw, jg.jxw, 1e-13)
    if jg.jinv is None:
        assert tg.jinv is None and tg.points is None
        for a, b in zip(tg.jinv_axis, jg.jinv_axis, strict=True):
            _rel_close(a, b, 1e-13)
        qx = jshape_data_1d(1, 3).quad_x
        _rel_close(tm.quad_coordinates(3), jm._base_quad_points(3, qx),
                   1e-13)
    else:
        assert tg.jinv_axis is None
        _rel_close(tg.jinv, jg.jinv, 1e-13)
        _rel_close(tg.points, jg.points, 1e-13)
        _rel_close(tm.quad_coordinates(3), jg.points, 1e-13)
    _rel_close(tm.dof_coordinates(2), jm.dof_coordinates(2), 1e-13)


@pytest.mark.parametrize("grid,ref,dim", [
    ("square", 0, 2), ("square", 1, 2), ("square", 2, 2), ("square", 0, 3),
    ("cylinder", 1, 2), ("cylinder", 2, 2)])
def test_dfg_mesh_and_geometry(grid, ref, dim):
    jm, tm = GRIDS[grid](ref, dim)
    _same_mesh(jm, tm)
    if ref > 0:
        _same_mesh(jm.coarsened(), tm.coarsened())


@pytest.mark.parametrize("ref", [1, 2])
def test_cylinder_obstacle_nodes_on_circle(ref):
    """Every velocity node on the obstacle's boundary lies on the circle of
    radius 0.05 about (0.2, 0.2) (tests/test_stokes.py:470-502)."""
    tm = tstokes.dfg_cylinder_mesh(ref)
    k = 2
    coords = tm.dof_coordinates(k)
    lo, hi = 2 ** ref * k, 2 * 2 ** ref * k     # the obstacle: base cell 1
    ring = np.zeros((hi - lo + 1,) * 2, dtype=bool)
    ring[0, :] = ring[-1, :] = ring[:, 0] = ring[:, -1] = True
    pts = coords[lo:hi + 1, lo:hi + 1][ring]
    rad = np.hypot(pts[:, 0] - 0.2, pts[:, 1] - 0.2)
    assert np.abs(rad - 0.05).max() < 1e-12
    act = tm.cell_mask.reshape(-1) != 0
    vol = tm.geometry(4).jxw.reshape(tm.n_cells, -1)[act].sum()
    assert abs(vol - (2.2 * 0.41 - np.pi * 0.05 ** 2)) < 1e-4


@pytest.mark.parametrize("grid", ["square", "cylinder"])
def test_laplace_mass_operator(grid):
    jm, tm = GRIDS[grid](1)
    jop = JOp(jm, 2, 3, 1.3, 0.7, dtype=jnp.float64)
    top = LaplaceMassOperator(tm, 2, 3, 1.3, 0.7, device="cpu")
    np.testing.assert_array_equal(top.mask_np, jop.mask_np)
    x = np.random.default_rng(0).standard_normal((2,) + top.dof_shape)
    _rel_close(top.apply(torch.tensor(x)), jop.apply(jnp.asarray(x)), 1e-12)
    _rel_close(top.element_matrices(), jop.element_matrices(), 1e-12)


def test_load_geometry():
    """stfem_tpu's jxw and jinv loaded into the port's operator give its
    apply; the loaded arrays are the ones used (a doubled jxw doubles the
    apply, doubled inverse steps quadruple the Laplace part)."""
    jm, tm = GRIDS["cylinder"](1)
    jop = JOp(jm, 2, 3, 1.3, 0.7, dtype=jnp.float64)
    top = LaplaceMassOperator(tm, 2, 3, 1.3, 0.7, device="cpu")
    jg = jm.geometry(3, 2)
    load_geometry(top, jxw=np.asarray(jg.jxw), jinv=np.asarray(jg.jinv))
    x = torch.tensor(np.random.default_rng(1).standard_normal(
        top.dof_shape))
    y = top.apply(x)
    _rel_close(y, jop.apply(jnp.asarray(x.numpy())), 1e-12)
    load_geometry(top, jxw=2.0 * np.asarray(jg.jxw))
    _rel_close(top.apply(x), 2.0 * y, 1e-15)
    js, ts = GRIDS["square"](1)
    lap = LaplaceMassOperator(ts, 2, 3, 0.0, 0.7, device="cpu")
    y = lap.apply(torch.tensor(np.random.default_rng(2).standard_normal(
        lap.dof_shape)))
    load_geometry(lap, jinv_axis=[2.0 * a for a in
                                  js.geometry(3, 2).jinv_axis])
    _rel_close(lap.apply(torch.tensor(np.random.default_rng(2)
                                      .standard_normal(lap.dof_shape))),
               4.0 * y, 1e-14)
    S = StokesOperator(ts, 2, 1, 3, NU, device="cpu", weak_faces=WEAK_2D,
                       free_faces=FREE)
    u = torch.tensor(np.random.default_rng(3).standard_normal(
        (2,) + S.dof_shape_u))
    p = torch.tensor(np.random.default_rng(4).standard_normal(S.p_shape))
    ru, rp = S.apply(u, p)
    load_geometry(S, jxw=np.asarray(S.geom.jxw) * 1.0)
    for a, b in zip(S.apply(u, p), (ru, rp)):
        _rel_close(a, b, 0.0)


@pytest.mark.parametrize("grid,ref,dim", [("square", 1, 2),
                                          ("cylinder", 1, 2),
                                          ("square", 0, 3)])
def test_stokes_operator(grid, ref, dim):
    jm, tm = GRIDS[grid](ref, dim)
    weak = WEAK_2D if dim == 2 else WEAK_3D
    js = JStokes(jm, 2, 1, 3, NU, weak_faces=weak, free_faces=FREE)
    ts = StokesOperator(tm, 2, 1, 3, NU, device="cpu", weak_faces=weak,
                        free_faces=FREE)
    np.testing.assert_array_equal(ts.mask_u_np, js.mask_u_np)
    rng = np.random.default_rng(6)
    u = rng.standard_normal((2, dim) + ts.dof_shape_u)
    p = rng.standard_normal((2,) + ts.p_shape)
    for t, j in zip(ts.apply(torch.tensor(u), torch.tensor(p)),
                    js.apply(jnp.asarray(u), jnp.asarray(p))):
        _rel_close(t, j, 1e-12)
    # stfem_tpu's E_uu carries the default boundary mask; its Vanka takes
    # the velocity Laplacian on the operator's mask, as the port's does
    j_uu = JOp(jm, 2, 3, 0.0, NU, mask=js.mask_u_np).element_matrices()
    _, j_up, j_pu = js.element_matrices()
    for t, j in zip(ts.element_matrices(), (j_uu, j_up, j_pu)):
        _rel_close(t, j, 1e-12)
    tf, jf = ts.face_element_matrices(), js.face_element_matrices()
    assert [f[:2] for f in tf] == [f[:2] for f in jf]
    for (_, _, tuu, tup, tpu), (_, _, juu, jup, jpu) in zip(tf, jf):
        for t, j in zip(tuu + [tup, tpu], list(juu) + [jup, jpu]):
            _rel_close(t, j, 1e-12)


def test_identity_map_is_cartesian():
    """tests/test_stokes.py:445-467 on the port: the mapped path with the
    identity map gives the Cartesian operator."""
    plain = StructuredMesh([2, 2], [0.0, 0.0], [1.0, 1.0], refinement=1)
    mapped = StructuredMesh([2, 2], [0.0, 0.0], [1.0, 1.0], refinement=1,
                            vertex_map=lambda x: x * 1.0, map_exact=True)
    Sa = StokesOperator(plain, 2, 1, 3, 1e-2, device="cpu")
    Sb = StokesOperator(mapped, 2, 1, 3, 1e-2, device="cpu")
    assert Sb.jinv is not None
    rng = np.random.default_rng(3)
    u = torch.tensor(rng.standard_normal((2,) + Sa.dof_shape_u))
    p = torch.tensor(rng.standard_normal(plain.cells + (Sa.n_ploc,)))
    for a, b in zip(Sa.apply(u, p), Sb.apply(u, p)):
        _rel_close(b, a, 1e-12)
    for a, b in zip(Sa.element_matrices(), Sb.element_matrices()):
        _rel_close(b, a, 1e-12)


@pytest.mark.parametrize("grid", ["square", "cylinder"])
@pytest.mark.parametrize("kind", ["DG", "CGP"])
def test_element_route(grid, kind):
    """Per-cell element matrices: the element route equals the
    sum-factorised apply (float64)."""
    _, tm = GRIDS[grid](1)
    S = StokesOperator(tm, 2, 1, 3, NU, device="cpu", weak_faces=WEAK_2D,
                       free_faces=FREE)
    M = LaplaceMassOperator(tm, 2, 3, 1.0, 0.0, device="cpu",
                            mask=S.mask_u_np)
    a, b = get_fe_time_weights(getattr(TimeStepType, kind), 1, 1 / 16, 2)[:2]
    ref = StokesSystemMatrix(S, M, a, b, precision=None)
    el = StokesSystemMatrix(S, M, a, b, precision=None, route="element")
    assert el._E.shape == (tm.n_cells, 21, 42)
    x = torch.tensor(np.random.default_rng(7).standard_normal(
        (a.shape[0], 3, S.n_u + S.n_p)))
    _rel_close(el.vmult(x), ref.vmult(x), 1e-12)


@pytest.mark.parametrize("grid", ["square", "cylinder"])
def test_functionals(grid):
    jm, tm = GRIDS[grid](1)
    js = JStokes(jm, 2, 1, 3, NU, weak_faces=WEAK_2D, free_faces=FREE)
    ts = StokesOperator(tm, 2, 1, 3, NU, device="cpu", weak_faces=WEAK_2D,
                        free_faces=FREE)
    assert tfun.obstacle_faces(tm) == [
        (d, tuple(int(i) for i in c), s)
        for d, c, s in jfun.obstacle_faces(jm)]
    rng = np.random.default_rng(8)
    u = rng.standard_normal((2,) + ts.dof_shape_u)
    p = rng.standard_normal(ts.p_shape)
    tdl = tfun.compute_drag_lift(ts, torch.tensor(u), torch.tensor(p), 48.8)
    jdl = jfun.compute_drag_lift(js, jnp.asarray(u), jnp.asarray(p), 48.8)
    np.testing.assert_allclose(tdl.numpy(), jdl, rtol=1e-12)
    assert float(tfun.compute_divergence_norm(ts, torch.tensor(u))) == \
        pytest.approx(jfun.compute_divergence_norm(js, jnp.asarray(u)),
                      rel=1e-12)
    if grid == "square":
        # the wall force on a non-uniform grid against its own definition
        # on the same field with the steps taken cell by cell: the lower
        # wall of a field u = (y, 0), p = 0 has traction nu (n = -e_y)
        c = tm.dof_coordinates(2)
        uy = np.stack([c[..., 1], np.zeros(c.shape[:-1])])
        F = tfun.compute_wall_force(ts, uy, np.zeros(ts.p_shape), (1, 0))
        np.testing.assert_allclose(F.numpy(), [NU * 2.2, 0.0], rtol=0,
                                   atol=1e-13)


def test_still_raising():
    """FE_Q pressure is not ported: it raises.  The weak obstacle and the
    Navier modes, which raised until they were ported, build and apply
    (their parity is tests/test_torch_weak_obstacle.py's and
    tests/test_torch_navier.py's); an unknown operator mode raises.  The
    Q1-interpolated vertex map is ported: it maps the vertex grid (its
    parity is tests/test_torch_distort.py's)."""
    from stfem_tpu_torch.stmg.gmg import build_stmg_stokes
    _, tm = GRIDS["square"](0)
    with pytest.raises(NotImplementedError):
        StokesOperator(tm, 2, 1, 3, NU, device="cpu", dg_pressure=False)
    with pytest.raises(NotImplementedError):
        build_stmg_stokes(tm, 1, TimeStepType.DG, 1, 1 / 16, device="cpu",
                          dg_pressure=False)
    S = StokesOperator(tm, 2, 1, 3, NU, device="cpu", weak_faces=WEAK_2D,
                       free_faces=FREE, weak_obstacle=True)
    u = torch.ones((2,) + S.dof_shape_u, dtype=torch.float64)
    p = torch.zeros(S.p_shape, dtype=torch.float64)
    for mode in ("none", "jacobian", "form"):
        ru, rp = S.apply(u, p, mode=mode, u_lin=u)
        assert torch.isfinite(ru).all() and torch.isfinite(rp).all()
    with pytest.raises(ValueError):
        S.apply(u, p, mode="newton", u_lin=u)
    gmg = build_stmg_stokes(tm, 1, TimeStepType.DG, 1, 1 / 16,
                            device="cpu", weak_faces=WEAK_2D,
                            free_faces=FREE, weak_obstacle=True)
    assert all(lvl.matrix.S.weak_obstacle for lvl in gmg.levels)
    q1 = StructuredMesh([1, 1], [0.0, 0.0], [1.0, 1.0],
                        vertex_map=lambda x: 2.0 * x)
    np.testing.assert_array_equal(q1.vertices, [[[0, 0], [0, 2]],
                                                [[2, 0], [2, 2]]])
