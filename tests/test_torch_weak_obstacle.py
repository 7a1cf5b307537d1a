"""The weak (Nitsche) obstacle of the DFG channel in stfem_tpu_torch
against stfem_tpu (CPU): the velocity mask, the per-face Nitsche matrices
of the obstacle (Nanson normals, physical gradients through J^-1, on the
square and on the mapped cylinder), their apply, the element route of
the slab operator, the obstacle Vanka in the STMG hierarchy, and
run_dfg_square(weak_obstacle=True) end to end.  2D Q2 x DGP1, dG(1),
nu 1e-3, tau 1/16, weak inflow and walls, do-nothing outflow; the
factories are tests/test_stokes.py:279-286's (smoothing range 5,
fe_degree_min 1, space-first), and the port's runs carry stfem_tpu's
level omegas, Vanka factors and coarse inverse (utils/carry.py).

Tolerances: the masks, the face index maps and the tables' coverage
exact; E_uu, E_up, the obstacle apply, the operator in every route and
the slab operator 1e-12 of the largest entry (FP64); the Vanka factors
and one float32 V-cycle from stfem_tpu's factors 1e-5 of the largest
entry; the channel's FGMRES iterations within 1 a slab (equal here), u
and p within 1e-8 of their largest entry on the dofs the port keeps
(it zeroes the eliminated ones after a slab), drag, lift and divergence
norm 1e-8 relative; the weak square's drag within 2% of the strong
one's (stfem_tpu's test_dfg_weak_obstacle criterion)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu.drivers import stokes as jstokes
from stfem_tpu.ops.spatial import LaplaceMassOperator as JLap
from stfem_tpu.ops.stokes import StokesOperator as JStokes
from stfem_tpu.stmg.gmg import GMGParams as JParams
from stfem_tpu.stmg.gmg import build_stmg_stokes as jbuild
from stfem_tpu.system_stokes import StokesSystemMatrix as JSystem
from stfem_tpu_torch import types as ttypes
from stfem_tpu_torch.drivers import stokes as tstokes
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
from stfem_tpu_torch.ops.stokes import StokesOperator
from stfem_tpu_torch.stmg.gmg import GMGParams, build_stmg_stokes
from stfem_tpu_torch.stmg.smoother import IdentitySmoother
from stfem_tpu_torch.system_stokes import StokesSystemMatrix
from stfem_tpu_torch.utils.carry import load_gmg, load_stokes_vanka

torch.set_num_threads(1)

WEAK, FREE = ((0, 0), (1, 0), (1, 1)), ((0, 1),)
NU, TAU = 1e-3, 1.0 / 16.0
MESHES = {"square": (jstokes.dfg_square_mesh, tstokes.dfg_square_mesh),
          "cylinder": (jstokes.dfg_cylinder_mesh, tstokes.dfg_cylinder_mesh)}
NAMES = pytest.mark.parametrize("name", list(MESHES))


def _rel_close(t, j, rel):
    t = np.asarray(t.detach() if torch.is_tensor(t) else t, np.float64)
    j = np.asarray(j, np.float64)
    assert t.shape == j.shape, (t.shape, j.shape)
    np.testing.assert_allclose(t, j, rtol=0, atol=rel * np.abs(j).max())


def _pair(name, ref=1, **kw):
    jm, tm = MESHES[name]
    return (JStokes(jm(ref), 2, 1, 3, NU, weak_faces=WEAK, free_faces=FREE,
                    weak_obstacle=True, **kw),
            StokesOperator(tm(ref), 2, 1, 3, NU, device="cpu",
                           weak_faces=WEAK, free_faces=FREE,
                           weak_obstacle=True, **kw))


@pytest.fixture(scope="module")
def ops():
    return {name: _pair(name) for name in MESHES}


@pytest.mark.parametrize("ref", [0, 2])
def test_obstacle_mask(ref):
    """Only the dofs that no active cell carries stay eliminated: the
    obstacle's boundary layer is free, its interior not."""
    js, ts = _pair("square", ref)
    np.testing.assert_array_equal(ts.mask_u_np, js.mask_u_np)
    strong = StokesOperator(tstokes.dfg_square_mesh(ref), 2, 1, 3, NU,
                            device="cpu", weak_faces=WEAK, free_faces=FREE)
    freed = (ts.mask_u_np == 1.0) & (strong.mask_u_np == 0.0)
    assert freed.sum() == 8 * 2 ** ref        # the obstacle's boundary
    assert np.all(strong.mask_u_np <= ts.mask_u_np)


@NAMES
def test_obstacle_face_matrices(name, ops):
    js, ts = ops[name]
    jo, to = js._obstacle_face_setup(), ts._obstacle
    np.testing.assert_array_equal(to["uidx"], np.asarray(jo["uidx"]))
    np.testing.assert_array_equal(to["pidx"], np.asarray(jo["pidx"]))
    _rel_close(to["E_uu"], jo["E_uu"], 1e-12)
    _rel_close(to["E_up"], jo["E_up"], 1e-12)
    # the owner-computes tables list every (face, node) and face once
    rows = to["u_table"].numpy()
    assert np.array_equal(np.sort(rows[rows < to["uidx"].size]),
                          np.arange(to["uidx"].size))
    assert np.array_equal(np.sort(to["u_dofs"].numpy()),
                          np.unique(to["uidx"]))
    prow = to["p_table"].numpy()
    assert np.array_equal(np.sort(prow[prow < len(to["pidx"])]),
                          np.arange(len(to["pidx"])))


@NAMES
def test_apply_nitsche_obstacle(name, ops):
    js, ts = ops[name]
    rng = np.random.default_rng(1)
    u = rng.standard_normal((2, 2) + ts.dof_shape_u) * ts.mask_u_np
    p = rng.standard_normal((2,) + ts.p_shape)
    for jr, tr in zip(js.apply_nitsche_obstacle(jnp.asarray(u),
                                                jnp.asarray(p)),
                      ts.apply_nitsche_obstacle(torch.as_tensor(u),
                                                torch.as_tensor(p))):
        _rel_close(tr, jr, 1e-12)
    for jr, tr in zip(js.apply(jnp.asarray(u), jnp.asarray(p)),
                      ts.apply(torch.as_tensor(u), torch.as_tensor(p))):
        _rel_close(tr, jr, 1e-12)


@NAMES
def test_slab_operator_routes(name, ops):
    """The slab operator with the weak obstacle: the element route (the
    obstacle cells' summed face matrices) and the sum-factorised route
    against stfem_tpu's StokesSystemMatrix, in FP64."""
    js, ts = ops[name]
    a = np.array([[0.6, 0.1], [-0.2, 0.5]])
    b = 0.5 * a.T
    jmu = JLap(js.mesh, 2, 3, 1.0, 0.0, mask=js.mask_u_np)
    tmu = LaplaceMassOperator(ts.mesh, 2, 3, 1.0, 0.0, device="cpu",
                              mask=ts.mask_u_np)
    x = np.random.default_rng(2).standard_normal((2, ts.n_u + ts.n_p))
    ref = JSystem(js, jmu, a, b).vmult(jnp.asarray(x))
    for route in ("sumfac", "element"):
        m = StokesSystemMatrix(ts, tmu, a, b, route=route)
        _rel_close(m.vmult(torch.as_tensor(x)), ref, 1e-12)


def _jfactory(store, key):
    def factory(ctx):
        store[key] = jbuild(ctx["mesh"], ctx["fe_degree"], ctx["type_"], 1,
                            ctx["time_step"], viscosity=ctx["viscosity"],
                            params=JParams(smoothing_range=5.0),
                            fe_degree_min=1, space_time_level_first=False,
                            weak_faces=ctx["weak_faces"],
                            free_faces=ctx["free_faces"],
                            weak_obstacle=ctx.get("weak_obstacle", False))
        return store[key]
    return factory


def carry_hierarchy(tg, jg):
    """stfem_tpu's level omegas, Vanka factors and coarse inverse into the
    port's hierarchy (utils/carry.py)."""
    omegas = [None] * len(jg.levels)
    for l, (jl, tl) in enumerate(zip(jg.levels, tg.levels)):
        if l == 0 or isinstance(tl.smoother, IdentitySmoother):
            continue
        omegas[l] = float(jl.smoother.omega)
        jv = jl.smoother.precond
        load_stokes_vanka(tl.smoother.precond, np.asarray(jv.Binv),
                          None if jv.Kappa is None else np.asarray(jv.Kappa))
    load_gmg(tg, omegas, np.asarray(jg.coarse_Ainv))


def _tfactory(store, key):
    def factory(ctx):
        tg = build_stmg_stokes(ctx["mesh"], ctx["fe_degree"], ctx["type_"],
                               1, ctx["time_step"],
                               viscosity=ctx["viscosity"],
                               params=GMGParams(smoothing_range=5.0),
                               fe_degree_min=1, weak_faces=ctx["weak_faces"],
                               free_faces=ctx["free_faces"],
                               weak_obstacle=ctx["weak_obstacle"],
                               device=ctx["device"])
        store[key] = tg
        return tg
    return factory


KW = dict(refinement=1, u_mean=1.0, dfg_benchmark=3, rel_tol=1e-12,
          gmres_maxiter=150, weak_obstacle=True)
SLABS = {False: 2, True: 1}


@pytest.fixture(scope="module")
def jax_runs():
    """stfem_tpu's weak-obstacle channel at refinement 1: the square for 2
    slabs, the cylinder for 1, and the hierarchies they built."""
    gmgs = {}
    runs = {cyl: jstokes.run_dfg_square(
        preconditioner_factory=_jfactory(gmgs, cyl), cylinder=cyl,
        n_slabs=SLABS[cyl], **KW) for cyl in (False, True)}
    return runs, gmgs


def test_obstacle_vanka_and_vcycle(jax_runs):
    """The square's hierarchy (the weak obstacle on every level's
    coarsened mask): masks, the Vanka factors, then one float32 V-cycle
    from stfem_tpu's factors."""
    jg = jax_runs[1][False]
    tg = build_stmg_stokes(tstokes.dfg_square_mesh(1), 1,
                           ttypes.TimeStepType.DG, 1, TAU, viscosity=NU,
                           params=GMGParams(smoothing_range=5.0),
                           fe_degree_min=1, weak_faces=WEAK,
                           free_faces=FREE, weak_obstacle=True,
                           device="cpu")
    assert len(tg.levels) == len(jg.levels)
    n = 0
    for l, (jl, tl) in enumerate(zip(jg.levels, tg.levels)):
        assert tl.matrix.S.weak_obstacle and jl.matrix.S.weak_obstacle
        np.testing.assert_array_equal(tl.matrix.S.mask_u_np,
                                      jl.matrix.S.mask_u_np)
        if l == 0 or isinstance(tl.smoother, IdentitySmoother):
            continue
        _rel_close(tl.smoother.precond.Binv, jl.smoother.precond.Binv, 1e-5)
        n += 1
    assert n
    carry_hierarchy(tg, jg)
    top = tg.levels[-1]
    x = np.random.default_rng(9).standard_normal((top.n_blocks,)
                                                 + top.dof_shape)
    _rel_close(tg.vmult(torch.as_tensor(x, dtype=torch.float32)),
               jax.jit(jg.vmult)(jnp.asarray(x, jnp.float32)), 1e-5)


@pytest.mark.parametrize("cylinder", [False, True],
                         ids=["square", "cylinder"])
def test_run_dfg_square_weak(cylinder, jax_runs):
    j = jax_runs[0][cylinder]
    jg = jax_runs[1][cylinder]
    store = {}
    tfac = _tfactory(store, 0)

    def factory(ctx):
        tg = tfac(ctx)
        carry_hierarchy(tg, jg)
        return tg

    t = tstokes.run_dfg_square(preconditioner_factory=factory, device="cpu",
                               cylinder=cylinder, n_slabs=SLABS[cylinder],
                               **KW)
    assert len(t["iterations"]) == len(j["iterations"])
    assert all(abs(a - b) <= 1 for a, b in zip(t["iterations"],
                                               j["iterations"]))
    S = store[0].levels[-1].matrix.S
    keep = np.broadcast_to(S.mask_u_np, t["u"].shape) == 1.0
    _rel_close(np.where(keep, t["u"], 0.0), np.where(keep, j["u"], 0.0),
               1e-8)
    _rel_close(t["p"], j["p"], 1e-8)
    np.testing.assert_allclose(t["drag_lift"], np.asarray(j["drag_lift"]),
                               rtol=1e-8)
    np.testing.assert_allclose(t["divergence"], j["divergence"], rtol=1e-8)


def test_weak_against_strong_drag():
    """The square's c_D with the weak obstacle within 2% of the strong
    obstacle's at the last slab (stfem_tpu's criterion: the same discrete
    trace space)."""
    cd = [float(tstokes.run_dfg_square(
        preconditioner_factory=_tfactory({}, 0), device="cpu",
        n_slabs=SLABS[False], **dict(KW, weak_obstacle=weak))[
            "drag_lift"][-1][0]) for weak in (True, False)]
    cd_w, cd_s = cd
    assert abs(cd_w - cd_s) <= 0.02 * abs(cd_s), (cd_w, cd_s)
