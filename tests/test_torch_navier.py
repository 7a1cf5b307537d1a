"""The Navier-Stokes surface of stfem_tpu_torch against stfem_tpu (CPU):
the nonlinear extrapolation (Picard predictor) tables, the "jacobian"
and "form" modes of StokesOperator.apply with the CIP and backflow
stabilizations, the slab operator's nonlinear modes on both routes, and
run_navier_stokes_cycle end to end with the Constant and the Polynomial
predictor.  2D Q2 x DGP1 (the CIP property case Q2 x DGP3, as stfem_tpu's
test_cip_stabilization), DG in time; the cycles use
tests/test_stokes.py:21-27's factory (smoothing range 5, fe_degree_min
1, space-first) and the port's runs carry stfem_tpu's level omegas,
Vanka factors, coarse inverse and coarse nullspace (utils/carry.py).

Tolerances: the extrapolation matrices 1e-14 (absolute; entries O(1));
every apply, CIP and backflow 1e-12 of the largest entry (FP64); CIP on
a C^1 field 1e-12 absolute; the cycle's FGMRES iterations within 1 a
slab (equal here) and every error norm 1e-8 relative; the Polynomial
predictor's l2 error within 1e-3 relative of the Constant one's and its
iterations at most the Constant run's + 2 (stfem_tpu's
test_navier_stokes_extrapolation_predictor)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu import types as jtypes
from stfem_tpu.drivers import stokes as jstokes
from stfem_tpu.mesh.grid import StructuredMesh as JMesh
from stfem_tpu.ops.spatial import LaplaceMassOperator as JLap
from stfem_tpu.ops.stokes import StokesOperator as JStokes
from stfem_tpu.stmg.gmg import GMGParams as JParams
from stfem_tpu.stmg.gmg import build_stmg_stokes as jbuild
from stfem_tpu.system_stokes import StokesSystemMatrix as JSystem
from stfem_tpu.time import tables as jtables
from stfem_tpu_torch import types as ttypes
from stfem_tpu_torch.drivers import stokes as tstokes
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
from stfem_tpu_torch.ops.stokes import StokesOperator
from stfem_tpu_torch.stmg.gmg import GMGParams, build_stmg_stokes
from stfem_tpu_torch.stmg.smoother import IdentitySmoother
from stfem_tpu_torch.system_stokes import StokesSystemMatrix
from stfem_tpu_torch.time import tables as ttables
from stfem_tpu_torch.utils.carry import load_gmg, load_stokes_vanka

torch.set_num_threads(1)

WEAK, FREE = ((0, 0), (1, 0), (1, 1)), ((0, 1),)
MODES = ("none", "jacobian", "form")


def _rel_close(t, j, rel):
    t = np.asarray(t.detach() if torch.is_tensor(t) else t, np.float64)
    j = np.asarray(j, np.float64)
    assert t.shape == j.shape, (t.shape, j.shape)
    np.testing.assert_allclose(t, j, rtol=0, atol=rel * np.abs(j).max())


@pytest.mark.parametrize("type_", ["DG", "CGP"])
@pytest.mark.parametrize("r", [1, 2, 3])
def test_extrapolation_matrices(type_, r):
    for pred in ("Auto", "Constant", "Polynomial"):
        j = jtables.get_extrapolation_matrix(
            getattr(jtypes.TimeStepType, type_),
            getattr(jtypes.NonlinearExtrapolation, pred), r, 1.0, 0.0, 0.0)
        t = ttables.get_extrapolation_matrix(
            getattr(ttypes.TimeStepType, type_),
            getattr(ttypes.NonlinearExtrapolation, pred), r, 1.0, 0.0, 0.0)
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-14)
    # the penalty and filter terms
    j = jtables.construct_extrapolation_matrix(
        getattr(jtypes.TimeStepType, type_), r, 0.5, 0.3, 0.2)
    t = ttables.construct_extrapolation_matrix(
        getattr(ttypes.TimeStepType, type_), r, 0.5, 0.3, 0.2)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-14)


def test_extrapolation_least_squares_raises():
    with pytest.raises(ValueError):
        ttables.get_extrapolation_matrix(
            ttypes.TimeStepType.DG, ttypes.NonlinearExtrapolation.LeastSquares,
            1, 1.0, 0.0, 0.0)


MESHES = {
    "uniform": (lambda: JMesh([1, 1], [0, 0], [1, 1], refinement=2),
                lambda: StructuredMesh([1, 1], [0, 0], [1, 1],
                                       refinement=2)),
    "square": (lambda: jstokes.dfg_square_mesh(1),
               lambda: tstokes.dfg_square_mesh(1)),
    "cylinder": (lambda: jstokes.dfg_cylinder_mesh(1),
                 lambda: tstokes.dfg_cylinder_mesh(1)),
}
STAB = dict(weak_faces=WEAK, free_faces=FREE, delta0=0.3,
            outflow_penalty=0.7)


@pytest.fixture(scope="module")
def ops():
    """Both packages' operators with weak and free faces, CIP and
    backflow, on each mesh (viscosity 0.01)."""
    return {name: (JStokes(jm(), 2, 1, 3, 0.01, **STAB),
                   StokesOperator(tm(), 2, 1, 3, 0.01, device="cpu", **STAB))
            for name, (jm, tm) in MESHES.items()}


def _fields(S, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 2) + S.dof_shape_u),
            rng.standard_normal((2,) + S.p_shape),
            rng.standard_normal((2, 2) + S.dof_shape_u))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(MESHES))
def test_apply_modes(name, mode, ops):
    js, ts = ops[name]
    u, p, ul = _fields(ts)
    jr = js.apply(jnp.asarray(u), jnp.asarray(p), mode=mode,
                  u_lin=jnp.asarray(ul))
    tr = ts.apply(torch.as_tensor(u), torch.as_tensor(p), mode=mode,
                  u_lin=torch.as_tensor(ul))
    for a, b in zip(tr, jr):
        _rel_close(a, b, 1e-12)


@pytest.mark.parametrize("name", list(MESHES))
def test_cip_backflow_parity(name, ops):
    js, ts = ops[name]
    u, _, ul = _fields(ts, 1)
    for j_lin, t_lin in ((jnp.asarray(ul), torch.as_tensor(ul)),
                         (None, None)):
        _rel_close(ts.apply_cip(torch.as_tensor(u), t_lin, 0.3),
                   js.apply_cip(jnp.asarray(u), j_lin, 0.3), 1e-12)
        _rel_close(ts.apply_backflow(torch.as_tensor(u), t_lin, 0.7),
                   js.apply_backflow(jnp.asarray(u), j_lin, 0.7), 1e-12)


def test_cip_properties():
    """stfem_tpu's test_cip_stabilization on the port: CIP vanishes on a
    globally C^1 field, is positive semi-definite, enters apply() only in
    the nonlinear modes with delta0 != 0."""
    mesh = StructuredMesh([1, 1], [0, 0], [1, 1], refinement=2)
    S0 = StokesOperator(mesh, 2, 3, 3, 1.0, device="cpu")
    S = StokesOperator(mesh, 2, 3, 3, 1.0, device="cpu", delta0=0.5)
    coords = torch.as_tensor(mesh.dof_coordinates(2))
    u_smooth = torch.stack([coords[..., 0] ** 2, coords[..., 1] ** 2])
    assert float(S.apply_cip(u_smooth, u_smooth, 0.5).abs().max()) < 1e-12
    rng = np.random.default_rng(3)
    u = torch.as_tensor(rng.standard_normal((2,) + S.dof_shape_u))
    p = torch.as_tensor(rng.standard_normal(S.p_shape))
    r2 = S.apply_cip(u * S.mask_u, u_smooth, 0.5)
    assert float(((u * S.mask_u) * r2).sum()) >= -1e-10
    ru0, rp0 = S0.apply(u, p, mode="form", u_lin=u_smooth)
    ru1, rp1 = S.apply(u, p, mode="form", u_lin=u_smooth)
    _rel_close(ru1, (ru0 + r2 * S.mask_u).numpy(), 1e-13)
    assert torch.equal(rp1, rp0)
    for a, b in zip(S.apply(u, p), S0.apply(u, p)):
        assert torch.equal(a, b)                  # linear mode: CIP off


def test_backflow_properties():
    """stfem_tpu's test_backflow_stabilization on the port: local to the
    outflow plane, only in the nonlinear modes with outflow_penalty."""
    mesh = StructuredMesh([1, 1], [0, 0], [1, 1], refinement=2)
    kw = dict(weak_faces=WEAK, free_faces=FREE, device="cpu")
    S = StokesOperator(mesh, 2, 1, 3, 1.0, outflow_penalty=1.0, **kw)
    S0 = StokesOperator(mesh, 2, 1, 3, 1.0, **kw)
    rng = np.random.default_rng(0)
    u = torch.as_tensor(rng.standard_normal((2,) + S.dof_shape_u))
    p = torch.as_tensor(rng.standard_normal(S.p_shape))
    r = S.apply_backflow(u, u, 1.0)
    off = torch.ones(r.shape, dtype=torch.bool)
    off[:, -1, :] = False
    assert float(r[off].abs().max()) == 0.0
    ru1, _ = S.apply(u, p, mode="form", u_lin=u)
    ru0, _ = S0.apply(u, p, mode="form", u_lin=u)
    assert float(((ru1 - ru0) - r * S.mask_u).abs().max()) < 1e-12
    for a, b in zip(S.apply(u, p), S0.apply(u, p)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["jacobian", "form"])
def test_slab_operator_nonlinear(mode, ops):
    """StokesSystemMatrix.vmult(x, u_lin=, mode=) against stfem_tpu's on
    the square: the nonlinear modes go through the Stokes operator on
    either route."""
    js, ts = ops["square"]
    a = np.array([[0.6, 0.1], [-0.2, 0.5]])
    b = 0.5 * a.T
    jmu = JLap(js.mesh, 2, 3, 1.0, 0.0, mask=js.mask_u_np)
    tmu = LaplaceMassOperator(ts.mesh, 2, 3, 1.0, 0.0, device="cpu",
                              mask=ts.mask_u_np)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, ts.n_u + ts.n_p))
    ul = rng.standard_normal((2, 2) + ts.dof_shape_u)
    ref = JSystem(js, jmu, a, b).vmult(jnp.asarray(x), u_lin=jnp.asarray(ul),
                                       mode=mode)
    for route in ("sumfac", "element"):
        m = StokesSystemMatrix(ts, tmu, a, b, route=route)
        _rel_close(m.vmult(torch.as_tensor(x), u_lin=torch.as_tensor(ul),
                           mode=mode), ref, 1e-12)


def _jfactory(store, key):
    def factory(ctx):
        store[key] = jbuild(ctx["mesh"], ctx["fe_degree"], ctx["type_"],
                            ctx["n_timesteps_at_once"], ctx["time_step"],
                            viscosity=ctx["viscosity"],
                            params=JParams(smoothing_range=5.0),
                            fe_degree_min=1, space_time_level_first=False)
        return store[key]
    return factory


def _tfactory(jg=None):
    """The port's factory, with stfem_tpu's hierarchy jg carried in."""
    def factory(ctx):
        tg = build_stmg_stokes(ctx["mesh"], ctx["fe_degree"], ctx["type_"],
                               ctx["n_timesteps_at_once"], ctx["time_step"],
                               viscosity=ctx["viscosity"],
                               params=GMGParams(smoothing_range=5.0),
                               fe_degree_min=1, device=ctx["device"])
        if jg is not None:
            omegas = [None] * len(jg.levels)
            for l, (jl, tl) in enumerate(zip(jg.levels, tg.levels)):
                if l == 0 or isinstance(tl.smoother, IdentitySmoother):
                    continue
                omegas[l] = float(jl.smoother.omega)
                jv = jl.smoother.precond
                load_stokes_vanka(tl.smoother.precond, np.asarray(jv.Binv),
                                  None if jv.Kappa is None
                                  else np.asarray(jv.Kappa))
            load_gmg(tg, omegas, np.asarray(jg.coarse_Ainv),
                     np.asarray(jg.coarse_null))
        return tg
    return factory


CASES = {"constant": dict(fe_degree=1, gmres_maxiter=60),
         "polynomial": dict(fe_degree=2, gmres_maxiter=150)}
NORMS = ("l2_l2_u", "linf_linf_u", "l2_h1_u", "l2_hdiv_u", "l2_l2_p",
         "linf_linf_p", "l2_h1_p")


def _kw(case, pkg):
    kw = dict(refinement=1, n_picard=2, **CASES[case])
    if case == "polynomial":
        kw["nonlinear_extrapolation"] = pkg.NonlinearExtrapolation.Polynomial
    return kw


@pytest.fixture(scope="module")
def jax_cycles():
    """stfem_tpu's cycles at refinement 1 (DG(1) with the Constant
    predictor, DG(2) with the Polynomial one) and their hierarchies."""
    gmgs = {}
    runs = {case: jstokes.run_navier_stokes_cycle(
        preconditioner_factory=_jfactory(gmgs, case), **_kw(case, jtypes))
        for case in CASES}
    return runs, gmgs


@pytest.mark.parametrize("case", list(CASES))
def test_run_navier_stokes_cycle(case, jax_cycles):
    j = jax_cycles[0][case]
    t = tstokes.run_navier_stokes_cycle(
        preconditioner_factory=_tfactory(jax_cycles[1][case]), device="cpu",
        **_kw(case, ttypes))
    assert t.n_timesteps == j.n_timesteps == len(t.slab_iterations)
    assert abs(t.total_iterations - j.total_iterations) <= t.n_timesteps
    for name in NORMS:
        assert getattr(t, name) == pytest.approx(getattr(j, name),
                                                 rel=1e-8), name
    if case == "polynomial":
        # the predictor reaches the Constant predictor's fixed point
        # without extra outer iterations (the port's own Constant run)
        kw = _kw(case, ttypes)
        kw.pop("nonlinear_extrapolation")
        const = tstokes.run_navier_stokes_cycle(
            preconditioner_factory=_tfactory(), device="cpu", **kw)
        assert t.l2_l2_u == pytest.approx(const.l2_l2_u, rel=1e-3)
        assert t.total_iterations <= const.total_iterations + 2


def test_navier_n_slabs_max():
    t = tstokes.run_navier_stokes_cycle(
        refinement=1, fe_degree=1, n_picard=2, gmres_maxiter=60,
        preconditioner_factory=_tfactory(), device="cpu", n_slabs_max=2)
    assert t.n_timesteps == 2 and len(t.slab_iterations) == 2
