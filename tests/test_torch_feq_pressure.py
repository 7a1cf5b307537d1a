"""The continuous (FE_Q, Taylor-Hood Q2/Q1) pressure of stfem_tpu_torch's
Stokes stack against stfem_tpu's (CPU, x64): the operator, its element
matrices and Nitsche faces, the element route, the FE_Q Vanka, the nodal
pressure transfers, the hierarchy and one whole convergence cycle
(stfem_tpu's dg_pressure=False; reference tp_03stokes.cc:81-87).

The same seeded NumPy inputs go through both packages.  Tolerances: the
operator apply, the Nitsche rhs, the element and face element matrices
and the element route against the sum-factorised one in float64, 1e-12
relative to the largest value; the neighbour-assembled patch coupling
1e-12; the float64 Vanka's pseudo-inverted patches, step couplings and
apply 1e-9 of the largest (pinv's cut-off is relative to each patch's
largest singular value, so a direction near it may differ in rounding);
the nodal pressure transfers 1e-13; the float32 hierarchy's power
omegas 2e-5 relative; the
refinement-1 cycle's FGMRES iterations equal per slab and its error
norms 1e-8 relative.  The refinement-2 cycle of stfem_tpu's
test_feq_pressure_stmg (rates u > 2, p > 1.5) is marked slow."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu import types as jtypes
from stfem_tpu.blocks import BlockSlice as JBlockSlice
from stfem_tpu.drivers import stokes as jstokes
from stfem_tpu.mesh.grid import StructuredMesh as JMesh
from stfem_tpu.ops.spatial import LaplaceMassOperator as JOp
from stfem_tpu.ops.stokes import StokesOperator as JStokes
from stfem_tpu.stmg.gmg import GMGParams as JParams
from stfem_tpu.stmg.gmg import build_stmg_stokes as jbuild
from stfem_tpu.stmg.stokes_level import StokesSpaceTransfer as JSTransfer
from stfem_tpu.stmg.stokes_level import StokesVanka as JVanka
from stfem_tpu.stmg.stokes_level import _assemble_patch_up as jpatch_up
from stfem_tpu.stmg.transfers import SpaceTransfer as JSpaceTransfer
from stfem_tpu.stmg.transfers import h_prolongation_global_1d as jh1d
from stfem_tpu.stmg.transfers import p_prolongation_global_1d as jp1d
from stfem_tpu.system_stokes import StokesSystemMatrix as JSys
from stfem_tpu.time import tables as jtab
from stfem_tpu_torch import types as ttypes
from stfem_tpu_torch.blocks import BlockSlice
from stfem_tpu_torch.drivers import stokes as tstokes
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.functionals import compute_drag_lift
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
from stfem_tpu_torch.ops.stokes import StokesOperator
from stfem_tpu_torch.stmg.gmg import GMGParams, build_stmg_stokes
from stfem_tpu_torch.stmg.smoother import IdentitySmoother
from stfem_tpu_torch.stmg.stokes_level import (StokesSpaceTransfer,
                                               StokesVanka,
                                               _assemble_patch_up)
from stfem_tpu_torch.stmg.transfers import (SpaceTransfer,
                                            h_prolongation_global_1d,
                                            p_prolongation_global_1d)
from stfem_tpu_torch.system_stokes import StokesSystemMatrix

torch.set_num_threads(1)
F64, F32 = torch.float64, torch.float32
ALL_FACES = ((0, 0), (0, 1), (1, 0), (1, 1))
NU, TAU = 0.7, 0.125
NORMS = ("l2_l2_u", "linf_linf_u", "l2_h1_u", "l2_hdiv_u", "l2_l2_p",
         "linf_linf_p", "l2_h1_p")


def _rel_close(t, j, rel):
    t = np.asarray(t.detach() if torch.is_tensor(t) else t, np.float64)
    j = np.asarray(j, np.float64)
    assert t.shape == j.shape, (t.shape, j.shape)
    np.testing.assert_allclose(t, j, rtol=0, atol=rel * np.abs(j).max())


def _meshes(kind):
    """stfem_tpu's and the port's mesh: the unit square at refinement 2 or
    the masked, non-uniform DFG square at refinement 1."""
    if kind == "square":
        return (JMesh([1, 1], [0.0, 0.0], [1.0, 1.0], refinement=2),
                StructuredMesh([1, 1], [0.0, 0.0], [1.0, 1.0], refinement=2))
    return jstokes.dfg_square_mesh(1), tstokes.dfg_square_mesh(1)


def _ops(kind, faces):
    """Both packages' float64 Q2/Q1 operators and velocity masses."""
    jm, tm = _meshes(kind)
    kw = dict(dg_pressure=False, weak_faces=faces)
    js = JStokes(jm, 2, 1, 3, NU, dtype=jnp.float64, **kw)
    ts = StokesOperator(tm, 2, 1, 3, NU, dtype=F64, device="cpu", **kw)
    jM = JOp(jm, 2, 3, 1.0, 0.0, dtype=jnp.float64, mask=js.mask_u_np)
    tM = LaplaceMassOperator(tm, 2, 3, 1.0, 0.0, dtype=F64, device="cpu",
                             mask=ts.mask_u_np)
    return js, ts, jM, tM


CASES = pytest.mark.parametrize("kind,faces", [
    ("square", ()), ("square", ALL_FACES), ("dfg", ())],
    ids=["square", "square-nitsche", "dfg"])


@CASES
def test_feq_operator(kind, faces):
    js, ts, _, _ = _ops(kind, faces)
    assert ts.p_shape == js.p_shape and ts.n_p == js.n_p
    assert ts.n_ploc_cell == js.n_ploc_cell
    np.testing.assert_array_equal(ts.mask_p_np, js.mask_p_np)
    rng = np.random.default_rng(1)
    u = rng.standard_normal((3, 2) + ts.dof_shape_u)
    p = rng.standard_normal((3,) + ts.p_shape)
    for mask_input in (True, False):
        ju, jp = js.apply(jnp.asarray(u), jnp.asarray(p),
                          mask_input=mask_input)
        tu, tp = ts.apply(torch.as_tensor(u), torch.as_tensor(p),
                          mask_input=mask_input)
        _rel_close(tu, ju, 1e-12)
        _rel_close(tp, jp, 1e-12)
    if faces:
        g = lambda x, t: 0.5 + t * x ** 2
        jr = js.nitsche_rhs(g, 0.3)
        tr = ts.nitsche_rhs(g, 0.3)
        for a, b in zip(tr, jr):
            _rel_close(a, b, 1e-12)


@pytest.mark.parametrize("faces", [(), ALL_FACES], ids=["strong", "all"])
def test_feq_skew_pairings(faces):
    """stfem_tpu's test_taylor_hood_pressure and test_feq_nitsche_skew_
    pairing on the port: the u-p and p-u couplings (faces included) are
    skew, (B^T p, u) = -(B u, p)."""
    _, S, _, _ = _ops("square", faces)
    rng = np.random.default_rng(5)
    u = torch.as_tensor(rng.standard_normal((2,) + S.dof_shape_u))
    p = torch.as_tensor(rng.standard_normal(S.p_shape))
    ru_p, _ = S.apply(torch.zeros_like(u), p)
    _, rp_u = S.apply(u, torch.zeros_like(p))
    lhs = float((ru_p * u * S.mask_u).sum())
    rhs = float((rp_u * p * S.mask_p).sum())
    assert abs(lhs + rhs) < 1e-10 * max(abs(lhs), 1.0)


@CASES
def test_feq_element_matrices_and_route(kind, faces):
    js, ts, jM, tM = _ops(kind, faces)
    _, jup, jpu = js.element_matrices()
    _, tup, tpu = ts.element_matrices()
    _rel_close(tup, jup, 1e-12)
    _rel_close(tpu, jpu, 1e-12)
    for j, t in zip(js.face_element_matrices(), ts.face_element_matrices()):
        assert (j[0], j[1]) == (t[0], t[1])
        for a, b in zip(t[2], j[2]):
            _rel_close(a, b, 1e-12)
        _rel_close(t[3], j[3], 1e-12)
        _rel_close(t[4], j[4], 1e-12)
    a, b, _, _ = jtab.get_fe_time_weights(jtypes.TimeStepType.DG, 1, TAU, 2)
    x = np.random.default_rng(2).standard_normal((a.shape[0],
                                                  ts.n_u + ts.n_p))
    ref = JSys(js, jM, a, b).vmult(jnp.asarray(x))
    for route in ("sumfac", "element"):
        got = StokesSystemMatrix(ts, tM, a, b, route=route).vmult(
            torch.as_tensor(x))
        _rel_close(got, ref, 1e-12)


@pytest.mark.parametrize("dim", [2, 3])
def test_feq_patch_up(dim):
    cells = (3, 2, 2)[:dim]
    C, A_u, A_p = int(np.prod(cells)), 3 ** dim, 2 ** dim
    E = np.random.default_rng(dim).standard_normal((C, dim * A_u, A_p))
    _rel_close(_assemble_patch_up(torch.as_tensor(E), cells, dim, 2, 1),
               jpatch_up(jnp.asarray(E), cells, dim, 2, 1), 1e-12)


@pytest.mark.parametrize("kind,faces,ntao", [
    ("square", (), 2), ("square", ALL_FACES, 2), ("dfg", (), 1)],
    ids=["square-2steps", "square-nitsche-2steps", "dfg-1step"])
def test_feq_vanka(kind, faces, ntao):
    """The FE_Q Vanka in float64: the pseudo-inverted patches (per step
    with the step coupling on two steps, dense on one), and its apply."""
    js, ts, jM, tM = _ops(kind, faces)
    A, B = jtab.get_fe_time_weights_sequence(
        jtypes.TimeStepType.DG, TAU, ntao, [], [1],
        weight_fn=jtab.get_fe_time_weights_stokes)[0][:2]
    jv = JVanka(js, jM, A, B, JBlockSlice(ntao, 2, 2), dtype=jnp.float64)
    tv = StokesVanka(ts, tM, A, B, BlockSlice(ntao, 2, 2), dtype=F64)
    assert tv.n_steps == jv.n_steps
    _rel_close(tv.Binv, jv.Binv, 1e-9)
    if jv.Kappa is None:
        assert tv.Kappa is None
    else:
        _rel_close(tv.Kappa, jv.Kappa, 1e-9)
    x = np.random.default_rng(3).standard_normal((2 * ntao,
                                                  ts.n_u + ts.n_p))
    _rel_close(tv.vmult(torch.as_tensor(x)), jv.vmult(jnp.asarray(x)), 1e-9)


@pytest.mark.parametrize("mg", ["h", "p"])
def test_feq_transfers(mg):
    """The flat Stokes transfer with the nodal pressure transfer under the
    pressure masks: h from refinement 1 to 2 at Q2/Q1, p from Q2/Q1 to
    Q3/Q2 at refinement 2 (the DFG square's masks for h)."""
    (jf, tf), (jc, tc) = ((_meshes("square"), _meshes("square")) if mg == "p"
                          else (_meshes("dfg"), (jstokes.dfg_square_mesh(0),
                                                 tstokes.dfg_square_mesh(0))))
    hi, lo = (3, 2) if mg == "p" else (2, 2)
    ops = []
    for jm, tm, k in ((jf, tf, hi), (jc, tc, lo)):
        ops.append((JStokes(jm, k, k - 1, k + 1, NU, dg_pressure=False),
                    StokesOperator(tm, k, k - 1, k + 1, NU, dtype=F64,
                                   device="cpu", dg_pressure=False)))
    (jS_hi, tS_hi), (jS_lo, tS_lo) = ops
    if mg == "h":
        P1 = lambda f, k: [f(jc.cells[d], k) for d in range(2)]
        fu, fp = P1(jh1d, hi), P1(jh1d, hi - 1)
        tu, tp_ = (P1(h_prolongation_global_1d, hi),
                   P1(h_prolongation_global_1d, hi - 1))
    else:
        P1 = lambda f, a, b: [f(jf.cells[d], a, b) for d in range(2)]
        fu, fp = P1(jp1d, lo, hi), P1(jp1d, lo - 1, hi - 1)
        tu, tp_ = (P1(p_prolongation_global_1d, lo, hi),
                   P1(p_prolongation_global_1d, lo - 1, hi - 1))
    jt = JSTransfer(jS_hi, jS_lo, JSpaceTransfer(
        fu, jS_hi.mask_u_np, jS_lo.mask_u_np, jnp.float64), mg, jnp.float64,
        p_transfer=JSpaceTransfer(fp, jS_hi.mask_p_np, jS_lo.mask_p_np,
                                  jnp.float64))
    tt = StokesSpaceTransfer(tS_hi, tS_lo, SpaceTransfer(
        tu, tS_hi.mask_u_np, tS_lo.mask_u_np, F64, "cpu"), mg, F64,
        p_transfer=SpaceTransfer(tp_, tS_hi.mask_p_np, tS_lo.mask_p_np, F64,
                                 "cpu"))
    rng = np.random.default_rng(4)
    xf = rng.standard_normal((3, tS_hi.n_u + tS_hi.n_p))
    xc = rng.standard_normal((3, tS_lo.n_u + tS_lo.n_p))
    _rel_close(tt.restrict(torch.as_tensor(xf)), jt.restrict(jnp.asarray(xf)),
               1e-13)
    _rel_close(tt.prolongate(torch.as_tensor(xc)),
               jt.prolongate(jnp.asarray(xc)), 1e-13)


def _relaxation_levels(jg, tg):
    return [(l, jl, tl) for l, (jl, tl) in enumerate(zip(jg.levels,
                                                         tg.levels))
            if not isinstance(tl.smoother, IdentitySmoother)]


@pytest.fixture(scope="module")
def hierarchies():
    """Both packages' FE_Q hierarchies (stfem_tpu's test_feq_pressure_stmg
    keys) at refinement 2, Nitsche faces on every wall, 2 steps a slab."""
    jm, tm = _meshes("square")
    kw = dict(viscosity=NU, fe_degree_min=1, space_time_level_first=False,
              dg_pressure=False, weak_faces=ALL_FACES)
    jg = jbuild(jm, 1, jtypes.TimeStepType.DG, 2, TAU,
                params=JParams(smoothing_range=5.0), **kw)
    tg = build_stmg_stokes(tm, 1, ttypes.TimeStepType.DG, 2, TAU,
                           params=GMGParams(smoothing_range=5.0),
                           device="cpu", **kw)
    return jg, tg


def test_feq_hierarchy(hierarchies):
    """The ladder, the masked-pressure coarse nullspace and the power
    omegas of every smoothed level.  (The float32 pseudo-inverted patches
    themselves are not compared: directions near pinv's cut-off differ
    between two float32 SVDs; the float64 Vanka test and the cycle's
    iterations hold them.)"""
    jg, tg = hierarchies
    assert [t.name for t in tg.mg_type_level] == \
        [t.name for t in jg.mg_type_level]
    _rel_close(tg.coarse_null, jg.coarse_null, 1e-7)
    for l, jl, tl in _relaxation_levels(jg, tg):
        np.testing.assert_allclose(float(tl.smoother.omega),
                                   float(jl.smoother.omega), rtol=2e-5)


def _factories():
    """stfem_tpu's test_feq_pressure_stmg factory, in both packages."""
    def j(ctx):
        return jbuild(ctx["mesh"], ctx["fe_degree"], ctx["type_"],
                      ctx["n_timesteps_at_once"], ctx["time_step"],
                      viscosity=ctx["viscosity"],
                      params=JParams(smoothing_range=5.0), fe_degree_min=1,
                      space_time_level_first=False,
                      dg_pressure=ctx["dg_pressure"],
                      weak_faces=ctx["weak_faces"])

    def t(ctx):
        return build_stmg_stokes(
            ctx["mesh"], ctx["fe_degree"], ctx["type_"],
            ctx["n_timesteps_at_once"], ctx["time_step"],
            viscosity=ctx["viscosity"], params=GMGParams(smoothing_range=5.0),
            fe_degree_min=1, space_time_level_first=False,
            dg_pressure=ctx["dg_pressure"], weak_faces=ctx["weak_faces"],
            device=ctx["device"])

    return j, t


def _cycles(ref):
    j, t = _factories()
    kw = dict(refinement=ref, fe_degree=1, gmres_maxiter=100,
              dg_pressure=False, nitsche_boundary=True)
    return (jstokes.run_stokes_cycle(type_=jtypes.TimeStepType.DG,
                                     preconditioner_factory=j, **kw),
            tstokes.run_stokes_cycle(type_=ttypes.TimeStepType.DG,
                                     preconditioner_factory=t, device="cpu",
                                     **kw))


def test_feq_cycle_refinement1():
    jr, tr = _cycles(1)
    assert tr.n_dofs_p == jr.n_dofs_p and tr.n_dofs_u == jr.n_dofs_u
    assert tr.total_iterations == jr.total_iterations
    for n in NORMS:
        np.testing.assert_allclose(getattr(tr, n), getattr(jr, n), rtol=1e-8)


@pytest.mark.slow
def test_feq_cycle_refinement2_rates():
    """stfem_tpu's test_feq_pressure_stmg on the port: refinement 2 against
    stfem_tpu, then the rates between refinements 1 and 2."""
    jr, tr = _cycles(2)
    assert tr.total_iterations == jr.total_iterations
    for n in NORMS:
        np.testing.assert_allclose(getattr(tr, n), getattr(jr, n), rtol=1e-8)
    r1 = _cycles(1)[1]
    assert np.log2(r1.l2_l2_u / tr.l2_l2_u) > 2.0
    assert np.log2(r1.l2_l2_p / tr.l2_l2_p) > 1.5
    assert r1.avg_iterations <= 25 and tr.avg_iterations <= 35


def test_feq_unsupported():
    """As in stfem_tpu: the weak obstacle takes the DGP pair only, and the
    traction functionals read the modal pressure."""
    with pytest.raises(ValueError):
        StokesOperator(tstokes.dfg_square_mesh(1), 2, 1, 3, NU, device="cpu",
                       dg_pressure=False, weak_obstacle=True)
    with pytest.raises(AssertionError):
        JStokes(jstokes.dfg_square_mesh(1), 2, 1, 3, NU, dg_pressure=False,
                weak_obstacle=True)
    S = StokesOperator(tstokes.dfg_square_mesh(1), 2, 1, 3, NU, device="cpu",
                       dg_pressure=False)
    u = torch.zeros((2,) + S.dof_shape_u, dtype=F64)
    with pytest.raises(NotImplementedError):
        compute_drag_lift(S, u, torch.zeros(S.p_shape, dtype=F64), 1.0)
