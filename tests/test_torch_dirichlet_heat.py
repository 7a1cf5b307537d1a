"""Strong inhomogeneous Dirichlet heat in stfem_tpu_torch against
stfem_tpu (CPU, x64): SlabBoundaryValues, SystemMatrix.vmult with
mask_input=False on every route, and run_heat_cycle(dirichlet_g=...)
with heat "solution 2" (problems/manufactured.py) on [0.25, 1.25]^dim,
where its sin(2 pi x) factors are nonzero on the boundary.

Tolerances: the block times bitwise, the boundary block values 1e-15 of
the largest (torch's and XLA's sin differ in the last bit), set_zero
and paste bitwise; the slab operator and the rhs coupling
reading the constrained dofs, in float64, 1e-12 of the largest entry on
the routes "kron" (K2/K3's plain versions), "quad" (K5's), "grid" and
"cell" (a distorted mesh); the cycles' FGMRES iterations equal per slab,
every slab's solution within 1e-10 of the largest entry of stfem_tpu's
(the constrained dofs are pasted g, bitwise alike) and the error norms
1e-10 relative, with and without the lift."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu import integrators as jintegrators
from stfem_tpu.drivers.heat import run_heat_cycle as jrun
from stfem_tpu.drivers.heat import stmg_preconditioner_factory as jfactory
from stfem_tpu.mesh.grid import StructuredMesh as JMesh
from stfem_tpu.ops.boundary import SlabBoundaryValues as JBoundary
from stfem_tpu.ops.spatial import LaplaceMassOperator as JOp
from stfem_tpu.problems.manufactured import heat2 as jheat2
from stfem_tpu.system import SystemMatrix as JSystem
from stfem_tpu.time.tables import get_fe_time_weights as jweights
from stfem_tpu.types import ProblemType as JProblem
from stfem_tpu.types import TimeStepType as JTimeStepType
from stfem_tpu_torch.drivers.heat import (run_heat_cycle,
                                          stmg_preconditioner_factory)
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.boundary import SlabBoundaryValues
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
from stfem_tpu_torch.problems.manufactured import heat2
from stfem_tpu_torch.system import SystemMatrix
from stfem_tpu_torch.types import ProblemType, TimeStepType

torch.set_num_threads(1)
F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _no_estimate_cache():
    """The port's hierarchies estimate afresh: no estimate disk cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STFEM_EIG_CACHE", "0")
        yield


def _close(got, ref, rel):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("kind", ["DG", "CGP"])
def test_slab_boundary_values(kind):
    args = (JTimeStepType[kind], 2, 0.125, 3)
    jm = JMesh([1, 1], [0.25, 0.25], [1.25, 1.25], refinement=2)
    tm = StructuredMesh([1, 1], [0.25, 0.25], [1.25, 1.25], refinement=2)
    jb = JBoundary(jm, 2, jheat2(2)[0], *args)
    tb = SlabBoundaryValues(tm, 2, heat2(2)[0], TimeStepType[kind], *args[1:],
                            device="cpu")
    jblocks, tblocks = jb.blocks(0.375), tb.blocks(0.375)
    np.testing.assert_array_equal(tb.offsets, np.asarray(jb.offsets))
    _close(tblocks, jblocks, 1e-15)
    assert np.all(tblocks.numpy()[:, 1:-1, 1:-1] == 0.0)
    x = np.random.default_rng(0).standard_normal(tblocks.shape)
    np.testing.assert_array_equal(tb.set_zero(torch.as_tensor(x)).numpy(),
                                  np.asarray(jb.set_zero(jnp.asarray(x))))
    np.testing.assert_array_equal(
        tb.paste(torch.as_tensor(x), torch.as_tensor(np.asarray(jblocks)))
        .numpy(), np.asarray(jb.paste(jnp.asarray(x), jblocks)))


def _system_pair(route, dim, tables):
    """stfem_tpu's and the port's FP64 SystemMatrix on [0.25, 1.25]^dim,
    Q2, refinement 2 (distorted by 0.15 for the "cell" route)."""
    distort = 0.15 if route == "cell" else 0.0
    kw = dict(refinement=2, distort=distort)
    lo, hi = [0.25] * dim, [1.25] * dim
    jm, tm = JMesh([1] * dim, lo, hi, **kw), StructuredMesh([1] * dim, lo,
                                                            hi, **kw)
    jK, jM = JOp(jm, 2, 3, 0.0, 1.0), JOp(jm, 2, 3, 1.0, 0.0)
    tK = LaplaceMassOperator(tm, 2, 3, 0.0, 1.0, dtype=F64, device="cpu")
    tM = LaplaceMassOperator(tm, 2, 3, 1.0, 0.0, dtype=F64, device="cpu")
    A, B = tables
    return (JSystem(jK, jM, A, B),
            SystemMatrix(tK, tM, A, B, route=route), tK.dof_shape)


@pytest.mark.parametrize("route,dim", [("kron", 3), ("kron", 2),
                                       ("quad", 3), ("grid", 3),
                                       ("cell", 2)])
def test_vmult_unmasked_input(route, dim):
    """The slab operator and the rhs coupling read the constrained dofs
    (the lift's A x_g and the unmasked previous value); the output stays
    masked, as stfem_tpu's."""
    A, B, G, _ = jweights(JTimeStepType.DG, 1, 0.125, 2)
    rng = np.random.default_rng(1)
    for tables, n_src in (((A, B), A.shape[0]),
                          ((np.zeros_like(G), G), 1)):
        jsys, tsys, shape = _system_pair(route, dim, tables)
        x = rng.standard_normal((n_src,) + tuple(shape))
        refs = [np.asarray(jsys.vmult(jnp.asarray(x), mask_input=m))
                for m in (False, True)]
        for mask_input, ref in zip((False, True), refs):
            _close(tsys.vmult(torch.as_tensor(x), mask_input=mask_input),
                   ref, 1e-12)
        # reading the constrained dofs changes the result
        assert not np.allclose(refs[0], refs[1])


def _both_cycles(dim, refinement, lift):
    """(stfem_tpu's per-slab iterations and solutions, its result, the
    port's per-slab solutions, its result) of the DG(1) heat cycle with
    heat2's data and dirichlet_g on [0.25, 1.25]^dim, each package's
    STMG factory (fe_degree_min 1)."""
    jslabs, jxs, txs = [], [], []
    orig = jintegrators.TimeIntegratorFO.solve

    def solve(self, *args):
        x, stats = orig(self, *args)
        jslabs.append(stats.iterations)
        jxs.append(np.asarray(x))
        return x, stats

    common = dict(refinement=refinement, fe_degree=1, n_timesteps_at_once=2,
                  subdivisions=(1,) * dim, lower=(0.25,) * dim,
                  upper=(1.25,) * dim, gmres_maxiter=60, boundary_lift=lift)
    je, jg, jf = jheat2(dim)
    te, tg, tf = heat2(dim)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STFEM_EIG_CACHE", "0")
        mp.setattr(jintegrators.TimeIntegratorFO, "solve", solve)
        jres = jrun(type_=JTimeStepType.DG, exact_override=(je, jg),
                    rhs_fn_override=jf, dirichlet_g=je,
                    preconditioner_factory=jfactory(fe_degree_min=1),
                    **common)
    tres = run_heat_cycle(
        type_=TimeStepType.DG, exact_override=(te, tg), rhs_fn_override=tf,
        dirichlet_g=te, preconditioner_factory=stmg_preconditioner_factory(
            fe_degree_min=1), device="cpu",
        on_slab=lambda step, t, dt, prev, x, stats: txs.append(x.numpy()),
        **common)
    return (jslabs, jxs, jres), (txs, tres)


@pytest.mark.parametrize("dim,refinement,lift", [
    (2, 2, True), (2, 2, False), (3, 1, True), (3, 1, False)],
    ids=["2d-lift", "2d-nolift", "3d-lift", "3d-nolift"])
def test_dirichlet_heat_cycle(dim, refinement, lift):
    (jslabs, jxs, jres), (txs, tres) = _both_cycles(dim, refinement, lift)
    assert tres.slab_iterations == jslabs and len(jslabs) >= 2
    for xj, xt in zip(jxs, txs):
        _close(xt, xj, 1e-10)
    for name in ("linf_linf", "l2_l2", "l2_h1"):
        a, b = getattr(tres, name), getattr(jres, name)
        assert abs(a / b - 1.0) <= 1e-10, (name, a, b)
    # the last block holds g at the end time on the constrained dofs
    mesh = StructuredMesh([1] * dim, [0.25] * dim, [1.25] * dim,
                          refinement=refinement)
    g = heat2(dim)[0](torch.as_tensor(mesh.dof_coordinates(2)), 1.0)
    bnd = 1.0 - mesh.boundary_dof_mask(2)
    assert np.abs((tres.solution - g).numpy() * bnd).max() <= 1e-12


def test_wave_dirichlet_raises():
    """The strong Dirichlet scheme is wired for first-order problems, as
    stfem_tpu asserts."""
    g = heat2(2)[0]
    with pytest.raises(ValueError):
        run_heat_cycle(refinement=1, fe_degree=1, problem=ProblemType.wave,
                       dirichlet_g=g, device="cpu")
    with pytest.raises(AssertionError):
        jrun(refinement=1, fe_degree=1, problem=JProblem.wave,
             dirichlet_g=jheat2(2)[0])
