"""The GMGParams fields that bench.py's switches set, stfem_tpu_torch
against stfem_tpu on the CPU: variable_steps_cap,
post_smoother_inner_iterations, no_post_smooth, no_post_smooth_finest,
smooth_all_levels, vanka_bf16, eig_exact_max_n and coarse_direct_pinv,
one case each.

The heat cases use a hierarchy like test_torch_gmg_options.py's
(stfem_tpu's test_direct_coarse_solver setup at refinement 1: 4 x 4
cells, Q2, dG(1), 4 steps at once, tau 1/16, fe_degree_min 1, float32
levels, 2 smoothing steps) with a fixed omega (relaxation 0.6), each
package building its own; the eig_exact_max_n case estimates, and
carries stfem_tpu's omegas over after comparing them.  Per case: the
precondition sequence equal, one V-cycle on a seeded vector within 1e-5
relative (2e-2 with the bf16 Vanka matrices), the FGMRES iterations
(the FP64 operator, rel 1e-8) with either package's V-cycle equal, and
the option changes the port's V-cycle.  The FGMRES is the port's in
both runs, stfem_tpu's V-cycle running eagerly inside it: stfem_tpu's
own FGMRES compiles the whole solve anew for every case, while the
eager operations' compiles carry over between the cases (the Stokes
V-cycle, one a case, is jitted).
smooth_all_levels and coarse_direct_pinv run on the Stokes ladder too
(2D, 1 x 1 cells at refinement 2, Q2 x DGP1, dG(1), 2 steps at once:
levels h, tau, h with one Identity level; relaxation 0.6), with
stfem_tpu's Vanka
factors, coarse inverse and nullspace carried over: the sequence and the
coarse solve equal, one V-cycle within 1e-5 of the largest entry."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu.mesh.grid import StructuredMesh as JMesh
from stfem_tpu.ops.spatial import LaplaceMassOperator as JOp
from stfem_tpu.stmg.gmg import GMGParams as JParams
from stfem_tpu.stmg.gmg import build_stmg as jbuild
from stfem_tpu.stmg.gmg import build_stmg_stokes as jbuild_stokes
from stfem_tpu.system import SystemMatrix as JSys
from stfem_tpu.time.tables import get_fe_time_weights
from stfem_tpu.types import TimeStepType as JT
from stfem_tpu_torch.krylov import fgmres
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
from stfem_tpu_torch.stmg.gmg import (GMGParams, build_stmg,
                                      build_stmg_stokes)
from stfem_tpu_torch.stmg.smoother import RelaxationSmoother
from stfem_tpu_torch.system import SystemMatrix
from stfem_tpu_torch.types import TimeStepType
from stfem_tpu_torch.utils.carry import load_gmg, load_stokes_vanka

torch.set_num_threads(1)

TAU = 1 / 16
BASE = dict(smoothing_steps=2, relaxation=0.6)
CASES = {  # the field's case, and the relative V-cycle tolerance
    "variable_steps_cap": (dict(variable_steps_cap=2), 1e-5),
    "post_smoother_inner_iterations": (dict(
        smoother_inner_iterations=2, post_smoother_inner_iterations=1),
        1e-5),
    "no_post_smooth": (dict(no_post_smooth=True), 1e-5),
    "no_post_smooth_finest": (dict(no_post_smooth_finest=True), 1e-5),
    "smooth_all_levels": (dict(smooth_all_levels=True), 1e-5),
    "vanka_bf16": (dict(vanka_bf16=True), 2e-2),
    "eig_exact_max_n": (dict(relaxation=0.0, eig_exact_max_n=0), 1e-5),
    "coarse_direct_pinv": (dict(coarse_grid_smoother_type="Direct",
                                coarse_direct_pinv=True), 1e-5)}


@pytest.fixture(autouse=True, scope="module")
def _no_estimate_cache():
    """Both packages estimate afresh: no estimate disk cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STFEM_EIG_CACHE", "0")
        yield


def _build(**kw):
    jm = JMesh([2, 2], [0, 0], [1, 1], refinement=1)
    tm = StructuredMesh([2, 2], [0, 0], [1, 1], refinement=1)
    jg = jbuild(jm, 1, 2, JT.DG, 4, TAU, dtype=jnp.float32, fe_degree_min=1,
                params=JParams(**kw))
    tg = build_stmg(tm, 1, 2, TimeStepType.DG, 4, TAU, GMGParams(**kw),
                    dtype=torch.float32, device="cpu", fe_degree_min=1)
    return jg, tg


@pytest.fixture(scope="module")
def system():
    """The FP64 slab operators of both packages, a seeded rhs and the
    port's V-cycle without an option."""
    jm = JMesh([2, 2], [0, 0], [1, 1], refinement=1)
    tm = StructuredMesh([2, 2], [0, 0], [1, 1], refinement=1)
    a, b, _, _ = get_fe_time_weights(JT.DG, 1, TAU, 4)
    jK, jM = (JOp(jm, 2, 3, m, l, dtype=jnp.float64)
              for m, l in ((0.0, 1.0), (1.0, 0.0)))
    tK, tM = (LaplaceMassOperator(tm, 2, 3, m, l, dtype=torch.float64,
                                  device="cpu")
              for m, l in ((0.0, 1.0), (1.0, 0.0)))
    jmat, tmat = JSys(jK, jM, a, b), SystemMatrix(tK, tM, a, b)
    x = np.random.default_rng(0).standard_normal((8,) + jK.dof_shape)
    rhs = np.array(jmat.vmult(jnp.asarray(x * jK.mask_np)))
    base = _build(**BASE)[1].vmult(torch.as_tensor(rhs, dtype=torch.float32))
    return tmat, rhs, base


def _omegas(gmg):
    return [getattr(lvl.smoother, "omega", None) for lvl in gmg.levels]


@pytest.mark.parametrize("field", sorted(CASES))
def test_heat_field(system, field):
    tmat, rhs, base = system
    kw, tol = CASES[field]
    jg, tg = _build(**dict(BASE, **kw))
    assert getattr(GMGParams(**dict(BASE, **kw)), field) == kw[field]
    assert [s.name for s in tg.precondition_sequence] == \
        [s.name for s in jg.precondition_sequence]
    for jl, tl in zip(jg.levels, tg.levels):
        if isinstance(tl.smoother, RelaxationSmoother):
            # the estimated omegas agree; stfem_tpu's are carried over
            assert tl.smoother.omega == pytest.approx(
                float(jl.smoother.omega), rel=1e-5)
    load_gmg(tg, [float(o) if o is not None and
                  isinstance(tl.smoother, RelaxationSmoother) else None
                  for o, tl in zip(_omegas(jg), tg.levels)])
    if field == "coarse_direct_pinv":
        np.testing.assert_allclose(tg.coarse_Ainv.numpy(),
                                   np.asarray(jg.coarse_Ainv), rtol=0,
                                   atol=1e-5 * np.abs(jg.coarse_Ainv).max())
    ref = np.asarray(jg.vmult(jnp.asarray(rhs, jnp.float32)), np.float64)
    got = tg.vmult(torch.as_tensor(rhs, dtype=torch.float32))
    rel = np.linalg.norm(got.double().numpy() - ref) / np.linalg.norm(ref)
    assert rel <= tol, rel
    if field != "coarse_direct_pinv":   # the pinv of a regular A is A^-1
        assert float((got - base).norm() / base.norm()) > 1e-6
    b = torch.as_tensor(rhs)
    jres, tres = (fgmres(tmat.vmult, b, torch.zeros_like(b), vcycle,
                         maxiter=40, reltol=1e-8, abstol=1e-30)
                  for vcycle in (lambda v: torch.as_tensor(np.array(
                      jg.vmult(jnp.asarray(v.numpy())))), tg.vmult))
    assert jres.converged and tres.converged
    assert tres.iterations == jres.iterations


def _stokes(**kw):
    """Both packages' Stokes hierarchies with relaxation 0.6."""
    kw = dict(relaxation=0.6, **kw)
    jm = JMesh([1, 1], [0.0] * 2, [1.0] * 2, refinement=2)
    tm = StructuredMesh([1, 1], [0.0] * 2, [1.0] * 2, refinement=2)
    jg = jbuild_stokes(jm, 1, JT.DG, 2, TAU, dtype=jnp.float32,
                       params=JParams(**kw), fe_degree_min=1)
    tg = build_stmg_stokes(tm, 1, TimeStepType.DG, 2, TAU,
                           params=GMGParams(**kw), dtype=torch.float32,
                           device="cpu")
    assert [s.name for s in tg.precondition_sequence] == \
        [s.name for s in jg.precondition_sequence]
    assert tg.coarse == jg.params.coarse_grid_smoother_type
    return jg, tg


@pytest.mark.parametrize("field", ["smooth_all_levels",
                                   "coarse_direct_pinv"])
def test_stokes_field(field):
    """smooth_all_levels takes the Identity level away; coarse_direct_pinv
    keeps params' coarse solve: a small Direct coarse level stays the
    pseudo-inverse, and a Smoother one stays the smoother, which the
    routing would otherwise replace (the Smoother and GMRES coarse solves
    amplify the singular coarse system's near-null directions in both
    packages, so that V-cycle is compared by its wiring alone)."""
    if field == "smooth_all_levels":
        jg, tg = _stokes(smooth_all_levels=True)
        assert {s.name for s in tg.precondition_sequence} == {"Relaxation"}
    else:
        jg, tg = _stokes(coarse_direct_pinv=True,
                         coarse_grid_smoother_type="Smoother")
        assert tg.coarse == "Smoother"
        assert isinstance(tg.levels[0].smoother, RelaxationSmoother)
        assert isinstance(jg.levels[0].smoother, type(jg.levels[1].smoother))
        jg, tg = _stokes(coarse_direct_pinv=True,
                         coarse_grid_smoother_type="Direct")
        assert tg.coarse == "Direct"
        assert "Identity" in {s.name for s in tg.precondition_sequence}
    for jl, tl in zip(jg.levels, tg.levels):
        if isinstance(tl.smoother, RelaxationSmoother):
            jv = jl.smoother.precond
            load_stokes_vanka(tl.smoother.precond, np.asarray(jv.Binv),
                              None if jv.Kappa is None
                              else np.asarray(jv.Kappa))
    load_gmg(tg, coarse_Ainv=np.asarray(jg.coarse_Ainv),
             coarse_null=np.asarray(jg.coarse_null))
    top = tg.levels[-1]
    x = np.random.default_rng(9).standard_normal((top.n_blocks,)
                                                 + top.dof_shape)
    ref = np.asarray(jax.jit(lambda v: jg.vmult(v))(
        jnp.asarray(x, jnp.float32)), np.float64)
    got = tg.vmult(torch.as_tensor(x, dtype=torch.float32)).double().numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
