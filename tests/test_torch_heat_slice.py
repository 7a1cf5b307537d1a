"""The whole heat slice of stfem_tpu_torch vs stfem_tpu at 4^3 cells, Q4 x
dG(2), 4 steps per slab, with bench.py's V-cycle parameters (Relaxation,
inner=2, one smoothing step, Identity levels skipped, Direct coarse,
level_bf16/vanka_bf16 or float32 levels).

The eigenvalue proxy is cut from bench.py's 4 cells (a quarter of its 16^3
mesh) to 2 cells here, so that the 4^3 fine levels are proxied like the
bench's and the ARPACK estimates stay small.

Tolerances: the ladder and the Richardson counts with float32 levels are
exact; omega from one estimator input agrees exactly (the same ARPACK run),
omega from each package's own build agrees to ARPACK's resolution of the
non-normal P A spectrum (1e-4 relative for float32 levels, 5e-3 for bf16
levels, whose matvecs differ by bf16 roundings); one V-cycle on a fixed
vector with the JAX factors carried across agrees to 1e-5 relative.

The bf16-level cases and bench_heat's route are in
test_torch_heat_slice_bf16.py, which builds its own hierarchy, so that the
two files run on separate workers."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu.krylov import estimate_error_propagator_radius as jradius
from stfem_tpu.krylov import fgmres as jfgmres
from stfem_tpu.krylov import richardson_solve as jrichardson
from stfem_tpu.mesh.grid import StructuredMesh as JMesh
from stfem_tpu.ops.spatial import LaplaceMassOperator as JOp
from stfem_tpu.stmg import smoother as jsm
from stfem_tpu.stmg.gmg import GMGParams as JParams, build_stmg as jbuild
from stfem_tpu.stmg.vanka import PreconditionVanka as JVanka
from stfem_tpu.system import SystemMatrix as JSys
from stfem_tpu.time.tables import get_fe_time_weights
from stfem_tpu.types import SupportedSmoothers as JSmooth
from stfem_tpu.types import TimeStepType as JT
from stfem_tpu_torch.krylov import (estimate_error_propagator_radius,
                                    fgmres, richardson_solve)
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
from stfem_tpu_torch.stmg import smoother as tsm
from stfem_tpu_torch.stmg.gmg import bench_params, build_stmg
from stfem_tpu_torch.system import SystemMatrix
from stfem_tpu_torch.types import TimeStepType as TT
from stfem_tpu_torch.utils.carry import load_gmg, load_vanka

torch.set_num_threads(1)

CELLS, NTAO, TAU, PROXY = 4, 4, 1.0 / 16.0, 2


@pytest.fixture(autouse=True, scope="module")
def _no_estimate_cache():
    """The port's hierarchies estimate afresh: no estimate disk cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STFEM_EIG_CACHE", "0")
        yield


def _jax_params(bf16):
    return JParams(smoothing_steps=1, variable=False,
                   smoother=JSmooth.Relaxation, smoothing_range=1.0,
                   coarse_grid_smoother_type="Direct", vanka_bf16=bf16,
                   smoother_inner_iterations=2, skip_identity_levels=True,
                   level_bf16=bf16, eig_proxy_cells=PROXY)


def _torch_params(bf16):
    return bench_params(level_bf16=bf16, vanka_bf16=bf16,
                        eig_proxy_cells=PROXY)


def build_slice(bf16):
    """(jax gmg, torch gmg, jax f32 outer operator, torch f32 outer
    operator, a fixed masked rhs), each package building its own
    hierarchy with bf16 or float32 levels."""
    saved = os.environ.get("STFEM_EIG_CACHE")
    os.environ["STFEM_EIG_CACHE"] = "0"     # no repo-local estimate memo
    try:
        jm = JMesh([2, 2, 2], [0.0] * 3, [1.0] * 3, refinement=1)
        tm = StructuredMesh([2, 2, 2], [0.0] * 3, [1.0] * 3, refinement=1)
        jg = jbuild(jm, 2, 4, JT.DG, NTAO, TAU, dtype=jnp.float32,
                    fe_degree_min=1, params=_jax_params(bf16))
        tg = build_stmg(tm, 2, 4, TT.DG, NTAO, TAU, _torch_params(bf16),
                        device="cpu")
    finally:
        if saved is None:
            os.environ.pop("STFEM_EIG_CACHE")
        else:
            os.environ["STFEM_EIG_CACHE"] = saved
    A, B, _, _ = get_fe_time_weights(JT.DG, 2, TAU, NTAO)
    jK = JOp(jm, 4, 5, 0.0, 1.0, dtype=jnp.float32)
    jM = JOp(jm, 4, 5, 1.0, 0.0, dtype=jnp.float32)
    tK = LaplaceMassOperator(tm, 4, 5, 0.0, 1.0, dtype=torch.float32,
                             device="cpu")
    tM = LaplaceMassOperator(tm, 4, 5, 1.0, 0.0, dtype=torch.float32,
                             device="cpu")
    b = np.random.default_rng(0).standard_normal(
        (A.shape[0],) + jK.dof_shape).astype(np.float32) * jK.mask_np
    return jg, tg, JSys(jK, jM, A, B), SystemMatrix(tK, tM, A, B), b


@pytest.fixture(scope="module")
def slice_setup():
    """The float32-level slice (the bf16 one is built in
    test_torch_heat_slice_bf16.py, so the two run in parallel)."""
    return build_slice(False)


def _omegas(gmg):
    """Relaxation omegas above the (directly solved) coarsest level."""
    return [None] + [getattr(lvl.smoother, "omega", None)
                     for lvl in gmg.levels[1:]]


def check_ladder(jg, tg, bf16):
    assert [m.name for m in jg.mg_type_level] == \
        [m.name for m in tg.mg_type_level]
    assert [s.name for s in jg.precondition_sequence] == \
        [s.name for s in tg.precondition_sequence]
    assert len(jg.levels) == len(tg.levels)
    for level, (jl, tl) in enumerate(zip(jg.levels, tg.levels)):
        assert (jl.n_blocks, tuple(jl.dof_shape)) == \
            (tl.n_blocks, tuple(tl.dof_shape))
        # the coarsest level is solved directly: stfem_tpu builds a smoother
        # there that never runs, the port does not
        if level > 0:
            assert type(jl.smoother).__name__ == type(tl.smoother).__name__
    for jt, tt in zip(jg.transfers, tg.transfers):
        assert type(jt).__name__ == type(tt).__name__
    assert tg.dtype == (torch.bfloat16 if bf16 else torch.float32)


def check_omega_own_build(jg, tg, tol):
    for jo, to in zip(_omegas(jg), _omegas(tg)):
        assert (jo is None) == (to is None)
        if jo is not None:
            assert abs(to / jo - 1.0) <= tol, (jo, to)


def check_richardson_iterations(jg, tg, jmat, tmat, b, slack):
    jres = jax.jit(lambda v: jrichardson(
        jmat.vmult, v, jnp.zeros_like(v), jg.vmult, maxiter=40,
        reltol=1e-6))(jnp.asarray(b))
    bt = torch.as_tensor(b)
    tres = richardson_solve(tmat.vmult, bt, torch.zeros_like(bt), tg.vmult,
                            maxiter=40, reltol=1e-6)
    assert bool(jres.converged) and tres.converged
    assert abs(int(jres.iterations) - tres.iterations) <= slack, \
        (int(jres.iterations), tres.iterations)


def test_level_ladder(slice_setup):
    check_ladder(*slice_setup[:2], bf16=False)


def test_relaxation_omega_own_build(slice_setup):
    check_omega_own_build(*slice_setup[:2], tol=1e-4)


class _JaxApply:
    """A stfem_tpu operator composite seen through torch tensors."""

    def __init__(self, fn):
        self.fn = jax.jit(fn)

    def vmult(self, x):
        return torch.as_tensor(np.array(self.fn(jnp.asarray(x.numpy()))))


class _Identity:
    def vmult(self, x):
        return x


def _check_estimator_on_jax_proxy(cells, h):
    """The port's estimator (start vector, ARPACK call, omega formula) on
    the very apply stfem_tpu's estimator sees -- a bench proxy level of
    `cells` cells of width h (Q4, 2-step dG(2) tables) -- gives
    stfem_tpu's omega to 1e-6."""
    jm = JMesh([cells] * 3, [0.0] * 3, [cells * h] * 3)
    A, B, _, _ = get_fe_time_weights(JT.DG, 2, TAU, 2)
    jK = JOp(jm, 4, 5, 0.0, 1.0, dtype=jnp.float32)
    jM = JOp(jm, 4, 5, 1.0, 0.0, dtype=jnp.float32)
    mat = JSys(jK, jM, A, B, precision=None)
    van = JVanka(jK, jM, A, B, dtype=jnp.float32, n_steps=2)
    shape = (A.shape[0],) + jK.dof_shape
    jinfo = jsm.estimate_eigenvalues(mat, van, shape, jK.mask_np,
                                     jnp.float32, method="arnoldi")
    composite = _JaxApply(lambda v: van.vmult(mat.vmult(v)))
    tinfo = tsm.estimate_eigenvalues(_Identity(), composite, shape,
                                     jK.mask_np, device="cpu",
                                     method="arnoldi")
    jo = jsm.relaxation_parameters(jinfo, 1.0)
    to = tsm.relaxation_parameters(tinfo, 1.0)
    assert abs(to / jo - 1.0) <= 1e-6, (jo, to)
    np.testing.assert_array_equal(
        tsm.initial_guess(shape, jK.mask_np, device="cpu").numpy(),
        np.asarray(jsm.initial_guess(shape, jK.mask_np, jnp.float32)))
    return int(np.prod(shape))


def test_relaxation_omega_estimator_exact():
    """The estimator on the proxy of this file's 4^3 hierarchy (2 cells)."""
    _check_estimator_on_jax_proxy(PROXY, 1.0 / CELLS)


def test_relaxation_omega_estimator_bench_proxy():
    """The estimator on bench_heat's own proxy (4 cells of its 16^3 fine
    level): the largest estimate of the bench, which must stay on ARPACK,
    stfem_tpu's engine (the device Krylov-Schur lands ~2e-4 away)."""
    n = _check_estimator_on_jax_proxy(4, 1.0 / 16.0)
    assert n == 29_478 and n <= tsm.ARPACK_HOST_MAX_N


def test_vcycle_f32_carried(slice_setup):
    """One f32 V-cycle with the JAX level factors, omegas and coarse
    inverse carried across: within 1e-5 relative of stfem_tpu's."""
    jg, b = slice_setup[0], slice_setup[4]
    tm = StructuredMesh([2, 2, 2], [0.0] * 3, [1.0] * 3, refinement=1)
    tg = build_stmg(tm, 2, 4, TT.DG, NTAO, TAU, _torch_params(False),
                    device="cpu")
    f32 = lambda a: None if a is None else np.asarray(a, np.float32)
    for jl, tl in zip(jg.levels[1:], tg.levels[1:]):
        jv = getattr(jl.smoother, "precond", None)
        if jv is not None:
            load_vanka(tl.smoother.precond, [f32(w) for w in jv.Wdn],
                       [f32(w) for w in jv.Wup], f32(jv.GinvT),
                       f32(jv.cvecT), f32(jv.TTg))
    load_gmg(tg, _omegas(jg), np.asarray(jg.coarse_Ainv))
    ref = np.asarray(jax.jit(jg.vmult)(jnp.asarray(b)), np.float64)
    got = tg.vmult(torch.as_tensor(b)).double().numpy()
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= 1e-5


def test_richardson_iterations(slice_setup):
    """Each package's own build, float32 levels: equal preconditioned-
    Richardson counts."""
    check_richardson_iterations(*slice_setup, slack=0)


def test_fgmres_fallback_and_radius(slice_setup):
    """The FGMRES fallback outer (one Gram-Schmidt pass, as bench.py's IR
    mode runs it) and the error-propagator radius, float32 levels, each
    package's own build: equal iteration counts, radius within 1e-3."""
    jg, tg, jmat, tmat, b = slice_setup
    jres = jax.jit(lambda v: jfgmres(
        jmat.vmult, v, jnp.zeros_like(v), precondition=jg.vmult, maxiter=24,
        abstol=1e-30, reltol=1e-6, reorthogonalize=False))(jnp.asarray(b))
    bt = torch.as_tensor(b)
    tres = fgmres(tmat.vmult, bt, torch.zeros_like(bt), tg.vmult,
                  maxiter=24, reltol=1e-6, abstol=1e-30,
                  reorthogonalize=False)
    assert bool(jres.converged) and tres.converged
    assert int(jres.iterations) == tres.iterations
    x = tres.x.double().numpy()
    xj = np.asarray(jres.x, np.float64)
    assert np.linalg.norm(x - xj) / np.linalg.norm(xj) <= 1e-4
    jr = float(jax.jit(lambda v: jradius(jmat.vmult, jg.vmult, v))(
        jnp.asarray(b)))
    tr = estimate_error_propagator_radius(tmat.vmult, tg.vmult, bt)
    assert 0.0 < tr < 1.0 and abs(tr - jr) <= 1e-3 * jr, (jr, tr)

