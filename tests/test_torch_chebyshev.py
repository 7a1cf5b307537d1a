"""The Chebyshev smoother and the solver-layer iterations of
stfem_tpu_torch against stfem_tpu on the CPU, in float64, on one 2D heat
level (2 x 2 cells at refinement 2, Q2, dG(1), 4 steps at once, its
grid-mode Vanka; each package builds its own operators and Vanka from the
same tables):

- chebyshev_parameters on the same EigInfo gives stfem_tpu's (theta,
  delta) exactly, and ChebyshevSmoother.vmult agrees within 1e-12
  relative for degrees 1-4 and ranges 1 and 5; degree 1 is the
  Relaxation smoother at omega = 1 / theta, bitwise;
- gmres_fixed_left (10 iterations, the level's Vanka as the left
  preconditioner) within 1e-10; a zero rhs gives zero, a system with
  fewer unknowns than iterations its solution without a NaN, and a
  non-finite value raises;
- chebyshev_solve within 1e-10, step for step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu.krylov import chebyshev_solve as jchebyshev_solve
from stfem_tpu.krylov import gmres_fixed_left as jgmres_fixed_left
from stfem_tpu.mesh.grid import StructuredMesh as JMesh
from stfem_tpu.ops.spatial import LaplaceMassOperator as JOp
from stfem_tpu.stmg import smoother as jsm
from stfem_tpu.stmg.vanka import PreconditionVanka as JVanka
from stfem_tpu.system import SystemMatrix as JSys
from stfem_tpu.time.tables import get_fe_time_weights
from stfem_tpu.types import TimeStepType as JT
from stfem_tpu_torch.krylov import chebyshev_solve, gmres_fixed_left
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
from stfem_tpu_torch.stmg import smoother as tsm
from stfem_tpu_torch.stmg.vanka import PreconditionVanka
from stfem_tpu_torch.system import SystemMatrix

torch.set_num_threads(1)
F64 = torch.float64


def _rel(got, ref):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


@pytest.fixture(scope="module")
def level():
    """(stfem_tpu's matrix and Vanka, the port's, a masked seeded vector,
    stfem_tpu's power EigInfo of P A)."""
    A, B, _, _ = get_fe_time_weights(JT.DG, 1, 1 / 16, 4)
    jm = JMesh([2, 2], [0.0, 0.0], [1.0, 1.0], refinement=2)
    tm = StructuredMesh([2, 2], [0.0, 0.0], [1.0, 1.0], refinement=2)
    jK, jM = (JOp(jm, 2, 3, m, l, dtype=jnp.float64)
              for m, l in ((0.0, 1.0), (1.0, 0.0)))
    tK, tM = (LaplaceMassOperator(tm, 2, 3, m, l, dtype=F64, device="cpu")
              for m, l in ((0.0, 1.0), (1.0, 0.0)))
    jmat, tmat = JSys(jK, jM, A, B), SystemMatrix(tK, tM, A, B)
    jvan = JVanka(jK, jM, A, B, dtype=jnp.float64, n_steps=4)
    tvan = PreconditionVanka(tK, tM, A, B, dtype=F64, n_steps=4)
    shape = (A.shape[0],) + jK.dof_shape
    x = np.random.default_rng(3).standard_normal(shape) * jK.mask_np
    info = jsm.estimate_eigenvalues(jmat, jvan, shape, jK.mask_np,
                                    jnp.float64, method="power")
    return jmat, jvan, tmat, tvan, x, info


@pytest.mark.parametrize("smoothing_range", [1.0, 5.0])
@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_chebyshev_smoother(level, degree, smoothing_range):
    jmat, jvan, tmat, tvan, x, info = level
    assert info.min_eigenvalue < info.max_eigenvalue   # the power EigInfo
    theta, delta = jsm.chebyshev_parameters(info, smoothing_range)
    assert tsm.chebyshev_parameters(
        tsm.EigInfo(info.min_eigenvalue, info.max_eigenvalue),
        smoothing_range) == (theta, delta)
    ref = jsm.ChebyshevSmoother(jmat, jvan, theta, delta,
                                degree).vmult(jnp.asarray(x))
    got = tsm.ChebyshevSmoother(tmat, tvan, theta, delta,
                                degree).vmult(torch.as_tensor(x))
    assert _rel(got, ref) <= 1e-12


def test_chebyshev_degree1_is_relaxation(level):
    """Degree 1 is one Relaxation sweep at omega = 1 / theta; with the
    converged estimate (min = max) at range 1 that omega is the
    Relaxation smoother's own, 2 / (1.9 lambda)."""
    _, _, tmat, tvan, x, info = level
    lam = info.max_eigenvalue
    theta, delta = tsm.chebyshev_parameters(tsm.EigInfo(lam, lam), 1.0)
    assert (theta, delta) == pytest.approx((0.95 * lam, 0.05 * lam))
    omega = tsm.relaxation_parameters(tsm.EigInfo(lam, lam), 1.0)
    assert omega == pytest.approx(1.0 / theta, rel=1e-15)
    b = torch.as_tensor(x)
    cheb = tsm.ChebyshevSmoother(tmat, tvan, theta, delta, 1).vmult(b)
    relax = tsm.RelaxationSmoother(tmat, tvan, 1.0 / theta, 1).vmult(b)
    assert torch.equal(cheb, relax)


def test_gmres_fixed_left(level):
    jmat, jvan, tmat, tvan, x, _ = level
    ref = jgmres_fixed_left(jmat.vmult, jnp.asarray(x), jvan.vmult, 10)
    got = gmres_fixed_left(tmat.vmult, torch.as_tensor(x), tvan.vmult, 10)
    assert _rel(got, ref) <= 1e-10
    # ten iterations reduce the preconditioned residual
    b = torch.as_tensor(x)
    pr = tvan.vmult(b - tmat.vmult(got))
    assert float(pr.norm()) < 0.1 * float(tvan.vmult(b).norm())
    zero = gmres_fixed_left(tmat.vmult, torch.zeros_like(b), tvan.vmult, 10)
    assert not torch.any(zero)


def test_gmres_fixed_left_breakdown():
    """A 6-unknown system and 10 iterations: the Krylov space is full
    after 6, H is rank-deficient, and the minimum-norm solve gives the
    solution, as stfem_tpu's lstsq does."""
    rng = np.random.default_rng(7)
    Ad = rng.standard_normal((6, 6)) + 6.0 * np.eye(6)
    D = np.diag(1.0 / np.diag(Ad))
    b = rng.standard_normal((2, 3))
    exact = np.linalg.solve(Ad, b.reshape(-1)).reshape(2, 3)
    At, Dt = torch.as_tensor(Ad), torch.as_tensor(D)
    got = gmres_fixed_left(lambda v: (At @ v.reshape(-1)).reshape(v.shape),
                           torch.as_tensor(b),
                           lambda v: (Dt @ v.reshape(-1)).reshape(v.shape),
                           10)
    ref = jgmres_fixed_left(lambda v: (Ad @ v.reshape(-1)).reshape(v.shape),
                            jnp.asarray(b),
                            lambda v: (D @ v.reshape(-1)).reshape(v.shape),
                            10)
    assert torch.all(torch.isfinite(got))
    assert _rel(got, exact) <= 1e-10
    assert _rel(got, ref) <= 1e-10


def test_gmres_fixed_left_raises_on_nan():
    b = torch.ones((2, 3), dtype=F64)
    with pytest.raises(FloatingPointError):
        gmres_fixed_left(lambda v: v * float("nan"), b, lambda v: v, 4)


def test_chebyshev_solve(level):
    """Both packages' Chebyshev iterations over the Vanka on the same
    interval, step for step: 25 steps (the stop test is out of reach)
    from the same start."""
    jmat, jvan, tmat, tvan, x, info = level
    lam = info.max_eigenvalue
    x0 = 0.1 * np.roll(x, 1, axis=-1)
    jres = jax.jit(lambda b, z: jchebyshev_solve(
        jmat.vmult, b, z, jvan.vmult, 0.05 * lam, 1.2 * lam, maxiter=25,
        abstol=1e-30, reltol=1e-30))(jnp.asarray(x), jnp.asarray(x0))
    tres = chebyshev_solve(tmat.vmult, torch.as_tensor(x),
                           torch.as_tensor(x0), tvan.vmult, 0.05 * lam,
                           1.2 * lam, maxiter=25, abstol=1e-30, reltol=1e-30)
    assert tres.iterations == int(jres.iterations) == 25
    assert not tres.converged and not bool(jres.converged)
    assert _rel(tres.x, jres.x) <= 1e-10
    assert tres.residual == pytest.approx(float(jres.residual), rel=1e-8)
    # to a reachable tolerance: the same step count
    jres = jax.jit(lambda b, z: jchebyshev_solve(
        jmat.vmult, b, z, jvan.vmult, 0.05 * lam, 1.2 * lam, maxiter=200,
        abstol=1e-30, reltol=1e-6))(jnp.asarray(x), jnp.asarray(x0))
    tres = chebyshev_solve(tmat.vmult, torch.as_tensor(x),
                           torch.as_tensor(x0), tvan.vmult, 0.05 * lam,
                           1.2 * lam, maxiter=200, abstol=1e-30, reltol=1e-6)
    assert tres.converged and bool(jres.converged)
    assert tres.iterations == int(jres.iterations)
    assert _rel(tres.x, jres.x) <= 1e-10
