"""The Krylov options of stfem_tpu_torch.krylov against stfem_tpu.krylov
on the CPU (the counterpart of tests/test_aux.py:127-220).

The system is test_aux.py's: the 8 x 8-cell Q2 x dG(1) slab operator
with 2 steps, a seeded masked rhs and a fixed diagonal preconditioner (a
linear one, so right preconditioning is exact).
  * flexible=False (right-preconditioned GMRES, no Z basis) takes the
    same iterations as FGMRES and stfem_tpu's flexible=False, FP64, the
    solutions within 1e-8 of the largest entry;
  * reorthogonalize="selective" (the DGKS second pass) and one pass take
    stfem_tpu's iterations, FP64, within 1e-8;
  * basis_dtype=bf16 on the float32 system converges to rel 1e-4 in
    stfem_tpu's iterations (within 1), its TRUE residual within 2x of
    stfem_tpu's;
  * richardson_solve with omega 0.7 (and the abstol stop) takes
    stfem_tpu's iterations on a contractive dense system, FP64, 1e-12."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu import krylov as jkrylov
from stfem_tpu.mesh.grid import StructuredMesh as JMesh
from stfem_tpu.ops.spatial import LaplaceMassOperator as JOp
from stfem_tpu.system import SystemMatrix as JSys
from stfem_tpu.time.tables import get_fe_time_weights
from stfem_tpu.types import TimeStepType as JT
from stfem_tpu_torch import krylov
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
from stfem_tpu_torch.system import SystemMatrix

torch.set_num_threads(1)


def _system(name):
    """(stfem_tpu's apply, the port's, the rhs, the diagonal, the dtypes)
    in dtype `name`."""
    jdt, tdt = getattr(jnp, name), getattr(torch, name)
    jm = JMesh([8, 8], [0.0, 0.0], [1.0, 1.0])
    tm = StructuredMesh([8, 8], [0.0, 0.0], [1.0, 1.0])
    A, B, _, _ = get_fe_time_weights(JT.DG, 1, 1 / 16, 2)
    jK, jM = (JOp(jm, 2, 3, m, l, dtype=jdt)
              for m, l in ((0.0, 1.0), (1.0, 0.0)))
    tK, tM = (LaplaceMassOperator(tm, 2, 3, m, l, dtype=tdt, device="cpu")
              for m, l in ((0.0, 1.0), (1.0, 0.0)))
    rng = np.random.default_rng(3)
    rhs = rng.standard_normal((A.shape[0],) + tuple(jK.dof_shape)) * \
        jK.mask_np[None]
    diag = 1.0 / (1.0 + rng.uniform(0.0, 2.0, rhs.shape))
    return (JSys(jK, jM, A, B).vmult, SystemMatrix(tK, tM, A, B).vmult,
            rhs, diag, jdt, tdt)


@pytest.fixture(scope="module")
def system64():
    return _system("float64")


@pytest.fixture(scope="module")
def system32():
    return _system("float32")


def _solve_both(system, reltol, **kw):
    jA, tA, rhs, diag, jdt, tdt = system
    jb, tb = jnp.asarray(rhs, jdt), torch.as_tensor(rhs, dtype=tdt)
    jd, td = jnp.asarray(diag, jdt), torch.as_tensor(diag, dtype=tdt)
    jkw = dict(kw)
    if kw.get("basis_dtype") is not None:
        jkw["basis_dtype"] = jnp.bfloat16
    jres = jkrylov.fgmres(jA, jb, jnp.zeros_like(jb),
                          precondition=lambda v: jd * v, maxiter=200,
                          abstol=1e-30, reltol=reltol, **jkw)
    tres = krylov.fgmres(tA, tb, torch.zeros_like(tb), lambda v: td * v,
                         maxiter=200, abstol=1e-30, reltol=reltol, **kw)
    return jres, tres


def _close(t, j, rel):
    t, j = t.double().numpy(), np.asarray(j, np.float64)
    np.testing.assert_allclose(t, j, rtol=0, atol=rel * np.abs(j).max())


@pytest.mark.parametrize("option", [dict(flexible=False),
                                    dict(reorthogonalize="selective"),
                                    dict(reorthogonalize=False)],
                         ids=["right", "selective", "one_pass"])
def test_fgmres_option(system64, option):
    jres, tres = _solve_both(system64, 1e-10, **option)
    _, fres = _solve_both(system64, 1e-10)
    assert bool(jres.converged) and tres.converged and fres.converged
    assert tres.iterations == int(jres.iterations) == fres.iterations
    _close(tres.x, jres.x, 1e-8)
    _close(tres.x, fres.x.numpy(), 1e-8)


def test_fgmres_bf16_basis(system32):
    """A bf16 V loses the Arnoldi relation at bf16 rounding: the Givens
    estimate reaches 1e-4 while the TRUE residual stays near 1e-2, in
    both packages alike."""
    rhs = system32[2]
    jres, tres = _solve_both(system32, 1e-4, basis_dtype=torch.bfloat16)
    assert bool(jres.converged) and tres.converged
    assert abs(tres.iterations - int(jres.iterations)) <= 1
    # the TRUE residuals, with the FP64 operator
    tm = StructuredMesh([8, 8], [0.0, 0.0], [1.0, 1.0])
    A, B, _, _ = get_fe_time_weights(JT.DG, 1, 1 / 16, 2)
    K, M = (LaplaceMassOperator(tm, 2, 3, m, l, dtype=torch.float64,
                                device="cpu")
            for m, l in ((0.0, 1.0), (1.0, 0.0)))
    op, b = SystemMatrix(K, M, A, B), torch.as_tensor(rhs)
    true = [float((b - op.vmult(torch.as_tensor(np.asarray(x, np.float64))
                                 )).norm() / b.norm())
            for x in (tres.x.double().numpy(), jres.x)]
    assert true[0] <= 2 * true[1] and true[1] <= 2 * true[0], true
    assert true[0] <= 3e-2


@pytest.mark.parametrize("abstol", [1e-30, 1e-3])
def test_richardson_omega(abstol):
    rng = np.random.default_rng(5)
    n = 60
    R = rng.standard_normal((n, n))
    A = np.eye(n) + 0.4 * R / np.linalg.norm(R, 2)
    b = rng.standard_normal(n)
    P = np.diag(1.0 / np.diag(A))
    jres = jkrylov.richardson_solve(
        lambda v: jnp.asarray(A) @ v, jnp.asarray(b), jnp.zeros(n),
        lambda v: jnp.asarray(P) @ v, omega=0.7, maxiter=200,
        abstol=abstol, reltol=1e-10)
    tres = krylov.richardson_solve(
        lambda v: torch.as_tensor(A) @ v, torch.as_tensor(b),
        torch.zeros(n, dtype=torch.float64), lambda v: torch.as_tensor(P) @ v,
        maxiter=200, reltol=1e-10, omega=0.7, abstol=abstol)
    assert bool(jres.converged) and tres.converged
    assert tres.iterations == int(jres.iterations)
    assert (tres.iterations < 20) == (abstol > 1e-20)
    _close(tres.x, jres.x, 1e-12)
    assert tres.residual == pytest.approx(float(jres.residual), rel=1e-8)
