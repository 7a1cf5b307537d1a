"""The space-time error norms of stfem_tpu_torch (errors.py) against
stfem_tpu's on the CPU: the same seeded slab vectors (numpy) through both
packages' SpatialEvaluator (values and physical gradients at the tensor
Gauss points) and ErrorCalculator.evaluate_error (L2(L2) and L2(H1-semi)
squared, Linf(Linf)), for DG(1), DG(2), CGP(2) and CGP(3) in 2D and 3D,
with the reference's under-integration (n_q = fe_degree + 1) and with the
full rule.  Agreement within 1e-12 relative (the same sums in another
order: the port batches every time point of the slab into one pass)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu.errors import ErrorCalculator as JErrorCalculator
from stfem_tpu.errors import SpatialEvaluator as JSpatialEvaluator
from stfem_tpu.mesh.grid import StructuredMesh as JMesh
from stfem_tpu.problems import heat as jheat
from stfem_tpu.types import TimeStepType as JTimeStepType
from stfem_tpu_torch.errors import ErrorCalculator, SpatialEvaluator
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.problems import heat
from stfem_tpu_torch.types import TimeStepType

torch.set_num_threads(1)

_DIMS = {2: ((2, 3), (0.0, 0.25), (1.0, 1.0)),
         3: ((2, 1, 2), (0.0, 0.0, 0.0), (1.0, 0.5, 1.0))}
_KINDS = [("DG", 1), ("DG", 2), ("CGP", 2), ("CGP", 3)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _meshes(dim):
    sub, lo, hi = _DIMS[dim]
    return (JMesh(sub, lo, hi, refinement=1),
            StructuredMesh(sub, lo, hi, refinement=1))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("degree,n_q", [(2, 2), (2, 3), (3, 4), (4, 3)])
def test_spatial_evaluator(dim, degree, n_q):
    jm, tm = _meshes(dim)
    u = np.random.default_rng(degree * 10 + n_q).standard_normal(
        (3,) + tm.dof_shape(degree))
    jev = JSpatialEvaluator(jm, degree, n_q)
    tev = SpatialEvaluator(tm, degree, n_q, device="cpu")
    assert _rel(tev.coords.numpy(), np.asarray(jev.coords)) <= 1e-15
    vals = tev.values(torch.as_tensor(u))
    grads = tev.gradients(torch.as_tensor(u))
    assert vals.shape == (3,) + tm.cells + (n_q,) * dim
    assert grads.shape == vals.shape + (dim,)
    assert _rel(vals, jev.values(jnp.asarray(u))) <= 1e-12
    assert _rel(grads, jev.gradients(jnp.asarray(u))) <= 1e-12


@pytest.mark.parametrize("under_integrate", [True, False])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("kind,r", _KINDS)
def test_evaluate_error(dim, kind, r, under_integrate):
    """One slab of 3 steps at once: a field near the exact solution (so the
    norms are of a realistic size) plus seeded noise."""
    jm, tm = _meshes(dim)
    space_degree, S = r + 1, 3
    nt = r + 1 if kind == "DG" else r
    n_q = r + 1 if under_integrate else None
    coords = tm.dof_coordinates(space_degree)
    rng = np.random.default_rng(dim * 100 + r * 10 + len(kind))
    t0, tau = 0.375, 0.0625
    exact = np.stack([np.asarray(jheat.exact_solution(
        jnp.asarray(coords), t0 + tau * (b + 1) / nt)) for b in range(S * nt)])
    x = exact + 1e-2 * rng.standard_normal(exact.shape)
    prev = np.asarray(jheat.exact_solution(jnp.asarray(coords), t0)) \
        + 1e-2 * rng.standard_normal(exact.shape[1:])
    jerr = JErrorCalculator(
        jm, getattr(JTimeStepType, kind), r, space_degree,
        jheat.exact_solution, jheat.exact_gradient, n_q=n_q)
    terr = ErrorCalculator(
        tm, getattr(TimeStepType, kind), r, space_degree,
        heat.exact_solution, heat.exact_gradient, n_q=n_q, device="cpu")
    je = jerr.evaluate_error(t0, tau, jnp.asarray(x), jnp.asarray(prev), S)
    te = terr.evaluate_error(t0, tau, torch.as_tensor(x),
                             torch.as_tensor(prev), S)
    for key in ("l2", "linf", "h1_semi"):
        assert te[key].ndim == 0
        assert abs(float(te[key]) / float(je[key]) - 1.0) <= 1e-12, key


@pytest.mark.parametrize("dim", [2, 3])
def test_exact_gradient(dim):
    pts = np.random.default_rng(dim).uniform(size=(4, 5, dim))
    t = 0.3
    ref = np.asarray(jheat.exact_gradient(jnp.asarray(pts), t, 1.5))
    got = heat.exact_gradient(torch.as_tensor(pts), t, 1.5).numpy()
    assert _rel(got, ref) <= 1e-14
    # a time per leading block, as the batched error pass calls it
    ts = torch.tensor([0.1, 0.7], dtype=torch.float64).reshape(2, 1, 1)
    got = heat.exact_gradient(torch.as_tensor(pts), ts)
    for i, ti in enumerate((0.1, 0.7)):
        ref = np.asarray(jheat.exact_gradient(jnp.asarray(pts), ti))
        assert _rel(got[i].numpy(), ref) <= 1e-14
