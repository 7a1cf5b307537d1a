"""The coefficient field of stfem_tpu_torch vs stfem_tpu: the
heterogeneous Coefficient, its quadrature table in LaplaceMassOperator,
the operator's apply and element matrices with it, and the practical
mode's C-infinity bump.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: float64 to 1e-13 relative to the max (the same products summed
in another order by torch's and XLA's einsums)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu.mesh.grid import StructuredMesh as JMesh
from stfem_tpu.ops.spatial import LaplaceMassOperator as JOp
from stfem_tpu.problems.coefficient import Coefficient as JCoefficient
from stfem_tpu.problems.heat import cutoff_cinfty as jcutoff
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
from stfem_tpu_torch.problems.coefficient import Coefficient
from stfem_tpu_torch.problems.heat import cutoff_cinfty

TOL = 1e-13

# (subdivisions, lower, upper, refinement, degree, distortion)
CASES = [((2, 2, 2), (0.0,) * 3, (1.0,) * 3, 1, 3, 0.5),
         ((3, 2, 2), (-1.0, 0.0, 0.5), (2.0, 1.0, 1.5), 0, 2, 0.3),
         ((2, 3), (0.0, 0.0), (1.0, 1.0), 1, 3, 0.0)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _pair(sub, lo, hi, ref, k, dist, ms, ls):
    jm = JMesh(sub, lo, hi, refinement=ref)
    tm = StructuredMesh(sub, lo, hi, refinement=ref)
    jop = JOp(jm, k, k + 1, ms, ls, coefficient=JCoefficient(sub, lo, hi,
                                                            dist))
    top = LaplaceMassOperator(tm, k, k + 1, ms, ls, device="cpu",
                              coefficient=Coefficient(sub, lo, hi, dist))
    return jop, top


@pytest.mark.parametrize("case", CASES)
def test_coefficient_quad_table(case):
    """The coefficient at every (cell, quadrature point) and the folded
    weights jxw * coefficient."""
    jop, top = _pair(*case, 0.0, 1.0)
    np.testing.assert_array_equal(top.coeff_np, np.asarray(jop.coeff))
    assert _rel(top.w.numpy(), np.asarray(jop.jxw * jop.coeff)) <= TOL
    # the distortion draws the same 1 +- d factors per subdivision cell
    if case[-1] != 0.0:
        c, jc = Coefficient(*case[:3], case[-1]), \
            JCoefficient(*case[:3], case[-1])
        np.testing.assert_array_equal(c.distortion, jc.distortion)


@pytest.mark.parametrize("ms,ls", [(0.0, 1.0), (1.0, 0.0), (0.5, 2.0)])
@pytest.mark.parametrize("case", CASES)
def test_operator_with_coefficient(case, ms, ls):
    """apply on a batch of blocks and the masked element matrices."""
    jop, top = _pair(*case, ms, ls)
    x = np.random.default_rng(7).standard_normal((3,) + top.dof_shape)
    assert _rel(top.apply(torch.as_tensor(x)).numpy(),
                jop.apply(jnp.asarray(x))) <= TOL
    assert _rel(top.element_matrices().numpy(),
                jop.element_matrices()) <= TOL


@pytest.mark.parametrize("dim,radius", [(3, 1e-2), (2, 0.3)])
def test_cutoff_cinfty(dim, radius):
    """The unit-integral bump at random points around its centre."""
    c = (0.5,) * dim
    pts = np.random.default_rng(dim).uniform(0.5 - 1.5 * radius,
                                             0.5 + 1.5 * radius, (400, dim))
    got = cutoff_cinfty(torch.as_tensor(pts), c, radius).numpy()
    ref = np.asarray(jcutoff(jnp.asarray(pts), c, radius))
    assert np.count_nonzero(ref) > 10
    assert _rel(got, ref) <= TOL
