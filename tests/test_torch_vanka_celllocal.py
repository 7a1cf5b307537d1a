"""The cell-local Vanka of stfem_tpu_torch (a coefficient field breaks the
separable eigenbasis) vs stfem_tpu's non-separable fastdiag mode, on
3^3-cell Q3 meshes with the distorted coefficient, float32 levels.

- JAX's factors (V, Ginv, cvec or TTinv, dinv) loaded through
  utils/carry.py: one apply within 1e-5 relative (the same float32
  products in another order; the multi-step recurrence is kernel K1's
  plain version here, an associative scan in stfem_tpu).
- The port's own build (float64 on the host, then float32): the apply
  within 1e-5 and the per-step inverses Ginv within 1e-3 of the largest
  (stfem_tpu's float32 eigh perturbs the eigenvalues, and Ginv follows;
  the eigenvector signs are free, so V itself is not compared).
- Without a coefficient the level keeps the grid mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu.mesh.grid import StructuredMesh as JMesh
from stfem_tpu.ops.spatial import LaplaceMassOperator as JOp
from stfem_tpu.problems.coefficient import Coefficient as JCoefficient
from stfem_tpu.stmg.vanka import PreconditionVanka as JVanka
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
from stfem_tpu_torch.ops.time_solve import time_solve
from stfem_tpu_torch.problems.coefficient import Coefficient
from stfem_tpu_torch.stmg.vanka import PreconditionVanka
from stfem_tpu_torch.time.tables import get_fe_time_weights
from stfem_tpu_torch.types import TimeStepType
from stfem_tpu_torch.utils.carry import load_vanka_cell

SUB, LO, HI = (3, 3, 3), (0.0,) * 3, (1.0,) * 3


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _build(n_steps, coefficient=True):
    A, B, _, _ = get_fe_time_weights(TimeStepType.DG, 2, 1.0 / 32, n_steps)
    jm, tm = JMesh(SUB, LO, HI), StructuredMesh(SUB, LO, HI)
    jc = JCoefficient(SUB, LO, HI, 0.5) if coefficient else None
    tc = Coefficient(SUB, LO, HI, 0.5) if coefficient else None
    jK = JOp(jm, 3, 4, 0.0, 1.0, dtype=jnp.float32, coefficient=jc)
    jM = JOp(jm, 3, 4, 1.0, 0.0, dtype=jnp.float32)
    tK = LaplaceMassOperator(tm, 3, 4, 0.0, 1.0, dtype=torch.float32,
                             device="cpu", coefficient=tc)
    tM = LaplaceMassOperator(tm, 3, 4, 1.0, 0.0, dtype=torch.float32,
                             device="cpu")
    jv = JVanka(jK, jM, A, B, dtype=jnp.float32, n_steps=n_steps)
    tv = PreconditionVanka(tK, tM, A, B, dtype=torch.float32,
                           n_steps=n_steps)
    x = (np.random.default_rng(n_steps).standard_normal(
        (A.shape[0],) + tK.dof_shape) * tK.mask_np).astype(np.float32)
    return jv, tv, x


def _apply_rel(jv, tv, x):
    ref = np.asarray(jv.vmult(jnp.asarray(x)), np.float64)
    return _rel(tv.vmult(torch.as_tensor(x)).numpy(), ref)


@pytest.fixture(scope="module", params=[4, 1])
def pair(request):
    return _build(request.param)


def test_mode_and_factors_carried(pair):
    jv, tv, x = pair
    assert jv.Wdn is None and jv.V is not None and tv.mode == "cell"
    assert tv.n_steps == jv.n_steps
    f32 = lambda a: None if a is None else np.asarray(a, np.float32)
    load_vanka_cell(tv, V=f32(jv.V), Ginv=f32(jv.Ginv), cvec=f32(jv.cvec),
                    TTinv=f32(jv.TTinv), dinv=f32(jv.dinv))
    before = time_solve.launches
    assert _apply_rel(jv, tv, x) <= 1e-5
    assert time_solve.launches == before        # the CPU takes K1's plain


def test_own_build(pair):
    """A fresh build of the port's own factors (the carried test above
    overwrote the fixture's)."""
    jv, _, x = pair
    tv = _build(jv.n_steps)[1]
    assert _apply_rel(jv, tv, x) <= 1e-5
    if jv.n_steps > 1:
        nt = jv.n_blocks // jv.n_steps
        Gj = np.asarray(jv.Ginv).reshape(-1, nt, nt)
        assert _rel(tv.GinvT.permute(2, 0, 1).numpy(), Gj) <= 1e-3
        assert tv.GinvT.shape == (nt, nt, Gj.shape[0])


def test_separable_level_keeps_grid_mode():
    jv, tv, x = _build(4, coefficient=False)
    assert tv.mode == "grid" and jv.Wdn is not None
    assert _apply_rel(jv, tv, x) <= 1e-5
