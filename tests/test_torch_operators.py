"""stfem_tpu_torch spatial/slab operators vs stfem_tpu on the same seeded
inputs (CPU).  Tolerances (relative to the reference's max norm): float64
1e-13 (summation order only), float32 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu.integrators import ForceAssembler as JForce
from stfem_tpu.mesh.grid import StructuredMesh as JMesh
from stfem_tpu.ops.kronfac import KronAssembled as JKron
from stfem_tpu.ops.spatial import LaplaceMassOperator as JOp
from stfem_tpu.problems import heat as jheat
from stfem_tpu.system import SystemMatrix as JSys
from stfem_tpu.time.tables import get_fe_time_weights
from stfem_tpu.types import TimeStepType
from stfem_tpu_torch.integrators import ForceAssembler
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.kronfac import KronAssembled
from stfem_tpu_torch.ops.spatial import (LaplaceMassOperator, cell_gather,
                                         cell_scatter)
from stfem_tpu_torch.problems import heat as theat
from stfem_tpu_torch.system import SystemMatrix

torch.set_num_threads(1)

DT = {"f64": (jnp.float64, torch.float64, 1e-13),
      "f32": (jnp.float32, torch.float32, 1e-5)}
GRIDS = [((2, 2, 2), 2), ((2, 3, 4), 2), ((3, 3, 3), 4), ((4, 4, 4), 4)]


def _meshes(cells):
    return (JMesh(list(cells), [0.0] * 3, [1.0] * 3),
            StructuredMesh(list(cells), [0.0] * 3, [1.0] * 3))


def _ops(cells, k, prec):
    jm, tm = _meshes(cells)
    jdt, tdt, _ = DT[prec]
    return ((JOp(jm, k, k + 1, 0.0, 1.0, dtype=jdt),
             JOp(jm, k, k + 1, 1.0, 0.0, dtype=jdt)),
            (LaplaceMassOperator(tm, k, k + 1, 0.0, 1.0, dtype=tdt,
                                 device="cpu"),
             LaplaceMassOperator(tm, k, k + 1, 1.0, 0.0, dtype=tdt,
                                 device="cpu")))


def _close(got, ref, tol):
    got = got.double().numpy() if torch.is_tensor(got) else got
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
    assert err <= tol, err


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("cells,k", GRIDS)
def test_laplace_mass_apply(cells, k, prec):
    (jK, jM), (tK, tM) = _ops(cells, k, prec)
    jdt, tdt, tol = DT[prec]
    x = np.random.default_rng(0).standard_normal((2,) + jK.dof_shape)
    for jop, top in ((jK, tK), (jM, tM)):
        _close(top.apply(torch.as_tensor(x, dtype=tdt)),
               jax.jit(jop.apply)(jnp.asarray(x, jdt)), tol)
    if prec == "f64":
        _close(tK.element_matrices(), jK.element_matrices(), tol)


@pytest.mark.parametrize("cells,k", GRIDS[:3])
def test_cell_gather_scatter_exact(cells, k):
    from stfem_tpu.ops.spatial import cell_gather as jg, cell_scatter as js
    n = tuple(c * k + 1 for c in cells)
    x = np.random.default_rng(1).standard_normal((3,) + n)
    u = cell_gather(torch.as_tensor(x), cells, k)
    np.testing.assert_array_equal(
        u.numpy(), np.asarray(jax.jit(lambda v: jg(v, cells, k))(
            jnp.asarray(x))))
    np.testing.assert_array_equal(
        cell_scatter(u, cells, k).numpy(),
        np.asarray(jax.jit(lambda v: js(v, cells, k))(
            jnp.asarray(u.numpy()))))


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("cells,k", GRIDS)
def test_kron_pair(cells, k, prec):
    (jK, jM), (tK, tM) = _ops(cells, k, prec)
    jdt, tdt, tol = DT[prec]
    jk, tk = JKron(jK, jM, jdt), KronAssembled(tK, tM, tdt)
    for d in range(3):
        _close(tk.M1[d], jk.M1[d], tol)
        _close(tk.Ad[d], jk.Ad[d], tol)
    x = np.random.default_rng(2).standard_normal((3,) + jK.dof_shape)
    Kt, Mt = tk.pair(torch.as_tensor(x, dtype=tdt))
    Kj, Mj = jax.jit(jk.pair)(jnp.asarray(x, jdt))
    _close(Kt, Kj, tol)
    _close(Mt, Mj, tol)
    Kt, Mt = tk.pair(torch.as_tensor(x, dtype=tdt), need_M=False)
    assert Mt is None
    _close(Kt, Kj, tol)


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("cells,k", [GRIDS[1], GRIDS[3]])
def test_system_vmult_and_slice(cells, k, prec):
    (jK, jM), (tK, tM) = _ops(cells, k, prec)
    jdt, tdt, tol = DT[prec]
    A, B, G, _ = get_fe_time_weights(TimeStepType.DG, 2, 1 / 16, 4)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((A.shape[0],) + jK.dof_shape)
    _close(SystemMatrix(tK, tM, A, B).vmult(torch.as_tensor(x, dtype=tdt)),
           jax.jit(JSys(jK, jM, A, B).vmult)(jnp.asarray(x, jdt)), tol)
    # rhs coupling (vmult_slice through the reduced nonzero rows)
    p = rng.standard_normal(jK.dof_shape)
    tr = SystemMatrix(tK, tM, np.zeros_like(G), G)
    assert tr._slice_nz == (0, 1, 2)
    _close(tr.vmult(torch.as_tensor(p, dtype=tdt)[None]),
           jax.jit(JSys(jK, jM, np.zeros_like(G), G).vmult)(
               jnp.asarray(p, jdt)[None]), tol)
    # rectangular per-step tables (input column reduction)
    nt = 3
    A4 = np.concatenate([A[nt:2 * nt, nt - 1:nt], A[:nt, :nt]], axis=1)
    B4 = np.concatenate([B[nt:2 * nt, nt - 1:nt], B[:nt, :nt]], axis=1)
    xs = x[:nt + 1]
    _close(SystemMatrix(tK, tM, A4, B4).vmult(torch.as_tensor(xs, dtype=tdt)),
           jax.jit(JSys(jK, jM, A4, B4).vmult)(jnp.asarray(xs, jdt)), tol)


def test_step_structure_detection():
    A, B, _, _ = get_fe_time_weights(TimeStepType.DG, 2, 1 / 16, 4)
    a = JSys._detect_step_structure(A, B)
    b = SystemMatrix._detect_step_structure(A, B)
    assert a[0] == b[0] == 3
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(x, y)
    assert SystemMatrix._detect_step_structure(A[:, :1], B[:, :1]) is None


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_force_assembler_batched(prec):
    jdt, tdt, tol = DT[prec]
    cells, k = (2, 2, 2), 4
    jm, tm = _meshes(cells)
    mask = jm.boundary_dof_mask(k)
    jf = JForce(jm, k, k + 1, lambda p, t: jheat.rhs(p, t, 1.0), mask,
                dtype=jdt)
    tf = ForceAssembler(tm, k, k + 1, lambda p, t: theat.rhs(p, t, 1.0),
                        mask, dtype=tdt, device="cpu")
    ts = np.array([0.01, 0.03, 0.0625, 0.2])
    sc = np.array([0.5, 1.0, 0.25, 2.0])
    _close(tf.batched(torch.as_tensor(ts, dtype=tdt),
                      torch.as_tensor(sc, dtype=tdt)),
           jax.jit(jf.batched)(jnp.asarray(ts, jdt), jnp.asarray(sc, jdt)),
           tol)
    _close(tf(0.3), jax.jit(jf.__call__)(0.3), tol)


def test_dof_coordinates_and_exact_solution():
    jm, tm = _meshes((2, 3, 2))
    np.testing.assert_array_equal(tm.dof_coordinates(3),
                                  jm.dof_coordinates(3))
    np.testing.assert_array_equal(tm.boundary_dof_mask(3),
                                  jm.boundary_dof_mask(3))
    c = jm.dof_coordinates(3)
    _close(theat.exact_solution(torch.as_tensor(c), 0.3),
           jheat.exact_solution(jnp.asarray(c), 0.3), 1e-15)
