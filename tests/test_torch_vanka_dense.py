"""The dense reference Vanka of stfem_tpu_torch (PreconditionVanka mode
"dense") against stfem_tpu's, and the port's grid and cell modes against
it (CPU, float64, numpy seeds; tests/test_stmg.py:50-96's mesh: 3 x 3
cells refined once, Q2).

Tolerances: as tests/test_stmg.py holds stfem_tpu's modes against each
other, rtol 1e-9 with atol 1e-11 (the dense inverse and the fast
diagonalisation differ by the conditioning of B_c); the float32 and bf16
stored inverses within 1e-5 and 2e-2 of the float64 apply's max entry
(one float32 rounding, or one bf16 rounding (2^-8) of each Binv entry
under sums of T A terms)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu.mesh.grid import StructuredMesh as JMesh
from stfem_tpu.ops.spatial import LaplaceMassOperator as JOp
from stfem_tpu.stmg.vanka import PreconditionVanka as JVanka
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
from stfem_tpu_torch.problems.coefficient import Coefficient
from stfem_tpu_torch.stmg import vanka as tvanka
from stfem_tpu_torch.stmg.vanka import PreconditionVanka
from stfem_tpu_torch.time.tables import (get_fe_time_weights,
                                         get_fe_time_weights_wave)
from stfem_tpu_torch.types import TimeStepType

torch.set_num_threads(1)
F64 = torch.float64


def _tables(kind, n_steps=4):
    if kind == "wave":
        one = get_fe_time_weights(TimeStepType.DG, 1, 0.125)
        return get_fe_time_weights_wave(TimeStepType.DG, *one, n_steps)[:2]
    t, r = (TimeStepType.DG, 1) if kind == "dg1" else (TimeStepType.CGP, 2)
    return get_fe_time_weights(t, r, 0.125, n_steps)[:2]


def _ops(dim=2, coefficient=False):
    tm = StructuredMesh([3] * dim, [0.0] * dim, [1.0] * dim, refinement=1)
    tc = Coefficient([2] * dim, [0.0] * dim, [1.0] * dim, 0.5) \
        if coefficient else None
    return (LaplaceMassOperator(tm, 2, 3, 0.0, 1.0, dtype=F64, device="cpu",
                                coefficient=tc),
            LaplaceMassOperator(tm, 2, 3, 1.0, 0.0, dtype=F64, device="cpu"))


def _src(n_blocks, K, seed=7):
    """Interior-supported defects (the solver's rhs and operator outputs
    are masked)."""
    x = np.random.default_rng(seed).standard_normal(
        (n_blocks,) + tuple(K.dof_shape))
    return torch.as_tensor(x * K.mask_np)


def _close(got, ref, rtol=1e-9, atol=1e-11):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def jax_dense():
    """stfem_tpu's dense-mode applies on the DG(1), CGP(2) and wave tables
    (each built once: the build is one jitted program)."""
    jm = JMesh([3, 3], [0.0, 0.0], [1.0, 1.0], refinement=1)
    jK = JOp(jm, 2, 3, 0.0, 1.0, dtype=jnp.float64)
    jM = JOp(jm, 2, 3, 1.0, 0.0, dtype=jnp.float64)
    out = {}
    for kind in ("dg1", "cgp2", "wave"):
        A, B = _tables(kind)
        src = _src(np.asarray(A).shape[0], jK)
        v = JVanka(jK, jM, np.asarray(A), np.asarray(B), mode="dense")
        out[kind] = (src, np.asarray(v.vmult(jnp.asarray(src.numpy()))),
                     np.asarray(v.Binv))
    return out


@pytest.mark.parametrize("kind", ["dg1", "cgp2", "wave"])
def test_dense_matches_stfem_tpu(jax_dense, kind):
    src, ref, jBinv = jax_dense[kind]
    A, B = _tables(kind)
    v = PreconditionVanka(*_ops(), A, B, mode="dense")
    assert v.mode == "dense" and v.n_steps == 1
    assert v.Binv.shape == jBinv.shape and v.Binv.dtype == F64
    _close(v.Binv, jBinv)
    _close(v.vmult(src), ref)


@pytest.mark.parametrize("kind,n_steps", [("dg1", 4), ("cgp2", 4),
                                          ("wave", 4), ("dg1", 1)])
@pytest.mark.parametrize("mode", ["grid", "cell"])
def test_fastdiag_matches_dense(kind, n_steps, mode, monkeypatch):
    """The grid and cell modes (K1's multi-step recurrence where the tables
    allow it, the dense per-position T x T solve for the wave tables and
    one step) against the dense inverse of the same level; the cell mode
    is the one a level gets when separable() says no."""
    A, B = _tables(kind, n_steps)
    K, M = _ops()
    dense = PreconditionVanka(K, M, A, B, mode="dense")
    if mode == "cell":
        monkeypatch.setattr(tvanka, "separable", lambda K_op, M_op: False)
    v = PreconditionVanka(K, M, A, B, n_steps=n_steps)
    assert v.mode == mode
    assert v.n_steps == (1 if kind == "wave" else n_steps)
    src = _src(np.asarray(A).shape[0], K)
    _close(v.vmult(src), dense.vmult(src))


@pytest.mark.parametrize("dim", [2, 3])
def test_cell_mode_matches_dense_with_coefficient(dim):
    """A coefficient field: the default mode is the cell mode, held against
    the dense inverse (which shares no factorisation with it)."""
    A, B = _tables("dg1", 2)
    K, M = _ops(dim, coefficient=True)
    v = PreconditionVanka(K, M, A, B, n_steps=2)
    assert v.mode == "cell" and v.n_steps == 2
    src = _src(np.asarray(A).shape[0], K, seed=dim)
    _close(v.vmult(src), PreconditionVanka(K, M, A, B, mode="dense")
           .vmult(src))


@pytest.mark.parametrize("storage,tol", [(torch.float32, 1e-5),
                                         (torch.bfloat16, 2e-2)])
def test_dense_storage_dtype(storage, tol):
    """storage_dtype stores Binv reduced; the apply computes in the
    promoted dtype and returns the level dtype."""
    A, B = _tables("dg1")
    K, M = _ops()
    ref_v = PreconditionVanka(K, M, A, B, mode="dense")
    v = PreconditionVanka(K, M, A, B, dtype=torch.float32,
                          storage_dtype=storage, mode="dense")
    assert v.Binv.dtype == storage
    src = _src(np.asarray(A).shape[0], K)
    got, ref = v.vmult(src), ref_v.vmult(src)
    assert got.dtype == torch.float32
    assert float((got.double() - ref).abs().max()) <= \
        tol * float(ref.abs().max())


def test_dense_byte_limit(monkeypatch):
    """A level whose Binv would pass the limit is refused before anything
    is assembled; the limit is a stated byte count, in the stored
    dtype."""
    assert tvanka.DENSE_MAX_BYTES == 2 ** 30
    A, B = _tables("dg1")
    K, M = _ops()
    C, TA = K.mesh.n_cells, np.asarray(A).shape[0] * 9
    n_bytes = C * TA * TA * 8
    monkeypatch.setattr(tvanka, "DENSE_MAX_BYTES", n_bytes - 1)
    with pytest.raises(ValueError, match="over the limit"):
        PreconditionVanka(K, M, A, B, mode="dense")
    v = PreconditionVanka(K, M, A, B, dtype=torch.float32, mode="dense")
    assert v.Binv.dtype == torch.float32
    monkeypatch.setattr(tvanka, "DENSE_MAX_BYTES", n_bytes)
    assert PreconditionVanka(K, M, A, B, mode="dense").Binv.numel() * 8 == \
        n_bytes


def test_modes_refused():
    """shard takes the grid mode only (dense and cell levels are refused);
    mode takes None (grid or cell, by separable()) or "dense" only."""
    A, B = _tables("dg1")
    K, M = _ops()
    dense = PreconditionVanka(K, M, A, B, n_steps=4, mode="dense")
    cell = PreconditionVanka(*_ops(coefficient=True), A, B, n_steps=4)
    assert (dense.mode, cell.mode) == ("dense", "cell")
    for v in (dense, cell):
        with pytest.raises(ValueError, match="grid-mode"):
            v.shard(((0, 3), (0, 3)))
    grid = PreconditionVanka(K, M, A, B, n_steps=4)
    assert grid.mode == "grid"
    assert grid.shard(((0, 3), (0, 3))).cells == (3, 3)
    for mode in ("grid", "cell", "fastdiag"):
        with pytest.raises(ValueError, match="unknown mode"):
            PreconditionVanka(K, M, A, B, mode=mode)
