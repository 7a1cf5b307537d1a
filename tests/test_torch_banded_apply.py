"""Kernel K3 (the FP64 single-axis banded apply) of stfem_tpu_torch vs
stfem_tpu (CPU): its plain version against the Pallas kernel
banded_ff_lane_apply in interpret mode, the f64 KronAssembled.pair for
every (need_K, need_M) against KronPallas9 in interpret mode, the routing
of single-output requests through K3, and the plain version along every
axis against a dense 1D matmul.

Tolerances: the float-float kernel carries ~2^-48 relative per operation
against FP64's 2^-53, so 1e-13 of the max for one apply and 1e-12 for the
chained pair (as tests/test_floatfloat.py's pallas9 parity); the plain
version against the dense matmul 1e-14 of the max (the same products,
summed in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu.mesh.grid import StructuredMesh as JMesh
from stfem_tpu.ops.floatfloat import ff_from_f64, ff_to_f64
from stfem_tpu.ops.kronfac import KronAssembled as JKron
from stfem_tpu.ops.pallas_ffband import KronPallas9, banded_ff_lane_apply
from stfem_tpu.ops.spatial import LaplaceMassOperator as JOp
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops import kronfac
from stfem_tpu_torch.ops.banded_apply import banded_apply_reference
from stfem_tpu_torch.ops.kronfac import KronAssembled, to_diags
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator

torch.set_num_threads(1)


def _banded(n, k, rng):
    """A random banded (n, n) matrix of half-bandwidth k and its (2k+1, n)
    diagonal storage."""
    A = rng.standard_normal((n, n))
    A[np.abs(np.subtract.outer(np.arange(n), np.arange(n))) > k] = 0.0
    return A, to_diags(A, k)


@pytest.mark.parametrize("n,k", [(n, k) for n in (9, 13) for k in (2, 3, 4)])
def test_banded_apply_plain_vs_pallas_lane_apply(n, k):
    rng = np.random.default_rng(100 * n + k)
    _, D = _banded(n, k, rng)
    xh, xl = ff_from_f64(jnp.asarray(rng.standard_normal((2, n, n, n))))
    dh, dl = ff_from_f64(jnp.asarray(D))
    yh, yl = banded_ff_lane_apply(xh, xl, dh, dl, k, interpret=True)
    ref = np.asarray(ff_to_f64((yh, yl)))
    # the port's input is the exact value of the float-float pair
    x64 = np.asarray(xh, np.float64) + np.asarray(xl, np.float64)
    d64 = np.asarray(dh, np.float64) + np.asarray(dl, np.float64)
    got = banded_apply_reference(torch.as_tensor(x64), torch.as_tensor(d64),
                                 -1, k).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-13 * np.abs(ref).max())


@pytest.fixture(scope="module")
def krons():
    deg = 3
    jm = JMesh([2, 2, 2], [0.0] * 3, [1.0] * 3, refinement=0)
    tm = StructuredMesh([2, 2, 2], [0.0] * 3, [1.0] * 3, refinement=0)
    jk = JKron(JOp(jm, deg, deg + 1, 0.0, 1.0, dtype=jnp.float64),
               JOp(jm, deg, deg + 1, 1.0, 0.0, dtype=jnp.float64),
               jnp.float64)
    tk = KronAssembled(
        LaplaceMassOperator(tm, deg, deg + 1, 0.0, 1.0, dtype=torch.float64,
                            device="cpu"),
        LaplaceMassOperator(tm, deg, deg + 1, 1.0, 0.0, dtype=torch.float64,
                            device="cpu"), torch.float64)
    x = np.random.default_rng(11).standard_normal((2,) + tm.dof_shape(deg))
    return KronPallas9(jk, interpret=True), tk, x


@pytest.mark.parametrize("need_K,need_M", [(True, True), (True, False),
                                           (False, True)])
def test_kron_pair_flags_vs_pallas9(krons, need_K, need_M):
    kp9, tk, x = krons
    xff = ff_from_f64(jnp.asarray(x))
    x64 = np.asarray(xff[0], np.float64) + np.asarray(xff[1], np.float64)
    jK, jM = kp9.pair(xff, need_K=need_K, need_M=need_M)
    tK, tM = tk.pair(torch.as_tensor(x64), need_K, need_M)
    for j, t, need in ((jK, tK, need_K), (jM, tM, need_M)):
        if not need:
            assert t is None
            continue
        ref = np.asarray(ff_to_f64(j))
        np.testing.assert_allclose(t.numpy(), ref,
                                   atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("need_K,need_M,n_k3,n_k2", [
    (True, True, 0, 1), (True, False, 7, 0), (False, True, 3, 0)])
def test_single_output_pairs_route_to_k3(krons, monkeypatch, need_K,
                                         need_M, n_k3, n_k2):
    """Both outputs of a 3D grid go to K2; any single output is a chain
    of K3 applies (M x alone: one per axis)."""
    _, tk, x = krons
    calls = {"k3": 0, "k2": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(kronfac, "banded_apply",
                        spy("k3", kronfac.banded_apply))
    monkeypatch.setattr(kronfac, "kron_pair", spy("k2", kronfac.kron_pair))
    tk.pair(torch.as_tensor(x), need_K, need_M)
    assert calls == {"k3": n_k3, "k2": n_k2}


@pytest.mark.parametrize("axis", [0, 1, 2, -1])
def test_banded_apply_plain_vs_dense_matmul(axis):
    rng = np.random.default_rng(7 + axis)
    shape, k = (7, 9, 11), 3
    A, D = _banded(shape[axis], k, rng)
    x = rng.standard_normal(shape)
    ref = np.moveaxis(np.tensordot(A, x, axes=([1], [axis])), 0, axis)
    got = banded_apply_reference(torch.as_tensor(x), torch.as_tensor(D),
                                 axis, k).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-14 * np.abs(ref).max())
