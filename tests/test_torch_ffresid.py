"""stfem_tpu_torch FP64 Kronecker pair (K2's plain version) and FP64 slab
residual vs stfem_tpu's float-float engine and its f64 SystemMatrix
residual (CPU).

Tolerance 1e-12 relative to the reference's max norm (or ||rhs|| for the
residual): float-float carries ~2^-48 per operation, the f64 paths ~2^-53,
so their difference sits near 1e-14."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu.mesh.grid import StructuredMesh as JMesh
from stfem_tpu.ops.floatfloat import (FFSlabResidual, KronAssembledFF,
                                      ff_from_f64, ff_to_f64)
from stfem_tpu.ops.kronfac import KronAssembled as JKron
from stfem_tpu.ops.pallas_ffresid import kron_pair_ff_pallas
from stfem_tpu.ops.spatial import LaplaceMassOperator as JOp
from stfem_tpu.system import SystemMatrix as JSys
from stfem_tpu.time.tables import get_fe_time_weights
from stfem_tpu.types import TimeStepType
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.kron_pair import kron_pair, kron_pair_reference
from stfem_tpu_torch.ops.kronfac import KronAssembled
from stfem_tpu_torch.ops.slab_residual import SlabResidual64
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
from stfem_tpu_torch.utils.carry import load_kron

torch.set_num_threads(1)


def _ops(refinement, deg):
    jm = JMesh([2, 2, 2], [0.0] * 3, [1.0] * 3, refinement=refinement)
    tm = StructuredMesh([2, 2, 2], [0.0] * 3, [1.0] * 3,
                        refinement=refinement)
    f64 = jnp.float64
    jK = JOp(jm, deg, deg + 1, 0.0, 1.0, dtype=f64)
    jM = JOp(jm, deg, deg + 1, 1.0, 0.0, dtype=f64)
    tK = LaplaceMassOperator(tm, deg, deg + 1, 0.0, 1.0, dtype=torch.float64,
                             device="cpu")
    tM = LaplaceMassOperator(tm, deg, deg + 1, 1.0, 0.0, dtype=torch.float64,
                             device="cpu")
    return jK, jM, tK, tM


def _rel(got, ref, scale=None):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    scale = np.max(np.abs(ref)) if scale is None else scale
    return np.max(np.abs(got - ref)) / scale


@pytest.mark.parametrize("refinement,deg", [(1, 3), (1, 4), (0, 2)])
def test_k2_plain_vs_ff_xla(refinement, deg):
    jK, jM, tK, tM = _ops(refinement, deg)
    jk = JKron(jK, jM, jnp.float64)
    kff = KronAssembledFF(jk)
    tk = KronAssembled(tK, tM, torch.float64)
    x = np.random.default_rng(1).standard_normal((2,) + jK.dof_shape)
    # eager, as stfem_tpu's own parity test runs it
    Kf, Mf = kff._pair_xla(ff_from_f64(jnp.asarray(x)))
    Kt, Mt = kron_pair_reference(torch.as_tensor(x), tk.Md, tk.Ad, tk.k)
    assert _rel(Kt, ff_to_f64(Kf)) <= 1e-12
    assert _rel(Mt, ff_to_f64(Mf)) <= 1e-12
    # the same with the JAX factors carried across
    load_kron(tk, Md=[np.asarray(a) for a in jk.Md],
              Ad=[np.asarray(a) for a in jk.Ad])
    Kc, Mc = kron_pair_reference(torch.as_tensor(x), tk.Md, tk.Ad, tk.k)
    assert _rel(Kc, ff_to_f64(Kf)) <= 1e-12
    assert _rel(Mc, ff_to_f64(Mf)) <= 1e-12


def test_k2_plain_vs_pallas_interpret():
    jK, jM, tK, tM = _ops(0, 3)
    kff = KronAssembledFF(JKron(jK, jM, jnp.float64))
    tk = KronAssembled(tK, tM, torch.float64)
    n = int(kff.Md[0][0].shape[1])
    x = np.random.default_rng(3).standard_normal((2, n, n, n))
    xh, xl = ff_from_f64(jnp.asarray(x))
    Kh, Kl, Mh, Ml = kron_pair_ff_pallas(xh, xl, kff._Dmh, kff._Dml,
                                         kff._Dah, kff._Dal, kff.k,
                                         interpret=True)
    before = kron_pair.launches
    Kt, Mt = kron_pair(torch.as_tensor(x), tk.Md, tk.Ad, tk.k)
    assert kron_pair.launches == before          # CPU: the plain version
    assert _rel(Kt, ff_to_f64((Kh, Kl))) <= 1e-12
    assert _rel(Mt, ff_to_f64((Mh, Ml))) <= 1e-12


def _slab_case(refinement, deg, ntao, seed):
    jK, jM, tK, tM = _ops(refinement, deg)
    A, B, G, _ = get_fe_time_weights(TimeStepType.DG, 2, 1 / 16, ntao)
    rng = np.random.default_rng(seed)
    nb = A.shape[0]
    x = rng.standard_normal((nb,) + jK.dof_shape)
    prev = rng.standard_normal(jK.dof_shape)
    fslab = rng.standard_normal(x.shape)
    full = JSys(jK, jM, A, B)
    r64 = JSys(jK, jM, np.zeros_like(G), G)
    rhs_ref = (np.asarray(jax.jit(r64.vmult)(jnp.asarray(prev)[None]))
               + fslab)
    r_ref = rhs_ref - np.asarray(jax.jit(full.vmult)(jnp.asarray(x)))
    res = SlabResidual64(KronAssembled(tK, tM, torch.float64), tK.mask_np,
                         A, B, G)
    r, rn, bn = res.residual(torch.as_tensor(prev), torch.as_tensor(x),
                             torch.as_tensor(fslab))
    return (jK, jM, A, B, G, x, prev, fslab), rhs_ref, r_ref, (r, rn, bn)


@pytest.mark.parametrize("refinement,deg,ntao", [(1, 3, 4), (1, 4, 2),
                                                 (0, 4, 8)])
def test_slab_residual_vs_f64_system(refinement, deg, ntao):
    _, rhs_ref, r_ref, (r, rn, bn) = _slab_case(refinement, deg, ntao, 4)
    scale = np.linalg.norm(rhs_ref.reshape(-1))
    assert np.linalg.norm((r.numpy() - r_ref).reshape(-1)) / scale <= 1e-12
    np.testing.assert_allclose(float(rn), np.linalg.norm(r_ref.reshape(-1)),
                               rtol=1e-12)
    np.testing.assert_allclose(float(bn), scale, rtol=1e-12)


def test_slab_residual_vs_ff_engine():
    (jK, jM, A, B, G, x, prev, fslab), rhs_ref, _, (r, rn, bn) = \
        _slab_case(1, 3, 4, 9)
    ffres = FFSlabResidual(jK, jM, A, B, G)
    (rh, rl), frn, fbn = jax.jit(ffres.residual)(
        ff_from_f64(jnp.asarray(prev)), ff_from_f64(jnp.asarray(x)),
        ff_from_f64(jnp.asarray(fslab)))
    r_ff = np.asarray(rh, np.float64) + np.asarray(rl, np.float64)
    scale = np.linalg.norm(rhs_ref.reshape(-1))
    assert np.linalg.norm((r.numpy() - r_ff).reshape(-1)) / scale <= 1e-12
    # the ff engine's norms are float32 reductions (~1e-6)
    np.testing.assert_allclose(float(rn), float(frn), rtol=1e-5)
    np.testing.assert_allclose(float(bn), float(fbn), rtol=1e-5)


def test_slab_residual_cancellation():
    """An rhs NEAR A x (the IR regime: ~5 digits cancel) keeps the
    cancelled digits: the FP64 residual matches the f64 oracle to 1e-12 of
    ||rhs||, where a float32 residual is only ~1e-7."""
    jK, jM, tK, tM = _ops(1, 3)
    A, B, G, _ = get_fe_time_weights(TimeStepType.DG, 2, 1 / 16, 4)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((A.shape[0],) + jK.dof_shape)
    ax = np.asarray(jax.jit(JSys(jK, jM, A, B).vmult)(jnp.asarray(x)))
    rhs = ax * (1.0 + 1e-5 * rng.standard_normal(ax.shape))
    res = SlabResidual64(KronAssembled(tK, tM, torch.float64), tK.mask_np,
                         A, B, np.zeros_like(G))
    r, _, _ = res.residual(torch.zeros(jK.dof_shape, dtype=torch.float64),
                           torch.as_tensor(x), torch.as_tensor(rhs))
    scale = np.linalg.norm(rhs.reshape(-1))
    err = np.linalg.norm((r.numpy() - (rhs - ax)).reshape(-1)) / scale
    assert err <= 1e-12, err
