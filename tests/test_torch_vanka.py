"""stfem_tpu_torch grid-mode Vanka, K1 plain version and transfers vs
stfem_tpu (CPU).

Tolerances, relative to the reference's max norm: float32 1e-5 (rounding
of float32 sums in another order); bf16 2e-2 (a few bf16 roundings of the
down/up matmuls, 2^-8 each); float64 transfers 1e-13."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu.mesh.grid import StructuredMesh as JMesh
from stfem_tpu.ops.pallas_timesolve import pick_tile, time_solve_pallas
from stfem_tpu.ops.spatial import LaplaceMassOperator as JOp
from stfem_tpu.stmg import transfers as jtr
from stfem_tpu.stmg.vanka import PreconditionVanka as JVanka
from stfem_tpu.time.tables import get_fe_time_weights
from stfem_tpu.types import MGType as JMG, TimeStepType as JT
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
from stfem_tpu_torch.ops.time_solve import time_solve, time_solve_reference
from stfem_tpu_torch.stmg import transfers as ttr
from stfem_tpu_torch.stmg.vanka import PreconditionVanka
from stfem_tpu_torch.types import MGType as TMG, TimeStepType as TT
from stfem_tpu_torch.utils.carry import load_vanka

torch.set_num_threads(1)


def _rel(got, ref):
    got = got.double().numpy() if torch.is_tensor(got) else got
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _f32(a):
    return None if a is None else np.asarray(a, np.float32)


def _pair(cells, k, ns, bf16):
    jm = JMesh(list(cells), [0.0] * 3, [1.0] * 3)
    tm = StructuredMesh(list(cells), [0.0] * 3, [1.0] * 3)
    A, B, _, _ = get_fe_time_weights(JT.DG, 2, 0.125, ns)
    jK = JOp(jm, k, k + 1, 0.0, 1.0, dtype=jnp.float32)
    jM = JOp(jm, k, k + 1, 1.0, 0.0, dtype=jnp.float32)
    tK = LaplaceMassOperator(tm, k, k + 1, 0.0, 1.0, dtype=torch.float32,
                             device="cpu")
    tM = LaplaceMassOperator(tm, k, k + 1, 1.0, 0.0, dtype=torch.float32,
                             device="cpu")
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    jv = JVanka(jK, jM, A, B, dtype=jdt,
                storage_dtype=jnp.bfloat16 if bf16 else None, n_steps=ns)
    tv = PreconditionVanka(tK, tM, A, B, dtype=tdt,
                           storage_dtype=torch.bfloat16 if bf16 else None,
                           n_steps=ns)
    x = np.random.default_rng(5).standard_normal(
        (A.shape[0],) + jK.dof_shape).astype(np.float32) * jK.mask_np
    return jv, tv, x


@pytest.mark.parametrize("bf16,tol", [(False, 1e-5), (True, 2e-2)])
@pytest.mark.parametrize("cells,k,ns", [((3, 3, 3), 4, 4), ((2, 3, 2), 2, 2),
                                        ((2, 2, 2), 2, 1)])
def test_vanka_grid_carried(cells, k, ns, bf16, tol):
    """The apply, with the JAX factors carried across."""
    jv, tv, x = _pair(cells, k, ns, bf16)
    assert tv.n_steps == jv.n_steps
    load_vanka(tv, [_f32(w) for w in jv.Wdn], [_f32(w) for w in jv.Wup],
               _f32(jv.GinvT), _f32(jv.cvecT), _f32(jv.TTg))
    ref = jax.jit(jv.vmult)(jnp.asarray(x))
    got = tv.vmult(torch.as_tensor(x))
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert _rel(got, np.asarray(ref, np.float32)) <= tol


@pytest.mark.parametrize("cells,k,ns", [((3, 3, 3), 4, 4), ((2, 2, 2), 2, 1)])
def test_vanka_grid_factors_own_build(cells, k, ns):
    """The port's own setup (eigenbasis, banded down/up, per-position
    factors) against stfem_tpu's, float32.  Eigenvector signs may differ,
    so the down/up matrices are compared through their product."""
    jv, tv, x = _pair(cells, k, ns, False)
    for d in range(3):
        np.testing.assert_allclose(
            (tv.Wup[d] @ tv.Wdn[d]).numpy(),
            np.asarray(jv.Wup[d] @ jv.Wdn[d]), atol=1e-5)
    if ns > 1:
        assert _rel(tv.GinvT, jv.GinvT) <= 1e-5
        assert _rel(tv.cvecT, jv.cvecT) <= 1e-5
    else:
        assert _rel(tv.TTg, jv.TTg) <= 1e-5
    assert _rel(tv.vmult(torch.as_tensor(x)),
                jax.jit(jv.vmult)(jnp.asarray(x))) <= 1e-5


def _k1_inputs(S, nt, N, seed=11):
    """The inputs of test_stmg.py::test_pallas_timesolve_kernel_parity."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((S * nt, N)).astype(np.float32)
    GinvT = (0.3 * rng.standard_normal((nt, nt, N))).astype(np.float32)
    cvecT = rng.uniform(-0.9, 0.9, (nt, N)).astype(np.float32)
    return w, GinvT, cvecT


def test_k1_plain_vs_pallas_interpret():
    S, nt, N = 4, 3, 1024
    w, G, c = _k1_inputs(S, nt, N)
    TN = pick_tile(N, S, nt, 4)
    ref = time_solve_pallas(jnp.asarray(w), jnp.asarray(G), jnp.asarray(c),
                            S, nt, TN, jnp.float32, interpret=True)
    got = time_solve_reference(torch.as_tensor(w), torch.as_tensor(G),
                               torch.as_tensor(c), S, nt, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("S,nt", [(32, 3), (5, 2), (3, 1), (2, 4)])
def test_k1_wrapper_cpu_uses_plain_version(S, nt):
    """On a CPU tensor the wrapper is the plain version (no launch)."""
    w, G, c = _k1_inputs(S, nt, 300, seed=S)
    before = time_solve.launches
    args = (torch.as_tensor(w).to(torch.bfloat16), torch.as_tensor(G),
            torch.as_tensor(c), S, nt, torch.bfloat16)
    got = time_solve(*args)
    assert time_solve.launches == before
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, time_solve_reference(*args))
    # the sequential recurrence, written out in numpy
    ws = np.asarray(args[0].float()).reshape(S, nt, -1)
    y = np.einsum("ijn,sjn->sin", G, ws)
    prev = np.zeros(y.shape[-1], np.float32)
    for s in range(S):
        np.testing.assert_allclose(got[s * nt:(s + 1) * nt].float().numpy(),
                                   y[s] + prev * c, rtol=8e-3, atol=8e-3)
        prev = y[s, -1] + c[-1] * prev


def test_k1_wrapper_rejects_other_devices():
    w, G, c = _k1_inputs(2, 3, 64)
    meta = lambda a: torch.as_tensor(a).to("meta")
    with pytest.raises(ValueError):
        time_solve(meta(w), meta(G), meta(c), 2, 3, torch.float32)


@pytest.mark.parametrize("mgt", ["h", "p", "tau", "k"])
def test_transfers(mgt):
    rng = np.random.default_rng(7)
    if mgt in ("h", "p"):
        jm = JMesh([2, 2, 2], [0.0] * 3, [1.0] * 3, refinement=1)
        jc = JMesh([2, 2, 2], [0.0] * 3, [1.0] * 3, refinement=0)
        if mgt == "h":
            kh = kl = 2
            P = [jtr.h_prolongation_global_1d(2, kh)] * 3
            mc = jc
        else:
            kh, kl = 4, 2
            P = [jtr.p_prolongation_global_1d(4, kl, kh)] * 3
            mc = jm
        args = (P, jm.boundary_dof_mask(kh), mc.boundary_dof_mask(kl))
        jt = jtr.SpaceTransfer(*args, dtype=jnp.float64)
        tt = ttr.SpaceTransfer(*args, dtype=torch.float64, device="cpu")
        xc = rng.standard_normal((3,) + mc.dof_shape(kl))
        xf = rng.standard_normal((3,) + jm.dof_shape(kh))
    else:
        j_mg, t_mg = JMG[mgt], TMG[mgt]
        nlo = 2 if mgt == "k" else 3
        jt = jtr.TimeTransfer(JT.DG, j_mg, 3, nlo, 4, dtype=jnp.float64)
        tt = ttr.TimeTransfer(TT.DG, t_mg, 3, nlo, 4, dtype=torch.float64,
                              device="cpu")
        nc = nlo * (4 if mgt == "k" else 2)
        xc = rng.standard_normal((nc, 5, 5))
        xf = rng.standard_normal((12, 5, 5))
    assert _rel(tt.prolongate(torch.as_tensor(xc)),
                jt.prolongate(jnp.asarray(xc))) <= 1e-13
    assert _rel(tt.restrict(torch.as_tensor(xf)),
                jt.restrict(jnp.asarray(xf))) <= 1e-13
