"""The Stokes slice of stfem_tpu_torch vs stfem_tpu (CPU), operator side:
the two-variable time tables and their per-level sequence, the DGP
element, the Vanka index maps and BlockSlice, the saddle operator and its element matrices, the slab system
and its rhs coupling, the FP64 saddle residual (against stfem_tpu's
float-float residual and against an FP64 StokesSystemMatrix oracle), and
the bench's FP64 force.  4^3 cells (Q2^3 x DGP1, n_q = 3), dG(1), 4 steps
per slab.  The hierarchy is in test_torch_stokes_gmg.py, so that the two
files run on separate workers.

Tolerances: tables and the DGP element are equal (both packages build
them in NumPy); the FP64 applies 1e-13 of the max (the same quadrature
summed in another order: the port contracts the full-cell basis where
stfem_tpu sum-factorizes); the residual 1e-12 of ||rhs|| (float-float
carries ~2^-48 per operation, FP64 ~2^-53)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu import blocks as jblocks
from stfem_tpu import types as jtypes
from stfem_tpu.errors import quad_coordinates
from stfem_tpu.mesh import fe_dgp as jdgp
from stfem_tpu.mesh.fe import shape_data_1d as jshape
from stfem_tpu.mesh.grid import StructuredMesh as JMesh
from stfem_tpu.ops.ff_stokes import build_ff_stokes_residual
from stfem_tpu.ops.floatfloat import ff_from_f64, ff_to_f64
from stfem_tpu.ops.spatial import LaplaceMassOperator as JOp
from stfem_tpu.ops.spatial import _sumfac as jsumfac
from stfem_tpu.ops.spatial import cell_scatter as jscatter
from stfem_tpu.ops.stokes import StokesOperator as JStokes
from stfem_tpu.system_stokes import StokesSystemMatrix as JSys
from stfem_tpu.time import tables as jtab
from stfem_tpu.utils import native as jnative
from stfem_tpu_torch import bench_stokes
from stfem_tpu_torch import blocks as tblocks
from stfem_tpu_torch import types as ttypes
from stfem_tpu_torch.mesh import fe_dgp as tdgp
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
from stfem_tpu_torch.ops.stokes import StokesOperator
from stfem_tpu_torch.ops.stokes_residual import build_stokes_residual64
from stfem_tpu_torch.system_stokes import StokesSystemMatrix
from stfem_tpu_torch.time import tables as ttab
from stfem_tpu_torch.utils import assembly as tasm

torch.set_num_threads(1)

TAU, NTAO = 1.0 / 16.0, 4
F64 = torch.float64


def _eq(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _close(t, j, rel):
    j = np.asarray(j, np.float64)
    np.testing.assert_allclose(np.asarray(t.detach().cpu(), np.float64), j,
                               atol=rel * max(np.abs(j).max(), 1e-300))


@pytest.mark.parametrize("tname,r", [("DG", 0), ("DG", 1), ("DG", 2),
                                     ("CGP", 1), ("CGP", 2)])
def test_stokes_tables_equal(tname, r):
    jt, tt = jtypes.TimeStepType[tname], ttypes.TimeStepType[tname]
    for n_at_once in (1, 2, 4):
        _eq(jtab.get_fe_time_weights_stokes(jt, r, TAU, n_at_once),
            ttab.get_fe_time_weights_stokes(tt, r, TAU, n_at_once))
    lad = ["h", "tau", "h", "k"] if r > 1 else ["h", "tau", "h"]
    degs = [r - 1, r] if r > 1 else [r]
    for fn in ("get_fe_time_weights", "get_fe_time_weights_stokes"):
        _eq(jtab.get_fe_time_weights_sequence(
                jt, TAU, 4, [jtypes.MGType[m] for m in lad], degs,
                weight_fn=getattr(jtab, fn)),
            ttab.get_fe_time_weights_sequence(
                tt, TAU, 4, [ttypes.MGType[m] for m in lad], degs,
                weight_fn=getattr(ttab, fn)))


@pytest.mark.parametrize("dim,deg", [(2, 0), (2, 2), (3, 1), (3, 2)])
def test_fe_dgp_equal(dim, deg):
    assert jdgp.dgp_exponents(dim, deg) == tdgp.dgp_exponents(dim, deg)
    assert jdgp.n_dgp_dofs(dim, deg) == tdgp.n_dgp_dofs(dim, deg)
    x = np.linspace(0.0, 1.0, 7)
    for n in range(deg + 1):
        _eq(jdgp.shifted_legendre_value(n, x),
            tdgp.shifted_legendre_value(n, x))
    _eq(jdgp.dgp_values_at_tensor_gauss(dim, deg, 3),
        tdgp.dgp_values_at_tensor_gauss(dim, deg, 3))
    _eq(jdgp.dgp_child_embedding(dim, deg), tdgp.dgp_child_embedding(dim, deg))
    if deg:
        _eq(jdgp.dgp_p_embedding(dim, deg - 1, deg),
            tdgp.dgp_p_embedding(dim, deg - 1, deg))


@pytest.mark.parametrize("cells,deg", [((3, 2), 1), ((2, 3, 2), 2),
                                       ((4, 4, 4), 2)])
def test_band_indices_and_valence_equal(cells, deg):
    _eq(jnative.band_indices(cells, deg), tasm.band_indices(cells, deg))
    _eq(jnative.dof_valence(cells, deg), tasm.dof_valence(cells, deg))


@pytest.mark.parametrize("variable_major", [True, False])
def test_block_slice_equal(variable_major):
    jb, tb = (B(4, 2, 3, variable_major=variable_major)
              for B in (jblocks.BlockSlice, tblocks.BlockSlice))
    assert tb.n_blocks == jb.n_blocks
    for i in range(tb.n_blocks):
        assert tb.decompose(i) == jb.decompose(i)
        assert tb.index(*tb.decompose(i)) == i
    for v in range(2):
        _eq(tb.get_time(v), jb.get_time(v))
    _eq(tb.get_variable(1, 2), jb.get_variable(1, 2))


@pytest.fixture(scope="module")
def ops():
    """f64 Stokes operators and mass operators at 4^3 in both packages."""
    jm = JMesh([2, 2, 2], [0.0] * 3, [1.0] * 3, refinement=1)
    tm = StructuredMesh([2, 2, 2], [0.0] * 3, [1.0] * 3, refinement=1)
    out = {}
    for nu in (1.0, 0.7):
        jS = JStokes(jm, 2, 1, 3, nu, dtype=jnp.float64)
        tS = StokesOperator(tm, 2, 1, 3, nu, dtype=F64, device="cpu")
        jM = JOp(jm, 2, 3, 1.0, 0.0, dtype=jnp.float64, mask=jS.mask_u_np)
        tM = LaplaceMassOperator(tm, 2, 3, 1.0, 0.0, dtype=F64,
                                 device="cpu", mask=tS.mask_u_np)
        out[nu] = (jS, tS, jM, tM)
    return jm, tm, out


def _random_flat(S, lead, seed):
    return np.random.default_rng(seed).standard_normal(lead
                                                       + (S.n_u + S.n_p,))


@pytest.mark.parametrize("nu", [1.0, 0.7])
def test_stokes_apply_f64(ops, nu):
    jS, tS, _, _ = ops[2][nu]
    assert (tS.n_u, tS.n_p, tS.p_shape) == (jS.n_u, jS.n_p, jS.p_shape)
    np.testing.assert_array_equal(tS.mask_u_np, jS.mask_u_np)
    x = _random_flat(tS, (2,), 1)
    ju, jp = jS.unpack(jnp.asarray(x))
    tu, tp = tS.unpack(torch.as_tensor(x))
    jru, jrp = jS.apply(ju, jp)
    tru, trp = tS.apply(tu, tp)
    _close(tru, jru, 1e-13)
    _close(trp, jrp, 1e-13)
    _close(tS.pack(tru, trp), jS.pack(jru, jrp), 1e-13)


@pytest.mark.parametrize("nu", [1.0, 0.7])
def test_stokes_element_matrices(ops, nu):
    jS, tS, _, _ = ops[2][nu]
    for t, j in zip(tS.element_matrices(), jS.element_matrices()):
        assert tuple(t.shape) == tuple(np.shape(j))
        _close(t, j, 1e-13)


def test_stokes_system_vmult_and_slice(ops):
    jS, tS, jM, tM = ops[2][1.0]
    for tname in ("DG", "CGP"):
        jt, tt = jtypes.TimeStepType[tname], ttypes.TimeStepType[tname]
        a, b, g, z = jtab.get_fe_time_weights(jt, 1, TAU, NTAO)
        gam, zet = (None, g) if tname == "DG" else (g, z)
        jsys = JSys(jS, jM, a, b, gamma=gam, zeta=zet, type_=jt)
        tsys = StokesSystemMatrix(tS, tM, a, b, gamma=gam, zeta=zet,
                                  type_=tt)
        x = _random_flat(tS, (a.shape[0],), 2)
        _close(tsys.vmult(torch.as_tensor(x)), jsys.vmult(jnp.asarray(x)),
               1e-13)
        prev = _random_flat(tS, (), 3)
        _close(tsys.vmult_slice(*tS.unpack(torch.as_tensor(prev))),
               jsys.vmult_slice(*jS.unpack(jnp.asarray(prev))), 1e-13)


@pytest.mark.parametrize("nu", [1.0, 0.7])
def test_stokes_residual_vs_ff_and_oracle(ops, nu):
    jS, tS, jM, tM = ops[2][nu]
    a, b, g, _ = jtab.get_fe_time_weights(jtypes.TimeStepType.DG, 1, TAU,
                                          NTAO)
    T = a.shape[0]
    rng = np.random.default_rng(5)
    prev, x, f = (rng.standard_normal(s) for s in
                  ((tS.n_u + tS.n_p,), (T, tS.n_u + tS.n_p),
                   (T, tS.n_u + tS.n_p)))
    # the float-float pairs, and their exact values for the port
    pff, xff, fff = (ff_from_f64(jnp.asarray(v)) for v in (prev, x, f))
    exact = lambda ff: torch.as_tensor(np.asarray(ff[0], np.float64)
                                       + np.asarray(ff[1], np.float64))
    jres = build_ff_stokes_residual(jS, a, b, zeta=g)
    (rh, rl), _, _ = jres.residual(pff, xff, fff)
    tres = build_stokes_residual64(tS, a, b, zeta=g)
    r, rn, bn = tres.residual(exact(pff), exact(xff), exact(fff))
    np.testing.assert_allclose(r.numpy(), np.asarray(ff_to_f64((rh, rl))),
                               atol=1e-12 * float(bn))
    # the f64 slab-system oracle: rhs = zeta (x) M prev + f, r = rhs - A x
    sysm = StokesSystemMatrix(tS, tM, a, b)
    rhsm = StokesSystemMatrix(tS, tM, a, b, zeta=g)
    rhs = rhsm.vmult_slice(*tS.unpack(exact(pff))) + exact(fff)
    ro = rhs - sysm.vmult(exact(xff))
    assert abs(float(bn) - float(rhs.norm())) <= 1e-12 * float(bn)
    assert float((r - ro).abs().max()) <= 1e-12 * float(bn)
    assert abs(float(rn) - float(ro.norm())) <= 1e-12 * float(bn)


def test_bench_force_vs_stfem_tpu_form(ops):
    """bench_stokes.force_slab against bench.py's force assembly
    (bench.py:158-197), written with stfem_tpu's own functions."""
    jm, tm, od = ops
    jS, tS, _, _ = od[1.0]
    tq = jtab.get_time_quad(jtypes.TimeStepType.DG, 1)[0]
    a1 = jtab.get_fe_time_weights(jtypes.TimeStepType.DG, 1, TAU, 1)[0]
    t_rows = np.array([0.5 + TAU * it + TAU * float(q) for it in range(NTAO)
                       for q in tq])
    scales = np.array([a1[j, j] for _ in range(NTAO) for j in range(len(tq))])
    Sf = jnp.asarray(jshape(2, 3).S)
    jxw = jnp.asarray(jm.geometry(3, 2).jxw)
    pts = jnp.asarray(quad_coordinates(jm, 3))
    rows = []
    for t, sc in zip(t_rows, scales):
        s = (jnp.sin(np.pi * pts[..., 0]) * jnp.sin(np.pi * pts[..., 1])
             * jnp.sin(np.pi * pts[..., 2]) * jnp.sin(t + 0.3))
        comps = [jscatter(jsumfac([Sf] * 3, c * s * jxw, 3, forward=False),
                          jm.cells, 2) for c in (1.0, 2.0, -1.0)]
        fu = jnp.stack(comps) * jS.mask_u
        rows.append(jnp.concatenate([fu.reshape(-1) * sc,
                                     jnp.zeros(jS.n_p)]))
    got = bench_stokes.force_slab(tm, tS, t_rows, scales)
    _close(got, jnp.stack(rows), 1e-13)
